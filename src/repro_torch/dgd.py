"""The paper's Section VI scenario end to end: distributed linear regression
with DGD under straggler scheduling; counterpart of
``examples/linear_regression_dgd.py`` and of the Table I check in
``benchmarks/table1_e2e.py``.

Every scheme really computes h(X_i) = X_i X_i^T theta — the uncoded
schemes through ``batched_gram_matvec`` (the ``gram_matvec`` CUDA kernel on
the card, one launch per iteration for all n tasks), the coded schemes on
their encoded data — the master applies eq. (61) (uncoded, through the
``StragglerAggregator``) or decodes (PC/PCMM), and a virtual clock
advances by each round's completion time.  The cluster is the EC2-like iid
one or, with ``cluster="markov"``, a heterogeneous persistent-straggler
``ec2_cluster``; the ADAPT row re-assigns the CS matrix's rows every
iteration from delay feedback (one ``greedy_assign`` kernel launch per
iteration on the card).  A run seeded ``seed`` starts its process under
``rng.round_seed(seed, 0)`` and draws iteration ``it`` under
``rng.round_seed(seed, it + 1)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from .configs import RegressionConfig
from .core import rng
from .core import (IIDProcess, RoundConfig, StragglerAggregator, ec2_cluster,
                   ec2_like, pc_decode, pc_encode, pc_threshold, pc_worker_compute,
                   pcmm_decode, pcmm_encode, pcmm_threshold,
                   pcmm_worker_compute, slot_arrival_times)
from .data import regression_dataset, regression_tasks
from .device import resolve_device
from .kernels.ops import batched_gram_matvec

__all__ = ["RegressionProblem", "DGDRun", "regression_problem", "loss_of",
           "run_uncoded", "run_pc", "run_pcmm", "paper_problem",
           "paper_cluster", "run_paper", "table1_check"]


@dataclasses.dataclass(frozen=True)
class RegressionProblem:
    """The regression data in the layouts the workers and the master use."""
    X: torch.Tensor          # (N, d)
    y: torch.Tensor          # (N,)
    Xs_cols: torch.Tensor    # (n, d, b): task i's samples as columns
    Xty_parts: torch.Tensor  # (n, d): X_i^T y_i per task
    Xty: torch.Tensor        # (d,)

    @property
    def n(self) -> int:
        return self.Xs_cols.shape[0]

    @property
    def N(self) -> int:
        return self.Xs_cols.shape[0] * self.Xs_cols.shape[2]


@dataclasses.dataclass
class DGDRun:
    """One scheme's run: final parameters, virtual wall-clock (seconds),
    ``(iteration, clock, loss)`` curve points, and per iteration the tasks
    (uncoded) or workers / slots (coded) whose results were used."""
    name: str
    theta: torch.Tensor
    clock: float
    curve: List[Tuple[int, float, float]]
    used: List[Tuple[int, ...]]


def regression_problem(X: torch.Tensor, y: torch.Tensor,
                       n: int) -> RegressionProblem:
    """Split float32 ``X``/``y`` into n tasks; everything stays on X's
    device."""
    Xs, ys = regression_tasks(X, y, n)
    Xs_cols = Xs.transpose(1, 2).contiguous()
    Xty_parts = torch.einsum("nbd,nb->nd", Xs, ys)
    return RegressionProblem(X=X, y=y, Xs_cols=Xs_cols, Xty_parts=Xty_parts,
                             Xty=Xty_parts.sum(dim=0))


def loss_of(theta: torch.Tensor, X: torch.Tensor, y: torch.Tensor) -> float:
    res = X @ theta.to(X.dtype) - y
    return float(res @ res) / X.shape[0]


def run_uncoded(config: RoundConfig, process, prob: RegressionProblem,
                iters: int, lr: float, *, seed: int = 0,
                curve_every: int = 10, label: str = "?") -> DGDRun:
    """The paper's uncoded DGD loop (Table I rows) through the round API:
    per iteration the aggregator schedules and draws the round (an adaptive
    ``config`` re-assigns the rows from delay feedback first), every worker
    computes h for its tasks (one batched kernel launch for all n tasks),
    and the master applies eq. (61) over the k winning distinct tasks."""
    dev = prob.X.device
    n, k, N = config.n, config.k, prob.N
    theta = torch.zeros(prob.Xs_cols.shape[1], dtype=torch.float32,
                        device=dev)
    agg = StragglerAggregator(config, process,
                              init_seed=rng.round_seed(seed, 0), device=dev)
    clock, curve, used = 0.0, [], []
    for it in range(iters):
        C = torch.as_tensor(agg.current_matrix(), device=dev)
        w, t_done = agg.round_mask(rng.round_seed(seed, it + 1))
        clock += float(t_done)
        hs = batched_gram_matvec(prob.Xs_cols, theta)     # workers: h(X_i)
        sel = torch.unique(C[w > 0])                      # sorted task ids
        if sel.numel() != k:
            raise RuntimeError(f"round {it} selected {sel.numel()} tasks, "
                               f"expected k={k}")
        grad = (2 * n / (k * N)) * (hs[sel] - prob.Xty_parts[sel]).sum(dim=0)
        theta = theta - lr * grad
        used.append(tuple(sel.tolist()))
        if it % curve_every == 0 or it == iters - 1:
            curve.append((it, clock, loss_of(theta, prob.X, prob.y)))
    return DGDRun(label, theta, clock, curve, used)


def run_pc(process, prob: RegressionProblem, r: int, iters: int, lr: float,
           *, seed: int = 7, curve_every: int = 10,
           label: str = "PC") -> DGDRun:
    """PC: one coded message per worker; the master decodes from the
    2*ceil(n/r)-1 earliest workers (eqs. 51-52)."""
    dev, n, N = prob.X.device, prob.n, prob.N
    theta = torch.zeros(prob.Xs_cols.shape[1], dtype=torch.float64,
                        device=dev)
    Xt, alphas, _ = pc_encode(prob.Xs_cols, r)
    kth = pc_threshold(n, r)
    tid = torch.zeros(1, dtype=torch.int64, device=dev)
    state = process.init_trials(rng.round_seed(seed, 0), tid, n)
    clock, curve, used = 0.0, [], []
    for it in range(iters):
        state, T1, T2 = process.step(state, rng.round_seed(seed, it + 1),
                                     tid, n, r)
        t_w = (T1.sum(dim=-1) + T2[..., -1])[0]           # per-worker times
        srt, order = torch.sort(t_w, stable=True)
        order = order[:kth]
        clock += float(srt[kth - 1])
        res = pc_worker_compute(Xt[order], theta)
        xxt = pc_decode(res, alphas[order.cpu().numpy()], n, r)
        theta = theta - lr * 2 / N * (xxt - prob.Xty)
        used.append(tuple(order.tolist()))
        if it % curve_every == 0 or it == iters - 1:
            curve.append((it, clock, loss_of(theta, prob.X, prob.y)))
    return DGDRun(label, theta, clock, curve, used)


def run_pcmm(process, prob: RegressionProblem, r: int, iters: int,
             lr: float, *, seed: int = 9, curve_every: int = 10,
             label: str = "PCMM") -> DGDRun:
    """PCMM: sequential coded messages; the master decodes from the 2n-1
    earliest slot results (eqs. 56-57)."""
    dev, n, N = prob.X.device, prob.n, prob.N
    d, b = prob.Xs_cols.shape[1:]
    theta = torch.zeros(d, dtype=torch.float64, device=dev)
    Xh, betas = pcmm_encode(prob.Xs_cols, r)
    Xh = Xh.reshape(n * r, d, b)
    betas = betas.reshape(-1)
    need = pcmm_threshold(n)
    tid = torch.zeros(1, dtype=torch.int64, device=dev)
    state = process.init_trials(rng.round_seed(seed, 0), tid, n)
    clock, curve, used = 0.0, [], []
    for it in range(iters):
        state, T1, T2 = process.step(state, rng.round_seed(seed, it + 1),
                                     tid, n, r)
        s = slot_arrival_times(T1, T2)[0].reshape(-1)
        srt, order = torch.sort(s, stable=True)
        order = order[:need]
        clock += float(srt[need - 1])
        res = pcmm_worker_compute(Xh[order], theta)
        xxt = pcmm_decode(res, betas[order.cpu().numpy()], n)
        theta = theta - lr * 2 / N * (xxt - prob.Xty)
        used.append(tuple(order.tolist()))
        if it % curve_every == 0 or it == iters - 1:
            curve.append((it, clock, loss_of(theta, prob.X, prob.y)))
    return DGDRun(label, theta, clock, curve, used)


def paper_problem(cfg: RegressionConfig, *, seed: int = 0,
                  device=None) -> RegressionProblem:
    """The scenario's data, drawn on the CPU from ``seed`` (so every device
    sees the same data) and moved to ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    X, y, _ = regression_dataset(gen, cfg.N, cfg.d, device="cpu")
    return regression_problem(X.to(dev), y.to(dev), cfg.n)


def paper_cluster(n: int, cluster: str = "iid", *,
                  persistence: float = 0.95, spread: float = 3.0):
    """The example's cluster: ``"iid"`` is the EC2-like iid cluster
    (``ec2_like(n, seed=1)``), ``"markov"`` the heterogeneous
    persistent-straggler ``ec2_cluster`` on the same base, as the JAX
    example builds them."""
    if cluster == "iid":
        return IIDProcess(ec2_like(n, seed=1))
    if cluster == "markov":
        return ec2_cluster(n, spread=spread, p_slow=0.25,
                           persistence=persistence, slow=8.0,
                           base=ec2_like(n, seed=1), seed=1)
    raise ValueError(f"unknown cluster {cluster!r}; choose iid or markov")


def run_paper(cfg: RegressionConfig = RegressionConfig(), iters: int = 100,
              *, device=None, curve_every: int = 10, cluster: str = "iid",
              persistence: float = 0.95,
              spread: float = 3.0) -> Dict[str, DGDRun]:
    """Run CS / SS / RA / ADAPT / PC / PCMM on ``paper_cluster(cfg.n,
    cluster)``, as the JAX example does; the coded rows advance their own
    realization of the same process type."""
    prob = paper_problem(cfg, device=device)
    process = paper_cluster(cfg.n, cluster, persistence=persistence,
                            spread=spread)
    runs = {}
    for name, kind, adaptive in (("CS", "cs", False), ("SS", "ss", False),
                                 ("RA", "ra", False), ("ADAPT", "cs", True)):
        rc = RoundConfig(n=cfg.n, k=cfg.k, kind=kind,
                         r=cfg.n if kind == "ra" else cfg.r,
                         adaptive=adaptive)
        runs[name] = run_uncoded(rc, process, prob, iters, cfg.lr,
                                 curve_every=curve_every, label=name)
    runs["PC"] = run_pc(process, prob, cfg.r, iters, cfg.lr,
                        curve_every=curve_every)
    runs["PCMM"] = run_pcmm(process, prob, cfg.r, iters, cfg.lr,
                            curve_every=curve_every)
    return runs


def table1_check(prob: RegressionProblem, r: int, *, eta: float = 0.01,
                 seed: int = 7) -> Dict[str, float]:
    """Table I: at k = n every scheme's one-step update must equal the
    exact full-gradient update.  Returns the max abs update error of the
    uncoded (kernel) path, PC and PCMM (the JAX benchmark's bounds: 1e-4,
    1e-4 and 1e-2)."""
    dev, n, N = prob.X.device, prob.n, prob.N
    d = prob.Xs_cols.shape[1]
    theta = torch.as_tensor(np.random.default_rng(seed).standard_normal(d)
                            * 0.1, device=dev)
    Xf = prob.X.to(torch.float64)
    yf = prob.y.to(torch.float64)
    Xty = Xf.T @ yf
    want = theta - eta * 2 / N * (Xf.T @ (Xf @ theta) - Xty)

    def err(xxt):
        return float((theta - eta * 2 / N * (xxt - Xty) - want).abs().max())

    hs = batched_gram_matvec(prob.Xs_cols, theta.to(torch.float32))
    out = {"uncoded": err(hs.sum(dim=0).to(torch.float64))}
    Xt, alphas, _ = pc_encode(prob.Xs_cols, r)
    kth = pc_threshold(n, r)
    res = pc_worker_compute(Xt, theta)
    out["pc"] = err(pc_decode(res[:kth], alphas[:kth], n, r))
    Xh, betas = pcmm_encode(prob.Xs_cols, r)
    need = pcmm_threshold(n)
    res = pcmm_worker_compute(Xh.reshape(n * r, d, -1), theta)
    out["pcmm"] = err(pcmm_decode(res[:need], betas.reshape(-1)[:need], n))
    return out
