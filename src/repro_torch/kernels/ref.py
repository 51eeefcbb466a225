"""Plain PyTorch versions of the port's kernels: what the CPU path runs and
what the card's kernels are held against."""
from __future__ import annotations

import math

import torch

__all__ = ["gram_matvec_ref", "batched_gram_matvec_ref", "greedy_assign_ref",
           "swa_attention_ref"]


def gram_matvec_ref(X: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The paper's per-task computation h(X_i) = X_i X_i^T theta, X (d, b),
    theta (d,) -> (d,).  Computed as X @ (X^T @ theta) in float32, never
    forming the (d, d) Gram matrix; the result has X's dtype."""
    u = torch.einsum("db,d->b", X.float(), theta.float())
    return torch.einsum("db,b->d", X.float(), u).to(X.dtype)


def batched_gram_matvec_ref(Xs: torch.Tensor,
                            theta: torch.Tensor) -> torch.Tensor:
    """``gram_matvec_ref`` over a leading task axis: Xs (n, d, b) -> (n, d)."""
    u = torch.einsum("ndb,d->nb", Xs.float(), theta.float())
    return torch.einsum("ndb,nb->nd", Xs.float(), u).to(Xs.dtype)


def greedy_assign_ref(W: torch.Tensor, order: torch.Tensor,
                      epick: torch.Tensor,
                      need_row: torch.Tensor | None = None) -> torch.Tensor:
    """The greedy row-assignment pick loop (plain version of the
    ``greedy_assign`` kernel; the JAX package's ``greedy_assign_ref``).

    ``W`` (n, n) float32 coverage weights of a TO matrix (``W[p, t]`` =
    discounted weight of task t in row p), ``order`` (B, n) each trial's
    pickers fastest-first, ``epick`` (B, n) their delay estimates in that
    order (clamped away from zero), ``need_row`` (B, n) optional reissue
    priorities (> 0: the row holds a needed task).  For pick t = 0..n-1:
    ``scores[p] = sum_j cov[j] * W[p, j]`` with taken rows at FLT_MAX; while
    an untaken needed row is left, the argmin runs over those rows only;
    ties (and NaNs, as ``argmin`` treats them) go to the lowest row; then
    ``worker_of_row[p] = order[t]`` and ``cov += W[p] / epick[t]``.
    Returns ``worker_of_row`` (B, n) int32.

    The arithmetic order is fixed so the CUDA kernel can match it bit for
    bit: each score is a left fold over j ascending of separately rounded
    products and sums (no fused multiply-add), starting from 0, and the
    update is a true division.  The JAX reference leaves the association
    of ``cov @ W.T`` to XLA, so the two agree bit for bit wherever every
    score is exact in float32 (and otherwise differ only at picks that are
    exact ties in real arithmetic)."""
    B, n = order.shape
    dev = order.device
    W = W.to(torch.float32)
    order = order.to(torch.int32)
    epick = epick.to(torch.float32)
    big = torch.finfo(torch.float32).max
    lanes = torch.arange(n, device=dev)
    cov = torch.zeros((B, n), dtype=torch.float32, device=dev)
    taken = torch.zeros((B, n), dtype=torch.bool, device=dev)
    wout = torch.zeros((B, n), dtype=torch.int32, device=dev)
    needed = None if need_row is None else need_row.to(torch.float32) > 0
    for t in range(n):
        scores = torch.zeros((B, n), dtype=torch.float32, device=dev)
        for j in range(n):
            scores = scores + cov[:, j:j + 1] * W[:, j]
        scores = torch.where(taken, big, scores)
        if needed is None:
            sel = scores
        else:
            pref = torch.where(needed & ~taken, scores, big)
            has = pref.amin(dim=-1, keepdim=True) < big
            sel = torch.where(has, pref, scores)
        p = torch.argmin(sel, dim=-1)
        hit = lanes == p[:, None]
        wout = torch.where(hit, order[:, t:t + 1], wout)
        taken = taken | hit
        cov = cov + W[p] / epick[:, t:t + 1]
    return wout


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int) -> torch.Tensor:
    """Causal sliding-window attention (plain version of the
    ``swa_attention`` kernel; the JAX package's ``swa_attention_ref`` with
    a batch axis and grouped KV heads).  q (B, T, H, dh), k/v (B, T, K, dh)
    with H % K == 0 -> (B, T, H, dh) in q's dtype.  Position t attends to
    positions (t - window, t]; query head h reads KV head h // (H // K), as
    ``repeat_kv`` maps them.  Scores, softmax and the weighted sum are
    float32 (float64 for float64 inputs: the error guard of the float32
    kernels holds both against that evaluation)."""
    B, T, H, dh = q.shape
    G = H // k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(acc).repeat_interleave(G, dim=2)
    vf = v.to(acc).repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), kf) * (1.0 / math.sqrt(dh))
    pos = torch.arange(T, device=q.device)
    ok = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
