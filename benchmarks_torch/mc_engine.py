"""Monte-Carlo sweep-engine throughput on the PyTorch port: a seed-style
per-scheme path vs the fused engine; counterpart of
``benchmarks/mc_engine.py`` (same rows).

The seed evaluated each scheme with its own delay sampling pass, a
scatter-min for the task arrivals and a full sort per scheme (``legacy``
here, in torch ops); the engine (``repro_torch.core.sweep``) samples once,
gathers task arrivals through a static layout shared by the stacked TO
matrices and sorts once per scheme family.  Both run on ``device`` (the card
by default) at the paper's Fig.-4 corner (n = r = k = 16), in
trials*schemes/s.  Every timed call ends in a host read of its means.

Rows:
  mc_engine/legacy         seed-style per-scheme evaluation
  mc_engine/fused          one engine call, same schemes, shared draws
  mc_engine/speedup        fused over legacy throughput ratio
  mc_engine/scan_overhead  the fused sweep streamed in 8 chunks
  mc_engine/chunked1M      10^6 trials (50 x trials under --quick) in
                           20k-trial chunks
  mc_engine/scaling1       the chunked sweep on one device
  mc_engine/scaling        the same on every local device -- only with more
                           than one device, and the port's engine runs on one
                           (ROADMAP.md queue 1 item 5), so it is not emitted
"""
from __future__ import annotations

import sys
import time

import torch

from repro_torch.core import (cyclic_to_matrix, lb_spec, pc_spec,
                              pc_threshold, pcmm_spec, pcmm_threshold,
                              random_assignment_to_matrix, scenario1,
                              slot_arrival_times, staircase_to_matrix, sweep,
                              to_spec)
from repro_torch.device import resolve_device

from .common import emit

INF = float("inf")


# ----------------------- seed-style per-scheme path --------------------------

def legacy_to(C, T1, T2, n: int, k: int) -> torch.Tensor:
    """One TO scheme the seed's way: slot arrivals (eq. 1), the task
    arrivals by a scatter-min over every slot (eq. 2), a full sort, the k-th
    order statistic -> (trials,)."""
    s = slot_arrival_times(T1, T2)
    sf = s.reshape(s.shape[0], -1)
    Cf = torch.as_tensor(C, dtype=torch.int64, device=s.device).reshape(-1)
    init = sf.new_full((s.shape[0], n), INF)
    tau = init.scatter_reduce(-1, Cf.expand(sf.shape), sf, reduce="amin",
                              include_self=True)
    return torch.sort(tau, dim=-1).values[..., k - 1]


def legacy_pc(T1, T2, kth: int) -> torch.Tensor:
    t_worker = T1.sum(dim=-1) + T2[..., -1]
    return torch.sort(t_worker, dim=-1).values[..., kth - 1]


def legacy_flat_sort(T1, T2, kth: int) -> torch.Tensor:
    s = slot_arrival_times(T1, T2).reshape(T1.shape[0], -1)
    return torch.sort(s, dim=-1).values[..., kth - 1]


def legacy_samples(model, n: int, r: int, k: int, *, trials: int,
                   seed: int = 0, device=None) -> dict:
    """Per-trial results of every scheme, the seed's way: each scheme draws
    its own (trials, n, r) delays from the same seed and trial ids and runs
    its own evaluation."""
    tids = torch.arange(trials, device=resolve_device(device))
    out = {}
    for name, C in (("cs", cyclic_to_matrix(n, r)),
                    ("ss", staircase_to_matrix(n, r)),
                    ("ra", random_assignment_to_matrix(n, seed=seed))):
        T1, T2 = model.sample(seed, tids, n, C.shape[1])
        out[name] = legacy_to(C, T1, T2, n, k)
    T1, T2 = model.sample(seed, tids, n, r)
    out["pc"] = legacy_pc(T1, T2, pc_threshold(n, r))
    T1, T2 = model.sample(seed, tids, n, r)
    out["pcmm"] = legacy_flat_sort(T1, T2, pcmm_threshold(n))
    T1, T2 = model.sample(seed, tids, n, r)
    out["lb"] = legacy_flat_sort(T1, T2, k)
    return out


def _legacy_scheme_means(model, n, r, k, *, trials, seed=0, device=None):
    return {name: float(v.mean()) for name, v in legacy_samples(
        model, n, r, k, trials=trials, seed=seed, device=device).items()}


def _fused_specs(n: int, r: int, seed: int):
    return (to_spec("cs", cyclic_to_matrix(n, r)),
            to_spec("ss", staircase_to_matrix(n, r)),
            to_spec("ra", random_assignment_to_matrix(n, seed=seed)),
            pc_spec(r), pcmm_spec(r), lb_spec(r))


def _time(fn, reps: int = 3) -> float:
    fn()                                   # warm (allocator, caches)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run(trials: int = 20000, device=None):
    n = r = k = 16
    model = scenario1()
    n_schemes = 6

    t_legacy = _time(lambda: _legacy_scheme_means(model, n, r, k,
                                                  trials=trials,
                                                  device=device))
    thr_legacy = trials * n_schemes / t_legacy
    emit("mc_engine/legacy", t_legacy * 1e6,
         f"trials={trials};schemes={n_schemes};"
         f"throughput={thr_legacy:,.0f}_trials_schemes_per_s")

    specs = _fused_specs(n, r, seed=0)
    t_fused = _time(lambda: sweep(specs, model, n, trials=trials, seed=0,
                                  devices=device))
    thr_fused = trials * n_schemes / t_fused
    emit("mc_engine/fused", t_fused * 1e6,
         f"trials={trials};schemes={n_schemes};"
         f"throughput={thr_fused:,.0f}_trials_schemes_per_s")

    emit("mc_engine/speedup", 0.0,
         f"fused_over_legacy={thr_fused / thr_legacy:.2f}x")

    t_chunk = _time(lambda: sweep(specs, model, n, trials=trials, seed=0,
                                  chunk=max(1, trials // 8), devices=device))
    thr_chunk = trials * n_schemes / t_chunk
    emit("mc_engine/scan_overhead", t_chunk * 1e6,
         f"trials={trials};chunks=8;"
         f"throughput={thr_chunk:,.0f}_trials_schemes_per_s;"
         f"chunked_over_fused={thr_chunk / thr_fused:.2f}")

    big = 1_000_000 if trials >= 20000 else 50 * trials
    chunk = 20000
    t0 = time.perf_counter()
    res = sweep(specs, model, n, trials=big, seed=0, chunk=chunk,
                devices=device)
    t_big = time.perf_counter() - t0
    emit("mc_engine/chunked1M", t_big * 1e6,
         f"trials={big};chunk={chunk};"
         f"throughput={big * n_schemes / t_big:,.0f}_trials_schemes_per_s;"
         f"cs_at_k={res.at_k('cs', k) * 1e3:.5f}ms"
         f"+-{float(res.stderr['cs'][k - 1]) * 1e3:.5f}ms")

    scaling = _scaling(model, n, r, trials, device)
    return {"legacy_s": t_legacy, "fused_s": t_fused,
            "speedup": thr_fused / thr_legacy, "big_s": t_big,
            "scan_overhead": thr_chunk / thr_fused, **scaling}


def _scaling(model, n: int, r: int, trials: int, device) -> dict:
    """The chunked sweep on one device (the base point of the reference's
    strong and weak scaling rows)."""
    dev = resolve_device(device)
    specs = _fused_specs(n, r, seed=0)
    chunk = max(1, trials // 16)
    t1 = _time(lambda: sweep(specs, model, n, trials=trials, seed=0,
                             chunk=chunk, devices=dev))
    tps1 = trials / t1
    emit("mc_engine/scaling1", t1 * 1e6,
         f"devices=1;trials={trials};chunk={chunk};"
         f"trials_per_sec={tps1:,.0f}")
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        print("mc_engine: no multi-device scaling row: the port's engine "
              "runs on one device (ROADMAP.md queue 1 item 5)",
              file=sys.stderr)
    return {"scaling_devices": 1, "trials_per_sec_1dev": tps1}
