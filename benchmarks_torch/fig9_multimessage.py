"""Fig. 9 on the PyTorch port (paper Sec. V-C): intra-round message budget
sweep; counterpart of ``benchmarks/fig9_multimessage.py`` (same rows and
guards).

The per-round message budget m in {1, 2, r} for CS / SS (uncoded) and PCMM
(coded) at equal computation load on the EC2-calibrated delay model, all
from one sweep: every (scheme, m) cell scores the same delay draws.  The
``fig9/mm_beats_single`` guard exits non-zero if full multi-message
(m = r) fails to beat single-message (m = 1) for any scheme.

The second panel adds a serialized per-message protocol overhead
``comm_eps`` (a worker's l-th message lands (l+1)*eps late) on a straggling
cluster at k = n-1 and reports the optimal budget m*(eps); the
``fig9/opt_m`` guard exits non-zero unless m* is r at eps = 0 and drops
below r at some tested eps.
"""
from __future__ import annotations

from repro_torch.core import (BimodalStragglerDelays, cyclic_to_matrix,
                              ec2_like, pcmm_spec, staircase_to_matrix,
                              sweep, to_spec)

from .common import emit

N, R, K = 12, 4, 10
BUDGETS = (1, 2, R)
# overhead panel: straggling makes late-slot copies matter, so the
# per-message overhead actually binds (k close to n)
K_EPS = N - 1
EPS_GRID = (0.0, 1e-4, 3e-4, 1e-3)


def run(trials: int = 20000, device=None):
    model = ec2_like(N, seed=0)
    cs, ss = cyclic_to_matrix(N, R), staircase_to_matrix(N, R)
    specs = []
    for m in BUDGETS:
        specs += [to_spec(f"cs_m{m}", cs, messages=m),
                  to_spec(f"ss_m{m}", ss, messages=m),
                  pcmm_spec(R, name=f"pcmm_m{m}", messages=m)]
    res = sweep(specs, model, N, trials=trials, seed=0, ks=K, devices=device)

    out, ok = {}, True
    for scheme in ("cs", "ss", "pcmm"):
        t = {m: res.at_k(f"{scheme}_m{m}", K) for m in BUDGETS}
        reduction = 100.0 * (t[1] - t[R]) / t[1]
        ok &= t[R] <= t[1]
        emit(f"fig9/{scheme}", t[R] * 1e6,
             ";".join([f"trials={trials}", f"n={N}", f"r={R}", f"k={K}"]
                      + [f"m{m}={t[m] * 1e3:.4f}ms" for m in BUDGETS]
                      + [f"mm_vs_single={reduction:+.1f}%"]))
        out[scheme] = t
    emit("fig9/mm_beats_single", 0.0,
         f"all_schemes={'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("fig9: multi-message completion time exceeded "
                         "single-message at equal load (Sec. V-C ordering)")

    # ---- optimal m under per-message overhead (one sweep: every (eps, m)
    # cell scores the same straggling draws) ---------------------------------
    smodel = BimodalStragglerDelays(p_straggle=0.25, slow=8.0)
    especs = [to_spec(f"cs_e{ei}_m{m}", cs, messages=m, comm_eps=eps)
              for ei, eps in enumerate(EPS_GRID)
              for m in range(1, R + 1)]
    eres = sweep(especs, smodel, N, trials=trials, seed=0, ks=K_EPS,
                 devices=device)
    opt = {}
    for ei, eps in enumerate(EPS_GRID):
        t = [eres.at_k(f"cs_e{ei}_m{m}", K_EPS) for m in range(1, R + 1)]
        opt[eps] = 1 + min(range(R), key=t.__getitem__)
    nontrivial = (opt[0.0] == R
                  and any(opt[e] < R for e in EPS_GRID if e > 0))
    emit("fig9/opt_m", 0.0,
         ";".join([f"trials={trials}", f"n={N}", f"r={R}", f"k={K_EPS}"]
                  + [f"eps{eps:g}_opt_m={opt[eps]}" for eps in EPS_GRID]
                  + [f"nontrivial={'PASS' if nontrivial else 'FAIL'}"]))
    if not nontrivial:
        raise SystemExit("fig9: per-message overhead failed to produce a "
                         "non-trivial optimal message budget (expected "
                         "m*=r at eps=0 and m*<r at some eps>0)")
    out["opt_m"] = opt
    return out
