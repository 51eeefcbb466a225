"""Fig. 10 on the PyTorch port (beyond the paper): adaptive load
re-balancing vs row re-permutation on a heterogeneous, persistent-straggler
cluster; counterpart of ``benchmarks/fig10_load_rebalance.py`` (same cell,
rows and guard).

Four policies at the same total budget n*r on the EC2-calibrated
heterogeneous cluster (fig8's hardest cell), all from ONE ``sweep_rounds``
call with censored feedback, every scheme on the same cluster
realizations: the static ``cs`` / ``ss``; ``adapt`` (greedy row
re-permutation of the CS matrix, the greedy_assign kernel on the card);
``rebal`` (re-permutation plus per-round load re-balancing on a dense CS
grid of width ``CAP`` from an initial r slots a worker); and the oracle
``lb``.

Rows: fig10/<scheme> with ms/round; fig10/rebalance carries the margins
``rebal_vs_static`` and ``rebal_vs_perm``.  Exits non-zero unless
re-balancing beats static CS/SS and permutation-only adaptation.
"""
from __future__ import annotations

from repro_torch.core import (adaptive_spec, cyclic_to_matrix, ec2_cluster,
                              lb_spec, scenario1, staircase_to_matrix,
                              sweep_rounds, to_spec)

from .common import emit

N, R, K = 12, 3, 9
CAP = 6                  # per-worker load cap of the re-balancing grid
ROUNDS = 20
PERSISTENCE, SPREAD = 0.98, 3.0
CHUNK = 1000


def _process():
    return ec2_cluster(N, spread=SPREAD, p_slow=0.25,
                       persistence=PERSISTENCE, slow=8.0, base=scenario1(),
                       seed=1)


def specs():
    cs = cyclic_to_matrix(N, R)
    return [to_spec("cs", cs), to_spec("ss", staircase_to_matrix(N, R)),
            adaptive_spec("adapt", cs),
            adaptive_spec("rebal", cyclic_to_matrix(N, CAP),
                          loads=(R,) * N, rebalance=True),
            lb_spec(R)]


def run(trials: int = 20000, device=None):
    trials = min(trials, 4000)          # ROUNDS sims (+ rebalance greedy)
    sp = specs()
    res = sweep_rounds(sp, _process(), N, rounds=ROUNDS, k=K,
                       trials=trials, seed=0, chunk=min(CHUNK, trials),
                       censored_feedback=True, devices=device)
    ms = {s.name: res.mean_round(s.name) * 1e3 for s in sp}
    static = min(ms["cs"], ms["ss"])
    vs_static = 100.0 * (static - ms["rebal"]) / static
    vs_perm = 100.0 * (ms["adapt"] - ms["rebal"]) / ms["adapt"]
    common = (f"trials={trials};rounds={ROUNDS};n={N};r={R};cap={CAP};"
              f"k={K};persistence={PERSISTENCE};spread={SPREAD:g}")
    for nm in ("cs", "ss", "adapt", "lb"):
        emit(f"fig10/{nm}", ms[nm] * 1e3, f"{common};ms_round={ms[nm]:.4f}ms")
    emit("fig10/rebalance", ms["rebal"] * 1e3,
         f"{common};ms_round={ms['rebal']:.4f}ms;"
         f"rebal_vs_static={vs_static:+.1f}%;"
         f"rebal_vs_perm={vs_perm:+.1f}%")
    ok = (ms["rebal"] < ms["cs"] and ms["rebal"] < ms["ss"]
          and ms["rebal"] < ms["adapt"])
    emit("fig10/rebalance_beats_all", 0.0,
         f"status={'PASS' if ok else 'FAIL'};"
         f"rebal={ms['rebal']:.4f}ms;adapt={ms['adapt']:.4f}ms;"
         f"cs={ms['cs']:.4f}ms;ss={ms['ss']:.4f}ms;lb={ms['lb']:.4f}ms")
    if not ok:
        raise SystemExit("fig10: adaptive load re-balancing failed to beat "
                         "static CS/SS and permutation-only adaptation on "
                         "the persistent heterogeneous cluster")
    return ms
