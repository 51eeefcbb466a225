"""Fig. 7 on the PyTorch port: average completion time vs computation
target k (n = 10, r = n); counterpart of ``benchmarks/fig7_vs_target.py``
(same rows and claims).  The whole k-sweep is one engine call: every k in
1..n comes from one sort of the shared task arrivals.  Claims reported by
``fig7/claims``: time increases with k; SS coincides with the lower bound
for small and medium k and stays close for large k."""
from repro_torch.core import ec2_like

from .common import Timer, emit, scheme_mean_table


def run(trials: int = 20000, device=None):
    n = 10
    model = ec2_like(n, seed=3)
    with Timer() as t:
        table = scheme_mean_table(model, n, n, trials=trials,
                                  include_coded=False, device=device)
    emit("fig7/sweep_all_k", t.us, f"schemes={len(table)};ks=1..{n}")
    rows = {}
    us_per_k = t.us / (n - 1)          # amortized: one call served every k
    for k in range(2, n + 1):
        m = {s: float(v[k - 1]) for s, v in table.items()}
        emit(f"fig7/k{k}", us_per_k,
             ";".join(f"{s}={v * 1e3:.4f}ms" for s, v in m.items()))
        rows[k] = m
    increases = all(rows[k]["ss"] <= rows[k + 1]["ss"] + 1e-9
                    for k in range(2, n))
    lb_tight_small_k = all((rows[k]["ss"] - rows[k]["lb"]) /
                           max(rows[k]["lb"], 1e-12) < 0.05
                           for k in range(2, 7))
    lb_close_large_k = (rows[n]["ss"] - rows[n]["lb"]) / rows[n]["lb"] < 0.25
    emit("fig7/claims", 0.0,
         f"time_increases_with_k={increases};"
         f"ss_matches_lb_small_k={lb_tight_small_k};"
         f"ss_near_lb_large_k={lb_close_large_k}")
    return rows
