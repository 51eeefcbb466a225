"""Fig. 5 on the PyTorch port: average completion time vs r with the
EC2-calibrated delay model (n = 15); counterpart of
``benchmarks/fig5_ec2.py`` (same rows and claims).  The paper's own
truncated-Gaussian calibration stands in for measured EC2 delays, with
communication dominating computation as in Fig. 3.

Claims reported by ``fig5/claims``: CS/SS well ahead of PC/PCMM; PC
worsens with r; SS faster than RA at r = n; the SS-LB gap small and
shrinking with r.
"""
from repro_torch.core import ec2_like

from .common import Timer, emit, scheme_means


def run(trials: int = 20000, device=None):
    n, k = 15, 15
    model = ec2_like(n, seed=1)
    rows = {}
    for r in (2, 3, 5, 7, 9, 11, 13, 15):
        with Timer() as t:
            m = scheme_means(model, n, r, k, trials=trials, device=device)
        emit(f"fig5/r{r}", t.us,
             ";".join(f"{s}={v * 1e3:.4f}ms" for s, v in m.items()))
        rows[r] = m
    gain = 100 * (rows[15]["ra"] - rows[15]["ss"]) / rows[15]["ra"]
    pc_grows = rows[13]["pc"] > rows[3]["pc"]
    gap_small = (rows[15]["ss"] - rows[15]["lb"]) / rows[15]["lb"] < 0.25
    gap_shrinks = ((rows[15]["ss"] - rows[15]["lb"]) / rows[15]["lb"] <
                   (rows[3]["ss"] - rows[3]["lb"]) / rows[3]["lb"])
    emit("fig5/claims", 0.0,
         f"ss_vs_ra_gain_pct={gain:.2f};pc_increases_with_r={pc_grows};"
         f"ss_lb_gap_small={gap_small};gap_shrinks_with_r={gap_shrinks}")
    return rows
