"""Fig. 4 on the PyTorch port: average completion time vs computation load
r (truncated Gaussian delays, n = 16, k = n), scenarios 1 and 2;
counterpart of ``benchmarks/fig4_vs_load.py`` (same rows and claims).

Paper claims reported by the ``fig4/<scenario>/claims`` rows:
  * SS slightly improves on CS; both beat PC and PCMM over the whole range;
  * PCMM beats PC (less pronounced in scenario 2);
  * at r = n, SS cuts RA's average delay by ~19.45% (scen 1) / ~16.32%
    (scen 2).
"""
from repro_torch.core import scenario1, scenario2

from .common import Timer, emit, scheme_means


def run(trials: int = 20000, device=None):
    n, k = 16, 16
    rows = {}
    for sc_name, model in (("scen1", scenario1()), ("scen2", scenario2(n))):
        for r in (2, 4, 6, 8, 10, 12, 14, 16):
            with Timer() as t:
                m = scheme_means(model, n, r, k, trials=trials, device=device)
            derived = ";".join(f"{s}={v * 1e3:.4f}ms" for s, v in m.items())
            emit(f"fig4/{sc_name}/r{r}", t.us, derived)
            rows[(sc_name, r)] = m
    for sc in ("scen1", "scen2"):
        full = rows[(sc, 16)]
        gain = 100 * (full["ra"] - full["ss"]) / full["ra"]
        beats = all(rows[(sc, r)]["ss"] <= rows[(sc, r)]["pc"] and
                    rows[(sc, r)]["cs"] <= rows[(sc, r)]["pc"]
                    for r in (2, 4, 8, 16))
        pcmm_beats_pc = all(rows[(sc, r)].get("pcmm", 1e9) <=
                            rows[(sc, r)]["pc"] for r in (4, 8, 16))
        emit(f"fig4/{sc}/claims", 0.0,
             f"ss_vs_ra_gain_pct={gain:.2f};cs_ss_beat_pc={beats};"
             f"pcmm_beats_pc={pcmm_beats_pc}")
    return rows
