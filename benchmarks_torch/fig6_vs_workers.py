"""Fig. 6 on the PyTorch port: average completion time vs number of workers
n (r = n, k = n); counterpart of ``benchmarks/fig6_vs_workers.py`` (same
rows and claims).  With the data size fixed, each task is an (N/n)-row
mini-batch, so the per-task computation delay scales ~1/n while the
communication delay stays (``_model``).  Claims reported by ``fig6/claims``:
SS improves with n and beats PC; PCMM's trend is reported, not asserted."""
import dataclasses

from repro_torch.core import ec2_like

from .common import Timer, emit, scheme_means


def _model(n: int, n_ref: int = 10):
    m = ec2_like(n, seed=2)
    scale = n_ref / n                    # task size N/n vs the n=10 baseline
    mu1 = tuple(v * scale for v in m.mu1)
    return dataclasses.replace(m, mu1=mu1, sigma1=m.sigma1 * scale,
                               a1=m.a1 * scale)


def run(trials: int = 20000, device=None):
    rows = {}
    for n in (10, 11, 12, 13, 14, 15):
        model = _model(n)
        with Timer() as t:
            m = scheme_means(model, n, n, n, trials=trials, device=device)
        emit(f"fig6/n{n}", t.us,
             ";".join(f"{s}={v * 1e3:.4f}ms" for s, v in m.items()))
        rows[n] = m
    ss_improves = rows[15]["ss"] < rows[10]["ss"]
    ss_beats_pc = all(rows[n]["ss"] < rows[n]["pc"] for n in rows)
    pcmm_trend = rows[15]["pcmm"] / rows[10]["pcmm"]
    emit("fig6/claims", 0.0,
         f"ss_improves_with_n={ss_improves};ss_beats_pc={ss_beats_pc};"
         f"pcmm_n15_over_n10={pcmm_trend:.3f}"
         f";pcmm_degradation_needs_contention_model=note")
    return rows
