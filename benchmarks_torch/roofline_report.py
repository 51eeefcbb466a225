"""Roofline rows from saved dry-run artifacts (counterpart of
``benchmarks/roofline_report.py``).

Reads ``experiments/dryrun_torch/*.json`` and emits one CSV row per (mesh,
arch, shape[, tag]): the three roofline terms on one H100, the dominant
term and the useful-FLOPs share; ``us_per_call`` is the dry run's trace
time.  The artifacts are produced by ``repro_torch.launch.dryrun``, which
traces each step on the ``meta`` device (no card, no allocation)::

    python -m repro_torch.launch.dryrun --arch gemma3-4b --shape long_500k
    python -m repro_torch.launch.dryrun --all      # every (arch, shape)

The directory is not checked in.  When it holds no artifact this reader
emits one ``roofline/skipped`` row saying so, and how to produce them."""
import glob
import json
import os

from .common import emit


def run(dryrun_dir: str = "experiments/dryrun_torch"):
    files = sorted(glob.glob(os.path.join(dryrun_dir, "*.json")))
    if not files:
        emit("roofline/skipped", 0.0,
             f"status=SKIP;reason=no_dryrun_artifacts_in_{dryrun_dir};"
             f"produce_with=python_-m_repro_torch.launch.dryrun_--all")
        print(f"roofline_report: skipped — no dry-run artifacts under "
              f"{dryrun_dir!r}; produce them with "
              f"`python -m repro_torch.launch.dryrun --all` (or a single "
              f"--arch/--shape combination) first")
        return
    for f in files:
        with open(f) as fh:
            r = json.load(fh)
        if r.get("skipped"):
            continue
        ro = r["roofline"]
        tag = os.path.basename(f).split("__")[-1].removesuffix(".json")
        emit(f"roofline/{r['mesh']}/{r['arch']}/{r['shape']}"
             + (f"/{tag}" if tag != r["shape"] else ""),
             r["timings"]["compile_s"] * 1e6,
             f"compute_s={ro['compute_s']:.3e};"
             f"memory_s={ro['memory_s']:.3e};"
             f"collective_s={ro['collective_s']:.3e};"
             f"dominant={ro['dominant'].removesuffix('_s')};"
             f"useful_ratio={ro['useful_ratio']:.3f}")
