"""Baseline-against-variant table of tagged dry-run artifacts (counterpart
of ``repro.launch.perf_report``): each ``<mesh>__<arch>__<shape>__<tag>.json``
beside its untagged baseline, the mesh word "h100" (one card), "pod"
(16x16) or "multipod" (2x16x16).

  PYTHONPATH=src python -m repro_torch.launch.perf_report \\
      [--dir experiments/dryrun_torch] [--mesh pod] [--md perf_table.md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["PAIRS_HEADER", "SEP", "rows", "to_markdown", "main"]

PAIRS_HEADER = ("| arch | shape | variant | compute s | memory s | "
                "collective s | max-term s | Δ max-term | arg GB | temp GB |")
SEP = "|" + "---|" * 10


def _load(path):
    with open(path) as f:
        return json.load(f)


def _maxterm(r):
    ro = r["roofline"]
    return max(ro["compute_s"], ro["memory_s"], ro["collective_s"])


def rows(dryrun_dir="experiments/dryrun_torch", mesh="h100"):
    """(baseline, variant, tag) for every tagged artifact whose baseline
    exists."""
    out = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, f"{mesh}__*.json"))):
        parts = os.path.basename(f).removesuffix(".json").split("__")
        if len(parts) != 4:
            continue
        _, arch, shape, tag = parts
        base_f = os.path.join(dryrun_dir, f"{mesh}__{arch}__{shape}.json")
        if not os.path.exists(base_f):
            continue
        out.append((_load(base_f), _load(f), tag))
    return out


def to_markdown(pairs) -> str:
    lines = [PAIRS_HEADER, SEP]
    for base, var, tag in pairs:
        for r, label in ((base, "baseline"), (var, tag)):
            ro = r["roofline"]
            m = r["memory_analysis"]
            mt = _maxterm(r)
            delta = ""
            if label != "baseline":
                mb = _maxterm(base)
                delta = f"{100 * (mt - mb) / mb:+.1f}%"
            lines.append(
                f"| {r['arch']} | {r['shape']} | {label} "
                f"| {ro['compute_s']:.3e} | {ro['memory_s']:.3e} "
                f"| {ro['collective_s']:.3e} | {mt:.3e} | {delta} "
                f"| {m.get('argument_size_in_bytes', 0) / 1e9:.1f} "
                f"| {m.get('temp_size_in_bytes', 0) / 1e9:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="h100",
                    help="the artifacts' mesh word: h100, pod, multipod")
    ap.add_argument("--md", default=None)
    args = ap.parse_args(argv)
    md = to_markdown(rows(args.dir, args.mesh))
    print(md)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md + "\n")
    return md


if __name__ == "__main__":
    main()
