"""Roofline table of the dry run's artifacts (counterpart of
``repro.launch.roofline``): one markdown row per (arch x shape x mesh) from
the JSON files ``launch/dryrun.py`` writes, with the H100's words for the
dominant term; then the same rows with the port's sizing columns
(``sizing_markdown``: argument + temp GB, whether they fit one card, the
dry run's wall seconds).

  PYTHONPATH=src python -m repro_torch.launch.roofline \\
      [--dir experiments/dryrun_torch] [--md roofline.md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

__all__ = ["HEADER", "SEP", "rows", "to_markdown", "sizing_markdown",
           "summarize", "main"]

HEADER = ("| arch | shape | mesh | compute s | memory s | collective s | "
          "dominant | HLO GFLOPs/dev | model GFLOPs/dev | useful | "
          "bottleneck note |")
SEP = "|" + "---|" * 11


def _note(r) -> str:
    dom = r["roofline"]["dominant"]
    if dom == "memory_s":
        return "HBM-traffic bound"
    if dom == "collective_s":
        return "NVLink bound"
    return "tensor-core bound"


def rows(dryrun_dir: str, mesh_filter=None):
    """The untagged, not skipped artifacts under ``dryrun_dir`` (a tagged
    file, ``<mesh>__<arch>__<shape>__<tag>.json``, is a variant)."""
    out = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        if os.path.basename(f).count("__") > 2:
            continue
        with open(f) as fh:
            r = json.load(fh)
        if r.get("skipped"):
            continue
        if mesh_filter and r["mesh"] != mesh_filter:
            continue
        out.append(r)
    return out


def _sorted(rs):
    return sorted(rs, key=lambda x: (x["mesh"], x["arch"], x["shape"]))


def _row(r) -> str:
    ro = r["roofline"]
    return (f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {ro['compute_s']:.3e} | {ro['memory_s']:.3e} "
            f"| {ro['collective_s']:.3e} "
            f"| **{ro['dominant'].removesuffix('_s')}** "
            f"| {r['flops_per_device'] / 1e9:.1f} "
            f"| {ro['model_flops_per_device'] / 1e9:.1f} "
            f"| {ro['useful_ratio']:.2f} | {_note(r)} |")


def to_markdown(rs) -> str:
    """The reference's table."""
    return "\n".join([HEADER, SEP] + [_row(r) for r in _sorted(rs)])


def sizing_markdown(rs) -> str:
    """The reference's table with the port's columns after it: the
    argument + temp GB, whether they fit one card (``fits``), and the dry
    run's wall seconds."""
    lines = [HEADER + " arg + temp GB | fits | wall s |", SEP + "---|" * 3]
    for r in _sorted(rs):
        m = r["memory_analysis"]
        need = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
        lines.append(f"{_row(r)} {need / 1e9:.1f} | "
                     f"{'yes' if r['fits'] else 'no'} | {r['wall_s']:.1f} |")
    return "\n".join(lines)


def summarize(rs) -> dict:
    dom = defaultdict(int)
    for r in rs:
        dom[r["roofline"]["dominant"]] += 1
    return dict(dom)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--md", default=None)
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    rs = rows(args.dir, args.mesh)
    md = to_markdown(rs)
    print(md)
    print("\ndominant-term counts:", summarize(rs))
    print()
    print(sizing_markdown(rs))
    if args.md:
        with open(args.md, "w") as f:
            f.write(md + "\n")
    return md


if __name__ == "__main__":
    main()
