"""Where a dry run's bytes and peak come from, on the CPU (no card needed).

For ``--arch`` at its CLIs' smoke config (or in full with ``--full``,
as the dry run builds it) and a ``--shape`` of the dry run, cut to each
``--seq-lens`` length if given (its batch kept, or ``--batch``), the
step that ``repro_torch.launch.dryrun`` builds is traced on ``meta`` as
``dryrun.measure`` traces it; per length it prints the bytes moved, the
five ops whose bytes lead (``op_bytes`` summed by op), and the peak of live
bytes read three ways: alone (``measure``'s reading), with Python's cycle
collector off, and with ``FlopCounterMode`` entered as well.

    PYTHONPATH=src python benchmarks_torch/dryrun_breakdown.py \\
        --arch rwkv6-1.6b --shape train_4k --seq-lens 32 64 128 --batch 16
    PYTHONPATH=src python benchmarks_torch/dryrun_breakdown.py \\
        --arch gemma3-4b --shape train_4k --full

Prints one JSON object per length.
"""
import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import (SHAPES, ARCH_IDS, cli_config,  # noqa: E402
                                 get_config, resolve)
from repro_torch.launch import dryrun  # noqa: E402


class ByOp(dryrun.TrafficMode):
    """``TrafficMode`` with its bytes also summed by op."""

    def __init__(self, known):
        super().__init__(known)
        self.by_op = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.bytes
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self.by_op[str(func)] += self.bytes - before
        return out


def trace(cfg, shape, *, cycles=True, flop_counter=False):
    """The second call of the step (as ``measure`` makes it) under
    ``ByOp``: the mode, after the call."""
    fn, args, _ = dryrun.build(cfg, shape)
    fn()
    mode = ByOp(dryrun._tensors(args))
    gc.collect()
    if not cycles:
        gc.disable()
    try:
        with (FlopCounterMode(display=False) if flop_counter
              else contextlib.nullcontext()), mode:
            fn()
    finally:
        gc.enable()
    return mode


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=tuple(SHAPES), required=True)
    ap.add_argument("--seq-lens", type=int, nargs="+", default=[None])
    ap.add_argument("--full", action="store_true",
                    help="published sizes (the dry run's config)")
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args(argv)
    whole = SHAPES[args.shape]
    try:
        for T in args.seq_lens:
            SHAPES[args.shape] = dataclasses.replace(
                whole, seq_len=T or whole.seq_len,
                global_batch=args.batch or whole.global_batch)
            cfg = (dryrun.dryrun_config(get_config(args.arch), args.shape)
                   if args.full else dataclasses.replace(
                       resolve(cli_config(args.arch, smoke=True), args.shape),
                       remat=whole.kind == "train"))
            mode = trace(cfg, args.shape)
            print(json.dumps({
                "arch": args.arch, "config": cfg.name, "shape": args.shape,
                "seq_len": SHAPES[args.shape].seq_len,
                "global_batch": SHAPES[args.shape].global_batch,
                "bytes": mode.bytes, "ops": mode.ops,
                "top_ops_bytes": dict(mode.by_op.most_common(5)),
                "peak": mode.peak,
                "peak_cycles_off": trace(cfg, args.shape,
                                         cycles=False).peak,
                "peak_under_flop_counter": trace(
                    cfg, args.shape, flop_counter=True).peak}), flush=True)
    finally:
        SHAPES[args.shape] = whole


if __name__ == "__main__":
    main()
