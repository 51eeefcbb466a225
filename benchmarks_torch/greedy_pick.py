"""The greedy_assign kernel's pick loop on the card, at the shapes of its
paths: (1, 15, 3) a DGD ADAPT call, (2000, 12, 3) a Fig. 8 chunk-round,
(20000, 16, 4), (333, 12, 3) a ragged block and (4096, 128, 8), the largest
n.  For each shape (B trials, n rows, CS matrix of r slots a row): whether
the output equals the plain version's, the wrapper's mean ms (CUDA
events), the kernel's device ms (the profiler's), the device ms of the
n = 1 launch at the same B (the floor of launch and prologue), the cost of
one pick (t(n) - t(1)) / (n - 1) in microseconds, and the device ms on
inputs whose coverage overflows (W scaled by 1e38: the dense fold after the
first pick).  ``--src`` names the tree whose ``repro_torch`` is timed
(default: this checkout's ``src``), so that two trees can be timed in
turns on one card.

Run on a machine with a card, from the repository root:

    python3 benchmarks_torch/greedy_pick.py [--src DIR] [--iters 200]

Prints the card's name and power limit, then one JSON object per shape.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

#: (B, n, r)
SHAPES = [(1, 15, 3), (2000, 12, 3), (20000, 16, 4), (333, 12, 3),
          (4096, 128, 8)]


def pick_times(device_ms, kernel, floor, dense, n):
    """The pick loop's times at one shape, from ``device_ms(fn)`` (device
    ms a call, None where not measured): the kernel's (``kernel``), the
    n = 1 launch's at the same B (``floor``: launch and prologue), the cost
    of one pick (t(n) - t(1)) / (n - 1) in microseconds, and the kernel's
    on an input that takes the dense fold (``dense``)."""
    t, t1 = device_ms(kernel), device_ms(floor)
    return dict(device_ms=t, n1_device_ms=t1,
                pick_us=None if None in (t, t1) else (t - t1) / (n - 1) * 1e3,
                dense_device_ms=device_ms(dense))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import cyclic_to_matrix
    from repro_torch.core.scheduling import _greedy_matrices
    from repro_torch.kernels import build, ops, ref

    if not torch.cuda.is_available():
        sys.exit("greedy_pick: no CUDA device available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {card}")
    build.build_all(["greedy_assign"])

    def cuda_ms(fn):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.iters

    def device_ms(fn):
        """Device ms a call from the profiler, tried twice; None (with a
        warning) where it records no device time or fewer kernels than
        calls."""
        fn()
        torch.cuda.synchronize()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            us = sum(float(getattr(e, "device_time_total",
                                   getattr(e, "cuda_time_total", 0.0)))
                     for e in events)
            if us and sum(e.count for e in events) >= args.iters:  # none dropped
                return us / 1e3 / args.iters
        print("greedy_pick: the profiler recorded no device time or "
              "dropped kernels", file=sys.stderr)
        return None

    def inputs(B, n, r, scale=1.0):
        gen = np.random.default_rng(B * n + r)
        C = cyclic_to_matrix(n, r)
        W, _ = _greedy_matrices(tuple(map(tuple, C.tolist())), 0.5)
        est = torch.as_tensor(gen.uniform(0.01, 1.0, (B, n)),
                              dtype=torch.float32, device="cuda")
        order = torch.argsort(est, dim=-1, stable=True)
        epick = torch.clamp(torch.take_along_dim(est, order, dim=-1),
                            min=1e-30)
        return (torch.as_tensor(W * np.float32(scale), device="cuda"),
                order.to(torch.int32), epick)

    for B, n, r in SHAPES:
        W, order, epick = inputs(B, n, r)
        Wd, orderd, epickd = inputs(B, n, r, scale=1e38)
        W1, order1, epick1 = inputs(B, 1, 1)
        equal = all(
            torch.equal(ops.greedy_assign(*x), ref.greedy_assign_ref(*x))
            for x in ((W, order, epick), (Wd, orderd, epickd)))
        kernel = lambda: ops.greedy_assign(W, order, epick)     # noqa: E731
        row = dict(shape=[B, n, r], equal_to_plain=equal, ms=cuda_ms(kernel),
                   **pick_times(
                       device_ms, kernel,
                       lambda: ops.greedy_assign(W1, order1, epick1),
                       lambda: ops.greedy_assign(Wd, orderd, epickd), n),
                   src=args.src, card=card)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
