"""gram_matvec on the card at tall tasks, the shapes past the one-pass limit
that ``ops.gram_plan`` sends to the two-pass kernel (``csrc/gram_matvec.cu``):
d one past the limit at b = 8 for one task and for the dgd-tall leg's 15,
in bfloat16, at b = 1, and (1, 100 000, 256), whose X is twice the L2.  For
each shape: the route, the relative error against the plain version, whether
two calls give the same bits, the wrapper's mean ms (CUDA events), its
device ms (the profiler's kernel time, summed and by kernel), the
``torch.bmm`` pair's ms and device ms on the same inputs, and the bound (X,
theta and y moved once at the HBM rate).  ``--src`` names the tree whose
``repro_torch`` is timed (default: this checkout's ``src``), so that two
trees can be timed in turns on one card.

Run on a machine with a card, from the repository root:

    python3 benchmarks_torch/gram_tall.py [--src DIR] [--iters 50]

Prints the card's name and power limit, then one JSON object per shape.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet

#: (n, b, dtype, d): d None means one past the tree's one-pass limit
SHAPES = [(1, 8, "float32", None), (15, 8, "float32", None),
          (1, 8, "bfloat16", None), (1, 1, "float32", None),
          (1, 256, "float32", 100000)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build, ops, ref

    if not torch.cuda.is_available():
        sys.exit("gram_tall: no CUDA device available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {card}")
    build.build_all(["gram_matvec"])

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
        """Device ms a call, summed and by kernel (the name up to its
        template arguments), from the profiler; None where it records
        none."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = float(getattr(e, "device_time_total",
                                   getattr(e, "cuda_time_total", 0.0)))
                name = e.key.split("<")[0].split("::")[-1]
                by[name] = by.get(name, 0.0) + us / 1e3 / args.iters
        return (sum(by.values()) or None), by

    def bmm_pair(Xs, th):
        t = th.reshape(1, -1, 1).expand(Xs.shape[0], -1, 1)
        return torch.bmm(Xs, torch.bmm(Xs.transpose(1, 2), t))[..., 0]

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, b, name, d in SHAPES:
        dt = getattr(torch, name)
        d = d or ops.gram_onepass_max_d(b, dt) + 1
        route = ops.gram_plan(n, d, b, dt).route
        Xs = torch.randn(n, d, b, generator=gen, device="cuda").to(dt)
        th = torch.randn(d, generator=gen, device="cuda").to(dt)
        got = ops.batched_gram_matvec(Xs, th)
        want = ref.batched_gram_matvec_ref(Xs, th).float()
        again = ops.batched_gram_matvec(Xs, th)
        torch.cuda.synchronize()
        rel = ((got.float() - want).abs().max()
               / want.abs().max()).item()
        item = Xs.element_size()
        bound = (n * d * b + d + n * d) * item / HBM_BYTES_PER_S * 1e3
        dev, by = device_ms(lambda: ops.batched_gram_matvec(Xs, th))
        row = dict(shape=[n, d, b], dtype=name, route=route, rel_err=rel,
                   deterministic=bool(torch.equal(got, again)),
                   ms=cuda_ms(lambda: ops.batched_gram_matvec(Xs, th)),
                   device_ms=dev, kernels_device_ms=by,
                   bmm_ms=cuda_ms(lambda: bmm_pair(Xs, th)),
                   bmm_device_ms=device_ms(lambda: bmm_pair(Xs, th))[0],
                   bound_ms=bound, src=args.src, card=card)
        print(json.dumps(row), flush=True)
        del Xs, th, got, want, again
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
