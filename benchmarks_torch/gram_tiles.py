"""Tile widths of the one-pass gram_matvec kernel on the card: for each
shape, the kernel launched with clusters of 8 CTAs and each column-block
width C in a list (the tile of one CTA is R = ceil(d / 8) rows x C
columns), its mean ms over 20 launches (CUDA events) and its shared memory
per CTA, beside the width ``ops.gram_plan`` picks and the ``torch.bmm``
pair.  This is what ``ops.GRAM_TILE_ELEMS`` rests on; no path of the
repository sends these shapes yet.

Run on a machine with a card, from the repository root:

    python3 benchmarks_torch/gram_tiles.py

Prints the card's name and power limit, then one JSON object per shape.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build, ops, ref  # noqa: E402

SHAPES = [((64, 4096, 1024), torch.float32, (32, 48, 64, 96)),
          ((64, 4096, 1024), torch.bfloat16, (48, 64, 96, 128, 192))]


def cuda_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main():
    if not torch.cuda.is_available():
        sys.exit("gram_tiles: no CUDA device available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {card}")
    lib = build.library("gram_matvec_onepass")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (n, d, b), dt, widths in SHAPES:
        Xs = torch.randn(n, d, b, generator=gen, device="cuda").to(dt)
        th = torch.randn(d, generator=gen, device="cuda").to(dt)
        want = ref.batched_gram_matvec_ref(Xs, th).float()
        y = torch.empty((n, d), dtype=dt, device="cuda")
        item = Xs.element_size()
        R = -(-d // 8)
        P = torch.empty((n, -(-b // min(widths)), d), device="cuda")
        rows = []
        for C in widths:
            nbc = -(-b // C)
            smem = ops._gram_smem(R, C, item)

            def launch():
                err = lib.gram_onepass_launch(
                    Xs.data_ptr(), th.data_ptr(), y.data_ptr(), P.data_ptr(),
                    n, d, b, 0 if item == 4 else 1, 8, R, C, nbc, smem, stream)
                if err:
                    raise RuntimeError(f"launch failed: error {err}")
            launch()
            torch.cuda.synchronize()
            rel = ((y.float() - want).abs().max() / want.abs().max()).item()
            rows.append({"C": C, "nbc": nbc, "smem": smem,
                         "tile_elems": ops._gram_tile_rows(R) * C,
                         "ms": cuda_ms(launch), "rel_err": rel})
        th3 = th.reshape(1, -1, 1).expand(n, -1, 1)
        print(json.dumps({
            "shape": [n, d, b], "dtype": str(dt).split(".")[-1], "card": card,
            "plan": ops.gram_plan(n, d, b, dt)._asdict(), "widths": rows,
            "library_ms": cuda_ms(lambda: torch.bmm(
                Xs, torch.bmm(Xs.transpose(1, 2), th3)))}))


if __name__ == "__main__":
    main()
