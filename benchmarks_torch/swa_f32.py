"""Where the float32 swa_attention kernel's time goes on the card: the
kernel (csrc/swa_attention_f32.cu) at the shapes of the float32 LM path
(gemma3-4b at B 2, W 1024: the 1 040-token forward and the 1 024-token
prefill), at gemma3-4b's 2 048-token prefill shape and at dh 128.  It runs
as ops.swa_f32_plan plans it ("kernel"), on plans that split the KV ranges
longer than a share of the longest ("share 1" splits none), and as
variants built from edited copies of its source with one part taken out:

  nosplit   operands go to the products unsplit (no TF32 rounding ops;
            wrong results), so the split arithmetic's cost shows;
  one       one TF32 product per float32 product (plain TF32 accuracy);
  noqk      no Q K^T products (scores 0; wrong results);
  nopv      no P V products (wrong results).

Each time is the mean of 20 launches (CUDA events), in turns (the list
twice); the earlier CUDA-core kernel (csrc/swa_attention.cu) and one
``scaled_dot_product_attention`` call with the band mask stand beside.
Last, the plan's cost model is fitted to the share timings: a block's cost
beyond its KV tiles and a split half's beyond that (grid of quarter tiles,
one tile time per head dim, least relative squared error), and the share
each model picks is printed beside the fastest one timed.

Run on a machine with a card, from the repository root:

    python3 benchmarks_torch/swa_f32.py

Prints the card's name and power limit, then one line per shape and
variant.  The edited copies are built under build/swa_f32_parts/.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, ops, ref  # noqa: E402

SHAPES = [(2, 1040, 8, 4, 256, 1024), (2, 1024, 8, 4, 256, 1024),
          (2, 2048, 8, 4, 256, 1024), (2, 2048, 8, 4, 128, 1024)]
SHARES = [1, 0.875, 0.75, 0.625, 0.5]

QK = """            mma(s[n + j], al, bh[2 * j], bh[2 * j + 1]);
            mma(s[n + j], ah, bl[2 * j], bl[2 * j + 1]);
            mma(s[n + j], ah, bh[2 * j], bh[2 * j + 1]);"""
PV = """            mma(acc[p][n], pl, h0v[n], h1v[n]);
            mma(acc[p][n], ph, z0v[n], z1v[n]);
            mma(acc[p][n], ph, l0v[n], l1v[n]);
            mma(acc[p][n], ph, h0v[n], h1v[n]);"""
SPLIT2 = """  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));"""
SPLIT3 = """  hi = tf32_rna(x);
  const float r = x - __uint_as_float(hi);
  lo = tf32_rna(r);
  lo2 = __float_as_uint(r - __uint_as_float(lo));"""


def variants(src):
    """name -> source text of each variant."""
    for part in (QK, PV, SPLIT2, SPLIT3):
        if part not in src:
            raise RuntimeError("swa_f32: the kernel source changed; update "
                               "the variants")
    qk_one = QK.splitlines()[2]
    pv_one = PV.splitlines()[3]
    return {
        "kernel": src,
        "nosplit": src.replace(SPLIT2, "  hi = lo = __float_as_uint(x);")
                      .replace(SPLIT3, "  hi = lo = lo2 = __float_as_uint(x);"),
        "one": src.replace(QK, qk_one).replace(PV, pv_one),
        "noqk": src.replace(QK, ""),
        "nopv": src.replace(PV, "            acc[p][n][0] += __uint_as_float("
                                "pl[0] ^ ph[1] ^ h0v[n] ^ h1v[n] ^ z0v[n] ^ "
                                "l1v[n]);"),
    }


def build_variants():
    out = ROOT / "build" / "swa_f32_parts"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "swa_attention_f32.cu").read_text()
    procs = []
    for name, text in variants(src).items():
        (out / f"{name}.cu").write_text(text)
        procs.append((name, subprocess.Popen(
            [build.nvcc_path(), *build.FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"swa_f32: nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, (argtypes, restype) in \
                build.SOURCES["swa_attention_f32"][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


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


def fit(share_ms):
    """(block, split) costs with the least relative squared error of
    tile time x makespan against the timed shares, and that error."""
    grid = [i / 4 for i in range(13)]
    best = None
    for block in grid:
        for split in grid:
            err = 0.0
            for dh in {shape[4] for shape, _ in share_ms}:
                pts = [(ops.swa_f32_makespan(ops.swa_f32_plan(*shape, f),
                                             shape[0], shape[2], block,
                                             split), ms)
                       for (shape, f), ms in share_ms.items()
                       if shape[4] == dh]
                tile = (sum(x * y for x, y in pts)
                        / sum(x * x for x, _ in pts))
                err += sum((tile * x - y) ** 2 / y ** 2 for x, y in pts)
            if best is None or err < best[2]:
                best = (block, split, err)
    return best


def main():
    if not torch.cuda.is_available():
        sys.exit("swa_f32: no CUDA device available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants()
    core = build.library("swa_attention")
    gen = torch.Generator(device="cuda").manual_seed(0)
    share_ms = {}
    for B, T, H, K, dh, W in SHAPES:
        q = torch.randn(B, T, H, dh, generator=gen, device="cuda") * 0.5
        k = torch.randn(B, T, K, dh, generator=gen, device="cuda") * 0.5
        v = torch.randn(B, T, K, dh, generator=gen, device="cuda")
        want = ref.swa_attention_ref(q, k, v, W)
        plans = {"kernel": ops.swa_f32_plan(B, T, H, K, dh, W)}
        plans.update((f"share {f}", ops.swa_f32_plan(B, T, H, K, dh, W, f))
                     for f in SHARES)
        runs = {name: (lambda lib=lib: ops._swa_f32_run(q, k, v, W,
                                                        plans["kernel"], lib))
                for name, lib in libs.items()}
        runs.update((name, lambda plan=plan: ops._swa_f32_run(
            q, k, v, W, plan, libs["kernel"]))
            for name, plan in plans.items() if name != "kernel")
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        runs["cuda_core (earlier kernel)"] = lambda: core.swa_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H,
            K, dh, W, 0, stream)
        pos = torch.arange(T, device="cuda")
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
        qt = q.transpose(1, 2)
        kt, vt = (a.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  for a in (k, v))
        runs["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band)
        times = {}
        for _ in range(2):
            for name, fn in runs.items():
                times.setdefault(name, []).append(cuda_ms(fn))
        for f in SHARES:
            share_ms[(B, T, H, K, dh, W), f] = sum(times[f"share {f}"]) / 2
        for name, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            if name.startswith("cuda_core"):
                got = out
            elif name == "sdpa":
                got = got.transpose(1, 2)
            err = (got - want).abs().max().item()
            print(f"swa_f32 {(B, T, H, K, dh, W)} {name}: ms "
                  + " ".join(f"{t:.5f}" for t in times[name])
                  + f" max_abs_err {err:.3e}"
                  + (f" (plan: {len(plans[name].items)} items, "
                     f"{plans[name].pairs} split)" if name in plans else ""))
    block, split, err = fit(share_ms)
    print(f"swa_f32 plan model fit: block cost {block} tiles, split half "
          f"cost {split} tiles (relative squared error {err:.5f}; ops: "
          f"{ops.SWA_F32_BLOCK_COST}, {ops.SWA_F32_SPLIT_COST})")
    for shape in SHAPES:
        timed = min(SHARES, key=lambda f: share_ms[shape, f])
        model = min(SHARES, key=lambda f: ops.swa_f32_makespan(
            ops.swa_f32_plan(*shape, f), shape[0], shape[2], block, split))
        rule = ops.swa_f32_plan(*shape)
        share = next(f for f in SHARES if ops.swa_f32_plan(*shape, f) == rule)
        print(f"swa_f32 {shape}: fastest share {timed}, fitted model's "
              f"pick {model}; ops.swa_f32_plan takes share {share}")


if __name__ == "__main__":
    main()
