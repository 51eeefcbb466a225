"""Smoke run of the PyTorch port on one CUDA card: builds the port's kernels
from the checkout, holds each against its plain PyTorch version, drives the
single-round Monte-Carlo engine at a 10^6-trial sweep, and runs the paper's
DGD regression loop end to end through the gram_matvec kernel.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Prints the card's name and power limit, one line per check, a JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the exit code is non-zero and the last line is
never printed.  Without a CUDA device, or outside a checkout of the
repository, it exits non-zero before printing any result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device available")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import RegressionConfig  # noqa: E402
from repro_torch.core import (completion_samples, cyclic_to_matrix,  # noqa: E402
                              lb_spec, pc_spec, pcmm_spec,
                              random_assignment_to_matrix, scenario1,
                              staircase_to_matrix, sweep, to_spec)
from repro_torch import dgd  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and float32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
DEV = torch.device("cuda")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters):
    """Mean device milliseconds of ``fn`` over ``iters`` launches (CUDA
    events, after a warm-up)."""
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


def bmm_pair(Xs, theta):
    """One library call pair computing the same function (timing yardstick
    only; the port never calls it)."""
    th = theta.reshape(1, -1, 1).expand(Xs.shape[0], -1, 1)
    u = torch.bmm(Xs.transpose(1, 2), th)
    return torch.bmm(Xs, u)[..., 0]


def gram_bound(n, d, b, itemsize):
    """Least time for h over (n, d, b): bytes (X once, theta, output) over
    the HBM rate vs 4*n*d*b flops over the float32 rate."""
    t_bytes = (n * d * b + d + n * d) * itemsize / HBM_BYTES_PER_S
    t_ops = 4 * n * d * b / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase():
    """gram_matvec against its plain version at the DGD shape, the odd
    shapes of the JAX kernel tests and one large shape."""
    shapes = [(15, 400, 60, torch.float32), (15, 400, 60, torch.bfloat16),
              (4, 37, 53, torch.float32), (4, 37, 53, torch.bfloat16),
              (4, 300, 200, torch.float32), (4, 300, 200, torch.bfloat16),
              (64, 4096, 1024, torch.float32)]
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = []
    for n, d, b, dt in shapes:
        Xs = torch.randn(n, d, b, generator=gen, device=DEV).to(dt)
        th = torch.randn(d, generator=gen, device=DEV).to(dt)
        got = ops.batched_gram_matvec(Xs, th)
        want = ref.batched_gram_matvec_ref(Xs, th)
        torch.cuda.synchronize()
        check(got.dtype == dt and got.shape == (n, d), f"output {got.dtype} "
              f"{tuple(got.shape)} at {(n, d, b)}")
        diff = (got.float() - want.float()).abs().max().item()
        rel = diff / (want.float().abs().max().item() + 1e-9)
        tol = 1e-5 if dt == torch.float32 else 3e-2
        check(rel < tol, f"gram_matvec rel err {rel:.2e} >= {tol} at "
                         f"{(n, d, b, dt)}")
        iters = 20 if n * d * b > 10 ** 7 else 200
        row = dict(shape=[n, d, b], dtype=str(dt).split(".")[-1],
                   max_abs_err=diff, max_rel_err=rel,
                   ms=cuda_ms(lambda: ops.batched_gram_matvec(Xs, th), iters),
                   plain_ms=cuda_ms(
                       lambda: ref.batched_gram_matvec_ref(Xs, th), iters),
                   library_ms=cuda_ms(lambda: bmm_pair(Xs, th), iters))
        row["bound_ms"], row["bound_by"] = gram_bound(n, d, b, Xs.element_size())
        rows.append(row)
        print(f"kernel gram_matvec {n}x{d}x{b} {row['dtype']}: rel_err={rel:.3e}"
              f" ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f}"
              f" library_ms={row['library_ms']:.5f} bound_ms={row['bound_ms']:.5f}")
    # eq. (48): the task sum of h is the full-data X^T X theta
    n, d, b = 15, 400, 60
    Xs = torch.randn(n, d, b, generator=gen, device=DEV)
    th = torch.randn(d, generator=gen, device=DEV)
    Xf = Xs.double().permute(1, 0, 2).reshape(d, n * b)
    want = Xf @ (Xf.T @ th.double())
    got = ops.batched_gram_matvec(Xs, th).double().sum(0)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    check(rel < 1e-4, f"eq. 48 task sum rel err {rel:.2e}")
    print(f"kernel gram_matvec eq48 task-sum rel_err={rel:.3e}")
    return rows


def engine_phase():
    """The 10^6-trial sweep over CS/SS/RA/LB/PC/PCMM (n=16, r=4, all-k,
    scenario 1), trial-level LB <= CS/SS, and CUDA-vs-CPU samples."""
    n, r, model = 16, 4, scenario1()
    specs = [to_spec("cs", cyclic_to_matrix(n, r)),
             to_spec("ss", staircase_to_matrix(n, r)),
             to_spec("ra", random_assignment_to_matrix(n)),
             lb_spec(r), pc_spec(r), pcmm_spec(r)]
    trials, chunk = 1_000_000, 20_000
    sweep(specs, model, n, trials=chunk, chunk=chunk, devices="cuda")  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sweep(specs, model, n, trials=trials, chunk=chunk, devices="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    means = {sp.name: res.at_k(sp.name, n) for sp in specs}
    for name, v in means.items():
        check(np.isfinite(v) and v > 0, f"sweep mean {name}={v}")
    check(means["lb"] <= min(means["cs"], means["ss"]),
          f"lower bound above a schedule: {means}")
    print(f"engine sweep trials={trials} chunk={chunk} schemes={len(specs)} "
          f"seconds={secs:.4f} trials_per_s={trials / secs:.1f} "
          f"means_ms_at_k=n " + " ".join(f"{k}={v * 1e3:.6f}"
                                         for k, v in means.items()))
    t = 4096
    lb = completion_samples(lb_spec(r), model, n, trials=t, devices="cuda")
    for name in ("cs", "ss"):
        cs = completion_samples(specs[0 if name == "cs" else 1], model, n,
                                trials=t, devices="cuda")
        check(bool((lb <= cs).all()), f"trial-level LB <= {name} violated")
    worst = 0.0
    for sp in specs:
        on_gpu = completion_samples(sp, model, n, trials=t, devices="cuda")
        on_cpu = completion_samples(sp, model, n, trials=t, devices="cpu")
        rel = ((on_gpu.cpu() - on_cpu).abs() / on_cpu.abs()).max().item()
        check(rel < 1e-6, f"{sp.name}: CUDA vs CPU samples rel {rel:.2e}")
        worst = max(worst, rel)
    print(f"engine trial-level LB<=CS/SS ok on {t} trials; CUDA-vs-CPU "
          f"samples max rel diff {worst:.3e}")
    return {"trials": trials, "seconds": secs, "trials_per_s": trials / secs}


def dgd_phase():
    """The paper's DGD loop at RegressionConfig() for 100 iterations on the
    card, and the Table I one-step check."""
    cfg = RegressionConfig()
    iters = 100
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    runs = dgd.run_paper(cfg, iters, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches["gram_matvec"] == 3 * iters,
          f"gram_matvec launches {launches} != {3 * iters} (CS/SS/RA x iters)")
    prob = dgd.paper_problem(cfg, device="cuda")
    loss0 = dgd.loss_of(torch.zeros(cfg.d, device=DEV), prob.X, prob.y)
    for name, run in runs.items():
        loss = dgd.loss_of(run.theta, prob.X, prob.y)
        check(np.isfinite(loss) and loss < loss0,
              f"{name} loss did not fall: {loss0} -> {loss}")
        print(f"dgd {name}: loss {loss0:.5f} -> {loss:.5f} virtual "
              f"{run.clock * 1e3:.3f} ms")
    print(f"dgd seconds={secs:.3f} for {iters} iterations x 5 schemes; "
          f"gram_matvec launches={launches['gram_matvec']}")
    small = dgd.paper_problem(RegressionConfig(N=240, d=60, n=6, r=2, k=6),
                              device="cuda")
    errs = dgd.table1_check(small, 2)
    check(errs["uncoded"] < 1e-4 and errs["pc"] < 1e-4
          and errs["pcmm"] < 1e-2, f"table-1 update errors {errs}")
    print("dgd table1 (N=240 d=60 n=6 r=2) update errors "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    errs = dgd.table1_check(prob, cfg.r)
    check(errs["uncoded"] < 1e-4 and errs["pc"] < 1e-4,
          f"paper-size table-1 update errors {errs}")
    print("dgd table1 (paper size) update errors "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + " (pcmm: raster-order decode, ill-conditioned at n=15)")
    return launches


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    build_s = build.build_all()
    print(f"device: {card}; kernel build {build_s:.2f} s")
    for name in build.SOURCES:
        log = (build.BUILD_DIR / f"{name}.log")
        if log.exists():
            print(f"nvcc {name}: " + " | ".join(
                ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln))
    rows = kernel_phase()
    engine = engine_phase()
    launches = dgd_phase()
    main_row = rows[0]                 # the DGD shape, float32
    print(json.dumps({"kernels": [{
        "name": "gram_matvec", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram_matvec.cu",
        "replaces": "src/repro/kernels/gram_matvec.py:67",
        "launches": launches["gram_matvec"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "card": card, "shapes": rows}], "engine": engine}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
