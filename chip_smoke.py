"""Smoke run of the PyTorch port on one CUDA card: builds the port's six
kernel sources (gram_matvec_onepass, gram_matvec's two-pass kernel for
columns no cluster holds, greedy_assign, swa_attention on the CUDA cores,
swa_attention_wgmma on the tensor cores for bfloat16 and swa_attention_f32
on the tensor cores for float32) from the checkout, holds each
kernel against its plain PyTorch version (greedy_assign on both of its
routes: one warp a trial with W in shared memory up to n = 128, one block a
trial with W read through L2 past it), drives the single-round Monte-Carlo
engine at a 10^6-trial sweep, the rounds engine over the full Fig. 8 grid
(adaptive scheduling through the greedy_assign kernel, CUDA trajectories
against CPU ones on a shared trace, at n = 12 and, on the wide route, at
n = 200, once more there under the reissue deadline policy, whose need rows
reach the kernel), runs the paper's DGD regression loop
end to end on the iid and the Markov cluster (the one-pass gram_matvec kernel
for every uncoded scheme, greedy_assign for the ADAPT row), regenerates the
paper's Figs. 3-7 and 9, Table I and the engine benchmark through
``python -m benchmarks_torch.run --quick`` on the card (their guards held;
Theorem 1's mean held to the direct order statistic), runs the
fault-tolerance slice (Figs. 10-12 at --quick with every status row PASS;
a faults grid at the Fig. 8 scale, CS / SS / adapt / rebal / LB under spot
preemption with a round deadline, close_partial then reissue, with its wall
seconds, launches per chunk-round and the card's busy share; CUDA against
CPU on recorded fault traces), and serves gemma3-4b at
full width and depth through ``repro_torch.launch.serve`` (prefill of two
2048-token prompts and greedy decode; the bf16 prefill attention of every
sliding-window layer through the tensor-core swa_attention kernel), with
the float32 kernel route (error-compensated TF32 on the tensor cores)
checked against the ring-cache route and the CPU, and a bfloat16 model of
narrow heads (dh 32, the CUDA-core kernel's route) against the CPU.  Last,
the grid phase: the reference benchmark's 64-cell grid (n = 16, 20 000
trials) streamed through ``stream_grid`` against a loop of per-cell sweeps
(fused cells bit-equal to per-cell ones, one evaluator build per shape
bucket, launches per fused dispatch), card against CPU means on a
2-bucket sub-grid, a resumable sweep over three rungs against fresh
sweeps, the racing planner against the grid's ``best_cell``, the Fig. 8
cell with an adaptive spec through ``stream_grid`` (greedy_assign
launches, card against CPU), and ``python -m benchmarks_torch.run --quick
--only grid,planner``.  Then the live phase: ``repro_torch.live``'s master
and n in-process workers over inproc and TCP at the paper's EC2 size
(n = 15, r = 3, 100 rounds): static CS bit-equal to the engine, to the
trace's replay and to the CPU, a close_partial deadline equal to the
engine's degradation streams, adaptive censored feedback under reissue
(one greedy_assign launch a round, card equal to CPU), an n = 200 leg on
the kernel's wide route, and Fig. 13 through the harness.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Prints the card's name and power limit, one line per check, a JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the exit code is non-zero and the last line is
never printed.  Without a CUDA device, or outside a checkout of the
repository, it exits non-zero before printing any result.
"""
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device available")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import RegressionConfig, get_config  # noqa: E402
from repro_torch.core import (DelayTrace, GridCell,  # noqa: E402
                              GridSpec, RoundConfig, TraceProcess,
                              adaptive_spec, cache_stats, completion_samples,
                              cyclic_to_matrix, ec2_cluster, lb_spec,
                              lower_bound_mean_mc,
                              make_scenario, mean_completion_time, pc_spec,
                              pcmm_spec, random_assignment_to_matrix,
                              resumable_sweep, scenario1, staircase_to_matrix,
                              stream_grid, sweep, sweep_rounds,
                              theorem1_mean_mc, to_spec, trajectory_samples)
from repro_torch.core import montecarlo  # noqa: E402
from repro_torch.core.scheduling import _greedy_matrices  # noqa: E402
from repro_torch import dgd  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.live import run_live, sample_delay_tables  # noqa: E402
from repro_torch.models import (forward, init_cache, init_params,  # noqa: E402
                                layer_specs)

sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks_torch"))
import fig8_convergence as fig8  # noqa: E402
import greedy_pick  # noqa: E402
from benchmarks_torch import grid_stream  # noqa: E402
from benchmarks_torch import planner as planner_bench  # noqa: E402
from benchmarks_torch import run as bench_run  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, float32 outside
# the tensor cores, bf16 and TF32 on the tensor cores (dense).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
DEV = torch.device("cuda")
# float32 stays float32 on the card: no TF32 in matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters, warmup=3):
    """Mean device milliseconds of ``fn`` over ``iters`` launches (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters):
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls, as
    torch.profiler records the kernels they launch (their summed device
    time); tried twice where it records none or fewer kernels than calls
    (dropped events), then None (not measured) with a warning on
    stderr."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(float(getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0.0)))
                 for e in events)
        if us and sum(e.count for e in events) >= iters:  # none dropped
            return us / 1e3 / iters
    print("chip_smoke: the profiler recorded no device time or dropped "
          "kernels (not measured)", file=sys.stderr)
    return None


def bmm_pair(Xs, theta):
    """One library call pair computing the same function (timing yardstick
    only; the port never calls it)."""
    th = theta.reshape(1, -1, 1).expand(Xs.shape[0], -1, 1)
    u = torch.bmm(Xs.transpose(1, 2), th)
    return torch.bmm(Xs, u)[..., 0]


def split_pass(Xs, theta):
    """The split-d two-pass kernel (csrc/gram_matvec.cu, the route of tasks
    past the one-pass limit) on inputs that take the one-pass route: its
    time there, launched past the wrapper with ops.gram_tall_plan's plan and
    not counted."""
    n, d, b = Xs.shape
    tall = ops.gram_tall_plan(n, d, b, Xs.dtype)
    scratch = torch.empty(n * b * (1 + (tall.s1 > 1) * tall.s1),
                          dtype=torch.float32, device=DEV)
    part = scratch[n * b:].data_ptr() if tall.s1 > 1 else None
    y = torch.empty((n, d), dtype=Xs.dtype, device=DEV)
    lib = build.library("gram_matvec")
    stream = torch.cuda.current_stream().cuda_stream
    dt = 0 if Xs.dtype == torch.float32 else 1

    def launch():
        err = lib.gram_matvec_launch(Xs.data_ptr(), theta.data_ptr(), part,
                                     scratch.data_ptr(), y.data_ptr(), n, d,
                                     b, dt, *tall, stream)
        if err:
            raise RuntimeError(f"split-d gram_matvec launch failed: CUDA "
                               f"error {err}")
    return launch


def ms_text(ms):
    return "not measured" if ms is None else f"{ms:.5f}"


def gram_bound(n, d, b, itemsize):
    """Least time for h over (n, d, b): bytes (X once, theta, output) over
    the HBM rate vs 4*n*d*b flops over the float32 rate."""
    t_bytes = (n * d * b + d + n * d) * itemsize / HBM_BYTES_PER_S
    t_ops = 4 * n * d * b / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase():
    """gram_matvec against its plain version at the DGD shape, the odd
    shapes of the JAX kernel tests, a ragged shape of several column blocks,
    the large shape in float32 and bfloat16, and tall tasks past the
    one-pass limit (the split-d two-pass route): d one past it at b = 8 for
    one task and for the dgd-tall leg's 15, in bfloat16, at b = 1, and
    (1, 100 000, 256), whose X is twice the L2.  Each call's route is the
    one ops.gram_plan names (checked by the launch counts, set to 0 just
    before each call); two calls give the same bits.  Returns the rows and
    the launches of the dgd-tall shape's call."""
    def past(b, dt):
        return ops.gram_onepass_max_d(b, dt) + 1
    f32, bf16 = torch.float32, torch.bfloat16
    dgd_tall = (15, past(8, f32), 8, f32)
    shapes = [(15, 400, 60, f32), (15, 400, 60, bf16),
              (4, 37, 53, f32), (4, 37, 53, bf16),
              (4, 300, 200, f32), (4, 300, 200, bf16),
              (8, 3000, 700, f32),
              (64, 4096, 1024, f32),
              (64, 4096, 1024, bf16),
              (1, past(8, f32), 8, f32), dgd_tall,
              (1, past(8, bf16), 8, bf16), (1, past(1, f32), 1, f32),
              (1, 100000, 256, f32)]
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = []
    tall_launches = None
    for n, d, b, dt in shapes:
        Xs = torch.randn(n, d, b, generator=gen, device=DEV).to(dt)
        th = torch.randn(d, generator=gen, device=DEV).to(dt)
        plan = ops.gram_plan(n, d, b, dt)
        tall = d > ops.gram_onepass_max_d(b, dt)
        check(plan.route == ("twopass" if tall else "onepass"),
              f"gram_plan route {plan} at {(n, d, b, dt)}")
        ops.reset_launch_counts()
        got = ops.batched_gram_matvec(Xs, th)
        launches = dict(ops.LAUNCHES)
        want = ref.batched_gram_matvec_ref(Xs, th)
        torch.cuda.synchronize()
        check(launches["gram_matvec"] == 1
              and launches["gram_matvec_onepass"] == (plan.route == "onepass"),
              f"gram_matvec at {(n, d, b, dt)} did not take the {plan.route} "
              f"route: launches {launches}")
        if (n, d, b, dt) == dgd_tall:
            tall_launches = launches["gram_matvec"]
        check(got.dtype == dt and got.shape == (n, d), f"output {got.dtype} "
              f"{tuple(got.shape)} at {(n, d, b)}")
        diff = (got.float() - want.float()).abs().max().item()
        rel = diff / (want.float().abs().max().item() + 1e-9)
        tol = 1e-5 if dt == torch.float32 else 3e-2
        check(rel < tol, f"gram_matvec rel err {rel:.2e} >= {tol} at "
                         f"{(n, d, b, dt)}")
        again = ops.batched_gram_matvec(Xs, th)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"gram_matvec not deterministic at "
                                       f"{(n, d, b, dt)}")
        iters = 20 if n * d * b > 10 ** 7 else 200
        kernel = lambda: ops.batched_gram_matvec(Xs, th)  # noqa: E731
        library = lambda: bmm_pair(Xs, th)                # noqa: E731
        row = dict(shape=[n, d, b], dtype=str(dt).split(".")[-1],
                   route=plan.route, plan=dict(c=plan.c, R=plan.R, C=plan.C,
                                               nbc=plan.nbc, smem=plan.smem),
                   max_abs_err=diff, max_rel_err=rel, deterministic=True,
                   ms=cuda_ms(kernel, iters),
                   device_ms=device_ms(kernel, iters),
                   plain_ms=cuda_ms(
                       lambda: ref.batched_gram_matvec_ref(Xs, th), iters),
                   library_ms=cuda_ms(library, iters),
                   library_device_ms=device_ms(library, iters))
        if tall:
            row["tall_plan"] = ops.gram_tall_plan(n, d, b, dt)._asdict()
        else:
            row["split_ms"] = cuda_ms(split_pass(Xs, th), iters)
            row["split_device_ms"] = device_ms(split_pass(Xs, th), iters)
        row["bound_ms"], row["bound_by"] = gram_bound(n, d, b, Xs.element_size())
        row["gb_per_s"] = Xs.numel() * Xs.element_size() / row["ms"] / 1e6
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        shown = (f"tall_plan={tuple(row['tall_plan'].values())}" if tall else
                 f"plan=(c={plan.c} R={plan.R} C={plan.C} nbc={plan.nbc} "
                 f"smem={plan.smem})")
        split = ("" if tall else
                 f" split_ms={row['split_ms']:.5f} split_device_ms="
                 f"{ms_text(row['split_device_ms'])}")
        print(f"kernel gram_matvec {n}x{d}x{b} {row['dtype']} route="
              f"{plan.route} {shown}: rel_err={rel:.3e} "
              f"deterministic ms={row['ms']:.5f} device_ms="
              f"{ms_text(row['device_ms'])} "
              f"({row['gb_per_s']:.1f} GB/s of X, {row['bound_share']:.3f} "
              f"of bound) plain_ms={row['plain_ms']:.5f} library_ms="
              f"{row['library_ms']:.5f} library_device_ms="
              f"{ms_text(row['library_device_ms'])}{split} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})")
        del Xs, th, got, want, again
        torch.cuda.empty_cache()
    check(tall_launches == 1, "the dgd-tall shape did not take the two-pass "
                              "route once")
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
    return rows, tall_launches


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


def greedy_inputs(B, n, r, *, seed=0, need=False, ties=False, infs=False,
                  case="plain"):
    """greedy_assign inputs for a CS matrix: W, the stable argsort of the
    estimates (random, all equal, or with +inf entries), epick = max(est,
    1e-30), and optional need rows; made from a seed with numpy.  ``case``
    reaches the kernel's dense fold: "nan_epick" / "zero_epick" put NaN / 0
    in a fifth of epick (direct calls), "huge_w" scales W by 1e38 so that
    W / epick overflows, "dense_row" fills row 0 of W (past the kernel's
    sparse cap, GREEDY_SPARSE_CAP, where n exceeds it)."""
    gen = np.random.default_rng(seed + B * n + r)
    C = cyclic_to_matrix(n, r)
    W, A = _greedy_matrices(tuple(map(tuple, C.tolist())), 0.5)
    est = (np.full((B, n), 1.0, np.float32) if ties
           else gen.uniform(0.01, 1.0, (B, n)).astype(np.float32))
    if infs:
        est[gen.random((B, n)) < 0.2] = np.inf
    est = torch.as_tensor(est, device=DEV)
    order = torch.argsort(est, dim=-1, stable=True).to(torch.int32)
    epick = torch.clamp(torch.take_along_dim(est, order.long(), dim=-1),
                        min=1e-30)
    need_row = None
    if need:
        nd = torch.as_tensor(gen.random((B, n)) < 0.3, device=DEV)
        Ab = torch.as_tensor(A > 0, device=DEV)
        need_row = (nd[:, None, :] & Ab[None]).sum(-1).float()
    W = torch.as_tensor(W, device=DEV)
    some = torch.as_tensor(gen.random((B, n)) < 0.2, device=DEV)
    if case == "nan_epick":
        epick = torch.where(some, float("nan"), epick)
    elif case == "zero_epick":
        epick = torch.where(some, 0.0, epick)
    elif case == "huge_w":
        W = W * 1e38
    elif case == "dense_row":
        W = W.clone()                  # W may share the cached numpy array
        W[0] = 0.25
    return W, order, epick, need_row


def greedy_bound(W, B, n, with_need):
    """Least time for the pick loop: bytes (order, epick, need_row in, the
    output out, W once) over the HBM rate vs the float32 flops these inputs
    need (each pick scores every row over W's nonzeros, each update adds a
    row's nonzeros)."""
    nnz = int((W != 0).sum())
    t_bytes = (B * n * (16 if with_need else 12) + n * n * 4) / HBM_BYTES_PER_S
    t_ops = (2 * B * n * nnz + 2 * B * nnz) / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


#: the most nonzeros a row of W may hold for the greedy_assign kernel's
#: sparse fold, read from its source
GREEDY_SPARSE_CAP = int(re.search(
    r"constexpr int kCap = (\d+);",
    (build.CSRC / "greedy_assign.cu").read_text())[1])

#: (need, ties, infs, case) of each greedy check; the last five reach the
#: kernel's dense fold
GREEDY_CASES = {"need": (True, False, False, "plain"),
                "ties": (False, True, False, "plain"),
                "infs": (False, False, True, "plain"),
                "nan_epick": (False, False, False, "nan_epick"),
                "zero_epick": (False, False, False, "zero_epick"),
                "huge_w": (False, False, False, "huge_w"),
                "huge_w_need": (True, False, False, "huge_w"),
                "dense_row": (False, False, False, "dense_row")}


def greedy_dense_count():
    """The greedy_assign kernel's own count of the trials that entered its
    dense pick loop, over every launch so far (waits for the device)."""
    count = ctypes.c_ulonglong()
    err = build.library("greedy_assign").greedy_assign_dense_trials(
        ctypes.byref(count))
    check(err == 0, f"greedy_assign_dense_trials: CUDA error {err}")
    return count.value


#: the greedy_assign shapes past the warp route (n > 128, the wide route):
#: its first n, the adaptive leg's n = 200 and n = 257, whose W (264 196
#: bytes) is past any block's shared memory
GREEDY_WIDE_SHAPES = [(256, 129, 3), (256, 200, 4), (64, 257, 4)]


def greedy_phase():
    """greedy_assign against its plain version, torch.equal required, at
    the DGD ADAPT shape, the Fig. 8 chunk, a large, a ragged, the two sides
    of one row a lane (n 32 / 33) and the warp route's largest n; each with
    and without need rows, with all-equal estimates (maximal ties), +inf
    estimates, and the cases of the dense fold (NaN or zero estimates,
    overflowing coverage, a row past the sparse cap), two calls equal; then
    the wide route's shapes (GREEDY_WIDE_SHAPES) with and without need rows.
    Each call's route is ops.greedy_route's.  Counts, by the kernel's
    counter, the trials of each case's call that took the dense fold: none
    on finite coverage at n <= 32, every one past n = 32 or the cap, some
    where the coverage turns non-finite.  Times each shape
    (greedy_pick.pick_times: device ms, the n = 1 launch at the same B as
    the floor, per pick (t(n) - t(1)) / (n - 1)) and its all-dense
    input."""
    shapes = [(1, 15, 3), (2000, 12, 3), (20000, 16, 4), (333, 12, 3),
              (333, 32, 5), (333, 33, 5), (4096, ops.GREEDY_WARP_MAX_N, 8),
              *GREEDY_WIDE_SHAPES]
    rows = []
    for B, n, r in shapes:
        route = ops.greedy_route(n)
        check(route == ("warp_smem" if n <= 128 else "wide"),
              f"greedy_route({n}) = {route}")
        wide = route == "wide"
        cases = {"need": GREEDY_CASES["need"]} if wide else GREEDY_CASES
        dense_trials = {}
        for case, (need, ties, infs, kind) in [
                ("plain", (False, False, False, "plain")),
                *cases.items()]:
            W, order, epick, need_row = greedy_inputs(
                B, n, r, need=need, ties=ties, infs=infs, case=kind)
            before = greedy_dense_count()
            got = ops.greedy_assign(W, order, epick, need_row)
            dense_trials[case] = greedy_dense_count() - before
            again = ops.greedy_assign(W, order, epick, need_row)
            want = ref.greedy_assign_ref(W, order, epick, need_row)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"greedy_assign != plain at {(B, n, r)} ({case})")
            check(torch.equal(got, again),
                  f"greedy_assign not deterministic at {(B, n, r)} ({case})")
            if n > 32 or (kind == "dense_row" and n > GREEDY_SPARSE_CAP):
                expect = dense_trials[case] == B
            elif kind in ("plain", "dense_row"):
                expect = dense_trials[case] == 0
            else:
                expect = n == 1 or dense_trials[case] > 0
            check(expect, f"greedy_assign at {(B, n, r)} ({case}): "
                          f"{dense_trials[case]} of {B} trials dense")
        W, order, epick, _ = greedy_inputs(B, n, r)
        got = ops.greedy_assign(W, order, epick)
        want = ref.greedy_assign_ref(W, order, epick)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        # the plain version at the wide shapes takes ~0.6-2.4 s a call (n^2
        # launches), already warm from the checks above: one call timed
        plain_iters = 1 if wide else 2 if n > 32 else 20
        kernel = lambda: ops.greedy_assign(W, order, epick)  # noqa: E731
        W1, order1, epick1, _ = greedy_inputs(B, 1, 1)
        Wd, orderd, epickd, _ = greedy_inputs(B, n, r, case="huge_w")
        row = dict(shape=[B, n, r], route=route, smem=ops.greedy_smem(n),
                   max_abs_err=float(err), ms=cuda_ms(kernel, 200),
                   **greedy_pick.pick_times(
                       lambda fn: device_ms(fn, 200), kernel,
                       lambda: ops.greedy_assign(W1, order1, epick1),
                       lambda: ops.greedy_assign(Wd, orderd, epickd), n),
                   plain_ms=cuda_ms(
                       lambda: ref.greedy_assign_ref(W, order, epick),
                       plain_iters, warmup=0 if wide else 3),
                   library_ms=None, dense_trials=dense_trials, trials=B)
        row["bound_ms"], row["bound_by"] = greedy_bound(W, B, n, False)
        rows.append(row)
        pick = ("not measured" if row["pick_us"] is None
                else f"{row['pick_us']:.5f}")
        shown = ("plain, need" if wide else "plain, need, ties, +inf, NaN "
                 "/ zero epick, overflow, dense row")
        print(f"kernel greedy_assign B={B} n={n} r={r} route={route} smem="
              f"{row['smem']}: equal ({shown}; two calls) ms={row['ms']:.5f} "
              f"device_ms="
              f"{ms_text(row['device_ms'])} n1_device_ms="
              f"{ms_text(row['n1_device_ms'])} pick_us={pick} "
              f"dense_device_ms={ms_text(row['dense_device_ms'])} "
              f"plain_ms={row['plain_ms']:.5f} bound_ms="
              f"{row['bound_ms']:.6f} dense_trials={dense_trials} of {B} "
              f"(the kernel's count) library_ms=none (no single PyTorch "
              f"call computes the pick loop)")
    return rows


def rounds_phase():
    """Fig. 8's grid at full size through the rounds engine (adaptive rows
    through the greedy_assign kernel), its guard, per-round LB <= every
    scheme, and CUDA-vs-CPU trajectories on one shared CPU-drawn trace."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, results = fig8.run(20000, "cuda")  # raises SystemExit on failure
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    trials = min(20000, 8000)
    n_chunks = -(-trials // fig8.CHUNK)
    cells = len(fig8.PERSISTENCE) * len(fig8.SPREAD)
    want = cells * fig8.ROUNDS * n_chunks
    check(launches["greedy_assign"] == want,
          f"fig8 greedy_assign launches {launches} != {want}")
    for cell, res in results.items():
        for name in res.per_round:
            check(bool((res.per_round["lb"] <= res.per_round[name]).all()),
                  f"fig8 {cell}: per-round LB above {name}")
            check(bool(np.isfinite(res.per_round[name]).all()),
                  f"fig8 {cell}: non-finite {name}")
    trial_rounds = cells * trials * fig8.ROUNDS
    print(f"rounds fig8 grid: {cells} cells x {trials} trials x "
          f"{fig8.ROUNDS} rounds seconds={secs:.4f} "
          f"trial_rounds_per_s={trial_rounds / secs:.1f} greedy_assign "
          f"launches={launches['greedy_assign']} (= cells x rounds x chunks)")
    # one shared trace, drawn on the CPU, replayed on both devices
    n, r, rounds, tr = fig8.N, fig8.R, fig8.ROUNDS, 2000
    T1, T2 = fig8.cell_process(0.98, 3.0).sample_rounds(
        0, tr, n, r, rounds, device="cpu")
    proc = TraceProcess(DelayTrace(T1.numpy(), T2.numpy()))
    cs = cyclic_to_matrix(n, r)
    for spec in (adaptive_spec("adapt", cs), to_spec("cs", cs),
                 to_spec("ss", staircase_to_matrix(n, r)), lb_spec(r)):
        for censored in (False, True):
            a = trajectory_samples(spec, proc, n, rounds=rounds, k=fig8.K,
                                   trials=tr, chunk=500, devices="cuda",
                                   censored_feedback=censored)
            b = trajectory_samples(spec, proc, n, rounds=rounds, k=fig8.K,
                                   trials=tr, devices="cpu",
                                   censored_feedback=censored)
            check(torch.equal(a.cpu(), b), f"{spec.name} (censored="
                  f"{censored}): CUDA trajectories differ from CPU")
    print(f"rounds shared trace ({rounds} x {tr} x {n} x {r}): CUDA "
          f"trajectories equal CPU bit for bit for adapt/cs/ss/lb, "
          f"censored and not")
    return {"seconds": secs, "trial_rounds_per_s": trial_rounds / secs,
            "greedy_launches": launches["greedy_assign"],
            "ms_per_round": {f"p{p}_s{s:g}": v for (p, s), v in out.items()}}


def adaptive_wide_leg(n=200, r=4, rounds=3, trials=256, deadline=None):
    """Adaptive scheduling past the warp route: trajectory_samples with an
    adaptive CS spec at n = 200, r = 4 on one shared trace drawn with numpy,
    on the card (greedy_assign's wide route; the launch counts set to 0
    just before, read just after: one launch a round) and on the CPU (the
    plain version), bit-equal.  With ``deadline`` the rounds close under
    the reissue policy, so every round after the first sends the wide route
    need rows (the tasks the round before did not deliver).  Returns the
    launches (with need rows too) and the card's seconds."""
    gen = np.random.default_rng(21)
    T1 = (1e-4 * (0.5 + gen.random((rounds, trials, n, r)))).astype(
        np.float32)
    T2 = (5e-4 * (0.5 + gen.random((rounds, trials, n, r)))).astype(
        np.float32)
    proc = TraceProcess(DelayTrace(T1, T2))
    spec = adaptive_spec("adapt", cyclic_to_matrix(n, r))
    k = 3 * n // 4
    kw = ({} if deadline is None
          else dict(deadline=deadline, deadline_policy="reissue"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    a = trajectory_samples(spec, proc, n, rounds=rounds, k=k, trials=trials,
                           devices="cuda", **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.LAUNCHES["greedy_assign"]
    need = ops.LAUNCHES["greedy_assign_need"]
    b = trajectory_samples(spec, proc, n, rounds=rounds, k=k, trials=trials,
                           devices="cpu", **kw)
    check(launches == rounds, f"adaptive n={n}: greedy_assign launches "
                              f"{launches} != {rounds} (one a round)")
    check(need == (0 if deadline is None else rounds),
          f"adaptive n={n}: {need} greedy_assign launches with need rows")
    check(torch.equal(a.cpu(), b), f"adaptive n={n}: CUDA trajectories "
                                   f"differ from CPU")
    check(bool(torch.isfinite(a).all()), f"adaptive n={n}: non-finite")
    shown = ("" if deadline is None else
             f" reissue deadline={deadline * 1e3:.6f} ms (closed at it: "
             f"{float((a >= deadline).float().mean()):.3f} of rounds);")
    print(f"rounds adaptive n={n} r={r} ({rounds} rounds x {trials} trials, "
          f"shared trace, route={ops.greedy_route(n)}):{shown} CUDA "
          f"trajectories equal CPU bit for bit; greedy_assign launches="
          f"{launches} (with need rows {need}); card seconds={secs:.4f}")
    return {"launches": launches, "need_launches": need, "seconds": secs,
            "trajectories": a}


#: the fault-tolerance figures the faults phase runs
FAULT_FIGURES = ("fig10", "fig11", "fig12")
#: the faults grid: the Fig. 8 cell at its scale (trials in chunks), with
#: re-balancing on a CS grid of this cap and Fig. 12's deadline slack
FAULT_TRIALS, FAULT_CHUNK, FAULT_CAP, FAULT_SLACK = 8000, 2000, 6, 1.5


def fault_specs():
    """CS / SS / adapt / rebal (cap FAULT_CAP, r slots a worker to start)
    / LB at the Fig. 8 cell's n and r."""
    n, r = fig8.N, fig8.R
    cs = cyclic_to_matrix(n, r)
    return [to_spec("cs", cs), to_spec("ss", staircase_to_matrix(n, r)),
            adaptive_spec("adapt", cs),
            adaptive_spec("rebal", cyclic_to_matrix(n, FAULT_CAP),
                          loads=(r,) * n, rebalance=True),
            lb_spec(r)]


def tie_exact_tables(seed, rounds, n, r, trials, lo=8, hi=14):
    """Delay tables on which no summation order can change a greedy pick
    (tests/torch_parity.py's family): T1 a power of two 2**-e, e in [lo,
    hi), constant per (trial, worker) over rounds and slots; T2 arbitrary
    positive.  With feedback_beta = coverage_gamma = 0.5 every estimate and
    greedy score is exact in float32."""
    gen = np.random.default_rng(seed)
    e = gen.integers(lo, hi, size=(1, trials, n, 1))
    T1 = np.broadcast_to(2.0 ** -e, (rounds, trials, n, r))
    T2 = 5e-4 * (0.5 + gen.random((rounds, trials, n, r)))
    return T1.astype(np.float32), T2.astype(np.float32)


def profiled(fn):
    """One call of ``fn`` under torch.profiler: (wall s, summed device
    time of the CUDA kernels s or None, kernel launches or None)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(float(getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0)))
             for e in kernels)
    count = int(sum(e.count for e in kernels))
    return wall, (us / 1e6 if us else None), (count or None)


def faults_phase():
    """The fault-tolerance slice on the card.

    1. Figs. 10-12 at --quick through ``python -m benchmarks_torch.run``'s
       main, the launch counts set to 0 just before and read just after:
       every status row PASS (their guards raise otherwise), greedy_assign
       launched (adapt and rebal specs).
    2. The faults grid at the Fig. 8 scale: n = 12, r = 3, k = 9, 24
       rounds, FAULT_TRIALS trials in FAULT_CHUNK-trial chunks, CS / SS /
       adapt / rebal / LB with censored feedback, under
       ``make_scenario("preemption", ...)`` with a deadline of FAULT_SLACK x
       the clean static mean round, first ``close_partial`` then
       ``reissue``: finite times and degradation metrics, realized-k
       histograms summing to one, per-round LB at or below CS/SS, the
       greedy_assign launches (two adaptive specs a chunk-round; with need
       rows exactly under reissue).  Wall seconds of each leg; then
       profiled one-chunk windows: launches per chunk-round and the card's
       busy share (device kernel time over wall time) of the whole grid
       under each policy, and the rebalance loop's launches (rebal alone
       minus adapt alone) and the reissue path's (reissue minus
       close_partial) per chunk-round.
    3. Card against CPU on shared recorded traces with faults: a
       preemption trace of the grid's cluster, static specs bit-equal under
       reissue; a preemption trace over a tie-exact base, adapt and rebal
       bit-equal under close_partial and reissue."""
    n, k, rounds = fig8.N, fig8.K, fig8.ROUNDS
    out_dir = str(Path(__file__).resolve().parent / "bench_out_torch")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = bench_run.main(["--quick", "--device", "cuda", "--only",
                           ",".join(FAULT_FIGURES), "--out", out_dir])
    torch.cuda.synchronize()
    fig_secs = time.perf_counter() - t0
    fig_launches = dict(ops.LAUNCHES)
    check(sorted(done) == sorted(FAULT_FIGURES), f"faults ran {sorted(done)}")
    status = {row["name"]: row["derived"]["status"]
              for job in done.values() for row in job["rows"]
              if "status" in row["derived"]}
    check(len(status) == 10 and set(status.values()) == {"PASS"},
          f"fault figures status rows {status}")
    check(fig_launches["greedy_assign"] > 0
          and fig_launches["greedy_assign_need"] == 0,
          f"fault figures: launches {fig_launches}")
    for name, job in done.items():
        print(f"faults {name}: seconds={job['seconds']:.3f} rows="
              f"{len(job['rows'])} status rows PASS")

    specs = fault_specs()
    base = fig8.cell_process(0.98, 3.0)
    kw = dict(rounds=rounds, k=k, seed=0, censored_feedback=True,
              devices="cuda")
    clean = sweep_rounds(specs, base, n, trials=FAULT_TRIALS,
                         chunk=FAULT_CHUNK, **kw)
    deadline = FAULT_SLACK * min(clean.mean_round("cs"),
                                 clean.mean_round("ss"))
    proc = make_scenario("preemption", base, n)
    chunk_rounds = rounds * (FAULT_TRIALS // FAULT_CHUNK)
    grid = {"deadline_ms": deadline * 1e3, "trials": FAULT_TRIALS,
            "chunk": FAULT_CHUNK, "rounds": rounds}
    for policy in ("close_partial", "reissue"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = sweep_rounds(specs, proc, n, trials=FAULT_TRIALS,
                           chunk=FAULT_CHUNK, deadline=deadline,
                           deadline_policy=policy, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        for sp in specs:
            nm = sp.name
            check(bool(np.isfinite(res.per_round[nm]).all()),
                  f"faults grid {policy}: non-finite {nm}")
            for key in ("realized_k", "missed", "stale"):
                check(bool(np.isfinite(res.degradation[nm][key]).all()),
                      f"faults grid {policy}: non-finite {nm} {key}")
            check(bool((res.realized_k(nm) <= k).all()),
                  f"faults grid {policy}: {nm} realized above k")
            check(np.allclose(res.khist(nm).sum(-1), 1.0, atol=1e-5),
                  f"faults grid {policy}: {nm} khist rows")
        for nm in ("cs", "ss"):
            check(bool((res.per_round["lb"] <= res.per_round[nm]).all()),
                  f"faults grid {policy}: per-round LB above {nm}")
        want = 2 * chunk_rounds
        check(launches["greedy_assign"] == want
              and launches["greedy_assign_need"]
              == (want if policy == "reissue" else 0),
              f"faults grid {policy}: launches {launches} (want {want} "
              f"greedy_assign, with need rows only under reissue)")
        cost = {sp.name: res.mean_round(sp.name) * 1e3
                / float(np.mean(res.realized_k(sp.name))) for sp in specs}
        grid[policy] = {
            "seconds": secs,
            "trial_rounds_per_s": FAULT_TRIALS * rounds / secs,
            "greedy_launches": launches["greedy_assign"],
            "greedy_need_launches": launches["greedy_assign_need"],
            "ms_round": {sp.name: res.mean_round(sp.name) * 1e3
                         for sp in specs},
            "ms_per_realized_task": cost,
            "realized_k": {sp.name: float(np.mean(res.realized_k(sp.name)))
                           for sp in specs},
            "missed": {sp.name: float(np.mean(res.missed_fraction(sp.name)))
                       for sp in specs},
            "stale": {sp.name: float(np.mean(res.stale_fraction(sp.name)))
                      for sp in specs}}
        print(f"faults grid preemption {policy} (n={n} k={k} {rounds} "
              f"rounds, {FAULT_TRIALS} trials in {FAULT_CHUNK}-trial "
              f"chunks, deadline={deadline * 1e3:.6f} ms): seconds="
              f"{secs:.4f} greedy_assign launches="
              f"{launches['greedy_assign']} (with need rows "
              f"{launches['greedy_assign_need']}); ms/realized task "
              + " ".join(f"{nm}={v:.6f}" for nm, v in cost.items())
              + "; realized k " + " ".join(
                  f"{nm}={v:.4f}" for nm, v in
                  grid[policy]["realized_k"].items()))

    # profiled one-chunk windows (the kernels are built and warm)
    one = dict(trials=FAULT_CHUNK, chunk=FAULT_CHUNK, deadline=deadline,
               **kw)
    windows = {
        "grid_close_partial": lambda: sweep_rounds(
            specs, proc, n, deadline_policy="close_partial", **one),
        "grid_reissue": lambda: sweep_rounds(
            specs, proc, n, deadline_policy="reissue", **one),
        "adapt_alone": lambda: sweep_rounds(
            [specs[2]], proc, n, deadline_policy="close_partial", **one),
        "rebal_alone": lambda: sweep_rounds(
            [specs[3]], proc, n, deadline_policy="close_partial", **one)}
    prof = {}
    for name, fn in windows.items():
        wall, dev_s, count = profiled(fn)
        prof[name] = {"wall_s": wall, "device_kernel_s": dev_s,
                      "launches": count,
                      "launches_per_chunk_round": (None if count is None
                                                   else count / rounds),
                      "busy_share": None if dev_s is None else dev_s / wall}

    def per_cr(a, b):
        x, y = prof[a]["launches"], prof[b]["launches"]
        return None if x is None or y is None else (x - y) / rounds
    grid["profile"] = prof
    grid["rebalance_loop_launches_per_chunk_round"] = per_cr("rebal_alone",
                                                             "adapt_alone")
    grid["reissue_path_launches_per_chunk_round"] = per_cr(
        "grid_reissue", "grid_close_partial")
    for name, w in prof.items():
        busy = ("not measured" if w["busy_share"] is None
                else f"{w['busy_share']:.4f}")
        lcr = ("not measured" if w["launches_per_chunk_round"] is None
               else f"{w['launches_per_chunk_round']:.1f}")
        print(f"faults profile {name} (one {FAULT_CHUNK}-trial chunk x "
              f"{rounds} rounds, profiled): wall_s={w['wall_s']:.4f} "
              f"launches_per_chunk_round={lcr} busy_share={busy}")
    print(f"faults profile: rebalance loop launches per chunk-round="
          f"{grid['rebalance_loop_launches_per_chunk_round']} reissue path "
          f"launches per chunk-round="
          f"{grid['reissue_path_launches_per_chunk_round']}")

    # card against CPU on shared recorded fault traces
    tr = 1000
    rec = sweep_rounds(specs[:2] + specs[4:], proc, n, trials=tr, chunk=500,
                       deadline=deadline, deadline_policy="reissue",
                       record_trace=True, **kw).trace
    check(rec.has_faults, "recorded preemption trace has no +inf cell")
    ckw = dict(rounds=rounds, k=k, trials=tr, censored_feedback=True,
               deadline=deadline)
    for sp in (specs[0], specs[1], specs[4]):
        a = trajectory_samples(sp, rec, n, chunk=250, devices="cuda",
                               deadline_policy="reissue", **ckw)
        b = trajectory_samples(sp, rec, n, devices="cpu",
                               deadline_policy="reissue", **ckw)
        check(torch.equal(a.cpu(), b),
              f"{sp.name}: CUDA trajectories on the fault trace differ "
              f"from CPU")
    T1, T2 = tie_exact_tables(5, rounds, n, FAULT_CAP, tr)
    te = make_scenario("preemption", TraceProcess(DelayTrace(T1, T2)), n)
    te_trace = sweep_rounds([specs[0], specs[3]], te, n, trials=tr,
                            chunk=500, deadline=deadline,
                            deadline_policy="close_partial",
                            record_trace=True, **kw).trace
    check(te_trace.has_faults, "tie-exact preemption trace has no +inf")
    ckw.update(feedback_beta=0.5, coverage_gamma=0.5)
    for sp in (specs[2], specs[3]):
        for policy in ("close_partial", "reissue"):
            a = trajectory_samples(sp, te_trace, n, chunk=250,
                                   devices="cuda", deadline_policy=policy,
                                   **ckw)
            b = trajectory_samples(sp, te_trace, n, devices="cpu",
                                   deadline_policy=policy, **ckw)
            check(torch.equal(a.cpu(), b),
                  f"{sp.name} ({policy}): CUDA trajectories on the "
                  f"tie-exact fault trace differ from CPU")
    print(f"faults card vs CPU ({rounds} rounds x {tr} trials): cs/ss/lb "
          f"equal bit for bit on the recorded preemption trace (reissue); "
          f"adapt/rebal equal bit for bit on the tie-exact preemption trace "
          f"(close_partial and reissue)")
    return {"figures_seconds": fig_secs, "figures_launches": fig_launches,
            "figure_job_seconds": {nm: job["seconds"]
                                   for nm, job in done.items()},
            "status": status, "grid": grid}


#: the grid phase: the reference benchmark's grid (benchmarks/grid_stream.py,
#: n = 16, 64 cells in 4 buckets) at benchmarks/run.py's 20 000 trials
GRID_TRIALS = 20000
#: the racing planner's target (benchmarks/planner.py's K)
GRID_K = 16


def grid_phase():
    """The grid engine and the racing planner on the card.

    1. ``benchmarks_torch/grid_stream.py`` at full size (64 cells, n = 16,
       20 000 trials, one chunk): the grid streamed (cold: the evaluator
       cache cleared first) and the naive loop of per-cell sweeps on the
       stratified subset; every subset cell fused equals its per-cell
       sweep on the card bit for bit; one evaluator build per shape bucket.
       Then the grid once more under torch.profiler (warm): launches per
       fused dispatch and the card's busy share.
    2. Card against CPU: a 2-bucket sub-grid (loads 2 and 4) at 2 000
       trials, every mean within rel 1e-6 (the draws' last bits may
       differ: card and CPU evaluate the truncated Gaussian's arithmetic
       in their own libraries).
    3. A resumable sweep over the load-16 bucket's specs, extended over
       three rungs (313, 1 252, 5 008 trials in 313-trial chunks, the
       planner's ladder), bit-equal to a fresh card sweep at each.
    4. ``benchmarks_torch/planner.py`` at full size: ``plan`` (k = 16,
       eta = 4) names the exhaustive grid's ``best_cell`` with fewer
       trial-evaluations.
    5. A rounds cell through ``stream_grid``: the Fig. 8 cell (n = 12,
       r = 3, k = 9, 24 rounds, persistence 0.98, spread 3) with an
       adaptive CS spec beside CS and LB, 2 000 trials in 500-trial chunks
       on one shared trace drawn on the CPU: greedy_assign launched once a
       chunk-round (the counts set to 0 just before, read just after), and
       the cell's statistics bit-equal to the CPU's.
    6. ``python -m benchmarks_torch.run --quick --only grid,planner``:
       ``bitexact=PASS`` and ``agree=1``."""
    t_phase = time.perf_counter()
    out_dir = str(Path(__file__).resolve().parent / "bench_out_torch")
    streamed = grid_stream.run(GRID_TRIALS, "cuda", out=out_dir)
    check(streamed["bitexact"], "grid: fused cells differ from per-cell")
    check(streamed["cells"] == 64 and streamed["buckets"] == 4
          and streamed["builds"] == streamed["buckets"],
          f"grid: {streamed['builds']} evaluator builds for "
          f"{streamed['buckets']} buckets of {streamed['cells']} cells")
    cells = grid_stream._grid(GRID_TRIALS).cells(scenario1())
    wall, dev_s, count = profiled(lambda: stream_grid(cells, devices="cuda"))
    per_dispatch = (None if count is None
                    else count / streamed["fused_dispatches"])
    busy = None if dev_s is None else dev_s / wall
    print(f"grid stream (64 cells, n=16, {GRID_TRIALS} trials, one chunk): "
          f"{streamed['cells_per_sec']:.4f} cells/s streamed in "
          f"{streamed['seconds']:.4f} s ({streamed['fused_dispatches']} "
          f"fused dispatches, {streamed['builds']} evaluator builds for "
          f"{streamed['buckets']} buckets); naive "
          f"{streamed['naive_cells_per_sec']:.4f} cells/s on "
          f"{streamed['naive_cells']} cells in "
          f"{streamed['naive_seconds']:.4f} s; speedup "
          f"{streamed['speedup']:.4f}x; fused bit-equal to per-cell")
    # the host's share of a fused dispatch that is not a launch: each
    # load's layout (gather plans, windows and offsets of its 16 specs,
    # built in Python) and its copy to the card, on the card's host
    loads = {}
    for c in cells:
        loads.setdefault(c.r_max, []).append(
            dataclasses.replace(c.specs[0], name=c.name))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r_max, fused in loads.items():
        params = montecarlo._eval_layout(tuple(fused), 16, r_max, None)[1]
        montecarlo.params_on(params, DEV)
    torch.cuda.synchronize()
    layout_s = (time.perf_counter() - t0) / len(loads)
    print(f"grid profile (warm, profiled): wall_s={wall:.4f} launches per "
          f"fused dispatch="
          f"{'not measured' if per_dispatch is None else f'{per_dispatch:.1f}'}"
          f" busy_share="
          f"{'not measured' if busy is None else f'{busy:.4f}'}; host layout "
          f"and copy a fused dispatch {layout_s:.6f} s (of "
          f"{streamed['seconds'] / streamed['fused_dispatches']:.6f} s a "
          f"streamed dispatch)")

    sub = GridSpec(n=16, families=("cs", "ss", "ra", "lb", "pc", "pcmm"),
                   loads=(2, 4), messages=(None, 2), comm_eps=(0.0, 0.02),
                   trials=2000).cells(scenario1())
    on_card = stream_grid(sub, devices="cuda")
    on_cpu = stream_grid(sub, devices="cpu")
    check(on_card.meta["buckets"] == 2, "grid sub-grid buckets")
    worst = max(float(np.max(np.abs(on_card.cells[c.name]["means"][nm]
                                    - v) / np.abs(v)))
                for c in sub for nm, v in on_cpu.cells[c.name]["means"].items())
    check(worst <= 1e-6, f"grid card vs CPU means rel {worst:.3e} > 1e-6")
    print(f"grid card vs CPU ({len(sub)} cells, 2 buckets, 2000 trials): "
          f"means max rel diff {worst:.3e} (<= 1e-6)")

    specs = [dataclasses.replace(c.specs[0], name=c.name) for c in cells
             if c.r_max == 16]
    rs = resumable_sweep(specs, scenario1(), 16, chunk=313, devices="cuda")
    for total in (313, 1252, 5008):
        got = rs.extend_trials(total)
        fresh = sweep(specs, scenario1(), 16, trials=total, chunk=313,
                      devices="cuda")
        for sp in specs:
            check(np.array_equal(got.means[sp.name], fresh.means[sp.name])
                  and np.array_equal(got.stderr[sp.name],
                                     fresh.stderr[sp.name]),
                  f"resumable {sp.name} at {total} differs from a fresh "
                  f"card sweep")
    print(f"grid resumable sweep ({len(specs)} specs at r=16, rungs 313 / "
          f"1252 / 5008 in 313-trial chunks): bit-equal to fresh card "
          f"sweeps")

    raced = planner_bench.run(GRID_TRIALS, "cuda")
    check(raced["agree"] and raced["winner"] == raced["best"],
          f"planner {raced['winner']} vs exhaustive {raced['best']}")
    check(raced["trials_spent"] < raced["exhaustive_trials"],
          f"planner spent {raced['trials_spent']} trial-evaluations")
    print(f"grid planner (k={GRID_K}, eta=4, {GRID_TRIALS} trials): winner "
          f"{raced['winner']} = exhaustive best_cell; trial-evaluations "
          f"{raced['trials_spent']} of {raced['exhaustive_trials']} "
          f"(saved {raced['saved']:.4f}x); pruned {raced['pruned']}, raced "
          f"{raced['raced']}, {raced['rungs']} rungs; plan seconds "
          f"{raced['plan_seconds']:.4f}, exhaustive seconds "
          f"{raced['exhaustive_seconds']:.4f}")

    n, r, rounds, tr, chunk = fig8.N, fig8.R, fig8.ROUNDS, 2000, 500
    T1, T2 = fig8.cell_process(0.98, 3.0).sample_rounds(
        0, tr, n, r, rounds, device="cpu")
    proc = TraceProcess(DelayTrace(T1.numpy(), T2.numpy()))
    cs = cyclic_to_matrix(n, r)
    cell = GridCell("fig8/adapt", (adaptive_spec("adapt", cs),
                                   to_spec("cs", cs), lb_spec(r)),
                    n, proc, trials=tr, chunk=chunk, rounds=rounds, k=fig8.K)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card = stream_grid([cell], devices="cuda")
    rounds_s = time.perf_counter() - t0
    greedy = ops.LAUNCHES["greedy_assign"]
    want = rounds * (tr // chunk)
    check(greedy == want, f"grid rounds cell: greedy_assign launches "
                          f"{greedy} != {want} (one a chunk-round)")
    cpu = stream_grid([cell], devices="cpu")
    for key in ("per_round", "stderr", "wallclock", "wallclock_stderr"):
        for nm in ("adapt", "cs", "lb"):
            check(np.array_equal(card.cell(cell.name)[key][nm],
                                 cpu.cell(cell.name)[key][nm]),
                  f"grid rounds cell {key} {nm}: card differs from CPU")
    print(f"grid rounds cell (fig8 cell n={n} r={r} k={fig8.K}, {rounds} "
          f"rounds x {tr} trials in {chunk}-trial chunks, shared trace): "
          f"greedy_assign launches={greedy} (= rounds x chunks); card "
          f"equal to CPU bit for bit; seconds={rounds_s:.4f}")

    ops.reset_launch_counts()
    done = bench_run.main(["--quick", "--device", "cuda", "--only",
                           "grid,planner", "--out", out_dir])
    quick = {row["name"]: row["derived"] for job in done.values()
             for row in job["rows"]}
    check(quick["grid/speedup"]["bitexact"] == "PASS"
          and quick["planner/agreement"]["agree"] == 1,
          f"run --quick --only grid,planner: {quick}")
    print(f"grid run --quick --only grid,planner: bitexact=PASS agree=1; "
          f"seconds grid={done['grid']['seconds']:.4f} "
          f"planner={done['planner']['seconds']:.4f}")
    secs = time.perf_counter() - t_phase
    print(f"grid phase wall seconds={secs:.4f}")
    return {"stream": streamed, "profile": {
                "wall_s": wall, "device_kernel_s": dev_s, "launches": count,
                "launches_per_fused_dispatch": per_dispatch,
                "busy_share": busy, "host_layout_s_per_dispatch": layout_s},
            "card_vs_cpu_rel": worst, "planner": raced,
            "rounds_cell": {"greedy_launches": greedy, "seconds": rounds_s},
            "quick_seconds": {nm: job["seconds"]
                              for nm, job in done.items()},
            "cache": cache_stats(), "seconds": secs}


#: the live phase: the paper's EC2 cluster (Table I: n = 15 workers, r = 3,
#: every task's result a round) over Table I's 100 iterations
LIVE_N, LIVE_R, LIVE_K, LIVE_ROUNDS = 15, 3, 15, 100
#: the live phase's wide leg: adaptive under reissue past the warp route
LIVE_WIDE = dict(n=200, r=4, k=150, rounds=3)


def live_process(n):
    """The live phase's cluster: ``ec2_cluster(n, persistence=0.95,
    spread=3, base=scenario1())``."""
    return ec2_cluster(n, persistence=0.95, spread=3, base=scenario1())


def timed_live(cfg, process, rounds, **kw):
    """``run_live`` (on the card unless ``device=`` says otherwise) and its
    wall seconds, the card synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_live(cfg, process, rounds, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def shared_trace(n, r, rounds):
    """A trial-0 trace of ``live_process(n)`` drawn on the CPU, for card
    against CPU runs: the card's truncated-Gaussian draws (``erfinv``) may
    part from the CPU's in the last bits, as the grid phase notes."""
    T1, T2 = sample_delay_tables(live_process(n), 0, rounds, n, r,
                                 device="cpu")
    return TraceProcess(DelayTrace(T1[:, None], T2[:, None]))


def same_live(a, b, what):
    check(np.array_equal(a.per_round, b.per_round)
          and np.array_equal(a.realized, b.realized)
          and np.array_equal(a.missed, b.missed)
          and np.array_equal(a.trace.T1, b.trace.T1)
          and np.array_equal(a.trace.T2, b.trace.T2),
          f"live {what}: per_round / realized / missed / trace differ")


def live_phase():
    """The live master-worker cluster on the card (``repro_torch.live``):
    ``run_live`` with n in-process workers over ``inproc`` and over
    ``tcp://127.0.0.1:0``, the master scoring and scheduling on the card.

    1. Static CS at the EC2 size (``RoundConfig(n=15, k=15, kind="cs",
       r=3)`` on ``live_process(15)``, 100 rounds, ``time_scale=0``,
       ``abort_on_close=False``): ``per_round`` equal bit for bit to
       ``sweep_rounds(trials=1, record_trace=True)`` on the card (the
       trace too) and to the replay of the live trace through
       ``TraceProcess``; the tcp run equal to the inproc run (per_round
       and trace); the same live run on the card and on the CPU over one
       CPU-drawn trace, equal (per_round, realized, missed, trace).
    2. Deadline: ``close_partial`` at the run's median round: per_round,
       realized and missed equal the engine's degradation streams; at
       least one round misses and one does not.
    3. Adaptive, censored feedback under ``reissue`` (same deadline) on the
       shared trace: greedy_assign launched once a round (100; the counts
       set to 0 just before, read just after; the kernel's launches
       counted by torch.profiler in a second run, up to three tries where
       it drops events), the card's run equal to
       the CPU's (per_round, realized, trace).  The master's launches a
       round: the profiled run's kernels less the workers' table draws.
    4. Wide leg: n = 200, r = 4, k = 150, 3 rounds, adaptive under
       reissue on a CPU-drawn trace: 3 launches on greedy_assign's wide
       route, the card's run equal to the CPU's.
    5. Fig. 13: ``python -m benchmarks_torch.run --quick --only fig13`` on
       the card, every status row PASS.

    Prints each leg's wall seconds, the workers' table sampling apart
    (each of the n workers draws the full (rounds, n, r) tables, as the
    JAX package's workers do), and ms a round on inproc and tcp: the
    shared-trace runs' wall seconds less the workers' replayed draws,
    timed apart."""
    t_phase = time.perf_counter()
    n, r, k, rounds = LIVE_N, LIVE_R, LIVE_K, LIVE_ROUNDS
    proc = live_process(n)
    static = RoundConfig(n=n, k=k, kind="cs", r=r)
    spec = static.to_scheme_spec("cs")
    out = {"n": n, "r": r, "k": k, "rounds": rounds}
    run_live(static, proc, 2, abort_on_close=False)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        sample_delay_tables(proc, static.seed, rounds, n, r)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    out["sampling_seconds"] = sample_s

    # 1. static CS: the engine, the replay, tcp, the CPU
    card, card_s = timed_live(static, proc, rounds, abort_on_close=False)
    tcp, tcp_s = timed_live(static, proc, rounds, abort_on_close=False,
                            address="tcp://127.0.0.1:0")
    ekw = dict(rounds=rounds, trials=1, k=k, seed=static.seed)
    eng = sweep_rounds([spec], proc, n, record_trace=True, **ekw)
    rep = sweep_rounds([spec], TraceProcess(card.trace), n, **ekw)
    live32 = card.per_round.astype(np.float32)
    check(np.array_equal(live32, eng.per_round["cs"].astype(np.float32))
          and np.array_equal(card.trace.T1, eng.trace.T1)
          and np.array_equal(card.trace.T2, eng.trace.T2),
          "live static: card run differs from sweep_rounds(record_trace)")
    check(np.array_equal(live32, rep.per_round["cs"].astype(np.float32)),
          "live static: card run differs from its trace's replay")
    same_live(tcp, card, "static tcp vs inproc")
    check(card.realized.tolist() == [k] * rounds and not card.missed.any()
          and bool(np.isfinite(card.per_round).all()),
          "live static: a round short of k or non-finite")
    # the rounds themselves, over a shared trace (a worker's replayed
    # tables are a gather a round): ms a round on inproc and on tcp
    shared = shared_trace(n, r, rounds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        sample_delay_tables(shared, static.seed, rounds, n, r)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    on_card, sh_s = timed_live(static, shared, rounds, abort_on_close=False)
    on_tcp, sh_tcp_s = timed_live(static, shared, rounds,
                                  abort_on_close=False,
                                  address="tcp://127.0.0.1:0")
    on_cpu, cpu_s = timed_live(static, shared, rounds, abort_on_close=False,
                               device="cpu")
    same_live(on_tcp, on_card, "static tcp vs inproc (shared trace)")
    same_live(on_card, on_cpu, "static card vs CPU (shared trace)")
    draws = float(np.abs(card.trace.T1.astype(np.float64)
                         - shared.trace.T1).max())
    out["static"] = {"inproc_seconds": card_s, "tcp_seconds": tcp_s,
                     "shared_inproc_seconds": sh_s,
                     "shared_tcp_seconds": sh_tcp_s, "cpu_seconds": cpu_s,
                     "replay_sampling_seconds": replay_s,
                     "ms_per_round_inproc": (sh_s - replay_s) / rounds * 1e3,
                     "ms_per_round_tcp": (sh_tcp_s - replay_s) / rounds * 1e3,
                     "mean_ms": card.mean * 1e3,
                     "card_vs_cpu_draws_max_abs": draws}
    print(f"live static CS (n={n} r={r} k={k}, {rounds} rounds, "
          f"ec2_cluster persistence 0.95 spread 3): per_round equal bit for "
          f"bit to sweep_rounds(record_trace) and to the trace's replay on "
          f"the card; tcp equal to inproc; card equal to CPU on a shared "
          f"trace; mean {card.mean * 1e3:.6f} ms/round; wall seconds "
          f"inproc={card_s:.4f} tcp={tcp_s:.4f} (each with the workers' "
          f"draws); worker table sampling {n} x ({rounds}, {n}, {r}) "
          f"seconds={sample_s:.4f} (measured apart); on the shared trace "
          f"wall seconds inproc={sh_s:.4f} tcp={sh_tcp_s:.4f} cpu="
          f"{cpu_s:.4f}, the replayed draws {replay_s:.4f}, so ms a round "
          f"inproc={out['static']['ms_per_round_inproc']:.4f} tcp="
          f"{out['static']['ms_per_round_tcp']:.4f}; card vs CPU draws max "
          f"abs diff {draws:.3e}")

    # 2. deadline: close_partial at the median round
    dl = float(np.quantile(card.per_round, 0.5))
    cfg_dl = RoundConfig(n=n, k=k, kind="cs", r=r, deadline=dl,
                         deadline_policy="close_partial")
    res_dl, dl_s = timed_live(cfg_dl, proc, rounds, abort_on_close=False)
    eng_dl = sweep_rounds([spec], proc, n, deadline=dl,
                          deadline_policy="close_partial", record_trace=True,
                          **ekw)
    deg = eng_dl.degradation["cs"]
    check(np.array_equal(res_dl.per_round.astype(np.float32),
                         eng_dl.per_round["cs"].astype(np.float32))
          and np.array_equal(res_dl.realized.astype(np.float64),
                             deg["realized_k"])
          and np.array_equal(res_dl.missed.astype(np.float64),
                             deg["missed"]),
          "live deadline: per_round / realized / missed differ from the "
          "engine's degradation streams")
    missed = int(res_dl.missed.sum())
    check(0 < missed < rounds, f"live deadline: {missed}/{rounds} missed")
    out["deadline"] = {"seconds": dl_s, "deadline_ms": dl * 1e3,
                       "missed": missed,
                       "mean_realized_k": float(res_dl.realized.mean())}
    print(f"live deadline close_partial at {dl * 1e3:.6f} ms: per_round, "
          f"realized and missed equal the engine's degradation streams; "
          f"missed {missed}/{rounds}, mean realized k "
          f"{res_dl.realized.mean():.4f}; wall seconds={dl_s:.4f}")

    # 3. adaptive: censored feedback under reissue, on the shared trace
    cfg_ad = RoundConfig(n=n, k=k, kind="cs", r=r, adaptive=True,
                         censored_feedback=True, deadline=dl,
                         deadline_policy="reissue")
    ops.reset_launch_counts()
    ad_card, ad_s = timed_live(cfg_ad, shared, rounds)
    launches = dict(ops.LAUNCHES)
    check(launches["greedy_assign"] == rounds,
          f"live adaptive: greedy_assign launches {launches} != {rounds}")
    ad_cpu, ad_cpu_s = timed_live(cfg_ad, shared, rounds, device="cpu")
    same_live(ad_card, ad_cpu, "adaptive card vs CPU")
    _, _, draw_kernels = profiled(lambda: [sample_delay_tables(
        shared, 0, rounds, n, r) for _ in range(n)])
    # the kernel's launches as the profiler records them; it may drop an
    # event (one of 100 in one smoke on an H100), so up to three tries: the
    # gate is the wrapper's count above, and no try may see more than one
    # greedy_assign kernel a round
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = run_live(cfg_ad, shared, rounds)
            torch.cuda.synchronize()
        same_live(again, ad_card, "adaptive card, profiled run")
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        total = int(sum(e.count for e in kernels))
        greedy_prof = int(sum(e.count for e in kernels if "greedy" in e.key))
        check(greedy_prof <= rounds, f"live adaptive: the profiler counts "
                                     f"{greedy_prof} greedy_assign kernels")
        if greedy_prof == rounds:
            break
    if total and greedy_prof != rounds:
        print(f"chip_smoke: the profiler recorded {greedy_prof} of {rounds} "
              f"greedy_assign kernels in each of three tries (dropped "
              f"events)", file=sys.stderr)
    master_per_round = (None if not total or draw_kernels is None
                        else (total - draw_kernels) / rounds)
    out["adaptive"] = {
        "seconds": ad_s, "cpu_seconds": ad_cpu_s,
        "greedy_launches": launches["greedy_assign"],
        "greedy_need_launches": launches["greedy_assign_need"],
        "profiled_greedy_kernels": greedy_prof if total else None,
        "master_launches_per_round": master_per_round,
        "mean_ms": ad_card.mean * 1e3,
        "missed": int(ad_card.missed.sum()),
        "mean_realized_k": float(ad_card.realized.mean())}
    shown = ("not measured" if master_per_round is None
             else f"{master_per_round:.1f}")
    print(f"live adaptive censored reissue (n={n}, {rounds} rounds, deadline "
          f"{dl * 1e3:.6f} ms, shared trace): greedy_assign launches="
          f"{launches['greedy_assign']} (with need rows "
          f"{launches['greedy_assign_need']}; profiler: "
          f"{greedy_prof if total else 'not measured'} greedy kernels); "
          f"card equal to CPU bit for bit; master launches a round={shown}; "
          f"mean {ad_card.mean * 1e3:.6f} ms/round, missed "
          f"{int(ad_card.missed.sum())}/{rounds}; wall seconds card="
          f"{ad_s:.4f} cpu={ad_cpu_s:.4f}")

    # 4. the wide leg: n = 200 on greedy_assign's wide route
    nw, rw, kw, rounds_w = (LIVE_WIDE[key] for key in ("n", "r", "k",
                                                       "rounds"))
    wide = shared_trace(nw, rw, rounds_w)
    static_w = RoundConfig(n=nw, k=kw, kind="cs", r=rw)
    dl_w = float(np.median(sweep_rounds(
        [static_w.to_scheme_spec("cs")], wide, nw, rounds=rounds_w,
        trials=1, k=kw).per_round["cs"]))
    cfg_w = RoundConfig(n=nw, k=kw, kind="cs", r=rw, adaptive=True,
                        censored_feedback=True, deadline=dl_w,
                        deadline_policy="reissue")
    ops.reset_launch_counts()
    w_card, w_s = timed_live(cfg_w, wide, rounds_w)
    wl = dict(ops.LAUNCHES)
    check(wl["greedy_assign"] == rounds_w and ops.greedy_route(nw) == "wide",
          f"live wide: greedy_assign launches {wl} (route "
          f"{ops.greedy_route(nw)})")
    w_cpu, w_cpu_s = timed_live(cfg_w, wide, rounds_w, device="cpu")
    same_live(w_card, w_cpu, "wide card vs CPU")
    out["wide"] = {"seconds": w_s, "cpu_seconds": w_cpu_s,
                   "greedy_launches": wl["greedy_assign"],
                   "greedy_need_launches": wl["greedy_assign_need"],
                   "deadline_ms": dl_w * 1e3}
    print(f"live wide adaptive reissue (n={nw} r={rw} k={kw}, {rounds_w} "
          f"rounds, route={ops.greedy_route(nw)}): greedy_assign launches="
          f"{wl['greedy_assign']} (with need rows "
          f"{wl['greedy_assign_need']}); card equal to CPU bit for bit; "
          f"wall seconds card={w_s:.4f} cpu={w_cpu_s:.4f}")

    # 5. Fig. 13 through the harness
    out_dir = str(Path(__file__).resolve().parent / "bench_out_torch")
    done = bench_run.main(["--quick", "--device", "cuda", "--only", "fig13",
                           "--out", out_dir])
    status = {row["name"]: row["derived"]["status"]
              for row in done["fig13"]["rows"]}
    check(len(status) == 3 and set(status.values()) == {"PASS"},
          f"fig13 status rows {status}")
    out["fig13_seconds"] = done["fig13"]["seconds"]
    print(f"live fig13 (n=8 r=2 k=6, 20 rounds, seed 7): status rows "
          f"{status}; seconds={done['fig13']['seconds']:.4f}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"live phase wall seconds={out['seconds']:.4f}")
    return out


#: the benchmark jobs the figures phase runs (fig8 runs in rounds_phase)
FIGURE_JOBS = ("fig3", "fig4", "fig5", "fig6", "fig7", "fig9", "table1",
               "mc_engine")


def figures_phase():
    """The paper's figures, Table I and the engine benchmark at --quick on
    the card through ``python -m benchmarks_torch.run``'s main (every row
    printed; the harness exits non-zero on fig9's guards and on a non-finite
    metric), with the launch counts set to 0 just before and read just
    after: Table I's uncoded step is one one-pass gram_matvec launch, and no
    figure is adaptive (no greedy_assign launch).  Table I's three updates
    must hold their bounds (``ok``).  The ``*/claims`` rows are printed as
    they stand (the reference asserts none of them).  Then Theorem 1's mean
    (eqs. 7-8, joint survivals counted on the card) against the direct
    order statistic at (n, r, k) = (6, 3, 4) CS on scenario 1, relative 3 %
    (tests/test_theory.py's bound), and the lower bound (eq. 46) at or
    below the CS mean."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = bench_run.main(["--quick", "--device", "cuda", "--only",
                           ",".join(FIGURE_JOBS)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(sorted(done) == sorted(FIGURE_JOBS), f"figures ran {sorted(done)}")
    check(launches["gram_matvec"] == 1
          and launches["gram_matvec_onepass"] == 1
          and launches["greedy_assign"] == 0,
          f"figures: launches {launches} (want Table I's one one-pass "
          f"gram_matvec launch, no greedy_assign)")
    for row in done["table1"]["rows"]:
        check(row["derived"].get("ok") == "True",
              f"table1: {row['name']} {row['derived_raw']}")
    claims = {row["name"]: row["derived_raw"]
              for job in done.values() for row in job["rows"]
              if row["name"].endswith("/claims")}
    for name, job in done.items():
        print(f"figures {name}: seconds={job['seconds']:.3f} rows="
              f"{len(job['rows'])}")
    n, r, k = 6, 3, 4
    C, model = cyclic_to_matrix(n, r), scenario1()
    t_thm = theorem1_mean_mc(C, model, k, tmax=4e-3, trials=6000,
                             devices="cuda")
    t_mc = mean_completion_time(C, model, k, trials=6000, devices="cuda")
    t_lb = lower_bound_mean_mc(model, n, k, r=r, trials=6000,
                               devices="cuda")
    rel = abs(t_thm - t_mc) / t_mc
    check(rel < 0.03, f"Theorem 1 mean {t_thm} vs direct {t_mc}: rel "
                      f"{rel:.3e} >= 0.03")
    check(t_lb <= t_mc, f"lower bound {t_lb} above the CS mean {t_mc}")
    print(f"figures theorem1 (n={n} r={r} k={k} CS scenario1, 6000 trials on "
          f"the card): eqs. 7-8 mean {t_thm * 1e3:.6f} ms, direct "
          f"{t_mc * 1e3:.6f} ms, rel {rel:.3e} (< 0.03); lower bound "
          f"{t_lb * 1e3:.6f} ms")
    return {"seconds": secs,
            "job_seconds": {name: job["seconds"]
                            for name, job in done.items()},
            "claims": claims, "launches": launches,
            "theorem1": {"thm_ms": t_thm * 1e3, "direct_ms": t_mc * 1e3,
                         "rel": rel, "lb_ms": t_lb * 1e3}}


def dgd_leg(cfg, iters, cluster):
    """One DGD leg (CS/SS/RA/ADAPT/PC/PCMM) with launch counts."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    runs = dgd.run_paper(cfg, iters, device="cuda", cluster=cluster)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches["gram_matvec"] == 4 * iters
          and launches["gram_matvec_onepass"] == 4 * iters,
          f"{cluster}: gram_matvec launches {launches} != {4 * iters} "
          f"(CS/SS/RA/ADAPT x iters, all on the one-pass route)")
    check(launches["greedy_assign"] == iters,
          f"{cluster}: greedy_assign launches {launches} != {iters} "
          f"(ADAPT x iters)")
    prob = dgd.paper_problem(cfg, device="cuda")
    loss0 = dgd.loss_of(torch.zeros(cfg.d, device=DEV), prob.X, prob.y)
    for name, run in runs.items():
        loss = dgd.loss_of(run.theta, prob.X, prob.y)
        note = ""
        if (cluster, name) == ("markov", "PCMM"):
            # reference caveat: PCMM's decode from the 2n-1 earliest slot
            # results is ill-conditioned at n=15, and on the Markov
            # cluster the JAX example's PCMM diverges as well (ROADMAP.md
            # section 3); reported, not asserted
            note = " (not asserted: ill-conditioned decode at n=15)"
        else:
            check(np.isfinite(loss) and loss < loss0,
                  f"{cluster} {name} loss did not fall: {loss0} -> {loss}")
        print(f"dgd {cluster} {name}: loss {loss0:.5f} -> {loss:.5f} "
              f"virtual {run.clock * 1e3:.3f} ms{note}")
    print(f"dgd {cluster} seconds={secs:.3f} for {iters} iterations x "
          f"{len(runs)} schemes; gram_matvec launches="
          f"{launches['gram_matvec']} greedy_assign launches="
          f"{launches['greedy_assign']}")
    return prob, launches, secs


def dgd_tall_leg(iters=5, b=8):
    """The uncoded DGD loop (CS at the paper's n=15, r=3, k=15) on tasks of
    b samples whose feature dim is one past the tallest column the one-pass
    gram_matvec route holds, so every worker step takes the two-pass kernel:
    the launch counts set to 0 just before, read just after; the loss must
    fall.  Returns the counts and the seconds."""
    cfg = RegressionConfig()
    N, d = cfg.n * b, ops.gram_onepass_max_d(b, torch.float32) + 1
    gen = torch.Generator(device=DEV).manual_seed(2)
    X = torch.randn(N, d, generator=gen, device=DEV) / d ** 0.5
    y = torch.randn(N, generator=gen, device=DEV)
    prob = dgd.regression_problem(X, y, cfg.n)
    rc = RoundConfig(n=cfg.n, k=cfg.k, kind="cs", r=cfg.r)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # X X^T is close to the identity at this scale: lr = N / 4 halves the
    # residual each iteration
    run = dgd.run_uncoded(rc, dgd.paper_cluster(cfg.n), prob, iters, N / 4,
                          label="CS")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches["gram_matvec"] == iters
          and launches["gram_matvec_onepass"] == 0,
          f"tall DGD: gram_matvec launches {launches}, expected {iters} on "
          f"the two-pass route")
    loss0 = dgd.loss_of(torch.zeros(d, device=DEV), X, y)
    loss = dgd.loss_of(run.theta, X, y)
    check(np.isfinite(loss) and loss < loss0,
          f"tall DGD loss did not fall: {loss0} -> {loss}")
    print(f"dgd tall (N={N} d={d} n={cfg.n}, two-pass gram_matvec) CS: loss "
          f"{loss0:.5f} -> {loss:.5f} in {iters} iterations, {secs:.3f} s, "
          f"launches {launches['gram_matvec']}")
    return launches, secs


def dgd_phase():
    """The paper's DGD loop at RegressionConfig() for 100 iterations on the
    card, on the iid and on the Markov cluster, and the Table I one-step
    check."""
    cfg = RegressionConfig()
    iters = 100
    prob, launches_iid, secs_iid = dgd_leg(cfg, iters, "iid")
    _, launches_markov, secs_markov = dgd_leg(cfg, iters, "markov")
    launches_tall, secs_tall = dgd_tall_leg()
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
    return {"iid": launches_iid, "markov": launches_markov,
            "tall": launches_tall,
            "seconds": {"iid": secs_iid, "markov": secs_markov,
                        "tall": secs_tall}}


def swa_pairs(T, W):
    """Visible (query, key) pairs of causal window-W attention over T
    positions: sum over t of min(t + 1, W)."""
    W = min(W, T)
    return W * (W + 1) // 2 + (T - W) * W


def swa_bound(B, T, H, K, dh, W, dtype):
    """Least time for swa_attention: 4 * dh flops per visible pair (QK^T and
    PV) over the least time the card takes for them at the input type's
    accuracy, vs q, k, v read and o written once over the HBM rate.
    bfloat16: the bf16 tensor-core rate.  float32: the CUDA cores' FMA rate
    or three TF32 tensor-core products a float32 product, whichever is
    faster.  Returns (ms, "bytes" or "operations", {bound name: ms}) with
    both float32 bounds named."""
    item = 2 if dtype == torch.bfloat16 else 4
    flops = 4 * dh * swa_pairs(T, W) * B * H
    if dtype == torch.bfloat16:
        named = {"bf16": flops / BF16_FLOPS_PER_S}
    else:
        named = {"fma": flops / F32_FLOPS_PER_S,
                 "tf32x3": 3 * flops / TF32_FLOPS_PER_S}
    t_ops = min(named.values())
    t_bytes = (2 * B * T * H * dh + 2 * B * T * K * dh) * item / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            {k: v * 1e3 for k, v in named.items()})


def sdpa_banded(q, k, v, W):
    """One library call computing the same function (timing yardstick only;
    the port never calls it): inputs laid out and KV heads repeated for
    ``scaled_dot_product_attention`` with a boolean band mask."""
    T, G = q.shape[1], q.shape[2] // k.shape[2]
    pos = torch.arange(T, device=q.device)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band)


def cuda_core_kernel(q, k, v, W):
    """The CUDA-core kernel (csrc/swa_attention.cu), the route of bfloat16
    before the wgmma kernel and of float32 before the float32 tensor-core
    kernel, on inputs that now take a tensor-core route: timing of the
    earlier kernel only, launched past the wrapper and not counted."""
    B, T, H, dh = q.shape
    out = torch.empty_like(q)
    lib = build.library("swa_attention")
    stream = torch.cuda.current_stream().cuda_stream
    dt = 0 if q.dtype == torch.float32 else 1
    return lambda: lib.swa_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H,
        k.shape[2], dh, min(W, T), dt, stream)


#: the swa layers' attention shape in consistency_phase's bfloat16 leg
#: (gemma3-4b's smoke width with dh 32): (B, T, H, K, dh, W)
NARROW_SWA = (2, 48, 4, 2, 32, 32)
#: the swa layers' attention shapes in consistency_phase's float32 leg
#: (gemma3-4b at full width): the full forward of 1 040 tokens and the
#: 1 024-token prefill
F32_LM_SWA = [(2, 1040, 8, 4, 256, 1024), (2, 1024, 8, 4, 256, 1024)]


def swa_phase():
    """swa_attention against its plain version at the JAX kernel tests'
    shapes (B = 1, K = H; float32 and bfloat16), window 1, two grouped
    shapes with ragged tiles, the shapes of the LM legs of
    consistency_phase, the gemma3-4b prefill shape and one long shape; each
    call's route (float32: its tensor-core kernel; bfloat16:
    wgmma at dh 64-256, CUDA cores at dh 16 / 32) checked by the launch
    counts.  float32: max-abs 2e-4, from tests/test_kernels.py, and the
    float64 guard: against a float64 evaluation of the same inputs the
    kernel's max-abs error is at most 10x the plain float32 version's own
    (error-compensated TF32 keeps float32 accuracy; one TF32 product would
    miss the guard by orders of magnitude).  bfloat16: elementwise |got -
    want| <= 1e-3 + 1e-2 |want|, which scales with the output (a band of
    ~1 000 keys gives outputs of std ~0.03, so a flat 3e-2 would pass an
    off-by-one window edge) and still admits the one-ulp bf16 rounding
    difference."""
    jax_shapes = [(128, 2, 64, 32), (200, 1, 32, 64), (256, 2, 128, 100),
                  (64, 4, 16, 8), (96, 1, 64, 96), (130, 2, 32, 17),
                  (64, 1, 32, 1)]
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(1, T, H, H, dh, W, dt) for T, H, dh, W in jax_shapes
              for dt in (f32, bf16)]
    shapes += [(2, 300, 8, 4, 256, 70, dt) for dt in (f32, bf16)]  # ragged
    shapes += [(2, 129, 8, 1, 128, 1000, dt) for dt in (f32, bf16)]  # K = 1
    shapes += [NARROW_SWA + (bf16,)]                # the dh-32 bf16 LM leg
    shapes += [shape + (f32,) for shape in F32_LM_SWA]   # the f32 LM leg
    shapes += [(2, 2048, 8, 4, 256, 1024, bf16),                  # gemma
               (2, 2048, 8, 4, 256, 1024, f32),                   # prefill
               (1, 16384, 8, 4, 256, 8192, bf16)]                 # long
    gen = torch.Generator(device=DEV).manual_seed(3)
    rows = []
    for B, T, H, K, dh, W, dt in shapes:
        q = (torch.randn(B, T, H, dh, generator=gen, device=DEV) * 0.5).to(dt)
        k = (torch.randn(B, T, K, dh, generator=gen, device=DEV) * 0.5).to(dt)
        v = torch.randn(B, T, K, dh, generator=gen, device=DEV).to(dt)
        route = ops.swa_route(dt, dh)
        check(route == ("tensor_core_f32" if dt == f32 else "tensor_core"
                        if dh >= 64 else "cuda_core"),
              f"swa_route {route} for {dt} at dh {dh}")
        before = dict(ops.LAUNCHES)
        got = ops.swa_attention(q, k, v, window=W)
        want = ref.swa_attention_ref(q, k, v, W)
        torch.cuda.synchronize()
        check(got.dtype == dt and got.shape == q.shape,
              f"swa output {got.dtype} {tuple(got.shape)}")
        counts = {name: ops.LAUNCHES[name] - before[name]
                  for name in ("swa_attention", "swa_attention_wgmma",
                               "swa_attention_f32")}
        check(counts == {"swa_attention": 1,
                         "swa_attention_wgmma": int(route == "tensor_core"),
                         "swa_attention_f32": int(route == "tensor_core_f32")},
              f"swa_attention at {(B, T, H, K, dh, W, dt)} did not take the "
              f"{route} route: launches {counts}")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        guard = ""
        if dt == f32:
            check(err < 2e-4, f"swa_attention max abs err {err:.2e} >= 2e-4"
                              f" at {(B, T, H, K, dh, W, dt)}")
            exact = ref.swa_attention_ref(q.double(), k.double(), v.double(), W)
            err64 = (got.double() - exact).abs().max().item()
            plain64 = (want.double() - exact).abs().max().item()
            del exact
            check(err64 <= 10 * plain64,
                  f"swa_attention float64 guard: error {err64:.3e} > 10 x the "
                  f"plain float32 version's {plain64:.3e} at "
                  f"{(B, T, H, K, dh, W, dt)}")
            ratio = err64 / plain64 if plain64 else (0.0 if err64 == 0
                                                     else float("inf"))
            guard = (f" f64_err={err64:.3e} plain_f64_err={plain64:.3e} "
                     f"guard_ratio={ratio:.3f} (<= 10)")
        else:
            worst = (diff / (1e-3 + 1e-2 * want.float().abs())).max().item()
            check(worst <= 1, f"swa_attention |got - want| exceeds 1e-3 + "
                              f"1e-2 |want| {worst:.2f}x (max abs err "
                              f"{err:.2e}) at {(B, T, H, K, dh, W, dt)}")
        del diff
        if W == 1:
            err1 = (got.float() - v.float()).abs().max().item()
            check(err1 < 1e-5 if dt == f32 else err1 == 0,
                  f"swa_attention window 1 is not v: {err1:.2e}")
        del want
        big = T * T * B * H > 2 ** 27
        kernel = lambda: ops.swa_attention(q, k, v, window=W)  # noqa: E731
        row = dict(shape=[B, T, H, K, dh, W], dtype=str(dt).split(".")[-1],
                   swa_route=route, max_abs_err=err,
                   ms=cuda_ms(kernel, 5 if big else 50),
                   plain_ms=cuda_ms(lambda: ref.swa_attention_ref(q, k, v, W),
                                    2 if big else 20),
                   library_ms=cuda_ms(sdpa_banded(q, k, v, W),
                                      5 if big else 50))
        row["bound_ms"], row["bound_by"], named = swa_bound(B, T, H, K, dh,
                                                            W, dt)
        row["tflop_per_s"] = 4 * dh * swa_pairs(T, W) * B * H / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        extra = guard
        if dt == f32:
            row.update(f64_err=err64, plain_f64_err=plain64, guard_ratio=ratio,
                       device_ms=device_ms(kernel, 20 if big else 50),
                       fma_bound_ms=named["fma"],
                       tf32x3_bound_ms=named["tf32x3"])
            extra += (f" device_ms={ms_text(row['device_ms'])} fma_bound_ms="
                      f"{named['fma']:.5f} tf32x3_bound_ms="
                      f"{named['tf32x3']:.5f}")
        if route != "cuda_core" and T >= 2048:
            row["cuda_core_ms"] = cuda_ms(cuda_core_kernel(q, k, v, W),
                                          3 if big else 20)
            extra += f" cuda_core_ms={row['cuda_core_ms']:.5f} (earlier kernel)"
        rows.append(row)
        print(f"kernel swa_attention B={B} T={T} H={H} K={K} dh={dh} W={W} "
              f"{row['dtype']} route={route}: max_abs_err={err:.3e} "
              f"ms={row['ms']:.5f} ({row['tflop_per_s']:.1f} TFLOP/s, "
              f"{row['bound_share']:.3f} of bound) plain_ms="
              f"{row['plain_ms']:.5f} library_ms={row['library_ms']:.5f} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}){extra}")
        del q, k, v, got
        torch.cuda.empty_cache()
    return rows


SERVE = dict(batch=2, prompt_len=2048, gen=32)


def serve_phase():
    """gemma3-4b at full width and depth, bf16, random weights from seed 0
    on the card, through the serve CLI: a warm-up run (one decode step),
    then the measured run with the launch counts set to 0 just before it.
    Exactly one swa_attention launch per sliding-window layer in the
    prefill, all on the tensor-core route, none in decode; every logit
    finite; tokens of the right shape and range."""
    cfg = get_config("gemma3-4b")
    n_swa = sum(s.mixer == "swa" for s in layer_specs(cfg))
    check(cfg.n_layers == 34 and n_swa == 29 and cfg.d_model == 2560,
          f"gemma3-4b config: {cfg.n_layers} layers, {n_swa} swa")
    argv = ["--arch", "gemma3-4b", "--batch", str(SERVE["batch"]),
            "--prompt-len", str(SERVE["prompt_len"]), "--seed", "0"]
    serve.main(argv + ["--gen", "2"])                          # warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    res = serve.main(argv + ["--gen", str(SERVE["gen"])])
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(res.launches_after_prefill["swa_attention"] == n_swa,
          f"serve prefill swa_attention launches "
          f"{res.launches_after_prefill} != {n_swa}")
    check(res.launches_after_prefill["swa_attention_wgmma"] == n_swa,
          f"serve prefill tensor-core launches "
          f"{res.launches_after_prefill} != {n_swa}")
    check(launches["swa_attention"] == n_swa
          and launches["swa_attention_wgmma"] == n_swa
          and launches["swa_attention_f32"] == 0,
          f"swa_attention launched in decode: {launches}")
    check(res.finite, "serve: non-finite logits")
    B, P, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    check(tuple(res.tokens.shape) == (B, G), f"tokens {tuple(res.tokens.shape)}")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "serve: token out of the vocabulary")
    out = {"prefill_ms": res.prefill_s * 1e3,
           "prefill_tok_per_s": B * P / res.prefill_s,
           "decode_ms_per_step": res.decode_s * 1e3 / (G - 1),
           "decode_tok_per_s": B * (G - 1) / res.decode_s,
           "peak_mem_bytes": peak, "mem_before_bytes": base,
           "swa_launches": launches["swa_attention"],
           "wgmma_launches": launches["swa_attention_wgmma"],
           "f32_launches": launches["swa_attention_f32"]}
    print(f"serve gemma3-4b 34 layers bf16 batch={B} prompt={P} gen={G}: "
          f"prefill {out['prefill_ms']:.3f} ms ({out['prefill_tok_per_s']:.1f}"
          f" tok/s), decode {out['decode_ms_per_step']:.4f} ms/step "
          f"({out['decode_tok_per_s']:.1f} tok/s), peak memory {peak} bytes "
          f"({base} allocated before the run), "
          f"swa_attention launches {launches['swa_attention']} (prefill "
          f"{res.launches_after_prefill['swa_attention']}, tensor-core "
          f"{launches['swa_attention_wgmma']})")
    return out


@torch.inference_mode()
def consistency_phase():
    """(1) gemma3-4b at full width, 7 layers (6 swa, 1 gqa), float32: the
    full forward without a cache (kernel route) against a 1024-token
    prefill plus 16 decode steps (kernel, then the ring route) at the same
    positions, max abs logit difference < 2e-3 (tests/test_models.py's
    decode-vs-full bound); the launch counts are set to 0 just before and
    read after: one launch of the float32 tensor-core kernel per swa layer
    for the forward and for the prefill, none of the other two.  (2) the
    7-layer smoke-width config on the card against the same weights on the
    CPU, relative difference < 1e-4.  (3) the same config in bfloat16 with
    heads of dh 32, the CUDA-core kernel's route (counts set to 0 just
    before, one launch per swa layer): its card logits are no further from
    the CPU's float32 logits than twice the CPU's own bfloat16 logits
    are."""
    cfg = dataclasses.replace(get_config("gemma3-4b"), n_layers=7,
                              param_dtype="float32", dtype="float32")
    specs = layer_specs(cfg)
    check(sum(s.mixer == "swa" for s in specs) == 6, "7-layer plan")
    model = init_params(cfg, seed=1, device=DEV)
    B, P, steps = 2, 1024, 16
    gen = torch.Generator(device=DEV).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, P + steps), generator=gen,
                         device=DEV)
    ops.reset_launch_counts()
    full, _, _ = forward(model, cfg, toks)
    full = full[:, P:].clone()
    cache = init_cache(cfg, B, P + steps + 8, device=DEV)
    _, _, cache = forward(model, cfg, toks[:, :P], cache=cache)
    worst = 0.0
    for t in range(steps):
        lg, _, cache = forward(model, cfg, toks[:, P + t:P + t + 1],
                               cache=cache)
        worst = max(worst, (lg[:, 0] - full[:, t]).abs().max().item())
    launches = dict(ops.LAUNCHES)
    check(launches["swa_attention"] == 12
          and launches["swa_attention_f32"] == 12
          and launches["swa_attention_wgmma"] == 0,
          f"f32 LM path: swa_attention launches {launches} (want 12 on the "
          f"float32 tensor-core route)")
    check(worst < 2e-3, f"decode vs full (ring vs kernel) {worst:.2e}")
    print(f"consistency gemma3-4b 7 layers f32: full forward vs prefill "
          f"{P} + {steps} decode steps max abs logit diff {worst:.3e}; "
          f"swa_attention launches {launches['swa_attention']} (float32 "
          f"tensor-core {launches['swa_attention_f32']})")
    del model, full, cache
    torch.cuda.empty_cache()

    small = dataclasses.replace(get_config("gemma3-4b").smoke(), n_layers=7)
    cpu_model = init_params(small, seed=2, device="cpu")
    gpu_model = init_params(small, seed=2, device="cpu").to(DEV)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, small.vocab_size, (2, 48)))
    a, _, _ = forward(gpu_model, small, toks.to(DEV))
    b, _, _ = forward(cpu_model, small, toks)
    rel_full = ((a.cpu() - b).abs().max() / b.abs().max()).item()
    ca = init_cache(small, 2, 64, device=DEV)
    cb = init_cache(small, 2, 64, device="cpu")
    a, _, ca = forward(gpu_model, small, toks[:, :40].to(DEV), cache=ca)
    b, _, cb = forward(cpu_model, small, toks[:, :40], cache=cb)
    rel_dec = ((a.cpu() - b).abs().max() / b.abs().max()).item()
    for t in range(40, 48):
        a, _, ca = forward(gpu_model, small, toks[:, t:t + 1].to(DEV), cache=ca)
        b, _, cb = forward(cpu_model, small, toks[:, t:t + 1], cache=cb)
        rel_dec = max(rel_dec, ((a.cpu() - b).abs().max()
                                / b.abs().max()).item())
    check(rel_full < 1e-4 and rel_dec < 1e-4,
          f"card vs CPU logits rel {rel_full:.2e} (full), {rel_dec:.2e} "
          f"(prefill + decode)")
    print(f"consistency {small.name} x7 f32 card vs CPU: rel diff "
          f"{rel_full:.3e} (full forward), {rel_dec:.3e} (prefill 40 + 8 "
          f"decode steps)")

    narrow = dataclasses.replace(small, head_dim=32)
    narrow16 = dataclasses.replace(narrow, param_dtype="bfloat16",
                                   dtype="bfloat16")
    f32_model = init_params(narrow, seed=4, device="cpu")
    weights = {k: v.to(torch.bfloat16)
               for k, v in f32_model.state_dict().items()}
    cpu16 = init_params(narrow16, seed=4, device="cpu")
    cpu16.load_state_dict(weights)
    gpu16 = init_params(narrow16, seed=4, device=DEV)
    gpu16.load_state_dict(weights)
    ops.reset_launch_counts()
    a, _, _ = forward(gpu16, narrow16, toks.to(DEV))
    narrow_launches = dict(ops.LAUNCHES)
    b, _, _ = forward(cpu16, narrow16, toks)
    c, _, _ = forward(f32_model, narrow, toks)
    rel_card = ((a.float().cpu() - c).abs().max() / c.abs().max()).item()
    rel_cpu = ((b.float() - c).abs().max() / c.abs().max()).item()
    check(narrow_launches["swa_attention"] == 6
          and narrow_launches["swa_attention_wgmma"] == 0
          and narrow_launches["swa_attention_f32"] == 0,
          f"bf16 dh-32 LM path: swa_attention launches {narrow_launches} "
          f"(want 6 on the CUDA-core route)")
    check(bool(torch.isfinite(a).all()) and rel_card <= 2 * rel_cpu,
          f"bf16 dh-32 card logits rel {rel_card:.3e} from the float32 ones,"
          f" the CPU's bf16 {rel_cpu:.3e}")
    print(f"consistency {narrow16.name} dh 32 x7 bf16: card vs CPU float32 "
          f"rel diff {rel_card:.3e} (the CPU's own bf16: {rel_cpu:.3e}); "
          f"swa_attention launches {narrow_launches['swa_attention']} "
          f"(CUDA-core)")
    return {"decode_vs_full": worst, "card_vs_cpu": max(rel_full, rel_dec),
            "swa_launches": launches["swa_attention"],
            "f32_launches": launches["swa_attention_f32"],
            "f32_wgmma_launches": launches["swa_attention_wgmma"],
            "narrow_bf16_rel": rel_card, "narrow_bf16_cpu_rel": rel_cpu,
            "cuda_core_launches": narrow_launches["swa_attention"],
            "narrow_wgmma_launches": narrow_launches["swa_attention_wgmma"],
            "narrow_f32_launches": narrow_launches["swa_attention_f32"]}


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
                if "registers" in ln or "spill" in ln or "arning" in ln))
    rows, tall_launches = kernel_phase()
    greedy_rows = greedy_phase()
    engine = engine_phase()
    rounds = rounds_phase()
    adaptive_wide = adaptive_wide_leg()
    # again under reissue, the deadline at the card's median round close
    wide_deadline = float(adaptive_wide.pop("trajectories").median())
    wide_reissue = adaptive_wide_leg(deadline=wide_deadline)
    del wide_reissue["trajectories"]
    wide_reissue["deadline_ms"] = wide_deadline * 1e3
    dgd_launches = dgd_phase()
    figures = figures_phase()
    faults = faults_phase()
    swa_rows = swa_phase()
    served = serve_phase()
    consistency = consistency_phase()
    grid = grid_phase()
    live = live_phase()
    main_row = rows[0]                 # the DGD shape, float32
    tp_row = next(r for r in rows if r["route"] == "twopass"
                  and r["shape"][0] == 15)      # the dgd-tall shape
    g_row = greedy_rows[1]             # the Fig. 8 chunk (2000, 12, 3)
    wide_rows = [r for r in greedy_rows if r["route"] == "wide"]
    gemma = [2, 2048, 8, 4, 256, 1024]    # the gemma3-4b prefill shape
    t_row = next(r for r in swa_rows if r["shape"] == gemma
                 and r["dtype"] == "bfloat16")
    c_row = next(r for r in swa_rows if r["shape"] == gemma
                 and r["dtype"] == "float32")      # the yardstick vs SDPA
    f_row = next(r for r in swa_rows if r["shape"] == list(F32_LM_SWA[1])
                 and r["dtype"] == "float32")   # the f32 LM leg's prefill
    n_row = next(r for r in swa_rows if r["shape"] == list(NARROW_SWA)
                 and r["dtype"] == "bfloat16")   # the dh-32 bf16 LM leg
    print(json.dumps({"kernels": [{
        "name": "gram_matvec_onepass", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram_matvec_onepass.cu",
        "replaces": "src/repro/kernels/gram_matvec.py:67",
        "launches": dgd_launches["markov"]["gram_matvec_onepass"],
        "launches_by_path": {
            **{f"dgd_{leg}": dgd_launches[leg]["gram_matvec_onepass"]
               for leg in ("iid", "markov", "tall")},
            "table1": figures["launches"]["gram_matvec_onepass"]},
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "card": card,
        "shapes": [r for r in rows if r["route"] == "onepass"]}, {
        "name": "gram_matvec", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram_matvec.cu",
        "replaces": "src/repro/kernels/gram_matvec.py:67",
        "launches": dgd_launches["tall"]["gram_matvec"],
        "launches_by_path": {
            f"dgd_{leg}": dgd_launches[leg]["gram_matvec"]
            - dgd_launches[leg]["gram_matvec_onepass"]
            for leg in ("iid", "markov", "tall")},
        "kernel_phase_launches": tall_launches,
        "max_abs_err": tp_row["max_abs_err"],
        "ms": tp_row["ms"], "device_ms": tp_row["device_ms"],
        "plain_ms": tp_row["plain_ms"],
        "bound_ms": tp_row["bound_ms"], "bound_by": tp_row["bound_by"],
        "library_ms": tp_row["library_ms"],
        "library_device_ms": tp_row["library_device_ms"], "card": card,
        "split_device_ms_at_onepass_shapes": {
            f"{r['shape']} {r['dtype']}": r["split_device_ms"]
            for r in rows if r["route"] == "onepass"},
        "shapes": [r for r in rows if r["route"] == "twopass"]}, {
        "name": "greedy_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/greedy_assign.cu",
        "replaces": "src/repro/kernels/greedy_assign.py:73",
        "launches": rounds["greedy_launches"],
        "launches_by_path": {
            "fig8": rounds["greedy_launches"],
            "dgd_iid": dgd_launches["iid"]["greedy_assign"],
            "dgd_markov": dgd_launches["markov"]["greedy_assign"],
            "adaptive_n200": adaptive_wide["launches"],
            "adaptive_n200_reissue": wide_reissue["launches"],
            "fig10_12": faults["figures_launches"]["greedy_assign"],
            "grid_rounds_cell": grid["rounds_cell"]["greedy_launches"],
            "faults_grid_close_partial":
                faults["grid"]["close_partial"]["greedy_launches"],
            "faults_grid_reissue":
                faults["grid"]["reissue"]["greedy_launches"],
            "live_adaptive": live["adaptive"]["greedy_launches"],
            "live_wide": live["wide"]["greedy_launches"]},
        "need_row_launches_by_path": {
            "faults_grid_reissue":
                faults["grid"]["reissue"]["greedy_need_launches"],
            "adaptive_n200_reissue": wide_reissue["need_launches"],
            "live_adaptive": live["adaptive"]["greedy_need_launches"],
            "live_wide": live["wide"]["greedy_need_launches"]},
        "max_abs_err": g_row["max_abs_err"],
        "ms": g_row["ms"], "device_ms": g_row["device_ms"],
        "n1_device_ms": g_row["n1_device_ms"], "pick_us": g_row["pick_us"],
        "plain_ms": g_row["plain_ms"],
        "bound_ms": g_row["bound_ms"], "bound_by": g_row["bound_by"],
        "library_ms": None, "card": card, "shapes": greedy_rows,
        "wide_shapes": {str(r["shape"]): {key: r[key] for key in (
            "route", "smem", "max_abs_err", "ms", "device_ms",
            "n1_device_ms", "pick_us", "dense_device_ms", "plain_ms",
            "bound_ms", "bound_by")} for r in wide_rows}}, {
        "name": "swa_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention.cu",
        "replaces": "src/repro/kernels/swa_attention.py:73",
        "launches": consistency["cuda_core_launches"],
        "launches_by_path": {"lm_bf16_dh32": consistency["cuda_core_launches"],
                             "lm_f32": consistency["swa_launches"]
                             - consistency["f32_launches"]
                             - consistency["f32_wgmma_launches"],
                             "serve": served["swa_launches"]
                             - served["wgmma_launches"]
                             - served["f32_launches"]},
        "max_abs_err": n_row["max_abs_err"],
        "ms": n_row["ms"], "plain_ms": n_row["plain_ms"],
        "bound_ms": n_row["bound_ms"], "bound_by": n_row["bound_by"],
        "library_ms": n_row["library_ms"], "card": card,
        "f32_gemma_ms": c_row["cuda_core_ms"],
        "shapes": [r for r in swa_rows if r["swa_route"] == "cuda_core"]}, {
        "name": "swa_attention_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention_f32.cu",
        "replaces": "src/repro/kernels/swa_attention.py:73",
        "launches": consistency["f32_launches"],
        "launches_by_path": {"lm_f32": consistency["f32_launches"],
                             "lm_bf16_dh32": consistency["narrow_f32_launches"],
                             "serve": served["f32_launches"]},
        "max_abs_err": f_row["max_abs_err"],
        "guard_ratio": f_row["guard_ratio"],
        "ms": f_row["ms"], "device_ms": f_row["device_ms"],
        "plain_ms": f_row["plain_ms"],
        "bound_ms": f_row["bound_ms"], "bound_by": f_row["bound_by"],
        "fma_bound_ms": f_row["fma_bound_ms"],
        "tf32x3_bound_ms": f_row["tf32x3_bound_ms"],
        "library_ms": f_row["library_ms"], "card": card,
        "gemma_prefill_2048": {key: c_row[key] for key in (
            "max_abs_err", "guard_ratio", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "fma_bound_ms", "tf32x3_bound_ms",
            "library_ms", "cuda_core_ms")},
        "shapes": [r for r in swa_rows
                   if r["swa_route"] == "tensor_core_f32"]}, {
        "name": "swa_attention_wgmma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention_wgmma.cu",
        "replaces": "src/repro/kernels/swa_attention.py:73",
        "launches": served["wgmma_launches"],
        "launches_by_path": {
            "serve": served["wgmma_launches"],
            "lm_f32": consistency["f32_wgmma_launches"],
            "lm_bf16_dh32": consistency["narrow_wgmma_launches"]},
        "max_abs_err": t_row["max_abs_err"],
        "ms": t_row["ms"], "plain_ms": t_row["plain_ms"],
        "bound_ms": t_row["bound_ms"], "bound_by": t_row["bound_by"],
        "library_ms": t_row["library_ms"],
        "cuda_core_ms": t_row["cuda_core_ms"], "card": card,
        "shapes": [r for r in swa_rows if r["swa_route"] == "tensor_core"]}],
        "engine": engine, "rounds": rounds, "adaptive_wide": adaptive_wide,
        "adaptive_wide_reissue": wide_reissue, "figures": figures,
        "faults": faults,
        "dgd_seconds": dgd_launches["seconds"], "serve": served,
        "consistency": consistency, "grid": grid, "live": live}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
