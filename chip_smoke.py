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
the kernel's wide route, and Fig. 13 through the harness.  Then the gate
phase: Fig. 8 at --quick through the harness, and the port's regression
gate (``benchmarks_torch.regression_gate``) over the artifacts the
figures, faults, grid and live phases wrote, which must exit 0; and the
shard phase: sweep-1M on four copies of the card (``devices=["cuda:0"] *
4``) and the Fig. 8 cell (0.98, 3) on three, padded chunk counts both,
each bit-equal to one device, with the sharded cell's greedy_assign
launches counted.  Last, the train
phase: straggler-scheduled training of gemma3-4b at full size (34 layers,
bf16, AdamW) through ``repro_torch.launch.train`` for 20 steps (the loss
falls; one greedy_assign launch a step from the adaptive scheduler, no
swa_attention launch inside training), the trained weights' logits through
the swa kernel without grad against the autograd route, a replay of the
run's recorded delays (bit-equal rounds; the log equal to the engine's
trial-0 tables), 10 steps under the reissue deadline policy (need rows on
the launches after rounds that left a task undelivered), and at the smoke
config the card against the CPU, each from ``init_params`` under one seed
on its own device, and a resume against a straight run.  Then the
families phase: whisper-base (6 + 6 layers, eight requests over the full
1 500 encoder frames) and rwkv6-1.6b (24 layers, two 2048-token prompts)
served at full size through ``repro_torch.launch.serve``, each decode held
to the full forward in bfloat16 and the smoke configs on the card to the
CPU (rwkv6's recurrent state too), whisper-base trained 10 steps through
``make_straggler_train_step`` with its encoder frames as ``extras`` and
rwkv6-1.6b 10 steps through the trainer CLI (the loss falls; one
greedy_assign launch a step; no swa_attention launch in either family).
Last, the wide phase: the MoE, MLA and vision-stub families at published
widths, bf16 (``wide_phase``): deepseek-v3 cut to 4 layers (3 dense, 1 MoE
of 256 experts) on the naive and the absorbed MLA path and
llama4-maverick cut to 2 (1 dense, 1 MoE of 128 experts) served at
gemma3-4b's shape through ``serve.run``, llava-next-34b served at full
size (60 layers) through the serve CLI; decode held to the full forward
(llava with 1 024 patch embeddings; the MoE families at capacity_factor
E/K, where no call drops a pair; deepseek's absorbed decode to its naive
one), the smoke configs on the card to the CPU in float32 at the default
capacity, and deepseek-v3 at 4 layers with 16 experts trained 10 steps
through ``make_straggler_train_step`` (the loss falls, the MoE aux loss
finite and non-zero; one greedy_assign launch a step); the dense legs
beside them: phi4-mini-3.8b at full size through the serve CLI and
qwen2-72b cut to 8 layers at published widths (QKV bias) through
``serve.run``, both at gemma3-4b's shape, decode held to the full forward
and the smoke configs card against CPU (no swa_attention launch), and on
phi4-mini's weights sampled decode (``make_serve_step(greedy=False)``):
16 steps whose tokens the CPU draws again from the card's logits and
keys (equal but for counted near-ties, no padded id), and 65 536 draws
from one logits row held to its softmax by a chi-square test.  Last,
the hybrid phase (``hybrid_phase``): jamba-v0.1-52b at published widths,
bf16, one Jamba block (8 layers: seven Mamba mixers and a GQA layer, MoE of 16
experts on the odd layers) served at gemma3-4b's shape through
``serve.run`` with a profiled prefill (the selective scan's step loop),
the full 32 layers refused by both launchers' memory checks before any
weight is drawn, decode held to the full forward on one routing (the
float32-activation decode within 1e-4), the CLIs' hybrid smoke cut on the
card against the CPU with every Mamba state, and the CLIs' cut at
published widths (a Mamba and an attention + MoE layer) trained 10 steps
(the loss falls, the aux loss finite and non-zero; one greedy_assign
launch a step).  Last, the shapes phase (``shapes_phase``): the bf16
tensor-core swa kernel gated at the long variant's window W 8192 at
gemma3-4b's and mistral-nemo-12b's heads, both long variants
(``configs.resolve(cfg, "long_500k")``: every layer sliding-window)
served at full width through ``serve.run`` at batch 1 and a 32 768-token
prompt (one kernel launch a layer in the prefill), decode past the window
held to the full forward and the smoke configs on the card to the CPU,
then the dry run (``repro_torch.launch.dryrun``) of two decode combos and
of a cut train round held to its own build run on the card: FLOPs
exactly, the argument bytes and the step's peak each within a stated
share, a decode step's time beside the roofline's.  Last, the mesh phase
(``mesh_phase``): mistral-nemo-12b's base at full size served through
the serve CLI and ``serve.run`` with ``grouped_gqa`` off and on, both
decodes in turn on one model (ms a step, launches, busy share), each
held to its full forward and to the other, the grouped smoke config card
against CPU and its step's FLOPs equal to the dry run's; one deepseek-v3
MoE layer at published widths expert-parallel over two gloo ranks on the
one card (each holding its 128 experts) against the one-device layer on
pinned routing, and a ring decode over a 32 768-slot cache split by
sequence over the two ranks against the one-device grouped attention
(outputs within the bf16 bound, cache blocks bit-equal); then three
straggler AdamW train steps under the 1 x 2 mesh over the two ranks
(weights and moments placed by ``shardings.distribute_train_state``):
phi4-mini-3.8b's published widths cut to 2 layers in bf16, and its smoke
config in float32, each against the same steps on one device; beside
them, the mesh dry runs on ``meta`` (16x16 and 2x16x16: per-device FLOPs,
bytes, peak and collective bytes by kind).

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Prints the card's name and power limit, one line per check, a JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the exit code is non-zero and the last line is
never printed.  Without a CUDA device, or outside a checkout of the
repository, it exits non-zero before printing any result.
"""
import contextlib
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device available")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import (SHAPES, InputShape,  # noqa: E402
                                RegressionConfig, cli_config, get_config,
                                long_variant, resolve)
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
from repro_torch.core import AdaptiveScheduler, montecarlo  # noqa: E402
from repro_torch.core.scheduling import _greedy_matrices  # noqa: E402
from repro_torch import dgd  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.core import load_trace  # noqa: E402
from repro_torch.data import TaskPartition, lm_task_batches  # noqa: E402
from repro_torch.launch import dryrun, roofline, serve  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.cluster import build_cluster  # noqa: E402
from repro_torch.live import run_live, sample_delay_tables  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.train import (gumbel_scores,  # noqa: E402
                               init_train_state, make_serve_step,
                               make_straggler_train_step)
from repro_torch.models import (forward, init_cache, init_params,  # noqa: E402
                                layer_specs)
from repro_torch.models import layers as model_layers  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks_torch"))
import fig8_convergence as fig8  # noqa: E402
import greedy_pick  # noqa: E402
from benchmarks_torch import grid_stream  # noqa: E402
from benchmarks_torch import planner as planner_bench  # noqa: E402
from benchmarks_torch import regression_gate  # noqa: E402
from benchmarks_torch import run as bench_run  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, float32 outside
# the tensor cores, bf16 and TF32 on the tensor cores (dense).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
DEV = torch.device("cuda")
#: where the harness phases write their BENCH_<name>.json files, which the
#: gate phase reads
BENCH_OUT = Path(__file__).resolve().parent / "bench_out_torch"
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


SWEEP_N, SWEEP_R, SWEEP_TRIALS, SWEEP_CHUNK = 16, 4, 1_000_000, 20_000


def sweep_1m_specs():
    """sweep-1M's schemes: CS/SS/RA/LB/PC/PCMM at n = 16, r = 4."""
    n, r = SWEEP_N, SWEEP_R
    return [to_spec("cs", cyclic_to_matrix(n, r)),
            to_spec("ss", staircase_to_matrix(n, r)),
            to_spec("ra", random_assignment_to_matrix(n)),
            lb_spec(r), pc_spec(r), pcmm_spec(r)]


def engine_phase():
    """The 10^6-trial sweep over CS/SS/RA/LB/PC/PCMM (n=16, r=4, all-k,
    scenario 1), trial-level LB <= CS/SS, and CUDA-vs-CPU samples."""
    n, r, model = SWEEP_N, SWEEP_R, scenario1()
    specs = sweep_1m_specs()
    trials, chunk = SWEEP_TRIALS, SWEEP_CHUNK
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
    out_dir = str(BENCH_OUT)
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
    out_dir = str(BENCH_OUT)
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
    out_dir = str(BENCH_OUT)
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
                           ",".join(FIGURE_JOBS), "--out", str(BENCH_OUT)])
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


def swa_bound(B, T, H, K, dh, W, dtype):
    """Least time for swa_attention: 4 * dh flops per visible pair (QK^T and
    PV) over the least time the card takes for them at the input type's
    accuracy, vs q, k, v read and o written once over the HBM rate.
    bfloat16: the bf16 tensor-core rate.  float32: the CUDA cores' FMA rate
    or three TF32 tensor-core products a float32 product, whichever is
    faster.  Returns (ms, "bytes" or "operations", {bound name: ms}) with
    both float32 bounds named."""
    item = 2 if dtype == torch.bfloat16 else 4
    flops = ops.swa_flops(B, T, H, dh, W)
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
        row["tflop_per_s"] = ops.swa_flops(B, T, H, dh, W) / row["ms"] / 1e9
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


#: the train phase's full-size leg: gemma3-4b as configured, AdamW with the
#: cosine schedule, the paper's round (n = 8, r = 2, k = 6, SS) on a
#: persistent-straggler cluster with adaptive row re-assignment
#: the shard phase's device lists: the one card repeated, which checks the
#: layout, the padding and the bits (a speedup needs several cards)
SHARD_SWEEP_DEVICES = ["cuda:0"] * 4
SHARD_FIG8_DEVICES = ["cuda:0"] * 3
#: the Fig. 8 cell's sharded leg: 8 000 trials in chunks of 1 750 are 5
#: chunks, padded to 6 over 3 devices, the last chunk partial
SHARD_FIG8 = dict(cell=(0.98, 3.0), trials=8000, chunk=1750)


def _max_abs_gap(a: dict, b: dict) -> float:
    """max |a - b| over every scheme's array of two result dicts."""
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    return max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k]))))
               for k in a)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def shard_phase(card):
    """Trial sharding (``repro_torch.sharding``) at full width on device
    lists that repeat the one card: sweep-1M on 4 x cuda:0 against
    ``devices=1`` (50 chunks, padded to 52), and the Fig. 8 cell (0.98, 3)
    at 8 000 trials in chunks of 1 750 (5 chunks, padded to 6, the last
    partial) on 3 x cuda:0 against one device, with the sharded run's
    greedy_assign launches counted (one a chunk-round).  Every statistic
    of each leg is held bit-equal (max abs 0)."""
    model, n = scenario1(), SWEEP_N
    specs = sweep_1m_specs()
    kw = dict(trials=SWEEP_TRIALS, chunk=SWEEP_CHUNK)
    one, t_one = _timed(lambda: sweep(specs, model, n, devices=1, **kw))
    many, t_many = _timed(lambda: sweep(specs, model, n,
                                        devices=SHARD_SWEEP_DEVICES, **kw))
    used, nc_pad, _ = montecarlo._shard_layout(
        SWEEP_TRIALS, SWEEP_CHUNK, SHARD_SWEEP_DEVICES)
    sweep_devs, sweep_pad = len(used), nc_pad
    gap = max(_max_abs_gap(one.means, many.means),
              _max_abs_gap(one.stderr, many.stderr))
    check(gap == 0, f"shard sweep-1M: {len(used)} devices vs 1, max abs "
                    f"{gap:.3e}")
    print(f"shard sweep-1M ({card}): {SWEEP_TRIALS} trials in "
          f"{SWEEP_CHUNK}-trial chunks, {-(-SWEEP_TRIALS // SWEEP_CHUNK)} "
          f"chunks padded to {nc_pad} over {len(used)} x cuda:0: means and "
          f"stderr max abs {gap:g} against devices=1; wall s one device "
          f"{t_one:.4f}, sharded {t_many:.4f}")
    p, spread = SHARD_FIG8["cell"]
    proc, sp = fig8.cell_process(p, spread), fig8.specs()
    rkw = dict(rounds=fig8.ROUNDS, k=fig8.K, trials=SHARD_FIG8["trials"],
               chunk=SHARD_FIG8["chunk"], seed=0)
    ops.reset_launch_counts()
    r_many, tr_many = _timed(lambda: sweep_rounds(
        sp, proc, fig8.N, devices=SHARD_FIG8_DEVICES, **rkw))
    launches = dict(ops.LAUNCHES)
    r_one, tr_one = _timed(lambda: sweep_rounds(sp, proc, fig8.N, devices=1,
                                                **rkw))
    used, nc_pad, _ = montecarlo._shard_layout(
        SHARD_FIG8["trials"], SHARD_FIG8["chunk"], SHARD_FIG8_DEVICES)
    nc = -(-SHARD_FIG8["trials"] // SHARD_FIG8["chunk"])
    check(nc_pad > nc, f"shard fig8: {nc} chunks need no padding")
    want = nc * fig8.ROUNDS
    check(launches["greedy_assign"] == want,
          f"shard fig8: greedy_assign launches {launches} != {want}")
    rgap = max(_max_abs_gap(getattr(r_one, f), getattr(r_many, f))
               for f in ("per_round", "stderr", "wallclock",
                         "wallclock_stderr"))
    check(rgap == 0, f"shard fig8: {len(used)} devices vs 1, max abs "
                     f"{rgap:.3e}")
    print(f"shard fig8 cell p{p} s{spread:g} ({card}): "
          f"{SHARD_FIG8['trials']} trials in {SHARD_FIG8['chunk']}-trial "
          f"chunks, {nc} chunks padded to {nc_pad} over {len(used)} x "
          f"cuda:0: per-round, wall-clock and stderr max abs {rgap:g} "
          f"against devices=1; greedy_assign launches "
          f"{launches['greedy_assign']} (= chunks x rounds); wall s one "
          f"device {tr_one:.4f}, sharded {tr_many:.4f}")
    return {"sweep": {"devices": sweep_devs, "padded_chunks": sweep_pad,
                      "max_abs": gap, "seconds_one": t_one,
                      "seconds_sharded": t_many},
            "fig8": {"devices": len(used), "chunks": nc,
                     "padded_chunks": nc_pad, "max_abs": rgap,
                     "greedy_launches": launches["greedy_assign"],
                     "seconds_one": tr_one, "seconds_sharded": tr_many}}


def gate_phase():
    """The port's regression gate (``benchmarks_torch.regression_gate``)
    on the artifacts the figures, faults, grid and live phases wrote into
    ``bench_out_torch/``, after Fig. 8 at --quick writes its own there
    (with its greedy_assign launches counted); the gate must exit 0."""
    ops.reset_launch_counts()
    done, secs = _timed(lambda: bench_run.main(
        ["--quick", "--device", "cuda", "--only", "fig8", "--out",
         str(BENCH_OUT)]))
    launches = dict(ops.LAUNCHES)
    check(list(done) == ["fig8"], f"gate: fig8 ran {sorted(done)}")
    rc = regression_gate.main(["--results", str(BENCH_OUT)])
    check(rc == 0, f"gate: regression_gate exited {rc}")
    print(f"gate: regression_gate exit {rc} on {BENCH_OUT.name}/ (fig8 "
          f"--quick {secs:.3f} s, greedy_assign launches "
          f"{launches['greedy_assign']})")
    return {"exit": rc, "fig8_seconds": secs,
            "greedy_launches": launches["greedy_assign"]}


TRAIN_ARGV = ["--arch", "gemma3-4b", "--steps", "20", "--n", "8", "--r", "2",
              "--k", "6", "--batch", "16", "--seq", "64", "--schedule", "ss",
              "--cluster", "markov", "--persistence", "0.95", "--spread", "3",
              "--adaptive"]
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "train_smoke"
#: card against CPU at the smoke config in float32 (tests/test_torch_train.py's
#: AdamW tolerance: loss rel 1e-5, weights within 5e-4, 99.9 % within 1e-5)
TRAIN_F32_LOSS_REL = 1e-5
TRAIN_F32_W_ATOL = 5e-4
TRAIN_F32_W_Q999 = 1e-5
#: the bfloat16 tolerance of the swa checks (tests/test_torch_card.py's TOL)
TRAIN_BF16_REL = 3e-2


def _launches_per_step(res, key):
    return [h["launches"][key] for h in res.history]


def _free_cuda():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def train_leg_a(log):
    """Leg A: the slice at full size through the trainer CLI, recording the
    delays.  The counts are set to 0 just before it and read after."""
    _free_cuda()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    res = train_cli.main(TRAIN_ARGV + ["--log-delays", str(log)])
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cfg = res.state.params.cfg
    n_params = sum(p.numel() for p in res.state.params.parameters())
    check(cfg.name == "gemma3-4b" and cfg.n_layers == 34
          and n_params == 4_550_996_480 and cfg.param_dtype == "bfloat16",
          f"train leg A model: {cfg.name} {cfg.n_layers} layers {n_params}")
    losses = [h["loss"] for h in res.history]
    gnorms = [h["grad_norm"] for h in res.history]
    check(len(losses) == 20 and all(np.isfinite(losses + gnorms)),
          f"train leg A: non-finite loss or grad norm {losses} {gnorms}")
    check(losses[-1] < losses[0],
          f"train leg A: loss {losses[0]:.4f} -> {losses[-1]:.4f} did not "
          f"fall")
    greedy = _launches_per_step(res, "greedy_assign")
    check(greedy == [1] * 20 and launches["greedy_assign"] == 20,
          f"train leg A: greedy_assign launches a step {greedy}")
    check(launches["swa_attention"] == 0,
          f"train leg A: swa_attention launched in training {launches}")
    secs = res.step_seconds[1:]
    tokens = 2 * 16 * 64                    # r x batch x seq a step
    out = {"steps": 20, "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "grad_norms": gnorms,
           "step_s_first": res.step_seconds[0],
           "step_s_mean": float(np.mean(secs)),
           "step_s_median": float(np.median(secs)),
           "tok_per_s": tokens / float(np.mean(secs)),
           "peak_mem_bytes": peak, "mem_before_bytes": base,
           "greedy_launches": launches["greedy_assign"],
           "greedy_launches_per_step": greedy,
           "swa_launches": launches["swa_attention"],
           "completion_times": [h["completion_time"] for h in res.history]}
    print(f"train A gemma3-4b 34 layers bf16 {n_params} params, 20 steps "
          f"n=8 r=2 k=6 ss+adaptive markov: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; {out['step_s_mean']:.4f} s/step after step 0 "
          f"(median {out['step_s_median']:.4f}, step 0 "
          f"{res.step_seconds[0]:.3f}), {out['tok_per_s']:.1f} tok/s, peak "
          f"memory {peak} bytes ({base} before); greedy_assign launches a "
          f"step {greedy[0]}..{max(greedy)} ({launches['greedy_assign']} in "
          f"all), swa_attention launches {launches['swa_attention']}")
    return res, out


def train_leg_e(res):
    """Leg E: the trained weights' logits under torch.no_grad (the swa
    kernel route: one tensor-core launch per sliding-window layer) against
    the same forward under autograd (attention_core).  The counts are set
    to 0 just before the no-grad forward and read after both."""
    model = res.state.params
    cfg = model.cfg
    n_swa = sum(s.mixer == "swa" for s in layer_specs(cfg))
    part = TaskPartition(n=8, global_batch=16, seq_len=64,
                         vocab=cfg.vocab_size, source="bigram",
                         seed=res.seeds["data_seed"])
    toks, labs = lm_task_batches(part, staircase_to_matrix(8, 2), 20,
                                 device=DEV)
    toks, labs = toks[0].reshape(16, 64), labs[0].reshape(16, 64)
    ops.reset_launch_counts()
    with torch.no_grad():
        kern = forward(model, cfg, toks)[0][..., :cfg.vocab_size].float()
    nograd = dict(ops.LAUNCHES)
    with torch.enable_grad():
        auto = forward(model, cfg, toks)[0][..., :cfg.vocab_size]
        auto = auto.detach().float()
    after = dict(ops.LAUNCHES)
    check(nograd["swa_attention"] == n_swa == 29
          and nograd["swa_attention_wgmma"] == n_swa,
          f"train leg E: no-grad forward launches {nograd} (want {n_swa} "
          f"on the tensor-core route)")
    check(after["swa_attention"] == n_swa,
          f"train leg E: the autograd forward launched swa_attention {after}")
    rel = ((kern - auto).abs().max() / auto.abs().max()).item()

    def seq_loss(lg):
        lp = torch.log_softmax(lg, dim=-1)
        return -lp.gather(-1, labs[..., None])[..., 0].mean(-1)

    la, lk = seq_loss(auto), seq_loss(kern)
    loss_rel = ((lk - la).abs().max() / la.abs().max()).item()
    check(bool(torch.isfinite(kern).all()) and rel <= TRAIN_BF16_REL
          and loss_rel <= TRAIN_BF16_REL,
          f"train leg E: kernel route vs autograd route logits rel {rel:.3e}"
          f", losses rel {loss_rel:.3e}")
    print(f"train E trained gemma3-4b no-grad (swa kernel, {n_swa} tensor-core"
          f" launches at (16, 64, 8, 4, 256, W 1024)) vs autograd "
          f"(attention_core): logits rel {rel:.3e}, per-sequence loss rel "
          f"{loss_rel:.3e}")
    return {"logits_rel": rel, "loss_rel": loss_rel,
            "swa_launches": nograd["swa_attention"],
            "wgmma_launches": nograd["swa_attention_wgmma"]}


def train_leg_c(log, a_out, seeds):
    """Leg C: replay leg A's recorded delays (--cluster trace): the rounds
    bit-equal; the log equal to the engine's trial-0 recording of the same
    process and seed."""
    _free_cuda()
    ops.reset_launch_counts()
    res = train_cli.main(TRAIN_ARGV + ["--cluster", "trace", "--trace",
                                       str(log)])
    launches = dict(ops.LAUNCHES)
    ct = [h["completion_time"] for h in res.history]
    check(ct == a_out["completion_times_exact"],
          "train leg C: replayed completion times differ")
    check([h["winners"] for h in res.history] == a_out["winners"]
          and [h["delivered_tasks"] for h in res.history]
          == a_out["delivered"], "train leg C: replayed winners differ")
    check(_launches_per_step(res, "greedy_assign") == [1] * 20,
          f"train leg C: greedy_assign launches {launches}")
    loss_diff = max(abs(h["loss"] - l) for h, l in
                    zip(res.history, a_out["losses"]))
    del res
    _free_cuda()
    args = train_cli._parser().parse_args(TRAIN_ARGV)
    process = build_cluster(args, seeds)
    T1, T2 = montecarlo._capture_tables(
        process, 8, 2, 20, seeds["delay_seed"],
        torch.zeros(1, dtype=torch.int64, device=DEV))
    tr = load_trace(str(log))
    check(np.array_equal(tr.T1[:, 0], T1[:, 0])
          and np.array_equal(tr.T2[:, 0], T2[:, 0]),
          "train leg C: logged delays differ from the engine's trial-0 "
          "recording")
    print(f"train C replay of leg A's 20 logged rounds: completion times, "
          f"winners, delivered tasks bit-equal; the log equal to "
          f"montecarlo._capture_tables (trial 0, seed "
          f"{seeds['delay_seed']}); loss max abs diff vs leg A "
          f"{loss_diff:.3e}")
    return {"replay_equal": True, "engine_tables_equal": True,
            "loss_max_abs_diff": loss_diff,
            "greedy_launches": launches["greedy_assign"]}


def train_leg_b(deadline):
    """Leg B: reissue at leg A's median round: each greedy_assign launch
    carries need rows exactly when the round before left a task
    undelivered.  Counts set to 0 just before, read after."""
    _free_cuda()
    ops.reset_launch_counts()
    argv = TRAIN_ARGV + ["--steps", "10", "--deadline", repr(deadline),
                         "--deadline-policy", "reissue"]
    res = train_cli.main(argv)
    launches = dict(ops.LAUNCHES)
    need = _launches_per_step(res, "greedy_assign_need")
    undelivered = [not all(h["delivered_tasks"]) for h in res.history]
    want = [0] + [int(u) for u in undelivered[:-1]]
    check(_launches_per_step(res, "greedy_assign") == [1] * 10,
          f"train leg B: greedy_assign launches {launches}")
    check(need == want and launches["greedy_assign_need"] == sum(want),
          f"train leg B: need-row launches {need} vs undelivered rounds "
          f"{want}")
    losses = [h["loss"] for h in res.history]
    check(all(np.isfinite(losses)), f"train leg B: losses {losses}")
    missed = sum(h["deadline_missed"] for h in res.history)
    print(f"train B reissue at deadline {deadline * 1e3:.6f} ms: "
          f"{missed}/10 rounds closed short of k, need-row launches "
          f"{launches['greedy_assign_need']} = rounds before the last that "
          f"left a task undelivered; realized k "
          f"{[h['realized_k'] for h in res.history]}")
    del res
    return {"deadline_ms": deadline * 1e3, "missed": missed,
            "greedy_launches": launches["greedy_assign"],
            "greedy_need_launches": launches["greedy_assign_need"],
            "need_per_step": need}


#: float32 erfinv on the card and on the CPU part by at most this many
#: units in the last place (tests/test_torch_card.py's bound on
#: init_params' normals)
INIT_ERFINV_ULPS = 4


def init_gap(cfg, seed):
    """``init_params(cfg, seed)`` on the card against the CPU: (max abs
    difference, max difference in units in the last place of the CPU's
    value, elements that differ, elements).  The Philox words are the same
    integers on both; only ``erfinv`` may part in the last bits."""
    a = init_params(cfg, seed=seed, device=DEV)
    b = init_params(cfg, seed=seed, device="cpu")
    inf = torch.tensor(float("inf"))
    gaps, ulps = [], []
    for p, q in zip(a.parameters(), b.parameters()):
        g = (p.detach().cpu() - q.detach()).abs()
        gaps.append(g)
        ulps.append(float((g / (torch.nextafter(q.abs(), inf)
                                - q.abs())).max()))
    return (max(float(g.max()) for g in gaps), max(ulps),
            sum(int((g > 0).sum()) for g in gaps),
            sum(g.numel() for g in gaps))


def train_leg_d():
    """Leg D: the smoke config in float32 on one CPU-recorded trace, card
    against CPU, each from ``init_params`` under the run's init seed on its
    own device (rounds exact, loss and weights at the float32 AdamW
    tolerance; the initial weights at that seed compared); then resume: 4 steps,
    --resume to 8, against 8 straight on the card (weights and optimizer
    state bit-equal)."""
    smoke = ["--arch", "gemma3-4b", "--smoke", "--n", "4", "--r", "2",
             "--k", "3", "--seq", "48", "--batch", "8"]
    log = TRAIN_DIR / "smoke_delays.npz"
    train_cli.main(smoke + ["--steps", "5", "--cluster", "markov",
                            "--device", "cpu", "--log-delays", str(log)])
    replay = smoke + ["--steps", "5", "--cluster", "trace", "--trace",
                      str(log), "--adaptive"]
    runs = {dev: train_cli.main(replay + ["--device", dev])
            for dev in ("cuda", "cpu")}
    card, cpu = runs["cuda"], runs["cpu"]
    check(card.start == cpu.start == 0, "train leg D: not from step 0")
    # the initial weights the two runs started from: init_params at the
    # init seed that the trainer derived from --seed
    i_seed = card.seeds["init_seed"]
    check(cpu.seeds["init_seed"] == i_seed,
          "train leg D: card and CPU runs derived different init seeds")
    i_max, i_ulps, i_diff, i_all = init_gap(
        get_config("gemma3-4b").smoke(), i_seed)
    check(i_ulps <= INIT_ERFINV_ULPS,
          f"train leg D: init_params card vs CPU {i_ulps:g} ulps (max abs "
          f"{i_max:.3e})")
    for a, b in zip(card.history, cpu.history):
        check(a["completion_time"] == b["completion_time"]
              and a["weights"] == b["weights"]
              and a["row_of_worker"] == b["row_of_worker"],
              f"train leg D: step {a['step']} rounds differ card vs CPU")
        check(abs(a["loss"] - b["loss"]) <= TRAIN_F32_LOSS_REL * abs(b["loss"]),
              f"train leg D: loss {a['loss']} vs {b['loss']}")
    diffs = np.concatenate([
        (p.detach().cpu() - q.detach()).abs().flatten().numpy()
        for p, q in zip(card.state.params.parameters(),
                        cpu.state.params.parameters())])
    w_max, w_q = float(diffs.max()), float(np.quantile(diffs, 0.999))
    check(w_max <= TRAIN_F32_W_ATOL and w_q <= TRAIN_F32_W_Q999,
          f"train leg D: weights card vs CPU max {w_max:.3e}, q999 {w_q:.3e}")
    ck = TRAIN_DIR / "ckpt"
    plain = smoke + ["--cluster", "iid"]
    train_cli.main(plain + ["--steps", "4", "--ckpt-dir", str(ck)])
    resumed = train_cli.main(plain + ["--steps", "8", "--ckpt-dir", str(ck),
                                      "--resume"])
    straight = train_cli.main(plain + ["--steps", "8"])
    check(resumed.start == 4, f"train leg D: resumed at {resumed.start}")
    # one program on one card from the same bits: the resumed run must be
    # the straight run, weights and AdamW state (step, m, v) alike
    r_max = max((p - q).abs().max().item() for p, q in zip(
        resumed.state.params.parameters(), straight.state.params.parameters()))
    check(r_max == 0, f"train leg D: resume vs straight max abs {r_max:.3e}")
    ro, so = resumed.state.opt_state, straight.state.opt_state
    check(resumed.state.step == straight.state.step == 8
          and int(ro["step"]) == int(so["step"]) == 8
          and all(torch.equal(ro[key][name], so[key][name])
                  for key in ("m", "v") for name in so[key]),
          "train leg D: resumed optimizer state differs from the straight run")
    print(f"train D smoke f32 card vs CPU from init_params(seed={i_seed}) "
          f"on each device (initial weights max abs {i_max:.3e}, {i_ulps:g} "
          f"ulps, bound {INIT_ERFINV_ULPS}; {i_diff} of {i_all} elements "
          f"differ: erfinv), 5 steps "
          f"on a recorded trace: rounds and adaptive rows equal, loss rel <= "
          f"{TRAIN_F32_LOSS_REL:g}, weights max abs {w_max:.3e} (99.9 % "
          f"within {w_q:.3e}); resume 4 -> 8 vs 8 straight on the card: "
          f"weights and AdamW step, m, v bit-equal")
    return {"init_seed": i_seed, "init_max_abs": i_max,
            "init_max_ulps": i_ulps,
            "init_elements_differ": i_diff,
            "init_elements": i_all, "weights_max_abs": w_max,
            "weights_q999": w_q, "resume_max_abs": r_max}


def train_phase():
    """Straggler-scheduled LM training through the port's trainer CLI,
    after the serve, grid and live phases have freed their models: legs A
    (gemma3-4b at full size, 20 steps), E (the trained weights through the
    swa kernel without grad), C (record and replay), B (reissue) and D
    (card against CPU and resume at the smoke config)."""
    t_phase = time.perf_counter()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)     # no stale checkpoint
    TRAIN_DIR.mkdir(parents=True)
    log = TRAIN_DIR / "delays.npz"
    res, a = train_leg_a(log)
    a["completion_times_exact"] = a["completion_times"]
    a["winners"] = [h["winners"] for h in res.history]
    a["delivered"] = [h["delivered_tasks"] for h in res.history]
    seeds = res.seeds
    e = train_leg_e(res)
    del res
    c = train_leg_c(log, a, seeds)
    b = train_leg_b(float(np.median(a["completion_times"])))
    d = train_leg_d()
    for key in ("completion_times_exact", "winners", "delivered"):
        a.pop(key)
    secs = time.perf_counter() - t_phase
    print(f"train phase wall seconds={secs:.4f}")
    return {"full": a, "nograd": e, "replay": c, "reissue": b,
            "card_vs_cpu": d, "seconds": secs}


#: the encoder-decoder and the recurrent family at full size:
#: whisper-base transcribing eight 30-second windows at once (the full
#: 1 500 encoder frames each), rwkv6-1.6b at gemma3-4b's serve shape
FAMILY_SERVE = {"whisper-base": dict(batch=8, prompt_len=4, gen=128),
                "rwkv6-1.6b": dict(batch=2, prompt_len=2048, gen=32)}
#: (decoder layers, encoder layers, parameters) at full size
FAMILY_SIZE = {"whisper-base": (6, 6, 114_358_784),
               "rwkv6-1.6b": (24, 0, 1_835_550_720)}
#: decode against the full forward on the card in bfloat16: max abs logit
#: difference over the max abs logit, at the bfloat16 tolerance of the swa
#: and training checks; card against CPU at the smoke configs in float32
#: at the gemma check's rel 1e-4
FAMILY_BF16_REL = 3e-2
FAMILY_F32_REL = 1e-4
FAMILY_TRAIN_STEPS = 10
#: rwkv6-1.6b through the trainer CLI with train leg A's round, optimiser
#: and data (16 x 64 tokens a slot) at ten times its peak learning rate:
#: at 3e-4 the loss on each step's fresh batch does not fall in 10 or 20
#: steps (PERF.md section 6).  At init the gradient's global norm is in
#: the thousands (the embedding and the first block), so the clip to 1.0
#: puts 99 % of the LM head's clipped gradient below AdamW's eps: only the
#: rows of the batch's own tokens move (benchmarks_torch/lm_grad_scale.py)
RWKV_TRAIN_ARGV = ["--arch", "rwkv6-1.6b", "--steps", str(FAMILY_TRAIN_STEPS)
                   ] + TRAIN_ARGV[4:] + ["--lr", "3e-3"]


def _swa_launches(launches):
    return sum(v for k, v in launches.items() if k.startswith("swa"))


@torch.inference_mode()
def decode_profile(cfg, batch, steps=8):
    """Kernel launches and busy share of a decode step of ``cfg`` (weights
    from seed 0): a 16-token prefill (with encoder frames where the model
    has an encoder), one warm step, then ``steps`` greedy steps under the
    profiler."""
    model = init_params(cfg, seed=0, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (batch, 16), generator=gen,
                         device=DEV)
    frames = (torch.randn((batch, cfg.encoder_seq, cfg.frontend_dim),
                          generator=gen, device=DEV)
              if cfg.encoder_layers else None)
    cache = init_cache(cfg, batch, 16 + steps + 8, device=DEV)
    logits, _, cache = forward(model, cfg, toks, cache=cache,
                               enc_frames=frames)
    nxt = logits[:, -1:].argmax(-1)
    step = make_serve_step(cfg)
    nxt, cache, _ = step(model, cache, nxt)

    def run():
        nonlocal nxt, cache
        for _ in range(steps):
            nxt, cache, _ = step(model, cache, nxt)

    wall, dev_s, count = profiled(run)
    return (None if count is None else count / steps,
            None if dev_s is None else dev_s / wall)


@torch.inference_mode()
def prefill_profile(cfg, batch, prompt_len):
    """Kernel launches, busy share and wall ms of a prefill of ``cfg``
    (weights from seed 0) of ``batch`` x ``prompt_len`` tokens into a
    cache, under the profiler (a decoder-only model)."""
    model = init_params(cfg, seed=0, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=DEV)
    cache = init_cache(cfg, batch, prompt_len + 8, device=DEV)
    wall, dev_s, count = profiled(lambda: forward(model, cfg, toks,
                                                  cache=cache))
    return {"launches": count, "ms": wall * 1e3,
            "busy_share": None if dev_s is None else dev_s / wall}


def family_serve(leg, cfg, shape, size, *, warm=True):
    """``cfg`` in bf16 with random weights from seed 0 on the card: through
    the serve CLI where ``cfg`` is its arch's own config, through
    ``serve.run`` where its depth is cut.  A warm-up run (one decode step)
    where ``warm``, then the measured run with the launch counts set to 0
    just before it; then the kernel launches and busy share of a decode
    step under the profiler (``decode_profile``).  ``size`` is (layers,
    encoder layers, parameters).  Every logit finite, tokens in range, no
    swa_attention launch."""
    n_params = sum(p.numel() for p in init_params(cfg, device="meta")
                   .parameters())
    check((cfg.n_layers, cfg.encoder_layers, n_params) == size
          and cfg.param_dtype == "bfloat16",
          f"{leg} config: {cfg.n_layers} + {cfg.encoder_layers} layers, "
          f"{n_params} parameters")
    B, P, G = (shape[k] for k in ("batch", "prompt_len", "gen"))

    def go(gen):
        if cfg == get_config(cfg.name):
            return serve.main(["--arch", cfg.name, "--batch", str(B),
                               "--prompt-len", str(P), "--gen", str(gen),
                               "--seed", "0", "--device", str(DEV)])
        return serve.run(cfg, batch=B, prompt_len=P, gen=gen, seed=0,
                         device=DEV)

    _free_cuda()
    ops.reset_launch_counts()
    if warm:
        go(2)
        _free_cuda()
    warm_launches = dict(ops.LAUNCHES)
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    res = go(G)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(res.finite, f"serve {leg}: non-finite logits")
    check(tuple(res.tokens.shape) == (B, G)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          f"serve {leg}: tokens {tuple(res.tokens.shape)} out of range")
    check(_swa_launches(launches) == 0 and _swa_launches(warm_launches) == 0,
          f"serve {leg}: swa_attention launched {launches} {warm_launches}")
    _free_cuda()
    dec_launches, busy = decode_profile(cfg, B)
    _free_cuda()
    out = {"layers": cfg.n_layers, "params": n_params, "batch": B,
           "prompt_len": P, "gen": G,
           "encoder_frames": cfg.encoder_seq if cfg.encoder_layers else 0,
           "init_s": res.init_s, "prefill_ms": res.prefill_s * 1e3,
           "prefill_tok_per_s": B * P / res.prefill_s,
           "decode_ms_per_step": res.decode_s * 1e3 / (G - 1),
           "decode_tok_per_s": B * (G - 1) / res.decode_s,
           "peak_mem_bytes": peak, "mem_before_bytes": base,
           "decode_launches_per_step": dec_launches,
           "decode_busy_share_profiled": busy,
           "swa_launches": _swa_launches(launches)}
    print(f"serve {leg} {cfg.n_layers}+{cfg.encoder_layers} layers "
          f"{n_params} params bf16 batch={B} prompt={P} gen={G}"
          f"{f' frames={cfg.encoder_seq}' if cfg.encoder_layers else ''}: "
          f"init_params {res.init_s:.3f} s, prefill "
          f"{out['prefill_ms']:.3f} ms "
          f"({out['prefill_tok_per_s']:.1f} tok/s), decode "
          f"{out['decode_ms_per_step']:.4f} ms/step "
          f"({out['decode_tok_per_s']:.1f} tok/s), peak memory {peak} bytes "
          f"({base} allocated before the run); kernel launches a decode "
          f"step {dec_launches} at a busy share of {busy} (profiled); "
          f"swa_attention launches 0")
    return out


def _frontend_inputs(cfg, batch, draw):
    """``forward``'s extra inputs for ``cfg``, drawn by ``draw(shape)``:
    encoder frames where the model has an encoder, patch embeddings (its
    frontend_seq) where it has a frontend, else none."""
    if cfg.encoder_layers:
        return {"enc_frames": draw((batch, cfg.encoder_seq,
                                    cfg.frontend_dim))}
    if cfg.frontend_seq:
        return {"embeds": draw((batch, cfg.frontend_seq, cfg.frontend_dim))}
    return {}


def _nudge(tree):
    """Scales every float tensor of a cache subtree by 1 + 2^-4, in
    place."""
    for v in tree.values():
        if isinstance(v, dict):
            _nudge(v)
        elif torch.is_tensor(v) and v.is_floating_point():
            v.mul_(1 + 2 ** -4)


def _decode_vs_full(model, cfg, toks, steps, extras, *, nudge=False):
    """Each of ``steps`` decode steps after a prefill of the rest of
    ``toks`` (with ``extras``: encoder frames or patch embeddings) against
    the full forward at the same positions: (max abs difference over the
    max abs logit, the steps' logits (steps, B, V) float32, the full
    forward's there).  ``nudge`` scales the first layer's cache after the
    prefill (``_nudge``), the control of ``_moves_when_nudged``."""
    V, B = cfg.vocab_size, toks.shape[0]
    P = extras["embeds"].shape[1] if "embeds" in extras else 0
    T0 = toks.shape[1] - steps
    full = forward(model, cfg, toks, **extras)[0][:, P + T0:, :V]
    full = full.float()
    cache = init_cache(cfg, B, P + toks.shape[1] + 8, device=DEV)
    _, _, cache = forward(model, cfg, toks[:, :T0], cache=cache, **extras)
    if nudge:
        _nudge(cache["layers"][0])
    out, worst = [], 0.0
    for t in range(steps):
        lg, _, cache = forward(model, cfg, toks[:, T0 + t:T0 + t + 1],
                               cache=cache)
        out.append(lg[:, 0, :V].float())
        worst = max(worst, (out[-1] - full[:, t]).abs().max().item())
    return (worst / full.abs().max().item(), torch.stack(out),
            full.transpose(0, 1))


def _moves_when_nudged(model, cfg, toks, extras, what):
    """The control of a decode-vs-full reading of exactly 0 (every bf16
    product of the decode rounded as in the full forward): one decode step
    after a prefill whose first layer's cache was scaled by 1 + 2^-4 must
    read above 0, so the check sees the cache it names.  Returns that
    reading."""
    moved, _, _ = _decode_vs_full(model, cfg, toks, 1, extras, nudge=True)
    check(np.isfinite(moved) and moved > 0,
          f"{what}: decode vs full reads {moved} after a nudged cache")
    return moved


def _smoke_card_vs_cpu(cfg):
    """The smoke config ``cfg`` in float32 (an MoE at its default capacity:
    pairs are dropped, the same ones on both devices), each device's
    weights from ``init_params(seed 2)`` on the CPU: the full forward and a
    16-token prefill plus 8 decode steps (with encoder frames or patch
    embeddings where the config takes them), max rel logit difference; the
    aux losses' rel difference; the recurrent states after the last step
    (rwkv6's ``S``, a Mamba layer's ``h`` and ``conv``).  All within
    ``FAMILY_F32_REL``."""
    cpu_model = init_params(cfg, seed=2, device="cpu")
    gpu_model = init_params(cfg, seed=2, device="cpu").to(DEV)
    rng_ = np.random.default_rng(2)
    toks = torch.as_tensor(rng_.integers(0, cfg.vocab_size, (2, 24)))
    ext = _frontend_inputs(cfg, 2, lambda s: torch.as_tensor(
        rng_.standard_normal(s, dtype=np.float32)))

    def both(tk, cache_a=None, cache_b=None, extras=None):
        extras = extras or {}
        a = forward(gpu_model, cfg, tk.to(DEV), cache=cache_a,
                    **{k: v.to(DEV) for k, v in extras.items()})
        b = forward(cpu_model, cfg, tk, cache=cache_b, **extras)
        aux = abs(a[1].item() - b[1].item()) / max(abs(b[1].item()), 1e-30)
        return _rel_gap(a[0].cpu(), b[0]), aux, a[2], b[2]

    rel_full, aux_rel, _, _ = both(toks, extras=ext)
    n = 32 + (ext["embeds"].shape[1] if "embeds" in ext else 0)
    ca = init_cache(cfg, 2, n, device=DEV)
    cb = init_cache(cfg, 2, n, device="cpu")
    rel_step, _, ca, cb = both(toks[:, :16], ca, cb, ext)
    for t in range(16, 24):
        r, _, ca, cb = both(toks[:, t:t + 1], ca, cb)
        rel_step = max(rel_step, r)
    def state_gap(key):
        return max((_rel_gap(a["ssm"][key].cpu(), b["ssm"][key])
                    for a, b in zip(ca["layers"], cb["layers"])
                    if key in a.get("ssm", {})), default=None)

    # rwkv6's recurrent state S; a Mamba layer's scan state h and conv tail
    states = {k: state_gap(k) for k in ("S", "h", "conv")}
    check(rel_full < FAMILY_F32_REL and rel_step < FAMILY_F32_REL
          and aux_rel < FAMILY_F32_REL
          and all(v is None or v < FAMILY_F32_REL for v in states.values()),
          f"{cfg.name} card vs CPU rel {rel_full:.2e} (full), "
          f"{rel_step:.2e} (prefill + decode), aux {aux_rel:.2e}, state "
          f"{states}")
    return {"card_vs_cpu_full": rel_full, "card_vs_cpu_decode": rel_step,
            "card_vs_cpu_aux": aux_rel, "card_vs_cpu_S": states["S"],
            "card_vs_cpu_mamba": (None if states["h"] is None else
                                  {"h": states["h"], "conv": states["conv"]})}


def _card_vs_cpu_line(name, o):
    mamba = o["card_vs_cpu_mamba"]
    return (f"{name} f32 card vs CPU rel {o['card_vs_cpu_full']:.3e} "
            f"(full), {o['card_vs_cpu_decode']:.3e} (prefill 16 + 8 decode "
            f"steps), aux {o['card_vs_cpu_aux']:.3e}, S {o['card_vs_cpu_S']}"
            + ("" if mamba is None else
               f", Mamba h {mamba['h']:.3e}, conv {mamba['conv']:.3e}"))


def _rel_gap(a, b):
    """max |a - b| over max |b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


@torch.inference_mode()
def family_consistency(arch, cfg=None, then=None):
    """(1) ``arch`` (or ``cfg``, a cut of it) at full width in bfloat16 on
    the card: the full forward against a 16-token prefill plus 8 decode
    steps at the same positions (``_decode_vs_full``; counts set to 0 just
    before, read after: no swa_attention launch), then ``then(model,
    cfg)`` on the same weights, its dict kept under "then".  (2) its smoke
    config in float32, the card against the same weights on the CPU
    (``_smoke_card_vs_cpu``)."""
    cfg = cfg or get_config(arch)
    model = init_params(cfg, seed=1, device=DEV)
    B, P, steps = 2, 16, 8
    gen = torch.Generator(device=DEV).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, P + steps), generator=gen,
                         device=DEV)
    ext = _frontend_inputs(cfg, B, lambda s: torch.randn(
        s, generator=gen, device=DEV))
    ops.reset_launch_counts()
    rel_dec, _, _ = _decode_vs_full(model, cfg, toks, steps, ext)
    moved = (_moves_when_nudged(model, cfg, toks, ext, arch) if rel_dec == 0
             else None)
    launches = dict(ops.LAUNCHES)
    check(np.isfinite(rel_dec) and rel_dec <= FAMILY_BF16_REL
          and _swa_launches(launches) == 0,
          f"{arch} bf16 decode vs full rel {rel_dec:.3e} (bound "
          f"{FAMILY_BF16_REL}), swa launches {launches}")
    after = None if then is None else then(model, cfg)
    del model
    _free_cuda()
    small = cfg.smoke()
    out = {"decode_vs_full_bf16_rel": rel_dec, "nudged_bf16_rel": moved,
           **_smoke_card_vs_cpu(small),
           "swa_launches": _swa_launches(launches), "then": after}
    print(f"consistency {arch} full size bf16: prefill {P} + {steps} decode "
          f"steps vs the full forward rel {rel_dec:.3e} (bound "
          f"{FAMILY_BF16_REL}; with a nudged cache {moved}); "
          f"{_card_vs_cpu_line(small.name, out)}; swa_attention launches 0")
    return out


def _train_summary(arch, lr, losses, secs, greedy, launches, peak, base,
                   params):
    check(len(losses) == FAMILY_TRAIN_STEPS and all(np.isfinite(losses)),
          f"train {arch}: losses {losses}")
    check(losses[-1] < losses[0],
          f"train {arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f} did not "
          f"fall")
    check(greedy == [1] * FAMILY_TRAIN_STEPS,
          f"train {arch}: greedy_assign launches a step {greedy}")
    check(_swa_launches(launches) == 0,
          f"train {arch}: swa_attention launched {launches}")
    steady = secs[1:]
    out = {"steps": FAMILY_TRAIN_STEPS, "params": params, "peak_lr": lr,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "step_s_first": secs[0],
           "step_s_mean": float(np.mean(steady)),
           "step_s_median": float(np.median(steady)),
           "tok_per_s": 2 * 16 * 64 / float(np.mean(steady)),
           "peak_mem_bytes": peak, "mem_before_bytes": base,
           "greedy_launches": launches["greedy_assign"],
           "swa_launches": _swa_launches(launches)}
    print(f"train {arch} {params} params bf16, {FAMILY_TRAIN_STEPS} steps "
          f"n=8 r=2 k=6 ss+adaptive markov, 16 x 64 tokens a slot, AdamW "
          f"peak lr {lr:g}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; {out['step_s_mean']:.4f} "
          f"s/step after step 0 (median {out['step_s_median']:.4f}, step 0 "
          f"{secs[0]:.3f}), {out['tok_per_s']:.1f} tok/s, peak memory "
          f"{peak} bytes ({base} before); greedy_assign launches "
          f"{launches['greedy_assign']} (one a step), swa_attention 0")
    return out


def train_straggler(name, cfg):
    """``cfg`` through ``make_straggler_train_step``: AdamW (cosine, lr
    3e-4, warm-up 5), ``RoundConfig(n=8, k=6, kind="ss", r=2)`` on leg A's
    cluster with adaptive rows, 2 bigram sequences of 64 tokens a worker
    and slot; where the model has an encoder, each task with its own
    encoder frames as ``extras`` (drawn once, gathered by the round's
    matrix as its tokens are).  Counts set to 0 just before, read after.
    The summary also holds each step's aux loss and gradient norm."""
    steps = FAMILY_TRAIN_STEPS
    rc = RoundConfig(n=8, k=6, kind="ss", r=2)
    opt = adamw(cosine_schedule(3e-4, steps, warmup=5))
    _free_cuda()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    state = init_train_state(cfg, opt, seed=0, device=DEV)
    step = make_straggler_train_step(
        cfg, opt, rc, ec2_cluster(8, spread=3.0, persistence=0.95, seed=0))
    base_C = rc.to_matrix()
    sched = AdaptiveScheduler(base_C, device=DEV)
    part = TaskPartition(n=8, global_batch=16, seq_len=64,
                         vocab=cfg.vocab_size, source="bigram", seed=0)
    frames = None
    if cfg.encoder_layers:
        gen = torch.Generator(device=DEV).manual_seed(0)
        frames = torch.randn((int(base_C.max()) + 1, part.task_batch,
                              cfg.encoder_seq, cfg.frontend_dim),
                             generator=gen, device=DEV).to(torch.bfloat16)
    cluster, losses, auxs, gnorms, secs, greedy = None, [], [], [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = ops.LAUNCHES["greedy_assign"]
        C = sched.matrix()
        row = sched.row_of_worker()
        toks, labs = lm_task_batches(part, C, i, device=DEV)
        extras = (None if frames is None else   # (r, n, b, T, D)
                  {"enc_frames": frames[torch.as_tensor(C.T, device=DEV)]})
        state, m, cluster = step(state, toks, labs, 7, cluster, row,
                                 extras=extras)
        sched.observe(m["worker_t1"].cpu().numpy())
        losses.append(float(m["loss"]))
        auxs.append(float(m["aux"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        greedy.append(ops.LAUNCHES["greedy_assign"] - before)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in state.params.parameters())
    del state, frames
    out = _train_summary(name, 3e-4, losses, secs, greedy, launches, peak,
                         base, n_params)
    out.update(aux=auxs, grad_norms=gnorms)
    return out


def train_rwkv6():
    """rwkv6-1.6b at full size through the trainer CLI with leg A's round,
    optimiser and data, 10 steps at a peak learning rate of 3e-3
    (``RWKV_TRAIN_ARGV``).  Counts set to 0 just before, read after."""
    _free_cuda()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    res = train_cli.main(RWKV_TRAIN_ARGV + ["--device", str(DEV)])
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in res.state.params.parameters())
    check(res.state.params.cfg == get_config("rwkv6-1.6b")
          and n_params == FAMILY_SIZE["rwkv6-1.6b"][2],
          f"train rwkv6: {res.state.params.cfg.name} {n_params} params")
    losses = [h["loss"] for h in res.history]
    greedy = _launches_per_step(res, "greedy_assign")
    secs = res.step_seconds
    del res
    return _train_summary("rwkv6-1.6b", 3e-3, losses, secs, greedy,
                          launches, peak, base, n_params)


def families_phase():
    """whisper-base and rwkv6-1.6b at full size on the card, after the
    train phase has freed gemma3-4b: serving, consistency (decode against
    the full forward, the card against the CPU) and training."""
    t_phase = time.perf_counter()
    legs = [(arch, "serve", lambda arch=arch: family_serve(
        arch, get_config(arch), FAMILY_SERVE[arch], FAMILY_SIZE[arch]))
        for arch in FAMILY_SERVE]
    legs += [(arch, "consistency", lambda arch=arch: family_consistency(arch))
             for arch in FAMILY_SERVE]
    legs += [("whisper-base", "train",
              lambda: train_straggler("whisper-base",
                                      get_config("whisper-base"))),
             ("rwkv6-1.6b", "train", train_rwkv6)]
    out = {arch: {} for arch in FAMILY_SERVE}
    for arch, leg, fn in legs:
        res, secs = _timed(fn)
        out[arch][leg] = {**res, "seconds": secs}
        print(f"families {arch} {leg}: {secs:.2f} s")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"families phase wall seconds={out['seconds']:.4f}")
    return out


#: the MoE, MLA and vision-stub families at published widths.  deepseek-v3
#: and llama4-maverick exceed one card at full depth (671 B and 400 B
#: parameters), so their depth is cut: deepseek-v3 to its 3 dense-prefix
#: layers and 1 MoE layer (MLA throughout; 256 routed experts top-8, 1
#: shared), llama4-maverick to 1 dense and 1 MoE layer (128 experts top-1,
#: 1 shared), both at gemma3-4b's serve shape through ``serve.run``, text
#: only (llama4's config has frontend_seq 0).  llava-next-34b runs at full
#: size (60 layers) through the serve CLI at batch 1: at batch 2 its 68.8
#: GB of weights leave too little of the card
WIDE_CUT = {"deepseek-v3": ("deepseek-v3-671b", dict(n_layers=4)),
            "deepseek-v3-absorbed": ("deepseek-v3-671b",
                                     dict(n_layers=4, mla_absorb=True)),
            "llama4-maverick": ("llama4-maverick-400b-a17b",
                                dict(n_layers=2)),
            "llava-next-34b": ("llava-next-34b", {}),
            "phi4-mini": ("phi4-mini-3.8b", {}),
            "qwen2-72b": ("qwen2-72b", dict(n_layers=8))}
#: (layers, encoder layers, parameters) of each leg
WIDE_SIZE = {"deepseek-v3": (4, 0, 15_111_101_440),
             "deepseek-v3-absorbed": (4, 0, 15_111_101_440),
             "llama4-maverick": (2, 0, 18_562_447_360),
             "llava-next-34b": (60, 0, 34_396_264_448),
             "phi4-mini": (32, 0, 4_451_404_800),
             "qwen2-72b": (8, 0, 9_512_902_656)}
WIDE_SERVE = {"deepseek-v3": SERVE, "deepseek-v3-absorbed": SERVE,
              "llama4-maverick": SERVE,
              "llava-next-34b": dict(batch=1, prompt_len=2048, gen=32),
              "phi4-mini": SERVE, "qwen2-72b": SERVE}
#: the dense legs of the wide phase: phi4-mini-3.8b at full size (its
#: vocabulary 200 064 padded to 200 192, the masked tail at width) and
#: qwen2-72b cut to 8 of its 80 layers at published widths (d 8192, 64 /
#: 8 heads of 128, d_ff 29 568, QKV bias; the untied embedding and head:
#: 19.0 GB of bf16), whose 145 GB at full depth exceed one card
DENSE_LEGS = ("phi4-mini", "qwen2-72b")
#: sampled decode on phi4-mini's weights: 16 steps after a 2 x 64 prompt,
#: keys (SAMPLE_SEED, step); the CPU's draw may differ only where the top
#: two perturbed scores lie within SAMPLE_NEAR_TIE; then SAMPLE_DRAWS
#: draws from one logits row in chunks of SAMPLE_CHUNK rows, keys
#: (SAMPLE_CHI_SEED, chunk), held to its softmax by a chi-square test over
#: SAMPLE_BINS bins of equal probability mass, p above SAMPLE_P_MIN
SAMPLE_STEPS = 16
SAMPLE_SEED = 5
SAMPLE_NEAR_TIE = 1e-5
SAMPLE_DRAWS = 65_536
SAMPLE_CHUNK = 1024
SAMPLE_CHI_SEED = 6
SAMPLE_BINS = 256
SAMPLE_P_MIN = 1e-3
#: deepseek-v3 trained at full width, 4 layers, with 16 routed experts
#: (top-8, the shared expert and capacity 1.25 kept): 4 539 735 040
#: parameters, gemma3-4b's training size
DEEPSEEK_TRAIN = dict(n_layers=4, n_experts=16)
DEEPSEEK_TRAIN_PARAMS = 4_539_735_040
#: the legs whose bf16 decode is held against twice the bf16 full
#: forward's distance from the float32-activation forward of the same
#: weights, not FAMILY_BF16_REL, and whose float32-activation decode is
#: held to that forward within FAMILY_F32_REL: llava's 60 layers put its
#: own bf16 error at about FAMILY_BF16_REL (PERF.md section 6; whisper
#: and rwkv6, for which it was set, have 6 and 24)
WIDE_TRUTH_HELD = ("llava-next-34b",)


def wide_cfg(leg, **kw):
    """The config of a leg of the wide phase, with ``kw`` on top."""
    arch, cut = WIDE_CUT[leg]
    return dataclasses.replace(get_config(arch), **{**cut, **kw})


def no_drop_cfg(cfg):
    """``cfg`` at capacity_factor E/K: C = ceil(T K / E x E / K) >= T in a
    call of T tokens, and an expert takes at most one pair a token, so no
    call drops a pair.  At the default 1.25 a decode step at B = 2, K = 8,
    E = 256 has C = 1: the reference itself drops pairs there, and decode
    does not equal the full forward."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)


def _same_weights(model, cfg):
    """A model of ``cfg`` on ``model``'s own weight tensors, nothing drawn
    or copied: ``cfg`` may differ from the model's in fields that change
    no weight (the activation dtype, ``mla_absorb``, ``capacity_factor``)."""
    other = init_params(cfg, device="meta")
    state = model.state_dict()
    other.load_state_dict({k: state[k] for k in other.state_dict()},
                          assign=True)
    return other


class RouteTape:
    """Within ``with``, records the ``Routing`` of every MoE call
    (``moe_route``) in ``calls``."""

    def __init__(self):
        self.calls = []

    def _route(self, x2d, router_w, cfg):
        own = self._own(x2d, router_w, cfg)
        self.calls.append(own)
        return own

    def __enter__(self):
        self._own = model_layers.moe_route
        model_layers.moe_route = self._route
        return self

    def __exit__(self, *exc):
        model_layers.moe_route = self._own


class RoutePin(RouteTape):
    """Within ``with``, routes the tokens of each MoE call to the experts
    and gate weights that ``pins`` names in call order ((top_w, top_i), (T,
    K) each for the call's T tokens), their slots planned anew
    (``moe_slots``); counts the routed tokens whose own top-K experts
    differ (``flipped`` of ``routed``).  A pin left over, or a call with no
    pin, fails the run."""

    def __init__(self, pins):
        super().__init__()
        self.pins = list(pins)
        self.flipped, self.routed = 0, 0

    def _route(self, x2d, router_w, cfg):
        own = self._own(x2d, router_w, cfg)
        check(bool(self.pins), "routing pins: more calls than pins")
        top_w, top_i = self.pins.pop(0)
        check(top_i.shape == own.top_i.shape,
              f"routing pins: a call of {tuple(own.top_i.shape)} picks met "
              f"a pin of {tuple(top_i.shape)}")
        differ = (own.top_i.sort(-1).values
                  != top_i.sort(-1).values).any(-1)
        self.flipped += int(differ.sum())
        self.routed += differ.numel()
        order, slot, ok, counts = model_layers.moe_slots(
            top_i, cfg.n_experts, own.capacity)
        return own._replace(top_w=top_w, top_i=top_i, order=order,
                            slot=slot, ok=ok, counts=counts)

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if exc[0] is None and self.pins:
            check(False, f"routing pins: {len(self.pins)} left over")


def _f32_truth(model, cfg, toks, steps, ext, full, dec, route=None):
    """The float32-activation yardstick of a bf16 decode-vs-full reading:
    the same decode with float32 activations on ``model``'s bf16 weights
    (``_same_weights``; under the ``route`` context where given, e.g. a
    ``RoutePin``), held to its own full forward within ``FAMILY_F32_REL``.
    Returns (that reading, the bf16 full forward ``full``'s distance from
    the float32 forward, the bf16 decode ``dec``'s distance from it)."""
    c32 = dataclasses.replace(cfg, dtype="float32")
    with route or contextlib.nullcontext():
        rel32, _, truth = _decode_vs_full(_same_weights(model, c32), c32,
                                          toks, steps, ext)
    check(rel32 <= FAMILY_F32_REL,
          f"{cfg.name}: float32-activation decode vs full rel {rel32:.3e} "
          f"(bound {FAMILY_F32_REL})")
    return rel32, _rel_gap(full, truth), _rel_gap(dec, truth)


@torch.inference_mode()
def wide_consistency(family):
    """(1) ``family`` at published widths in bf16 on the card (deepseek-v3
    and llama4-maverick at their serve cuts, llava-next-34b at full size),
    at capacity_factor E/K (``no_drop_cfg``): the full forward against a
    16-token prefill plus 8 decode steps at the same positions, within
    ``FAMILY_BF16_REL``; llava prefills its 1 024 patch embeddings (its
    frontend_seq) with the text.  llava (``WIDE_TRUTH_HELD``): the same
    decode with float32 activations on the same bf16 weights is held to
    its float32 full forward within ``FAMILY_F32_REL``, and the bf16
    decode to the full forward within twice the bf16 full forward's own
    distance from that float32 forward, as is its distance from it.
    deepseek-v3 decodes on the naive MLA path, recording its routing
    (``RouteTape``), then on the absorbed path pinned to that routing
    (``RoutePin``, which counts the tokens whose own top-K would differ;
    their slots planned anew, as the recording's): the absorbed decode is
    held to the full forward and to the naive decode within
    ``FAMILY_BF16_REL``.  Every variant runs on one draw of the weights
    (``_same_weights``).  Counts set to 0 just before, read after: no
    swa_attention launch.  (2) the family's smoke config in float32 at its
    default capacity, the card against the CPU (``_smoke_card_vs_cpu``;
    deepseek-v3 on both MLA paths)."""
    legs = (["deepseek-v3", "deepseek-v3-absorbed"] if family == "deepseek-v3"
            else [family])
    B, P, steps = 2, 16, 8
    cfg = no_drop_cfg(wide_cfg(legs[0]))
    gen = torch.Generator(device=DEV).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, P + steps), generator=gen,
                         device=DEV)
    ext = _frontend_inputs(cfg, B, lambda s: torch.randn(
        s, generator=gen, device=DEV))
    out, decs, pins = {}, {}, None
    ops.reset_launch_counts()
    model = init_params(cfg, seed=1, device=DEV)
    for leg in legs:
        cfg = no_drop_cfg(wide_cfg(leg))
        # the absorbed path is pinned to the naive path's routing
        route = RouteTape() if pins is None else RoutePin(pins)
        with route:
            rel, decs[leg], full = _decode_vs_full(
                _same_weights(model, cfg), cfg, toks, steps, ext)
        o = out[leg] = {"decode_vs_full_bf16_rel": rel,
                        "capacity_factor": cfg.capacity_factor,
                        "patch_embeddings": ext["embeds"].shape[1]
                        if "embeds" in ext else 0,
                        "nudged_bf16_rel": None}
        if rel == 0:
            o["nudged_bf16_rel"] = _moves_when_nudged(
                _same_weights(model, cfg), cfg, toks, ext, leg)
        bound = FAMILY_BF16_REL
        if leg in WIDE_TRUTH_HELD:
            rel32, gap, dec_gap = _f32_truth(model, cfg, toks, steps, ext,
                                             full, decs[leg])
            bound = 2 * gap
            o.update(f32_decode_vs_full_rel=rel32, full_vs_f32_bf16_rel=gap,
                     decode_vs_f32_bf16_rel=dec_gap)
            check(dec_gap <= bound,
                  f"{leg}: bf16 decode vs the float32-activation forward "
                  f"{dec_gap:.3e} (bound {bound:.3e})")
        if isinstance(route, RoutePin):
            o.update(routing_pinned=True, flipped_tokens=route.flipped,
                     routed_tokens=route.routed,
                     absorbed_vs_naive_bf16_rel=_rel_gap(
                         decs[leg], decs["deepseek-v3"]))
            check(o["absorbed_vs_naive_bf16_rel"] <= FAMILY_BF16_REL,
                  f"{leg}: decode vs the naive decode rel "
                  f"{o['absorbed_vs_naive_bf16_rel']:.3e} (bound "
                  f"{FAMILY_BF16_REL})")
        elif family == "deepseek-v3":
            pins = [(c.top_w, c.top_i) for c in route.calls]
        o["decode_vs_full_bound"] = bound
        del full
        check(np.isfinite(rel) and rel <= bound,
              f"{leg} bf16 decode vs full rel {rel:.3e} (bound {bound:.3e})")
    del model, decs
    _free_cuda()
    launches = dict(ops.LAUNCHES)
    check(_swa_launches(launches) == 0,
          f"{family} consistency: swa_attention launched {launches}")
    for leg in legs:
        small = get_config(WIDE_CUT[leg][0]).smoke()
        if WIDE_CUT[leg][1].get("mla_absorb"):
            small = dataclasses.replace(small, mla_absorb=True)
        o = out[leg]
        o.update(_smoke_card_vs_cpu(small))
        extra = ""
        if "f32_decode_vs_full_rel" in o:
            extra = (f": twice the full forward's "
                     f"{o['full_vs_f32_bf16_rel']:.3e} from the "
                     f"float32-activation forward, decode's "
                     f"{o['decode_vs_f32_bf16_rel']:.3e}; the "
                     f"float32-activation decode vs its full forward "
                     f"{o['f32_decode_vs_full_rel']:.3e} (bound "
                     f"{FAMILY_F32_REL})")
        if o.get("routing_pinned"):
            extra = (f"; pinned to the naive decode's routing ("
                     f"{o['flipped_tokens']} of {o['routed_tokens']} routed "
                     f"tokens would pick other experts), decode vs the "
                     f"naive decode rel {o['absorbed_vs_naive_bf16_rel']:.3e}"
                     f" (bound {FAMILY_BF16_REL})")
        print(f"consistency {leg} full width bf16"
              + (f" ({o['patch_embeddings']} patch embeddings)"
                 if o["patch_embeddings"] else "")
              + f": prefill {P} + {steps} decode steps vs the full forward "
              f"rel {o['decode_vs_full_bf16_rel']:.3e} (bound "
              f"{o['decode_vs_full_bound']:.3e}{extra}; with a nudged cache "
              f"{o['nudged_bf16_rel']}; capacity_factor "
              f"{o['capacity_factor']:g}); "
              f"{_card_vs_cpu_line(small.name, o)}; swa_attention launches 0")
    return out


def _chi_square(counts, p, bins):
    """Pearson's chi-square of ``counts`` (V,) against the probabilities
    ``p`` (V,), float64 on the card, over ``bins`` bins of about equal
    mass (the categories in descending probability, each in the bin of
    the mass before it; bins that stay empty dropped): (statistic,
    degrees of freedom, p-value, the least expected count).  A draw
    where ``p`` is 0 makes the statistic infinite."""
    order = torch.argsort(p, descending=True)
    ps = p[order]
    b = torch.clamp(((torch.cumsum(ps, 0) - ps) * bins).long(), max=bins - 1)
    n = counts.sum().double()
    exp = torch.zeros(bins, dtype=torch.float64, device=p.device
                      ).index_add_(0, b, ps) * n
    obs = torch.zeros_like(exp).index_add_(0, b, counts[order].double())
    used = (exp > 0) | (obs > 0)
    exp, obs = exp[used], obs[used]
    stat = float(((obs - exp) ** 2 / exp).sum())
    dof = int(used.sum()) - 1
    pval = float(torch.special.gammaincc(
        torch.tensor(dof / 2, dtype=torch.float64),
        torch.tensor(stat / 2, dtype=torch.float64)))
    return stat, dof, pval, float(exp.min())


def sampled_decode(model, cfg):
    """``make_serve_step(cfg, greedy=False)`` on ``model``'s weights:
    ``SAMPLE_STEPS`` steps after a 2 x 64-token prompt, keys (SAMPLE_SEED,
    step), timed beside as many greedy steps after them: no drawn id at or past the vocabulary; the CPU's
    ``gumbel_scores`` of the card's float32 logits under the same keys
    draws the same tokens, but where its top two scores lie within
    ``SAMPLE_NEAR_TIE`` (counted).  Then ``SAMPLE_DRAWS`` draws from the
    first step's first logits row, none in the padded tail, held to its
    softmax (``_chi_square``, p above ``SAMPLE_P_MIN``)."""
    B, P = 2, 64
    gen = torch.Generator(device=DEV).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                         device=DEV)
    cache = init_cache(cfg, B, P + 2 * SAMPLE_STEPS + 8, device=DEV)
    logits, _, cache = forward(model, cfg, toks, cache=cache)
    nxt = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    del logits
    step = make_serve_step(cfg, greedy=False)
    drawn, lasts = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(SAMPLE_STEPS):
        nxt, cache, last = step(model, cache, nxt, rng=(SAMPLE_SEED, t))
        drawn.append(nxt[:, 0])
        lasts.append(last.float())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / SAMPLE_STEPS
    greedy = make_serve_step(cfg)
    t0 = time.perf_counter()
    for t in range(SAMPLE_STEPS):
        nxt, cache, _ = greedy(model, cache, nxt)
    torch.cuda.synchronize()
    greedy_ms = (time.perf_counter() - t0) * 1e3 / SAMPLE_STEPS
    drawn = torch.stack(drawn).long().cpu()
    check(int(drawn.min()) >= 0 and int(drawn.max()) < cfg.vocab_size,
          f"sampled decode drew ids {drawn.min()}..{drawn.max()} of "
          f"{cfg.vocab_size}")
    near = differ = 0
    for t, last in enumerate(lasts):
        top = gumbel_scores(last.cpu(), (SAMPLE_SEED, t)).topk(2, dim=-1)
        tie = (top.values[:, 0] - top.values[:, 1]) < SAMPLE_NEAR_TIE
        other = top.indices[:, 0] != drawn[t]
        check(not bool((other & ~tie).any()),
              f"sampled decode step {t}: card {drawn[t].tolist()} vs CPU "
              f"{top.indices[:, 0].tolist()}, gaps "
              f"{(top.values[:, 0] - top.values[:, 1]).tolist()}")
        near += int(tie.sum())
        differ += int(other.sum())
    row = lasts[0][0]
    counts = torch.zeros(row.shape[0], dtype=torch.int64, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(SAMPLE_DRAWS // SAMPLE_CHUNK):
        idx = gumbel_scores(row.expand(SAMPLE_CHUNK, -1),
                            (SAMPLE_CHI_SEED, c)).argmax(dim=-1)
        counts += torch.bincount(idx, minlength=row.shape[0])
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    padded = int(counts[cfg.vocab_size:].sum())
    stat, dof, pval, least = _chi_square(
        counts, torch.softmax(row.double(), dim=-1), SAMPLE_BINS)
    check(padded == 0 and least >= 5 and pval > SAMPLE_P_MIN,
          f"sampled decode: {padded} padded draws, chi-square {stat:.3f} "
          f"on {dof} dof, p {pval:.3e}, least expected count {least:.2f}")
    out = {"steps": SAMPLE_STEPS, "step_ms": step_ms,
           "greedy_step_ms": greedy_ms, "near_ties": near,
           "card_cpu_differ": differ, "max_id": int(drawn.max()),
           "draws": SAMPLE_DRAWS, "draw_s": draw_s, "chi_square": stat,
           "dof": dof, "p_value": pval, "least_expected": least,
           "padded_draws": padded}
    print(f"sampled decode {cfg.name} batch {B}, {SAMPLE_STEPS} steps: "
          f"{step_ms:.3f} ms a step (then {SAMPLE_STEPS} greedy steps "
          f"{greedy_ms:.3f}), max id {out['max_id']} < "
          f"{cfg.vocab_size}, card vs CPU tokens equal but {differ} "
          f"({near} near-ties within {SAMPLE_NEAR_TIE}); {SAMPLE_DRAWS} "
          f"draws from one row in {draw_s:.3f} s: chi-square {stat:.3f} on "
          f"{dof} dof, p {pval:.4f}, least expected count {least:.1f}, 0 "
          f"padded draws")
    return out


def dense_consistency(leg):
    """A dense leg's ``family_consistency`` at its config (``wide_cfg``),
    phi4-mini with the sampled decode (``sampled_decode``) on the same
    weights."""
    return family_consistency(
        leg, wide_cfg(leg),
        then=sampled_decode if leg == "phi4-mini" else None)


def train_deepseek():
    """deepseek-v3 at full width (4 layers, 16 routed experts) through
    ``train_straggler``: the loss falls; the MoE aux loss is finite and
    non-zero every step."""
    out = train_straggler("deepseek-v3",
                          wide_cfg("deepseek-v3", **DEEPSEEK_TRAIN))
    check(out["params"] == DEEPSEEK_TRAIN_PARAMS,
          f"train deepseek-v3: {out['params']} params")
    auxs = out["aux"]
    check(all(np.isfinite(a) and a > 0 for a in auxs),
          f"train deepseek-v3: aux {auxs}")
    print(f"train deepseek-v3: aux {auxs[0]:.6f} -> {auxs[-1]:.6f} (one MoE "
          f"layer: 1 at an even load), grad norm {out['grad_norms'][0]:.4f} "
          f"at step 0")
    return out


def _warm_wide():
    """The wide phase's code paths once at the smoke widths in bf16 (MLA on
    both paths, MoE, the frontend's projection) through ``serve.run``, so
    that the first full-size leg's times hold no first-call costs."""
    for leg in WIDE_CUT:
        cfg = dataclasses.replace(wide_cfg(leg).smoke(),
                                  param_dtype="bfloat16", dtype="bfloat16")
        serve.run(cfg, batch=2, prompt_len=64, gen=3, device=DEV)


def wide_phase():
    """deepseek-v3 (naive and absorbed MLA), llama4-maverick and
    qwen2-72b at published widths with their depth cut, llava-next-34b and
    phi4-mini-3.8b at full size, after the families phase has freed
    whisper and rwkv6: serving
    (no warm-up at full size: ``_warm_wide`` ran the same code at the smoke
    widths, and each draw of the weights costs seconds), consistency
    (decode against the full forward, the card against the CPU; phi4's
    sampled decode) and deepseek-v3's training."""
    t_phase = time.perf_counter()
    _warm_wide()
    legs = [(leg, "serve", lambda leg=leg: family_serve(
        leg, wide_cfg(leg), WIDE_SERVE[leg], WIDE_SIZE[leg], warm=False))
        for leg in WIDE_SERVE]
    legs += [(fam, "consistency", lambda fam=fam: wide_consistency(fam))
             for fam in ("deepseek-v3", "llama4-maverick", "llava-next-34b")]
    legs += [(leg, "consistency", lambda leg=leg: dense_consistency(leg))
             for leg in DENSE_LEGS]
    legs += [("deepseek-v3", "train", train_deepseek)]
    out = {leg: {} for leg in WIDE_SERVE}
    for leg, kind, fn in legs:
        res, secs = _timed(fn)
        out[leg][kind] = {**res, "seconds": secs}
        print(f"wide {leg} {kind}: {secs:.2f} s")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"wide phase wall seconds={out['seconds']:.4f}")
    return out


#: jamba-v0.1-52b, the hybrid family, at published widths.  Its 32 layers
#: (51.57 B parameters, 103 GB in bf16) exceed one card, so it is served
#: at the depth of one Jamba block: 8 layers, Mamba (d_inner 8192, d_state
#: 16, d_conv 4) but for the GQA attention layer 4 (32 heads, 8 KV heads
#: of 128), MoE (16 experts of d_ff 14 336, top-2, capacity 1.25) on the
#: odd layers and SwiGLU 14 336 on the even ones, at gemma3-4b's serve
#: shape through ``serve.run``
HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_SERVE_CUT = dict(n_layers=8)
#: (layers, encoder layers, parameters) of the served block
HYBRID_SIZE = (8, 0, 13_295_235_072)
#: trained at the reference CLIs' hybrid cut at published widths: layer 0
#: Mamba + SwiGLU, layer 1 attention + MoE with all 16 experts (one full
#: Jamba block with its AdamW state would need ~190 GB)
HYBRID_TRAIN_CUT = dict(n_layers=2, ssm_period=2, ssm_attn_offset=1)
HYBRID_TRAIN_PARAMS = 3_678_941_184
#: one Jamba block's bf16 decode against its bf16 full forward, both on
#: the full forward's routing (read 3.458e-2 on an H100: above
#: FAMILY_BF16_REL, for the reference's own bf16 arithmetic puts about
#: 1e-2 between one Mamba layer in bf16 and in float32 activations at
#: these widths, tests/test_torch_mamba.py); a decode step after a nudged
#: state must read above it
HYBRID_BF16_REL = 6e-2
#: the block's bf16 full forward and decode against its float32-activation
#: forward on the same weights (read 1.411e-1 and 1.465e-1 on an H100)
HYBRID_F32_GAP = 2e-1


def hybrid_cfg(**kw):
    """jamba-v0.1-52b with ``kw`` on top."""
    return dataclasses.replace(get_config(HYBRID_ARCH), **kw)


def hybrid_serve():
    """One Jamba block through ``family_serve`` (no warm-up at full size:
    ``hybrid_phase`` ran its code at the smoke widths), then a prefill of
    the serve shape under the profiler (``prefill_profile``): the selective
    scan's step loop is launch-bound."""
    cfg = hybrid_cfg(**HYBRID_SERVE_CUT)
    out = family_serve(HYBRID_ARCH, cfg, SERVE, HYBRID_SIZE, warm=False)
    pre = out["prefill_profiled"] = prefill_profile(
        cfg, SERVE["batch"], SERVE["prompt_len"])
    _free_cuda()
    print(f"serve {HYBRID_ARCH} a profiled prefill of {SERVE['batch']} x "
          f"{SERVE['prompt_len']} tokens: {pre['launches']} kernel launches "
          f"in {pre['ms']:.3f} ms at a busy share of {pre['busy_share']}")
    return out


def hybrid_refusal():
    """The full 32-layer jamba on the card: ``serve.run``'s weight check
    and the trainer's ``state_bytes`` check refuse it before any weight is
    drawn (``init_weights_`` replaced by a recorder meanwhile; the card's
    allocated memory unchanged)."""
    full = get_config(HYBRID_ARCH)
    weights = sum(p.numel() * p.element_size()
                  for p in init_params(full, device="meta").parameters())
    _free_cuda()
    before = torch.cuda.memory_allocated()
    real, drawn, msgs = model_layers.init_weights_, [], {}
    model_layers.init_weights_ = lambda *a, **k: drawn.append(a)
    try:
        try:
            serve.run(full, batch=SERVE["batch"],
                      prompt_len=SERVE["prompt_len"], gen=SERVE["gen"],
                      device=DEV)
        except ValueError as e:
            msgs["serve"] = str(e)
        try:
            train_cli.main(["--arch", HYBRID_ARCH, "--steps", "1",
                            "--device", str(DEV)])
        except SystemExit as e:
            msgs["train"] = str(e)
    finally:
        model_layers.init_weights_ = real
    after = torch.cuda.memory_allocated()
    check(all("exceed" in msgs.get(k, "") for k in ("serve", "train"))
          and not drawn and after == before,
          f"{HYBRID_ARCH} at full depth: {msgs}, {len(drawn)} draws, "
          f"{after - before} bytes allocated")
    state = train_cli.state_bytes(full)
    print(f"refusal {HYBRID_ARCH} at full depth ({full.n_layers} layers, "
          f"{weights} bytes of bf16 weights, {state} bytes of training "
          f"state): serve.run: {msgs['serve']}; trainer: {msgs['train']}; "
          f"no weight drawn")
    return {"weight_bytes": weights, "state_bytes": state, **msgs}


def _route_flips(calls, n_moe, B, T0, steps):
    """The (token, MoE layer) pairs whose top-K experts in a prefill of T0
    tokens and ``steps`` decode steps differ from the full forward's at the
    same position (``calls``: a ``RouteTape`` over ``_decode_vs_full``,
    which routes the full forward, the prefill, then each step), and all
    routed pairs."""
    T = T0 + steps
    check(len(calls) == n_moe * (2 + steps),
          f"routing tape: {len(calls)} calls for {n_moe} MoE layers")
    flipped = 0
    for j in range(n_moe):
        full = calls[j].top_i.reshape(B, T, -1)
        got = torch.cat([calls[n_moe + j].top_i.reshape(B, T0, -1)] + [
            calls[n_moe * (2 + s) + j].top_i.reshape(B, 1, -1)
            for s in range(steps)], dim=1)
        flipped += int((got.sort(-1).values != full.sort(-1).values)
                       .any(-1).sum())
    return flipped, n_moe * B * T


def _decode_pins(full, B, T0, steps):
    """Pins (``RoutePin``) for a run of ``_decode_vs_full`` from the full
    forward's routing (``full``: its MoE calls over B T tokens): the full
    forward's own, then each token of the prefill of T0 tokens and of the
    ``steps`` decode steps pinned to its full-forward experts and gate
    weights."""
    T = T0 + steps
    per = [(c.top_w.reshape(B, T, -1), c.top_i.reshape(B, T, -1))
           for c in full]
    pins = [(c.top_w, c.top_i) for c in full]
    pins += [(w[:, :T0].reshape(B * T0, -1), i[:, :T0].reshape(B * T0, -1))
             for w, i in per]
    for s in range(steps):
        pins += [(w[:, T0 + s], i[:, T0 + s]) for w, i in per]
    return pins


@torch.inference_mode()
def hybrid_consistency():
    """(1) One Jamba block at published widths on the card, at
    capacity_factor E/K (``no_drop_cfg``), a 16-token prefill plus 8 decode
    steps against the full forward at the same positions
    (``_decode_vs_full``).  On its own routing (read, not held): near-tied
    routers pick other experts in the decode than in the full forward, and
    those tokens are counted.  Then every run is pinned to the bf16 full
    forward's experts and gate weights (``RoutePin``): the bf16 decode is
    held to the full forward within ``HYBRID_BF16_REL``, and a decode
    step after a prefill whose first layer's state was nudged
    (``_nudge``) must read above that bound; the float32-activation decode
    on the same bf16 weights is held to its full forward within
    ``FAMILY_F32_REL`` (``_f32_truth``), and the bf16 full forward and
    decode to that float32 forward within ``HYBRID_F32_GAP``.  Counts set
    to 0 just before, read after: no swa_attention launch.  (2) The CLIs'
    hybrid smoke cut in float32, the card against the CPU
    (``_smoke_card_vs_cpu``), every Mamba layer's ``h`` and ``conv``
    included."""
    cfg = no_drop_cfg(hybrid_cfg(**HYBRID_SERVE_CUT))
    B, P, steps = 2, 16, 8
    gen = torch.Generator(device=DEV).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, P + steps), generator=gen,
                         device=DEV)
    ops.reset_launch_counts()
    model = init_params(cfg, seed=1, device=DEV)
    with RouteTape() as tape:
        rel_own, _, _ = _decode_vs_full(model, cfg, toks, steps, {})
    n_moe = sum(s.ffn == "moe" for s in layer_specs(cfg))
    flipped, routed = _route_flips(tape.calls, n_moe, B, P, steps)
    full_calls = tape.calls[:n_moe]
    del tape
    pins = _decode_pins(full_calls, B, P, steps)
    with RoutePin(pins) as pin:
        rel, dec, full = _decode_vs_full(model, cfg, toks, steps, {})
    pin32 = RoutePin(pins)
    rel32, gap, dec_gap = _f32_truth(model, cfg, toks, steps, {}, full, dec,
                                     route=pin32)
    with RoutePin(_decode_pins(full_calls, B, P + steps - 1, 1)):
        moved, _, _ = _decode_vs_full(model, cfg, toks, 1, {}, nudge=True)
    launches = dict(ops.LAUNCHES)
    del model, dec, full, full_calls, pins
    _free_cuda()
    check(np.isfinite(rel) and rel <= HYBRID_BF16_REL < moved
          and gap <= HYBRID_F32_GAP and dec_gap <= HYBRID_F32_GAP
          and _swa_launches(launches) == 0,
          f"{HYBRID_ARCH} on the full forward's routing: bf16 decode vs full "
          f"{rel:.3e} (bound {HYBRID_BF16_REL}; {moved:.3e} after a nudged "
          f"state, which must read above it); the bf16 full forward "
          f"{gap:.3e} and decode {dec_gap:.3e} from the float32-activation "
          f"forward (bound {HYBRID_F32_GAP}); on its own routing "
          f"{rel_own:.3e}, {flipped} of {routed} routed tokens picking other "
          f"experts; swa launches {launches}")
    small = cli_config(HYBRID_ARCH, smoke=True)
    out = {"decode_vs_full_bf16_rel": rel,
           "decode_vs_full_bound": HYBRID_BF16_REL,
           "nudged_bf16_rel": moved, "f32_decode_vs_full_rel": rel32,
           "full_vs_f32_bf16_rel": gap, "decode_vs_f32_bf16_rel": dec_gap,
           "f32_gap_bound": HYBRID_F32_GAP,
           "own_routing_decode_vs_full_bf16_rel": rel_own,
           "capacity_factor": cfg.capacity_factor,
           "flipped_tokens": flipped, "routed_tokens": routed,
           "pinned_flipped_pairs": pin.flipped + pin32.flipped,
           "pinned_routed_pairs": pin.routed + pin32.routed,
           **_smoke_card_vs_cpu(small),
           "swa_launches": _swa_launches(launches)}
    check(out["card_vs_cpu_mamba"] is not None,
          f"{small.name}: no Mamba state compared")
    print(f"consistency {HYBRID_ARCH} one block bf16: prefill {P} + {steps} "
          f"decode steps on the full forward's routing vs the full forward "
          f"rel {rel:.3e} (bound {HYBRID_BF16_REL}; one step after a nudged "
          f"first-layer state {moved:.3e}); the bf16 full forward "
          f"{gap:.3e} and decode {dec_gap:.3e} from the float32-activation "
          f"forward (bound {HYBRID_F32_GAP}); the float32-activation decode "
          f"vs its full forward {rel32:.3e} (bound {FAMILY_F32_REL}); "
          f"capacity_factor {cfg.capacity_factor:g}; "
          f"{out['pinned_flipped_pairs']} of {out['pinned_routed_pairs']} "
          f"pinned (token, layer) pairs would pick other experts; on its "
          f"own routing rel {rel_own:.3e}, {flipped} of {routed} routed "
          f"(token, layer) pairs picking other experts than the full "
          f"forward; {_card_vs_cpu_line(small.name, out)}; swa_attention "
          f"launches 0")
    return out


def train_jamba():
    """jamba-v0.1-52b at the CLIs' hybrid cut at published widths (a Mamba
    + SwiGLU and an attention + MoE layer, 16 experts) through
    ``train_straggler``: the loss falls; the MoE aux loss is finite and
    non-zero every step."""
    out = train_straggler(HYBRID_ARCH, hybrid_cfg(**HYBRID_TRAIN_CUT))
    check(out["params"] == HYBRID_TRAIN_PARAMS,
          f"train {HYBRID_ARCH}: {out['params']} params")
    auxs = out["aux"]
    check(all(np.isfinite(a) and a > 0 for a in auxs),
          f"train {HYBRID_ARCH}: aux {auxs}")
    print(f"train {HYBRID_ARCH}: aux {auxs[0]:.6f} -> {auxs[-1]:.6f} (one "
          f"MoE layer: 1 at an even load), grad norm "
          f"{out['grad_norms'][0]:.4f} at step 0")
    return out


def hybrid_phase():
    """jamba-v0.1-52b after the wide phase: one Jamba block served at
    published widths (``hybrid_serve``), the full depth refused by both launchers'
    memory checks, consistency (decode against the full forward, the card
    against the CPU with the Mamba state) and training at the CLIs' cut.
    The block's code paths run first at the smoke widths in bf16, so the
    served leg's times hold no first-call costs."""
    t_phase = time.perf_counter()
    serve.run(dataclasses.replace(get_config(HYBRID_ARCH).smoke(),
                                  n_layers=8, param_dtype="bfloat16",
                                  dtype="bfloat16"),
              batch=2, prompt_len=64, gen=3, device=DEV)
    legs = [("serve", hybrid_serve),
            ("refusal", hybrid_refusal),
            ("consistency", hybrid_consistency),
            ("train", train_jamba)]
    out = {}
    for kind, fn in legs:
        res, secs = _timed(fn)
        out[kind] = {**res, "seconds": secs}
        print(f"hybrid {HYBRID_ARCH} {kind}: {secs:.2f} s")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"hybrid phase wall seconds={out['seconds']:.4f}")
    return out


#: the bfloat16 tensor-core swa kernel's gate at the long variant's window,
#: at the shapes the long variants' prefills give it (LONG_SERVE's 32 768
#: tokens, so T > W and the window's edge is crossed): (B, T, H, K, dh, W)
#: at gemma3-4b's and mistral-nemo-12b's heads
LONG_SWA = [(1, 32768, 8, 4, 256, 8192), (1, 32768, 32, 8, 128, 8192)]
#: the long variants served at full width: long_500k's batch of 1, a
#: prompt cut to 32 768 tokens (the shape's 524 288 would need (1, 524 288,
#: V_pad) prefill logits, 275 GB for gemma3-4b), 32 tokens generated
LONG_ARCHS = {"gemma3-4b": 34, "mistral-nemo-12b": 40}
LONG_SERVE = dict(batch=1, prompt_len=32768, gen=32)
#: decode steps held to the full forward after a LONG_SERVE-long prefill:
#: every one past the window, the ring wrapped
LONG_DECODE_STEPS = 4
#: the dry run's combos whose decode build runs for real on the card: a
#: ring of 8 192 slots at depth 524 288, and rwkv6's O(1) state at batch 128
DRY_HELD = [("gemma3-4b", "long_500k"), ("rwkv6-1.6b", "decode_32k")]
#: the train round held to the card: gemma3-4b at published widths cut to
#: 4 layers, its 16 workers one 512-token sequence each (train_4k's 256 x
#: 4 096 round peaks at 3.5 TB on no card)
DRY_TRAIN = ("gemma3-4b", 4, InputShape("train_4k", 512, 16, "train"))
#: the card against the dry run, as shares of the dry run's bytes: the
#: build's allocation against ``argument_size_in_bytes``, and the second
#: step's peak over what it started with against ``temp_size_in_bytes``.
#: Set from the readings of the shapes phase ("NVIDIA H100 80GB HBM3,
#: 700.00 W"): arguments +1.02e-4 (gemma3-4b long_500k), 0 (rwkv6-1.6b
#: decode_32k), +6.1e-5 (the train round); temps +1.9e-5, +5.9e-7,
#: -3.4e-6.  Each limit is about five times the largest reading; what the
#: card adds is the allocator's rounding of blocks, not a tensor the trace
#: misses (1e-4 of the train round's temp is 2.6 MB, of gemma3-4b's
#: decode temp 13 kB)
DRY_ARG_TOL = 5e-4
DRY_TEMP_TOL = 1e-4
DRY_DIR = Path(__file__).resolve().parent / "build" / "dryrun_smoke"


def long_swa_gate(B, T, H, K, dh, W):
    """The bfloat16 swa kernel at (B, T, H, K, dh, W) against its plain
    version (``ref.swa_attention_ref`` one KV group at a time, so its
    float32 scores fit the card: (1, 4, 32 768, 32 768), 17.2 GB, at
    mistral-nemo-12b's heads), elementwise |got - want| <= 1e-3 + 1e-2
    |want| as in ``swa_phase``; one launch on the tensor-core route; the
    kernel's, the plain version's and SDPA-with-a-band-mask's times."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(5)
    q = (torch.randn(B, T, H, dh, generator=gen, device=DEV) * 0.5).to(bf16)
    k = (torch.randn(B, T, K, dh, generator=gen, device=DEV) * 0.5).to(bf16)
    v = torch.randn(B, T, K, dh, generator=gen, device=DEV).to(bf16)
    G = H // K

    def plain():
        return torch.cat([ref.swa_attention_ref(
            q[:, :, g * G:(g + 1) * G], k[:, :, g:g + 1], v[:, :, g:g + 1], W)
            for g in range(K)], dim=2)

    before = dict(ops.LAUNCHES)
    got = ops.swa_attention(q, k, v, window=W)
    want = plain()
    torch.cuda.synchronize()
    counts = {name: ops.LAUNCHES[name] - before[name]
              for name in ("swa_attention", "swa_attention_wgmma")}
    check(counts == {"swa_attention": 1, "swa_attention_wgmma": 1},
          f"swa_attention at {(B, T, H, K, dh, W)} bf16: launches {counts}")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    worst = (diff / (1e-3 + 1e-2 * want.float().abs())).max().item()
    check(worst <= 1, f"swa_attention |got - want| exceeds 1e-3 + 1e-2 |want|"
                      f" {worst:.2f}x (max abs err {err:.2e}) at "
                      f"{(B, T, H, K, dh, W)} bf16")
    del diff, want, got
    kernel = lambda: ops.swa_attention(q, k, v, window=W)  # noqa: E731
    row = dict(shape=[B, T, H, K, dh, W], dtype="bfloat16",
               swa_route="tensor_core", max_abs_err=err, worst_share=worst,
               ms=cuda_ms(kernel, 10), plain_ms=cuda_ms(plain, 1, warmup=1),
               library_ms=cuda_ms(sdpa_banded(q, k, v, W), 5))
    row["bound_ms"], row["bound_by"], _ = swa_bound(B, T, H, K, dh, W, bf16)
    row["tflop_per_s"] = ops.swa_flops(B, T, H, dh, W) / row["ms"] / 1e9
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print(f"shapes kernel swa_attention B={B} T={T} H={H} K={K} dh={dh} W={W}"
          f" bfloat16 route=tensor_core: max_abs_err={err:.3e} "
          f"({worst:.3f} of the tolerance) ms={row['ms']:.5f} "
          f"({row['tflop_per_s']:.1f} TFLOP/s, {row['bound_share']:.3f} of "
          f"bound) plain_ms={row['plain_ms']:.5f} (one KV group at a time) "
          f"library_ms={row['library_ms']:.5f} bound_ms="
          f"{row['bound_ms']:.5f} ({row['bound_by']})")
    del q, k, v
    _free_cuda()
    return row


@torch.inference_mode()
def long_serve(arch):
    """``arch``'s long variant (every layer sliding-window at W 8192) at
    full width in bf16, random weights: through ``serve.run`` at
    ``LONG_SERVE`` (counts set to 0 just before: one tensor-core
    swa_attention launch a layer in the prefill, none in decode; logits
    finite, tokens in range; peak memory); then its decode against the full
    forward past the window (``_decode_vs_full``, the ring route against
    the kernel's) within ``FAMILY_BF16_REL``; then its smoke config in
    float32, the card against the CPU (``_smoke_card_vs_cpu``)."""
    cfg = resolve(get_config(arch), "long_500k")
    n = LONG_ARCHS[arch]
    check(cfg.n_layers == n and cfg.name == arch + "+swa"
          and cfg.sliding_window == 8192
          and {s.mixer for s in layer_specs(cfg)} == {"swa"},
          f"{arch} long variant: {cfg.name}, {cfg.n_layers} layers, window "
          f"{cfg.sliding_window}")
    B, P, G = (LONG_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    _free_cuda()
    ops.reset_launch_counts()
    res = serve.run(cfg, batch=B, prompt_len=P, gen=G, seed=0, device=DEV)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    pre = res.launches_after_prefill
    check(pre["swa_attention"] == pre["swa_attention_wgmma"] == n
          and _swa_launches(launches) == _swa_launches(pre),
          f"{cfg.name} serve launches: prefill {pre}, run {launches}")
    check(res.finite, f"{cfg.name} serve: non-finite logits")
    check(tuple(res.tokens.shape) == (B, G)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          f"{cfg.name} serve: tokens {tuple(res.tokens.shape)} out of range")
    _free_cuda()
    model = init_params(cfg, seed=1, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, P + LONG_DECODE_STEPS),
                         generator=gen, device=DEV)
    ops.reset_launch_counts()
    rel, _, _ = _decode_vs_full(model, cfg, toks, LONG_DECODE_STEPS, {})
    moved = (_moves_when_nudged(model, cfg, toks, {}, cfg.name) if rel == 0
             else None)
    dvf = dict(ops.LAUNCHES)
    dvf_peak = torch.cuda.max_memory_allocated()
    check(np.isfinite(rel) and rel <= FAMILY_BF16_REL
          and dvf["swa_attention_wgmma"] == (2 + 2 * (moved is not None)) * n,
          f"{cfg.name} bf16 decode vs full rel {rel:.3e} (bound "
          f"{FAMILY_BF16_REL}), launches {dvf}")
    del model
    _free_cuda()
    small = long_variant(get_config(arch)).smoke()
    check({s.mixer for s in layer_specs(small)} == {"swa"},
          f"{small.name}: not every layer sliding-window")
    out = {"layers": n, "window": cfg.sliding_window, "batch": B,
           "prompt_len": P, "gen": G, "init_s": res.init_s,
           "prefill_ms": res.prefill_s * 1e3,
           "prefill_tok_per_s": B * P / res.prefill_s,
           "decode_ms_per_step": res.decode_s * 1e3 / (G - 1),
           "decode_tok_per_s": B * (G - 1) / res.decode_s,
           "peak_mem_bytes": peak, "prefill_swa_launches": pre["swa_attention"],
           "prefill_wgmma_launches": pre["swa_attention_wgmma"],
           "decode_vs_full_bf16_rel": rel, "nudged_bf16_rel": moved,
           "decode_vs_full_wgmma_launches": dvf["swa_attention_wgmma"],
           "decode_vs_full_peak_mem_bytes": dvf_peak,
           **_smoke_card_vs_cpu(small)}
    print(f"shapes serve {cfg.name} {n} layers bf16 W=8192 batch={B} "
          f"prompt={P} gen={G}: init_params {res.init_s:.3f} s, prefill "
          f"{out['prefill_ms']:.3f} ms ({out['prefill_tok_per_s']:.1f} tok/s),"
          f" decode {out['decode_ms_per_step']:.4f} ms/step "
          f"({out['decode_tok_per_s']:.1f} tok/s), peak memory {peak} bytes; "
          f"swa_attention launches in the prefill {pre['swa_attention']} "
          f"(tensor-core {pre['swa_attention_wgmma']}), in decode 0; "
          f"{LONG_DECODE_STEPS} decode steps past the window vs the full "
          f"forward rel {rel:.3e} (bound {FAMILY_BF16_REL}; "
          f"{dvf['swa_attention_wgmma']} kernel launches, peak {dvf_peak} "
          f"bytes); {_card_vs_cpu_line(small.name, out)}")
    return out


@contextlib.contextmanager
def _shape_cut(shape):
    """``SHAPES[shape.name]`` is ``shape`` inside the block."""
    whole = SHAPES[shape.name]
    SHAPES[shape.name] = shape
    try:
        yield
    finally:
        SHAPES[shape.name] = whole


def _held_on_card(cfg, shape, flops, mem):
    """``cfg``'s build of ``shape`` for real on the card (weights from seed
    0, zero caches and tokens), run as ``dryrun.measure`` runs it on
    ``meta``: one step under ``FlopCounterMode``, which must count exactly
    ``flops``; then one step whose peak over the bytes it started with must
    lie within ``DRY_TEMP_TOL`` of ``mem``'s temp bytes, as the build's own
    allocation must of its argument bytes (``DRY_ARG_TOL``).  Returns (the
    step, its arguments, the readings)."""
    _free_cuda()
    before = torch.cuda.memory_allocated()
    fn, args, _ = dryrun.build(cfg, shape, device=DEV, seed=0)
    torch.cuda.synchronize()
    card_args = torch.cuda.memory_allocated() - before
    with FlopCounterMode(display=False) as fc:
        out = fn()
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    card_temp = torch.cuda.max_memory_allocated() - base
    del out
    want_args = mem["argument_size_in_bytes"]
    want_temp = mem["temp_size_in_bytes"]
    got = {"flops": fc.get_total_flops(), "argument_bytes": want_args,
           "card_argument_bytes": card_args, "temp_bytes": want_temp,
           "card_temp_bytes": card_temp,
           "argument_gap": (card_args - want_args) / want_args,
           "temp_gap": (card_temp - want_temp) / want_temp}
    what = f"dry run {cfg.name} {shape} ({SHAPES[shape]})"
    check(got["flops"] == flops, f"{what}: the card counts {got['flops']} "
                                 f"FLOPs, the dry run {flops}")
    check(abs(got["argument_gap"]) <= DRY_ARG_TOL,
          f"{what}: the build allocates {card_args} bytes on the card, the "
          f"dry run counts {want_args} ({got['argument_gap']:+.6f}, "
          f"tolerance {DRY_ARG_TOL})")
    check(abs(got["temp_gap"]) <= DRY_TEMP_TOL,
          f"{what}: the step's peak is {card_temp} bytes over its start on "
          f"the card, the dry run's temp {want_temp} "
          f"({got['temp_gap']:+.6f}, tolerance {DRY_TEMP_TOL})")
    return fn, args, got


def _held_line(got):
    return (f"card FLOPs {got['flops']:.6e} = the dry run's; arguments "
            f"{got['card_argument_bytes']} bytes on the card vs "
            f"{got['argument_bytes']} counted ({got['argument_gap']:+.6f}); "
            f"the step's peak {got['card_temp_bytes']} bytes over its start "
            f"vs temp {got['temp_bytes']} ({got['temp_gap']:+.6f})")


def dryrun_held(arch, shape):
    """The dry run of (``arch``, ``shape``) on ``meta``, its artifact's
    counts held to its own build on the card (``_held_on_card``); then the
    step's time (CUDA events, 5 steps) beside the roofline's
    max(compute_s, memory_s)."""
    art = dryrun.run_one(arch, shape, out_dir=str(DRY_DIR))
    cfg = dryrun.dryrun_config(get_config(arch), shape)
    fn, args, got = _held_on_card(cfg, shape, art["flops_per_device"],
                                  art["memory_analysis"])
    ms = cuda_ms(fn, 5, warmup=2)
    ro = art["roofline"]
    roof_ms = max(ro["compute_s"], ro["memory_s"]) * 1e3
    out = {"arch": arch, "shape": shape, "config": cfg.name, **got,
           "bytes": art["bytes_per_device"], "ms": ms, "roofline_ms": roof_ms,
           "roofline_share": roof_ms / ms, "dominant": ro["dominant"],
           "fits": art["fits"], "meta_wall_s": art["wall_s"]}
    print(f"shapes dry run {arch} {shape} ({cfg.name}): {_held_line(got)}; "
          f"a step {ms:.4f} ms vs max(compute_s, memory_s) {roof_ms:.4f} ms "
          f"({roof_ms / ms:.3f} of the roofline, {ro['dominant']}); the "
          f"meta trace took {art['wall_s']:.2f} s")
    del fn, args
    _free_cuda()
    return out


def dryrun_train_held():
    """``DRY_TRAIN``'s straggler train round (remat and AdamW, as the dry
    run builds it) traced on ``meta`` by ``dryrun.measure``, its counts
    held to the same round on the card (``_held_on_card``)."""
    arch, layers, shape = DRY_TRAIN
    cfg = dataclasses.replace(
        dryrun.dryrun_config(get_config(arch), shape.name), n_layers=layers)
    with _shape_cut(shape):
        t0 = time.perf_counter()
        res = dryrun.measure(*dryrun.build(cfg, shape.name)[:2])
        wall = time.perf_counter() - t0
        fn, args, got = _held_on_card(cfg, shape.name, res["flops"],
                                      res["mem"])
    del fn, args
    _free_cuda()
    print(f"shapes dry run {arch} cut to {layers} layers, train round "
          f"{shape}: {_held_line(got)}; the meta trace took {wall:.2f} s")
    return {"arch": arch, "layers": layers, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch, **got, "meta_wall_s": wall}


def shapes_phase():
    """The input shapes' long-context variant on the card, after the hybrid
    phase: the bf16 swa kernel gated at W 8192 at both long variants' heads
    (``long_swa_gate``), gemma3-4b+swa and mistral-nemo-12b+swa served at
    full width (``long_serve``), the dry run held to the card at two combos
    (``dryrun_held``) and at a cut train round (``dryrun_train_held``),
    then the phase's artifacts through ``roofline.to_markdown``."""
    t_phase = time.perf_counter()
    shutil.rmtree(DRY_DIR, ignore_errors=True)
    out = {"gates": [long_swa_gate(*shape) for shape in LONG_SWA]}
    for arch in LONG_ARCHS:
        out[arch], secs = _timed(lambda: long_serve(arch))
        out[arch]["seconds"] = secs
    out["dryrun"] = [dryrun_held(*combo) for combo in DRY_HELD]
    out["dryrun_train"] = dryrun_train_held()
    table = roofline.to_markdown(roofline.rows(str(DRY_DIR)))
    check(len(table.splitlines()) == 2 + len(DRY_HELD),
          f"roofline table of {DRY_DIR}:\n{table}")
    print(table)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"shapes phase wall seconds={out['seconds']:.4f}")
    return out


# ------------------------------------------------------------------ mesh

#: the grouped-GQA legs: mistral-nemo-12b's base (every layer full
#: attention, 40 layers, 12 247 782 400 parameters) at gemma3-4b's shape
MESH_ARCH = "mistral-nemo-12b"
MESH_SIZE = (40, 0, 12_247_782_400)
MESH_SERVE = SERVE
MESH_DECODE_STEPS = 8
#: rounds of 16 decode steps of each path, in turn
MESH_TIMED = 3
#: one deepseek-v3 MoE layer at published widths (256 experts of d 7168 x
#: f 2048, top 8, one shared expert) over 2 x 2048 tokens, split over two
#: ranks on the one card
MESH_EP_TOKENS = (2, 2048)
MESH_EP_SEED = 4
#: one attention layer at mistral-nemo's widths (32 heads, 8 KV heads, dh
#: 128) decoding 32 steps against a 32 768-slot cache split over two ranks
MESH_RING = dict(batch=2, cache=32768, steps=32)
MESH_RANKS = 2
MESH_DIR = Path(__file__).resolve().parent / "build" / "mesh_smoke"
#: the mesh dry runs on ``meta``, one process each: (arch, shape, variant,
#: mesh)
MESH_DRY = [("mistral-nemo-12b", "decode_32k", "", "16x16"),
            ("mistral-nemo-12b", "decode_32k", "grouped", "16x16"),
            ("mistral-nemo-12b", "decode_32k", "ringdecode", "16x16"),
            ("deepseek-v3-671b", "decode_32k", "", "16x16"),
            ("phi4-mini-3.8b", "train_4k", "zero1", "2x16x16")]


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(fn, *args):
    """``fn(rank, world, port, *args)`` in ``MESH_RANKS`` processes on the
    one card, joined before this returns (``torch.multiprocessing``)."""
    import torch.multiprocessing as mp
    mp.spawn(fn, args=(MESH_RANKS, _free_port()) + args, nprocs=MESH_RANKS,
             join=True)


def _rank_group(rank, world, port):
    """This rank's gloo group on ``cuda:0`` and a 1 x world mesh context
    (NCCL takes no two ranks on one card)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh_ctx
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    return make_local_mesh_ctx(1, world)


def _rank_report(rank, res, name):
    """Every rank's ``res`` gathered to rank 0, which writes them."""
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, res)
    if rank == 0:
        (MESH_DIR / name).write_text(json.dumps(got))
    dist.destroy_process_group()


def _mesh_dry_start():
    """The mesh dry runs (``MESH_DRY``), each in a process of its own on
    one CPU thread (a mesh starts the fake process group), started now to
    run beside the card's legs."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(
        Path(__file__).resolve().parent / "src"))
    procs = []
    for arch, shape, variant, mesh in MESH_DRY:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out-dir",
               str(MESH_DIR)] + (["--variant", variant] if variant else [])
        procs.append((time.perf_counter(), subprocess.Popen(
            cmd, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)))
    return procs


def _mesh_dry_finish(procs, card):
    """Waits for the mesh dry runs and prints each artifact's per-device
    FLOPs, bytes, peak and collective bytes by kind."""
    out = []
    for (arch, shape, variant, mesh), (t0, p) in zip(MESH_DRY, procs):
        _, err = p.communicate(timeout=900)
        wall = time.perf_counter() - t0
        check(p.returncode == 0, f"mesh dry run {arch} {shape} {variant} "
                                 f"{mesh}: rc {p.returncode}\n{err[-3000:]}")
        name = dryrun.artifact_name(str(MESH_DIR), arch, shape, variant,
                                    mesh)
        art = json.loads(Path(name).read_text())
        coll = art["collectives"]
        check(art["n_devices"] == (512 if mesh == "2x16x16" else 256)
              and coll["total_bytes"] > 0 and art["flops_per_device"] > 0,
              f"mesh dry run {name}: {art['n_devices']} devices, "
              f"collectives {coll}")
        row = {"arch": arch, "shape": shape, "variant": variant or
               "baseline", "mesh": mesh, "n_devices": art["n_devices"],
               "flops_per_device": art["flops_per_device"],
               "bytes_per_device": art["bytes_per_device"],
               "argument_bytes": art["memory_analysis"][
                   "argument_size_in_bytes"],
               "temp_bytes": art["memory_analysis"]["temp_size_in_bytes"],
               "collective_bytes": coll["bytes"],
               "collective_counts": coll["counts"],
               "collective_total_bytes": coll["total_bytes"],
               "roofline": {k: art["roofline"][k] for k in (
                   "compute_s", "memory_s", "collective_s", "dominant")},
               "meta_wall_s": art["wall_s"], "process_wall_s": wall}
        out.append(row)
        print(f"mesh dry run {arch} {shape} {row['variant']} on {mesh} "
              f"({art['n_devices']} devices, meta, per device): FLOPs "
              f"{art['flops_per_device']:.6e}, bytes "
              f"{art['bytes_per_device']:.6e}, arguments "
              f"{row['argument_bytes']} + temp {row['temp_bytes']} bytes, "
              f"collective bytes {coll['bytes']} (counts {coll['counts']}, "
              f"total {coll['total_bytes']}), terms compute "
              f"{row['roofline']['compute_s']:.4e} s / memory "
              f"{row['roofline']['memory_s']:.4e} s / collective "
              f"{row['roofline']['collective_s']:.4e} s; trace "
              f"{art['wall_s']:.2f} s, process {wall:.2f} s (card "
              f"{card})")
    return out


@torch.inference_mode()
def grouped_decode(base, grouped):
    """The ``repeat_kv`` and the grouped decode on one set of bf16 weights
    (seed 1) after one 2048-token prefill each: each held to its full
    forward over ``MESH_DECODE_STEPS`` steps within ``FAMILY_BF16_REL``,
    the two decodes' logits to each other within it; then, from a
    prefilled cache of each, ``MESH_TIMED`` rounds of 16 steps of each in
    turn (ms a step, CUDA-synchronised wall; the peak over the step's
    start), and 8 steps of each under the profiler (launches a step, busy
    share).  No swa_attention launch."""
    _free_cuda()
    model = init_params(grouped, seed=1, device=DEV)
    plain = _same_weights(model, base)
    gen = torch.Generator(device=DEV).manual_seed(1)
    B, P = MESH_SERVE["batch"], MESH_SERVE["prompt_len"]
    toks = torch.randint(0, base.vocab_size, (B, P + MESH_DECODE_STEPS),
                         generator=gen, device=DEV)
    ops.reset_launch_counts()
    rel_g, dec_g, _ = _decode_vs_full(model, grouped, toks,
                                      MESH_DECODE_STEPS, {})
    rel_r, dec_r, _ = _decode_vs_full(plain, base, toks,
                                      MESH_DECODE_STEPS, {})
    g_vs_r = _rel_gap(dec_g, dec_r)
    legs = {"repeat_kv": (plain, base), "grouped": (model, grouped)}
    state = {}
    for name, (m, cfg) in legs.items():
        cache = init_cache(cfg, B, P + 16 * MESH_TIMED + 16, device=DEV)
        _, _, cache = forward(m, cfg, toks[:, :P], cache=cache)
        state[name] = [cache, toks[:, P:P + 1], make_serve_step(cfg), [],
                       0]

    def steps(name, n):
        cache, nxt, step, _, _ = state[name]
        m = legs[name][0]
        for _ in range(n):
            nxt, cache, _ = step(m, cache, nxt)
        state[name][0], state[name][1] = cache, nxt

    for _ in range(MESH_TIMED):
        for name in legs:
            _free_cuda()
            base_mem = torch.cuda.memory_allocated()
            _, secs = _timed(lambda: steps(name, 16))
            state[name][3].append(secs * 1e3 / 16)
            state[name][4] = max(state[name][4],
                                 torch.cuda.max_memory_allocated()
                                 - base_mem)
    out = {"grouped_decode_vs_full": rel_g,
           "repeat_kv_decode_vs_full": rel_r, "grouped_vs_repeat_kv": g_vs_r}
    for name in legs:
        wall, dev_s, count = profiled(lambda: steps(name, 8))
        out[name] = {"ms_per_step": state[name][3],
                     "step_peak_bytes": state[name][4],
                     "launches_per_step": None if count is None
                     else count / 8,
                     "busy_share_profiled": None if dev_s is None
                     else dev_s / wall}
    swa = _swa_launches(ops.LAUNCHES)
    check(max(rel_g, rel_r, g_vs_r) <= FAMILY_BF16_REL and swa == 0,
          f"grouped decode vs full {rel_g:.3e}, repeat_kv decode vs full "
          f"{rel_r:.3e}, grouped vs repeat_kv {g_vs_r:.3e} (bound "
          f"{FAMILY_BF16_REL}); swa launches {swa}")
    del model, plain, state
    _free_cuda()
    return out


def grouped_flops_held(grouped):
    """The grouped decode step's FLOPs counted on ``meta`` by the dry run
    (``dryrun.measure``) against the same step run on the card under
    ``FlopCounterMode``: equal.  The serve shape's last step (B 2, a cache
    of 2 080 positions) at published widths, cut to 4 layers."""
    B, P, G = (MESH_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    shape = InputShape("decode_32k", P + G, B, "decode")
    with _shape_cut(shape):
        cfg = dataclasses.replace(
            dryrun.dryrun_config(get_config(MESH_ARCH), shape.name,
                                 "grouped"), n_layers=4)
        res = dryrun.measure(*dryrun.build(cfg, shape.name)[:2])
        _free_cuda()
        fn, args, _ = dryrun.build(cfg, shape.name, device=DEV, seed=0)
        with FlopCounterMode(display=False) as fc:
            out = fn()
        del out, fn, args
        _free_cuda()
    flops = fc.get_total_flops()
    check(flops == res["flops"], f"grouped decode step: the card counts "
                                 f"{flops} FLOPs, the dry run {res['flops']}")
    return {"layers": 4, "flops": flops, "dry_run_flops": res["flops"],
            "dry_run_bytes": res["bytes"]}


def _served(name, res, B, P, G, peak):
    check(res.finite and tuple(res.tokens.shape) == (B, G)
          and bool(((res.tokens >= 0)
                    & (res.tokens < get_config(MESH_ARCH).vocab_size)).all()),
          f"serve {name}: non-finite logits or tokens out of range")
    return {"init_s": res.init_s, "prefill_ms": res.prefill_s * 1e3,
            "decode_ms_per_step": res.decode_s * 1e3 / (G - 1),
            "peak_mem_bytes": peak}


def grouped_leg(card):
    """mistral-nemo-12b's base at full width and depth in bf16 at
    ``MESH_SERVE``: served with ``grouped_gqa`` off through the serve CLI
    and on through ``serve.run`` (prefill and decode ms, peak memory; no
    swa_attention launch), both decodes on one set of weights
    (``grouped_decode``: held to their full forwards and to each other,
    ms a step in turn, launches and busy share under the profiler), the
    grouped smoke config card against CPU in float32, and the grouped
    step's FLOPs counted by the dry run equal to the card's
    (``grouped_flops_held``)."""
    base = get_config(MESH_ARCH)
    grouped = dataclasses.replace(base, grouped_gqa=True)
    n_params = sum(p.numel() for p in init_params(base, device="meta")
                   .parameters())
    check((base.n_layers, base.encoder_layers, n_params) == MESH_SIZE,
          f"{MESH_ARCH}: {base.n_layers} layers, {n_params} parameters")
    B, P, G = (MESH_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    out = {}
    _free_cuda()
    ops.reset_launch_counts()
    res = serve.main(["--arch", MESH_ARCH, "--batch", str(B), "--prompt-len",
                      str(P), "--gen", str(G), "--seed", "0", "--device",
                      str(DEV)])
    out["serve_repeat_kv"] = _served("repeat_kv", res, B, P, G,
                                     torch.cuda.max_memory_allocated())
    _free_cuda()
    res = serve.run(grouped, batch=B, prompt_len=P, gen=G, seed=0,
                    device=DEV)
    out["serve_grouped"] = _served("grouped", res, B, P, G,
                                   torch.cuda.max_memory_allocated())
    check(_swa_launches(ops.LAUNCHES) == 0,
          f"serve {MESH_ARCH}: swa launches {ops.LAUNCHES}")
    _free_cuda()
    out.update(grouped_decode(base, grouped))
    small = dataclasses.replace(base.smoke(), grouped_gqa=True)
    out.update(_smoke_card_vs_cpu(small))
    out["flops_held"] = grouped_flops_held(grouped)
    g, r = out["grouped"], out["repeat_kv"]
    print(f"mesh grouped {MESH_ARCH} 40 layers {n_params} params bf16 "
          f"batch={B} prompt={P} gen={G}: serve CLI (repeat_kv) prefill "
          f"{out['serve_repeat_kv']['prefill_ms']:.3f} ms, decode "
          f"{out['serve_repeat_kv']['decode_ms_per_step']:.4f} ms/step, peak "
          f"{out['serve_repeat_kv']['peak_mem_bytes']} bytes; serve.run "
          f"(grouped) prefill {out['serve_grouped']['prefill_ms']:.3f} ms, "
          f"decode {out['serve_grouped']['decode_ms_per_step']:.4f} ms/step, "
          f"peak {out['serve_grouped']['peak_mem_bytes']} bytes; in turn on "
          f"one model, ms a step grouped {g['ms_per_step']} vs repeat_kv "
          f"{r['ms_per_step']}, the step's peak {g['step_peak_bytes']} vs "
          f"{r['step_peak_bytes']} bytes, launches a step "
          f"{g['launches_per_step']} vs {r['launches_per_step']}, busy "
          f"{g['busy_share_profiled']} vs {r['busy_share_profiled']} "
          f"(profiled); decode vs full {out['grouped_decode_vs_full']:.3e} / "
          f"{out['repeat_kv_decode_vs_full']:.3e}, grouped vs repeat_kv "
          f"{out['grouped_vs_repeat_kv']:.3e} (bound {FAMILY_BF16_REL}); "
          f"{_card_vs_cpu_line(small.name, out)}; the step's FLOPs at 4 "
          f"layers {out['flops_held']['flops']:.6e} on the card = the dry "
          f"run's; no swa_attention launch (card {card})")
    return out


def _ep_cfg():
    return dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=4)


def _draw_slice(shape, dtype, seed, index, scale, start):
    """Elements [start, start + prod(shape)) of the flat parameter that
    ``layers.init_weights_`` draws as parameter ``index`` (Philox trial
    ``index``, each element a function of its offset), on the card."""
    from repro_torch.core import rng as prng
    n = int(np.prod(shape))
    flat = torch.empty(n, dtype=dtype, device=DEV)
    tid = torch.tensor([index], dtype=torch.int64, device=DEV)
    for lo in range(0, n, model_layers.INIT_SLAB):
        m = min(model_layers.INIT_SLAB, n - lo)
        z = prng.normal(seed, tid, model_layers.INIT_STREAM, (m,),
                        start=start + lo)[0]
        flat[lo:lo + m] = (z * scale).to(dtype)
    return flat.view(shape)


def _ep_on_rank(ctx, rank, world):
    """The expert-parallel leg on one rank: this rank's E / world experts
    drawn at their offsets of the one-device draw (nothing else of the
    stacks), the router replicated and the shared expert cut by the
    port's rules (column- then row-parallel; its sum reduced in float32,
    ``sharding.reduce_partial``), the tokens replicated, routing pinned to
    the one-device call's; ``moe_apply`` under the mesh context."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding import mesh_context
    cfg = _ep_cfg()
    ref = torch.load(MESH_DIR / "ep_ref.pt")
    n_local = cfg.n_experts // world
    moe = model_layers.MoE(cfg, device="meta")
    mesh = ctx.mesh
    for i, (name, p) in enumerate(list(moe.named_parameters())):
        scale = (moe.INIT_STD.get(name) if "." not in name
                 else None)
        owner, _, leaf = name.rpartition(".")
        mod = moe.get_submodule(owner) if owner else moe
        if name in ("w_gate", "w_up", "w_down"):
            per = int(np.prod(p.shape[1:]))
            local = _draw_slice((n_local,) + tuple(p.shape[1:]), p.dtype,
                                MESH_EP_SEED, i, scale, rank * n_local * per)
            t = DTensor.from_local(local, mesh, [Replicate(), Shard(0)],
                                   run_check=False)
        else:
            if scale is None:                       # a Dense of the shared
                scale = mod.init_scale
            whole = _draw_slice(tuple(p.shape), p.dtype, MESH_EP_SEED, i,
                                scale, 0)
            t = shardings.distribute(whole, shardings.param_spec(
                "segments/0/0/ffn/" + name.replace(".", "/"),
                tuple(p.shape), ctx), ctx)
        setattr(mod, leaf, torch.nn.Parameter(t, requires_grad=False))
    x = DTensor.from_local(ref["x"].to(DEV), mesh, [Replicate()] * 2,
                           run_check=False)
    pins = [(w.to(DEV), i.to(DEV)) for w, i in ref["pins"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RoutePin(pins) as pin, mesh_context(ctx), implicit_replication(), \
            torch.no_grad():
        out, aux = model_layers.moe_apply(moe, cfg, x)
        out, aux = out.to_local(), aux.to_local()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = ref["out"].to(DEV)
    res = {"rank": rank, "local_experts": n_local,
           "local_expert_bytes": sum(
               getattr(moe, w).to_local().numel() * 2
               for w in ("w_gate", "w_up", "w_down")),
           "out_rel": _rel_gap(out.float(), want.float()),
           "aux": float(aux), "aux_want": world * float(ref["aux"]),
           "flipped": pin.flipped, "routed": pin.routed, "seconds": secs,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del moe, out, x, want
    _free_cuda()
    return res


def ranks_leg(card):
    """The two-rank legs (two processes on ``cuda:0`` over gloo,
    ``_mesh_rank``).  Expert parallelism: one deepseek-v3 MoE layer at
    published widths, each rank holding its 128 experts (11.3 GB of bf16),
    against the one-device ``moe_apply`` on the card on the same 2 x 2048
    tokens with the routing pinned to the one-device call's
    (``RoutePin``): the output within ``FAMILY_BF16_REL`` of the largest
    (each rank sums its experts' share over K in bf16, the ranks' sums are
    added in float32), the aux equal to 2 x the one-device aux within rel
    1e-6 (the reference's sum over every axis of each rank's whole
    estimate, over the data size 1).  Then the ring decode
    (``_ring_on_rank``, ``ring_check``)."""
    cfg = _ep_cfg()
    _free_cuda()
    moe = model_layers.init_weights_(model_layers.MoE(cfg, device=DEV),
                                     MESH_EP_SEED).requires_grad_(False)
    gen = torch.Generator(device=DEV).manual_seed(5)
    B, T = MESH_EP_TOKENS
    x = torch.randn((B, T, cfg.d_model), generator=gen, device=DEV).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RouteTape() as tape, torch.inference_mode():
        out, aux = model_layers.moe_apply(moe, cfg, x)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated()
    expert_bytes = sum(getattr(moe, w).numel() * 2
                       for w in ("w_gate", "w_up", "w_down"))
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    torch.save({"x": x.cpu(), "out": out.cpu(), "aux": aux.cpu(),
                "pins": [(c.top_w.cpu(), c.top_i.cpu())
                         for c in tape.calls]}, MESH_DIR / "ep_ref.pt")
    del moe, out, x
    _free_cuda()
    t0 = time.perf_counter()
    _spawn_ranks(_mesh_rank)
    ranks_s = time.perf_counter() - t0
    both = json.loads((MESH_DIR / "ranks.json").read_text())
    got = [r["ep"] for r in both]
    for r in got:
        check(r["out_rel"] <= FAMILY_BF16_REL
              and abs(r["aux"] - r["aux_want"]) <= 1e-6 * abs(r["aux_want"])
              and r["flipped"] == 0 and r["local_experts"] == 128
              and r["local_expert_bytes"] * 2 == expert_bytes,
              f"expert-parallel MoE rank {r['rank']}: {r}")
    out = {"one_device_s": one_s, "one_device_peak_bytes": one_peak,
           "expert_bytes": expert_bytes, "ranks_wall_s": ranks_s,
           "ranks": got}
    print(f"mesh expert-parallel deepseek-v3 MoE layer (256 experts, d "
          f"7168, f 2048, top 8, one shared) on {B} x {T} tokens: one device "
          f"{one_s * 1e3:.3f} ms (peak {one_peak} bytes, experts "
          f"{expert_bytes} bytes); 2 ranks over gloo on cuda:0, "
          + "; ".join(f"rank {r['rank']} {r['local_experts']} experts "
                      f"({r['local_expert_bytes']} bytes) out rel "
                      f"{r['out_rel']:.3e} (bound {FAMILY_BF16_REL}), aux "
                      f"{r['aux']:.6f} = 2 x {r['aux_want'] / 2:.6f}, "
                      f"{r['seconds'] * 1e3:.3f} ms, peak "
                      f"{r['peak_mem_bytes']} bytes" for r in got)
          + f"; the ranks' processes {ranks_s:.2f} s, both legs (card "
          f"{card})")
    return {"ep": out, "ring": ring_check([r["ring"] for r in both], card)}


def _ring_on_rank(ctx, rank, world):
    """The ring-decode leg on one rank: an attention layer at
    mistral-nemo's widths (bf16, weights seed 3) computes each step's
    query, key and value on the rank as one device would; a cache of
    ``MESH_RING["cache"]`` positions, filled with seeded values up to the
    first step, is split over the ranks by sequence;
    ``MESH_RING["steps"]`` steps of ``seq_sharded_decode_attention`` on
    them (replicated DTensors: its only collectives are its own float32
    all-reduces) against ``grouped_attention`` over this rank's own whole
    copy of the cache, written as one device writes it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.sharding import mesh_context, seq_write
    mesh = ctx.mesh
    cfg = dataclasses.replace(get_config(MESH_ARCH), n_layers=1,
                              seq_shard_decode=True)
    B, S, steps = (MESH_RING[k] for k in ("batch", "cache", "steps"))
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = model_layers.gqa_init(cfg, seed=3, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(7)
    pos0 = S - steps - 1
    cache = model_layers.gqa_cache_init(cfg, B, S, device=DEV)
    for k in ("k", "v"):
        cache[k][:, :, :pos0] = torch.randn((B, K, pos0, dh), generator=gen,
                                            device=DEV).to(cache[k].dtype)
    sl = S // world
    dcache = {k: DTensor.from_local(
        cache[k][:, :, rank * sl:(rank + 1) * sl].clone(), mesh,
        [Replicate(), Shard(2)], run_check=False) for k in ("k", "v")}
    xs = torch.randn((steps, B, 1, cfg.d_model), generator=gen,
                     device=DEV).to(torch.bfloat16)

    def rep(t):
        return DTensor.from_local(t, mesh, [Replicate()] * 2,
                                  run_check=False)

    worst, untouched, owned, ring_s, one_s = 0.0, [], 0, 0.0, 0.0
    with torch.no_grad():
        for t in range(steps):
            pos = pos0 + t
            positions = torch.tensor([[pos]], device=DEV)
            q = model_layers.apply_rope(attn.wq(xs[t]).unflatten(-1, (H, dh)),
                                        positions, cfg.rope_theta)
            kx = model_layers.apply_rope(
                attn.wk(xs[t]).unflatten(-1, (K, dh)), positions,
                cfg.rope_theta)
            vx = attn.wv(xs[t]).unflatten(-1, (K, dh))
            q, kx, vx = (a.transpose(1, 2) for a in (q, kx, vx))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seq_write(cache["k"], kx, pos, 2)
            seq_write(cache["v"], vx, pos, 2)
            want = model_layers.grouped_attention(
                q, cache["k"], cache["v"], kv_len=pos + 1, q_offset=pos)
            torch.cuda.synchronize()
            one_s += time.perf_counter() - t0
            before = dcache["k"].to_local().clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mesh_context(ctx):
                got, kf, vf = model_layers.seq_sharded_decode_attention(
                    cfg, rep(q), rep(kx), rep(vx), {**dcache, "pos": pos})
            torch.cuda.synchronize()
            ring_s += time.perf_counter() - t0
            dcache = {"k": kf, "v": vf}
            worst = max(worst, _rel_gap(got.to_local().float(),
                                        want.float()))
            if rank * sl <= pos < (rank + 1) * sl:
                owned += 1
            else:
                untouched.append(bool(torch.equal(before,
                                                  kf.to_local())))
    equal = all(torch.equal(dcache[k].to_local(),
                            cache[k][:, :, rank * sl:(rank + 1) * sl])
                for k in ("k", "v"))
    res = {"rank": rank, "out_rel": worst, "cache_equal": equal,
           "owned_steps": owned, "untouched": untouched,
           "ring_ms_per_step": ring_s * 1e3 / steps,
           "one_device_ms_per_step": one_s * 1e3 / steps,
           "local_cache_bytes": 2 * dcache["k"].to_local().numel() * 2}
    return res


def _mesh_rank(rank, world, port):
    """One of the ``MESH_RANKS`` processes on the card: its gloo group, the
    expert-parallel leg then the ring-decode leg, both reported."""
    ctx = _rank_group(rank, world, port)
    _rank_report(rank, {"ep": _ep_on_rank(ctx, rank, world),
                        "ring": _ring_on_rank(ctx, rank, world)},
                 "ranks.json")


def ring_check(got, card):
    """``seq_sharded_decode_attention`` on the card: two ranks (processes on
    ``cuda:0`` over gloo), ``MESH_RING``'s cache split by sequence, each
    rank's output within ``FAMILY_BF16_REL`` of the one-device
    ``grouped_attention`` (the softmax's sums in float32 on both, the
    weights rounded to bf16 before the values on both, summed in another
    order), each rank's cache block bit-equal to the one-device cache's,
    the rank that does not own a step's position leaving its block
    untouched.  Times a step against the one-device attention."""
    steps = MESH_RING["steps"]
    for r in got:
        check(r["out_rel"] <= FAMILY_BF16_REL and r["cache_equal"]
              and all(r["untouched"])
              and r["owned_steps"] + len(r["untouched"]) == steps,
              f"ring decode rank {r['rank']}: {r}")
    check(sorted(r["owned_steps"] for r in got) == [0, steps],
          f"ring decode: owned steps {[r['owned_steps'] for r in got]}")
    print(f"mesh ring decode, one attention layer at {MESH_ARCH}'s widths, "
          f"batch {MESH_RING['batch']}, a {MESH_RING['cache']}-slot cache "
          f"over 2 ranks, {steps} steps: "
          + "; ".join(f"rank {r['rank']} out rel {r['out_rel']:.3e} (bound "
                      f"{FAMILY_BF16_REL}), cache block bit-equal "
                      f"{r['cache_equal']}, owned {r['owned_steps']} steps, "
                      f"{r['ring_ms_per_step']:.3f} ms/step vs one device "
                      f"{r['one_device_ms_per_step']:.3f}" for r in got)
          + f" (card {card})")
    return {"ranks": got}


#: the mesh train leg: MESH_TRAIN_STEPS straggler AdamW steps (lr 1e-3)
#: of MESH_TRAIN_ROUND on a Markov EC2 cluster (seed 7, 8 x 128 bigram
#: tokens a slot) under the 1 x 2 mesh over the two ranks, against the
#: same steps on one device; the float32 weights after the last step
#: within MESH_TRAIN_REL x the step count of their largest value, at
#: AdamW's eps 1e-8 but for a MESH_ADAM_NOISE_SHARE of them (elements
#: whose gradient is rounding noise, moved up to lr a step either way),
#: all within MESH_ADAM_ABS; at eps 1e-5 every one
MESH_TRAIN_STEPS = 3
MESH_TRAIN_ROUND = dict(n=4, k=3, kind="ss", r=2)
MESH_TRAIN_TOKENS = dict(global_batch=8, seq_len=128)
MESH_TRAIN_LR = 1e-3
MESH_TRAIN_REL = 1e-5
MESH_ADAM_NOISE_SHARE = 1e-5
MESH_ADAM_ABS = 5e-4


def mesh_train_cases():
    """{name: (config, AdamW eps)}: phi4-mini-3.8b's published widths cut
    to 2 layers (1.43 B parameters) in bf16, and its smoke config in
    float32 at eps 1e-8 and 1e-5."""
    small = get_config("phi4-mini-3.8b").smoke()
    return {"bf16_cut": (dataclasses.replace(get_config("phi4-mini-3.8b"),
                                             n_layers=2), 1e-8),
            "f32_smoke": (small, 1e-8), "f32_smoke_eps": (small, 1e-5)}


@contextlib.contextmanager
def _mesh_grad(ctx):
    """A train step's context on ``ctx``'s mesh: the mesh context, plain
    tensors taken as replicated, autograd on."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding import mesh_context
    with mesh_context(ctx), implicit_replication():
        yield


def _mesh_train(cfg, eps, ctx=None):
    """``MESH_TRAIN_STEPS`` straggler AdamW steps of ``cfg`` on the card,
    on ``ctx``'s mesh (the state placed by
    ``shardings.distribute_train_state``, the slot-major batches by
    ``batch_shardings``) or on one device: (losses, grad norms, seconds a
    step, peak bytes; the float32 weights after the last step on the CPU,
    None in bf16).  Delays keyed by the seed alone, never by rank."""
    from repro_torch.sharding import is_dtensor
    rc = RoundConfig(**MESH_TRAIN_ROUND)
    opt = adamw(MESH_TRAIN_LR, eps=eps)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, opt, seed=0, device=DEV)
    step = make_straggler_train_step(cfg, opt, rc, ec2_cluster(
        rc.n, spread=3.0, persistence=0.9, seed=0))
    part = TaskPartition(n=rc.n, vocab=cfg.vocab_size, source="bigram",
                         seed=0, **MESH_TRAIN_TOKENS)
    if ctx is not None:
        shardings.distribute_train_state(state, ctx)

    def whole(t):
        return t.full_tensor() if is_dtensor(t) else t

    cluster, losses, norms, secs = None, [], [], []
    for i in range(MESH_TRAIN_STEPS):
        toks, labs = lm_task_batches(part, rc.to_matrix(), i, device=DEV)
        if ctx is not None:
            spec = shardings.batch_shardings({"t": toks}, ctx,
                                             slot_major=True)["t"]
            toks, labs = (shardings.distribute(t, spec, ctx)
                          for t in (toks, labs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (contextlib.nullcontext() if ctx is None else _mesh_grad(ctx)):
            state, m, cluster = step(state, toks, labs, 7, cluster)
        losses.append(float(whole(m["loss"])))
        norms.append(float(whole(m["grad_norm"])))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    params = None
    if cfg.param_dtype == "float32":
        params = {k: whole(p).detach().cpu()
                  for k, p in state.params.named_parameters()}
    res = {"loss": losses, "grad_norm": norms, "step_s": secs,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del state, step
    _free_cuda()
    return res, params


def _train_rank(rank, world, port):
    """One of the two ranks of the mesh train leg: every case of
    ``mesh_train_cases`` on the 1 x 2 mesh, the float32 weights against
    the one-device run's (``train_ref.pt``), reported."""
    ctx = _rank_group(rank, world, port)
    ref = torch.load(MESH_DIR / "train_ref.pt")
    res = {"rank": rank}
    for name, (cfg, eps) in mesh_train_cases().items():
        ops.reset_launch_counts()
        r, params = _mesh_train(cfg, eps, ctx)
        r["swa_launches"] = _swa_launches(ops.LAUNCHES)
        r["greedy_launches"] = ops.LAUNCHES["greedy_assign"]
        if params is not None:
            want = ref[name]
            diffs = torch.cat([(params[k] - want[k]).abs().flatten()
                               for k in want])
            r["param_max"] = max(float(w.abs().max())
                                 for w in want.values())
            r["param_diffs"] = torch.sort(
                diffs, descending=True).values[:64].tolist()
            r["n_params"] = diffs.numel()
        res[name] = r
    _rank_report(rank, res, "train.json")


def mesh_train_leg(card):
    """Three straggler AdamW train steps under a real mesh: each case of
    ``mesh_train_cases`` on one device on the card, then on the 1 x 2 mesh
    over two gloo ranks on ``cuda:0`` (``_train_rank``): bf16 losses and
    grad norms within ``FAMILY_BF16_REL`` of one device's a step (the
    rank's row-parallel sums in float32 after bf16 products, the
    vocab-parallel head gathered); float32 within ``MESH_TRAIN_REL`` x the
    step number, the weights as ``MESH_TRAIN_REL`` says.  No swa launch,
    no greedy_assign launch (a static schedule)."""
    cases = mesh_train_cases()
    one, refs = {}, {}
    for name, (cfg, eps) in cases.items():
        one[name], params = _mesh_train(cfg, eps)
        if params is not None:
            refs[name] = params
    torch.save(refs, MESH_DIR / "train_ref.pt")
    del refs
    t0 = time.perf_counter()
    _spawn_ranks(_train_rank)
    ranks_s = time.perf_counter() - t0
    got = json.loads((MESH_DIR / "train.json").read_text())
    for r in got:
        for name, (cfg, eps) in cases.items():
            g, w = r[name], one[name]
            bf16 = cfg.param_dtype == "bfloat16"
            for key in ("loss", "grad_norm"):
                for i, (a, b) in enumerate(zip(g[key], w[key])):
                    tol = FAMILY_BF16_REL if bf16 else MESH_TRAIN_REL * (i + 1)
                    check(abs(a - b) <= tol * abs(b),
                          f"mesh train {name} rank {r['rank']} step {i} "
                          f"{key} {a} vs one device {b} (rel bound {tol})")
            check(g["swa_launches"] == 0 and g["greedy_launches"] == 0,
                  f"mesh train {name}: launches {g}")
            if not bf16:
                bound = MESH_TRAIN_REL * MESH_TRAIN_STEPS * g["param_max"]
                over = [d for d in g["param_diffs"] if d > bound]
                check(not over if eps > 1e-8 else
                      len(over) <= MESH_ADAM_NOISE_SHARE * g["n_params"]
                      and g["param_diffs"][0] <= MESH_ADAM_ABS,
                      f"mesh train {name} rank {r['rank']}: weights past "
                      f"{bound:.3e}: {over}")
                g["over_bound"] = len(over)
    for name, (cfg, eps) in cases.items():
        w = one[name]
        print(f"mesh train {name} ({cfg.name}, {cfg.n_layers} layers, "
              f"{cfg.param_dtype}, AdamW eps {eps:g}), {MESH_TRAIN_STEPS} "
              f"steps: one device loss {w['loss']}, grad norm "
              f"{w['grad_norm']}, s a step {w['step_s']}, peak "
              f"{w['peak_mem_bytes']} bytes; "
              + "; ".join(
                  f"rank {r['rank']} loss {r[name]['loss']}, grad norm "
                  f"{r[name]['grad_norm']}, s a step {r[name]['step_s']}, "
                  f"peak {r[name]['peak_mem_bytes']} bytes"
                  + ("" if "param_diffs" not in r[name] else
                     f", weights max diff {r[name]['param_diffs'][0]:.3e} "
                     f"({r[name]['over_bound']} past the bound)")
                  for r in got) + f" (card {card})")
    print(f"mesh train ranks' processes {ranks_s:.2f} s")
    return {"one_device": one, "ranks": got, "ranks_wall_s": ranks_s}


def mesh_phase(card):
    """The mesh slice on the card, after the shapes phase: the mesh dry
    runs started in processes of their own (``_mesh_dry_start``), then the
    grouped-GQA legs (``grouped_leg``), the expert-parallel MoE and the
    ring decode over two gloo ranks on the one card (``ranks_leg``), three
    train steps under the 1 x 2 mesh (``mesh_train_leg``), then the dry
    runs' artifacts (``_mesh_dry_finish``)."""
    t_phase = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    procs = _mesh_dry_start()
    try:
        ops.reset_launch_counts()
        out = {"grouped": grouped_leg(card), **ranks_leg(card)}
        out["train"] = mesh_train_leg(card)
        out["swa_launches"] = _swa_launches(ops.LAUNCHES)
        check(out["swa_launches"] == 0,
              f"mesh phase: swa launches {ops.LAUNCHES}")
        out["dry_runs"] = _mesh_dry_finish(procs, card)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"mesh phase wall seconds={out['seconds']:.4f} (card {card})")
    return out


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    build_s = build.build_all()
    print(f"device: {card}; kernel build {build_s:.2f} s")
    for stale in BENCH_OUT.glob("BENCH_*.json"):     # the gate reads this run's
        stale.unlink()
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
    gate = gate_phase()
    shard = shard_phase(card)
    train = train_phase()
    families = families_phase()
    wide = wide_phase()
    hybrid = hybrid_phase()
    shapes = shapes_phase()
    mesh = mesh_phase(card)
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
            "live_wide": live["wide"]["greedy_launches"],
            "train": train["full"]["greedy_launches"],
            "train_whisper": families["whisper-base"]["train"][
                "greedy_launches"],
            "train_rwkv6": families["rwkv6-1.6b"]["train"][
                "greedy_launches"],
            "train_deepseek_v3": wide["deepseek-v3"]["train"][
                "greedy_launches"],
            "train_jamba": hybrid["train"]["greedy_launches"],
            "shard_fig8": shard["fig8"]["greedy_launches"],
            "gate_fig8": gate["greedy_launches"],
            "train_reissue": train["reissue"]["greedy_launches"],
            "mesh_train": sum(r[c]["greedy_launches"]
                              for r in mesh["train"]["ranks"]
                              for c in mesh_train_cases())},
        "need_row_launches_by_path": {
            "faults_grid_reissue":
                faults["grid"]["reissue"]["greedy_need_launches"],
            "adaptive_n200_reissue": wide_reissue["need_launches"],
            "live_adaptive": live["adaptive"]["greedy_need_launches"],
            "live_wide": live["wide"]["greedy_need_launches"],
            "train_reissue": train["reissue"]["greedy_need_launches"]},
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
            "train": train["full"]["swa_launches"],
            "train_nograd": train["nograd"]["wgmma_launches"],
            "lm_f32": consistency["f32_wgmma_launches"],
            "lm_bf16_dh32": consistency["narrow_wgmma_launches"],
            **{f"long_serve_{a}": shapes[a]["prefill_wgmma_launches"]
               for a in LONG_ARCHS},
            **{f"long_decode_vs_full_{a}":
               shapes[a]["decode_vs_full_wgmma_launches"]
               for a in LONG_ARCHS},
            "mesh_grouped_ep_ring": mesh["swa_launches"],
            "dense_phi4_qwen2": sum(
                wide[leg][kind]["swa_launches"] for leg in DENSE_LEGS
                for kind in ("serve", "consistency")),
            "mesh_train": sum(r[c]["swa_launches"]
                              for r in mesh["train"]["ranks"]
                              for c in mesh_train_cases())},
        "max_abs_err": t_row["max_abs_err"],
        "ms": t_row["ms"], "plain_ms": t_row["plain_ms"],
        "bound_ms": t_row["bound_ms"], "bound_by": t_row["bound_by"],
        "library_ms": t_row["library_ms"],
        "cuda_core_ms": t_row["cuda_core_ms"], "card": card,
        "w8192_shapes": shapes["gates"],
        "shapes": [r for r in swa_rows if r["swa_route"] == "tensor_core"]}],
        "engine": engine, "rounds": rounds, "adaptive_wide": adaptive_wide,
        "adaptive_wide_reissue": wide_reissue, "figures": figures,
        "faults": faults,
        "dgd_seconds": dgd_launches["seconds"], "serve": served,
        "consistency": consistency, "grid": grid, "live": live,
        "gate": gate, "shard": shard, "train": train,
        "families": families, "wide": wide, "hybrid": hybrid,
        "shapes": shapes, "mesh": mesh}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
