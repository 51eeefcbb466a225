"""The port on a CUDA card: the gram_matvec kernels against their plain
version (rel 1e-5 in float32, 3e-2 in bfloat16, the tolerances of
tests/test_kernels.py) on the route ops.gram_plan names (one-pass, or
two-pass past its limit), bit for bit from call to call, the
greedy_assign kernel against its plain version bit for bit (the two
share one summation order and rounding, ties included; NaN and zero
estimates, overflowing coverage, rows denser than the sparse fold's cap
and n past 32 take its dense fold, as the kernel's own count of dense
trials shows; past n = 128 its wide route, with adaptive rounds at n = 200
on the card equal to the CPU's), the swa_attention kernels against their plain version (max abs
2e-4 in float32, tests/test_kernels.py's; elementwise atol 1e-3 + rtol
1e-2 in bfloat16, which scales with outputs of a wide window) with the
route each call takes (float32 on its TF32 tensor-core kernel, bfloat16
on the wgmma kernel at dh 64-256 and on the CUDA cores at dh 16 / 32), the
float32 kernel's error against a float64 evaluation (at most 10x the plain
float32 version's own), their launch counters and input checks, sharded
sweeps on the card repeated against one device, the engines' per-trial
samples and trajectories on the card against their own CPU runs, the grid engine's fused cells
against per-cell sweeps on the card bit for bit, a resumable sweep's
extension against a fresh card sweep, a cached rounds function's second
call, the live cluster's static and adaptive runs (the master on the card)
against the CPU's on a shared trace, ``init_params``' weights on the card
against the CPU's (within 4 ulps: float32 erfinv), the LM's logits on the card against the CPU with the swa route's
launch counts, and training: the swa kernels refuse a call autograd would
record, a bfloat16 straggler-scheduled step on the card against the CPU
(the round exact, loss rel 3e-2, weights within AdamW's reach), and the
trainer CLI's one greedy_assign launch a step under ``--adaptive``.

Skipped without a card.  This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_card.py
"""
import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch.core import (DelayTrace, GridCell, GridSpec,
                              MarkovRegimeProcess, RoundConfig, TraceProcess,
                              adaptive_spec, completion_samples,
                              cyclic_to_matrix, greedy_row_assignment_batch,
                              lb_spec, pc_spec, pcmm_spec, resumable_sweep,
                              scenario1, staircase_to_matrix, stream_grid,
                              sweep, sweep_rounds, to_spec,
                              trajectory_samples)
from repro_torch.core import montecarlo, rng
from repro_torch.configs import get_config
from repro_torch.core.scheduling import _greedy_matrices
from repro_torch.data import TaskPartition, lm_task_batches
from repro_torch.kernels import build, ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.live import run_live, sample_delay_tables
from repro_torch.models import forward, init_cache, init_params
from repro_torch.optim import adamw
from repro_torch.train import init_train_state, make_straggler_train_step

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
#: float32 erfinv on the card and on the CPU part by at most this many
#: units in the last place (the bound init_params' normals are held to)
INIT_ERFINV_ULPS = 4


@pytest.fixture
def cuda():
    """The CUDA device, or a skip (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(n, d, b, dtype, device, seed=0):
    gen = np.random.default_rng(seed + n * d * b)
    Xs = torch.as_tensor(gen.standard_normal((n, d, b), dtype=np.float32))
    th = torch.as_tensor(gen.standard_normal(d, dtype=np.float32))
    return Xs.to(device=device, dtype=dtype), th.to(device=device,
                                                    dtype=dtype)


#: stand for the largest d the one-pass route holds and the d just past it
AT_LIMIT, PAST_LIMIT = "at_limit", "past_limit"


# the JAX tests' shapes and the plan's edges: d off multiples of c and R
# (37, 513, 3000), b off multiples of C and b = 1, rows that are not
# 16-byte multiples (b = 53, 37), several column blocks (2000 x 300,
# 3000 x 700), n = 1, more items than resident clusters (64 x 512 x 256),
# many TMA boxes a tile (2 x 60 000 rows, 32 columns), the one-pass limit (one
# tile of ~11 000 rows a CTA) and d just past it (the split-d two-pass route:
# one task and the dgd-tall leg's 15, one column, odd rows of 3 elements,
# 256 columns, where the slabs are capped and the column blocks narrowed, so
# many tasks that each takes one slab, and a u too wide for shared memory)
GRAM_SHAPES = [(15, 400, 60), (4, 37, 53), (4, 300, 200), (1, 512, 64),
               (3, 100, 300), (2, 8, 1), (3, 513, 1), (2, 513, 53),
               (1, 300, 37), (3, 2000, 300), (2, 3000, 700), (1, 1000, 53),
               (64, 512, 256), (2, 60000, 32), (1, AT_LIMIT, 8),
               (1, PAST_LIMIT, 8), (15, PAST_LIMIT, 8), (1, PAST_LIMIT, 1),
               (1, PAST_LIMIT, 3), (1, PAST_LIMIT, 256), (300, PAST_LIMIT, 8),
               (1, PAST_LIMIT, 4104)]


@pytest.mark.parametrize("n,d,b", GRAM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, n, d, b, dtype):
    """One call on the route gram_plan names: the launch counters add one
    (and one more for the one-pass route)."""
    past = d == PAST_LIMIT
    if d in (AT_LIMIT, PAST_LIMIT):
        d = ops.gram_onepass_max_d(b, dtype) + past
    route = ops.gram_plan(n, d, b, dtype).route
    assert route == ("twopass" if past else "onepass")
    Xs, th = _inputs(n, d, b, dtype, cuda)
    before = dict(ops.LAUNCHES)
    got = ops.batched_gram_matvec(Xs, th)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gram_matvec"] == before["gram_matvec"] + 1
    assert (ops.LAUNCHES["gram_matvec_onepass"]
            == before["gram_matvec_onepass"] + (route == "onepass"))
    want = ref.batched_gram_matvec_ref(Xs, th)
    assert got.dtype == dtype and got.device == Xs.device
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert rel < TOL[dtype], rel


@pytest.mark.parametrize("n,d,b", [(15, 400, 60), (2, 513, 53),
                                   (3, 2000, 300), (1, PAST_LIMIT, 8),
                                   (15, PAST_LIMIT, 8), (1, PAST_LIMIT, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(cuda, n, d, b, dtype):
    """Two calls on the same inputs give the same bits, on both routes (no
    atomics, every sum in a fixed order)."""
    if d == PAST_LIMIT:
        d = ops.gram_onepass_max_d(b, dtype) + 1
    Xs, th = _inputs(n, d, b, dtype, cuda, seed=1)
    a = ops.batched_gram_matvec(Xs, th)
    c = ops.batched_gram_matvec(Xs, th)
    torch.cuda.synchronize()
    assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_pass_calls_carry_no_state(cuda, dtype):
    """Calls of two tall shapes in turn (different slab counts, so the
    scratch of partials is laid out differently) each equal that shape's
    first call bit for bit: nothing one call leaves behind changes the
    next."""
    shapes = [(15, ops.gram_onepass_max_d(8, dtype) + 1, 8),
              (2, ops.gram_onepass_max_d(64, dtype) + 1000, 64)]
    inputs, first = [], []
    for n, d, b in shapes:
        plan = ops.gram_tall_plan(n, d, b, dtype)
        assert ops.gram_plan(n, d, b, dtype).route == "twopass"
        assert plan.s1 > 1
        inputs.append(_inputs(n, d, b, dtype, cuda, seed=2))
        first.append(ops.batched_gram_matvec(*inputs[-1]))
    for _ in range(3):
        for (Xs, th), want in zip(inputs, first):
            assert torch.equal(ops.batched_gram_matvec(Xs, th), want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_pass_bits_do_not_depend_on_the_address(cuda, dtype):
    """A task stack that starts off a 16-byte boundary takes the same plan
    with element loads in place of vector loads: the same bits as an
    aligned copy."""
    n, d, b = 2, ops.gram_onepass_max_d(8, dtype) + 1, 8
    Xs, th = _inputs(n, d, b, dtype, cuda, seed=3)
    buf = torch.empty(Xs.numel() + 1, dtype=dtype, device=cuda)
    off = buf[1:].view(n, d, b)
    off.copy_(Xs)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    assert torch.equal(ops.batched_gram_matvec(off, th),
                       ops.batched_gram_matvec(Xs, th))


def test_single_task_wrapper_and_eq48(cuda):
    Xs, th = _inputs(6, 96, 48, torch.float32, cuda)
    hs = ops.batched_gram_matvec(Xs, th)
    for t in range(6):
        assert torch.allclose(ops.gram_matvec(Xs[t], th), hs[t], rtol=1e-6,
                              atol=1e-5)
    Xf = Xs.double().permute(1, 0, 2).reshape(96, -1)
    want = Xf @ (Xf.T @ th.double())
    assert torch.allclose(hs.double().sum(0), want, rtol=1e-4, atol=1e-3)


def test_kernel_rejects_what_it_cannot_take(cuda):
    Xs = torch.zeros(2, 8, 4, device=cuda)
    with pytest.raises(TypeError):
        ops.batched_gram_matvec(Xs.double(), torch.zeros(8, device=cuda,
                                                         dtype=torch.float64))
    with pytest.raises(TypeError):
        ops.batched_gram_matvec(Xs, torch.zeros(8, device=cuda,
                                                dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ops.batched_gram_matvec(Xs.transpose(1, 2).contiguous().transpose(1, 2),
                                torch.zeros(8, device=cuda))
    with pytest.raises(ValueError):
        ops.batched_gram_matvec(Xs, torch.zeros(8))
    with pytest.raises(ValueError):
        ops.batched_gram_matvec(Xs, torch.zeros(5, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_smem_is_the_kernels_own(cuda, dtype):
    """gram_plan's count of a CTA's shared memory equals the kernel's own
    (smem_bytes in csrc/gram_matvec_onepass.cu) from one row to past the
    one-pass limit and from one column to past a TMA box, and the launcher
    refuses a plan whose count differs."""
    item = torch.finfo(dtype).bits // 8
    lib = build.library("gram_matvec_onepass")
    top = -(-ops.gram_onepass_max_d(1, dtype) // ops.GRAM_MAX_CLUSTER) + 8
    for R in [*range(1, 2100), *range(2100, top, 37)]:
        for C in (1, 2, 4, 8, 16, 37, 53, 60, 64, 96, 128, 256, 300):
            assert lib.gram_onepass_smem(R, C, item) == ops._gram_smem(
                R, C, item), (R, C, item)
    n, d, b = 2, 513, 53
    Xs, th = _inputs(n, d, b, dtype, cuda)
    y = torch.empty((n, d), dtype=dtype, device=cuda)
    plan = ops.gram_plan(n, d, b, dtype)
    assert plan.route == "onepass" and plan.nbc == 1
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.gram_onepass_launch(
        Xs.data_ptr(), th.data_ptr(), y.data_ptr(), None, n, d, b,
        int(dtype == torch.bfloat16), plan.c, plan.R, plan.C, plan.nbc,
        plan.smem + 16, stream)
    assert lib.gram_onepass_error_string(err).decode() == "invalid argument"


@pytest.mark.parametrize("make", [
    lambda: to_spec("cs", cyclic_to_matrix(8, 3)), lambda: lb_spec(3),
    lambda: pc_spec(3)])
def test_samples_on_card_match_cpu(cuda, make):
    """Same integer bits on both devices; erf/erfinv may differ in the last
    ulps, so per-trial samples agree within rel 1e-6."""
    spec = make()
    a = completion_samples(spec, scenario1(), 8, trials=512, chunk=100,
                           devices=cuda)
    b = completion_samples(spec, scenario1(), 8, trials=512, devices="cpu")
    assert ((a.cpu() - b).abs() / b.abs()).max().item() < 1e-6


def greedy_inputs(B, n, r, device, *, seed=0, need=False, ties=False,
                  infs=False, case="plain"):
    """Kernel-shaped greedy inputs for a CS matrix, made with numpy: W, the
    stable argsort of random (or all-equal) estimates with some +inf
    entries, epick = max(est, 1e-30), and optional need rows.  ``case``
    reaches the kernel's dense fold: "nan_epick" and "zero_epick" put NaN
    or 0 in a fifth of epick (direct calls), "huge_w" scales W by 1e38 so
    that W / epick overflows, "dense_row" fills row 0 of W (more nonzeros
    than the kernel's sparse cap, GREEDY_SPARSE_CAP, where n exceeds it)."""
    gen = np.random.default_rng(seed + B * n + r)
    C = cyclic_to_matrix(n, r)
    W, A = _greedy_matrices(tuple(map(tuple, C.tolist())), 0.5)
    est = (np.full((B, n), 0.25, np.float32) if ties
           else gen.uniform(0.01, 1.0, (B, n)).astype(np.float32))
    if infs:
        est[gen.random((B, n)) < 0.2] = np.inf
    est = torch.as_tensor(est, device=device)
    order = torch.argsort(est, dim=-1, stable=True)
    epick = torch.clamp(torch.take_along_dim(est, order, dim=-1), min=1e-30)
    need_row = None
    if need:
        nd = torch.as_tensor(gen.random((B, n)) < 0.3, device=device)
        A = torch.as_tensor(A > 0, device=device)
        need_row = (nd[:, None, :] & A[None]).sum(-1).float()
    W = torch.as_tensor(W, device=device)
    some = torch.as_tensor(gen.random((B, n)) < 0.2, device=device)
    if case == "nan_epick":
        epick = torch.where(some, float("nan"), epick)
    elif case == "zero_epick":
        epick = torch.where(some, 0.0, epick)
    elif case == "huge_w":
        W = W * 1e38
    elif case == "dense_row":
        W = W.clone()                  # W may share the cached numpy array
        W[0] = 0.25
    return W, order.to(torch.int32), epick, need_row


GREEDY_CASES = ["plain", "need", "ties", "infs", "nan_epick", "zero_epick",
                "huge_w", "huge_w_need", "dense_row"]

#: the most nonzeros a row of W may hold for the greedy_assign kernel's
#: sparse fold, read from its source
GREEDY_SPARSE_CAP = int(re.search(
    r"constexpr int kCap = (\d+);",
    (build.CSRC / "greedy_assign.cu").read_text())[1])


def greedy_dense_count():
    """The greedy_assign kernel's own count of the trials that entered its
    dense pick loop, over every launch so far (waits for the device)."""
    count = ctypes.c_ulonglong()
    lib = build.library("greedy_assign")
    assert lib.greedy_assign_dense_trials(ctypes.byref(count)) == 0
    return count.value


# past n = 128 the wide route (one block a trial, W through L2): its first
# n, n off a multiple of 32 with fewer warps than the most, and W of n = 257,
# past any shared-memory budget
@pytest.mark.parametrize("B,n,r", [(1, 15, 3), (2000, 12, 3), (333, 12, 3),
                                   (20000, 16, 4), (64, 128, 8), (5, 1, 1),
                                   (70, 32, 5), (70, 33, 5), (70, 40, 5),
                                   (64, 129, 3), (256, 200, 4), (64, 257, 4)])
@pytest.mark.parametrize("case", GREEDY_CASES)
def test_greedy_kernel_equals_plain(cuda, B, n, r, case):
    assert ops.greedy_route(n) == ("warp_smem" if n <= 128 else "wide")
    W, order, epick, need_row = greedy_inputs(
        B, n, r, cuda, need=case.endswith("need"), ties=case == "ties",
        infs=case == "infs", case=case.removesuffix("_need"))
    before = ops.LAUNCHES["greedy_assign"]
    dense_before = greedy_dense_count()
    got = ops.greedy_assign(W, order, epick, need_row)
    dense = greedy_dense_count() - dense_before
    again = ops.greedy_assign(W, order, epick, need_row)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["greedy_assign"] == before + 2
    want = ref.greedy_assign_ref(W, order, epick, need_row)
    assert got.dtype == torch.int32 and got.shape == (B, n)
    assert torch.equal(got, want)
    assert torch.equal(again, got)
    if case in ("plain", "need", "ties", "infs", "dense_row"):
        # finite scores: every row picked once (with +inf scores an untaken
        # row loses to a taken one's FLT_MAX, as in the plain version)
        assert torch.equal(torch.sort(got.long(), dim=-1).values,
                           torch.arange(n, device=cuda).expand(B, n))
    # the trials the kernel folded densely, by its own count
    if n > 32 or (case == "dense_row" and n > GREEDY_SPARSE_CAP):
        assert dense == B
    elif case in ("plain", "need", "ties", "infs", "dense_row"):
        assert dense == 0
    elif n > 1:
        assert dense > 0


@pytest.mark.parametrize("case", ["plain", "need", "huge_w_need"])
def test_greedy_wide_route_with_more_row_groups_than_warps(cuda, case):
    """n = 545: 18 groups of 32 rows over the wide block's 16 warps, so two
    warps score two groups each; equal to the plain version, every trial
    counted dense."""
    B, n = 3, 545
    W, order, epick, need_row = greedy_inputs(
        B, n, 5, cuda, need=case.endswith("need"),
        case=case.removesuffix("_need"))
    dense_before = greedy_dense_count()
    got = ops.greedy_assign(W, order, epick, need_row)
    assert greedy_dense_count() - dense_before == B
    want = ref.greedy_assign_ref(W, order, epick, need_row)
    assert torch.equal(got, want)


def test_greedy_kernel_rejects_what_it_cannot_take(cuda):
    W, order, epick, _ = greedy_inputs(4, 8, 3, cuda)
    with pytest.raises(ValueError):
        ops.greedy_assign(W.cpu(), order, epick)
    with pytest.raises(ValueError):
        ops.greedy_assign(W[:4], order, epick)
    with pytest.raises(ValueError):
        n = ops.GREEDY_MAX_N + 1
        big = torch.zeros((2, n), device=cuda)
        ops.greedy_assign(torch.zeros((n, n), device=cuda),
                          big.to(torch.int32), big)


def test_greedy_smem_is_the_kernels_own(cuda):
    """ops.greedy_smem's count equals the kernel's own (greedy_assign_smem)
    on both routes and at their edges; past GREEDY_MAX_N the kernel
    refuses (0)."""
    lib = build.library("greedy_assign")
    for n in (1, 12, 32, 33, 64, 65, 128, 129, 200, 238, 257, 512, 1000,
              ops.GREEDY_MAX_N):
        assert lib.greedy_assign_smem(n) == ops.greedy_smem(n), n
    assert lib.greedy_assign_smem(ops.GREEDY_MAX_N + 1) == 0


def test_adaptive_rounds_past_the_warp_route_on_card(cuda):
    """Adaptive scheduling at n = 200 (the wide route): trajectories on a
    shared trace are the same bits on the card as on the CPU, and
    sweep_rounds with an adaptive spec runs on the card, one greedy_assign
    launch a round and chunk."""
    gen = np.random.default_rng(11)
    n, r, rounds, trials = 200, 4, 3, 48
    T1 = (1e-4 * (0.5 + gen.random((rounds, trials, n, r)))).astype(
        np.float32)
    T2 = (5e-4 * (0.5 + gen.random((rounds, trials, n, r)))).astype(
        np.float32)
    proc = TraceProcess(DelayTrace(T1, T2))
    spec = adaptive_spec("adapt", cyclic_to_matrix(n, r))
    ops.reset_launch_counts()
    a = trajectory_samples(spec, proc, n, rounds=rounds, k=150,
                           trials=trials, devices=cuda)
    assert ops.LAUNCHES["greedy_assign"] == rounds
    b = trajectory_samples(spec, proc, n, rounds=rounds, k=150,
                           trials=trials, devices="cpu")
    assert torch.equal(a.cpu(), b)
    ops.reset_launch_counts()
    res = sweep_rounds([spec, to_spec("cs", cyclic_to_matrix(n, r))],
                       scenario1(), n, rounds=rounds, k=150, trials=256,
                       chunk=128, devices=cuda)
    assert ops.LAUNCHES["greedy_assign"] == rounds * 2
    assert np.isfinite(res.mean_round("adapt"))


def test_batch_impls_agree_on_card(cuda):
    """``impl="kernel"`` (the CUDA kernel) and ``impl="scan"`` (the plain
    version on the card) give the same picks, with leading batch dims."""
    gen = np.random.default_rng(4)
    C = staircase_to_matrix(12, 3)
    est = torch.as_tensor(gen.uniform(0.01, 1.0, (5, 13, 12)),
                          dtype=torch.float32, device=cuda)
    need = torch.as_tensor(gen.random((5, 13, 12)) < 0.4, device=cuda)
    for nd in (None, need):
        a = greedy_row_assignment_batch(C, est, need=nd, impl="kernel")
        b = greedy_row_assignment_batch(C, est, need=nd, impl="scan")
        assert torch.equal(a, b)


@pytest.mark.parametrize("censored", [False, True])
def test_trajectories_on_card_equal_cpu(cuda, censored):
    """On a shared trace the rounds engine's trajectories are the same bits
    on the card (greedy kernel) as on the CPU (plain version): replay,
    gathers, mins, selections, explicit left folds and the greedy picks are
    all exact."""
    gen = np.random.default_rng(9)
    n, r, rounds, trials = 12, 3, 6, 300
    T1 = (1e-4 * (0.5 + gen.random((rounds, trials, n, r)))).astype(
        np.float32)
    T2 = (5e-4 * (0.5 + gen.random((rounds, trials, n, r)))).astype(
        np.float32)
    proc = TraceProcess(DelayTrace(T1, T2))
    for spec in (adaptive_spec("adapt", cyclic_to_matrix(n, r)),
                 to_spec("cs", cyclic_to_matrix(n, r)), lb_spec(r)):
        a = trajectory_samples(spec, proc, n, rounds=rounds, k=9,
                               trials=trials, chunk=128, devices=cuda,
                               censored_feedback=censored)
        b = trajectory_samples(spec, proc, n, rounds=rounds, k=9,
                               trials=trials, devices="cpu",
                               censored_feedback=censored)
        assert torch.equal(a.cpu(), b)


def _live_trace(n, r, rounds, seed):
    gen = np.random.default_rng(seed)
    T1 = (1e-4 * (0.5 + gen.random((rounds, 1, n, r)))).astype(np.float32)
    T2 = (5e-4 * (0.5 + gen.random((rounds, 1, n, r)))).astype(np.float32)
    return TraceProcess(DelayTrace(T1, T2))


def _same_live(a, b):
    for key in ("per_round", "realized", "missed"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    np.testing.assert_array_equal(a.trace.T1, b.trace.T1)
    np.testing.assert_array_equal(a.trace.T2, b.trace.T2)


def test_live_static_on_card_equals_cpu_and_the_engine(cuda):
    """A static live run (inproc and tcp, the master scoring on the card)
    on a shared trace: the same bits as on the CPU and as the engine's
    replay; the card's own draws equal sweep_rounds' recording."""
    n, r, rounds = 8, 2, 5
    proc = _live_trace(n, r, rounds, 3)
    cfg = RoundConfig(n=n, k=6, kind="cs", r=r)
    a = run_live(cfg, proc, rounds, abort_on_close=False)
    _same_live(a, run_live(cfg, proc, rounds, abort_on_close=False,
                           device="cpu"))
    _same_live(a, run_live(cfg, proc, rounds, abort_on_close=False,
                           address="tcp://127.0.0.1:0"))
    spec = cfg.to_scheme_spec("s")
    eng = sweep_rounds([spec], proc, n, rounds=rounds, trials=1, k=6,
                       devices=cuda)
    np.testing.assert_array_equal(a.per_round.astype(np.float32),
                                  eng.per_round["s"].astype(np.float32))
    cluster = MarkovRegimeProcess(base=scenario1(), persistence=0.9)
    T1, T2 = sample_delay_tables(cluster, 5, rounds, n, r)
    rec = sweep_rounds([spec], cluster, n, rounds=rounds, trials=1, k=6,
                       seed=5, record_trace=True, devices=cuda).trace
    np.testing.assert_array_equal(T1, rec.T1[:, 0])
    np.testing.assert_array_equal(T2, rec.T2[:, 0])


@pytest.mark.parametrize("n", [8, 200])
def test_live_adaptive_on_card_equals_cpu(cuda, n):
    """An adaptive live run under reissue with censored feedback on a
    shared trace: one greedy_assign launch a round (the wide route at
    n = 200), and the same bits on the card as on the CPU."""
    r, rounds = 3, 4
    proc = _live_trace(n, r, rounds, 8)
    k = 3 * n // 4
    dl = float(np.median(sweep_rounds(
        [to_spec("cs", cyclic_to_matrix(n, r))], proc, n, rounds=rounds,
        trials=1, k=k, devices=cuda).per_round["cs"]))
    cfg = RoundConfig(n=n, k=k, kind="cs", r=r, adaptive=True,
                      censored_feedback=True, deadline=dl,
                      deadline_policy="reissue")
    ops.reset_launch_counts()
    a = run_live(cfg, proc, rounds)
    assert ops.LAUNCHES["greedy_assign"] == rounds
    _same_live(a, run_live(cfg, proc, rounds, device="cpu"))


def test_stream_grid_fused_equals_per_cell_on_card(cuda):
    """The grid engine on the card: every fused cell (all-k and single-k,
    budgets, overheads, coded schemes) equals its per-cell sweep on the
    card bit for bit, in several chunks, with one evaluator build per
    shape bucket."""
    cells = GridSpec(n=8, families=("cs", "ss", "ra", "lb", "pc", "pcmm"),
                     loads=(2, 4, 8), messages=(None, 2),
                     comm_eps=(0.0, 0.02), ks=(None, 5), trials=3000,
                     chunk=1000).cells(scenario1())
    montecarlo.clear_cache()
    before = montecarlo.cache_stats()["traces"]
    res = stream_grid(cells, devices=cuda)
    assert montecarlo.cache_stats()["traces"] - before == res.meta["buckets"]
    assert res.meta["devices"].startswith("cuda")
    for c in cells:
        ref = sweep(c.specs, c.model, c.n, trials=c.trials, seed=c.seed,
                    chunk=c.chunk, ks=c.ks, devices=cuda)
        for sp in c.specs:
            np.testing.assert_array_equal(res.cell(c.name)["means"][sp.name],
                                          np.atleast_1d(ref.means[sp.name]))
            np.testing.assert_array_equal(
                res.cell(c.name)["stderr"][sp.name],
                np.atleast_1d(ref.stderr[sp.name]))


@pytest.mark.parametrize("ks", [None, 5])
def test_resumable_extension_equals_fresh_sweep_on_card(cuda, ks):
    """A resumable sweep extended over three rungs equals a fresh card
    sweep at each total bit for bit, and its kept samples equal
    completion_samples on the card."""
    n = 8
    specs = [to_spec("cs", cyclic_to_matrix(n, 4)),
             to_spec("ss", staircase_to_matrix(n, 4), messages=2),
             lb_spec(4), pcmm_spec(4)]
    rs = resumable_sweep(specs, scenario1(), n, seed=2, chunk=512, ks=ks,
                         devices=cuda, keep_samples=True)
    for total in (512, 2048, 8192):
        got = rs.extend_trials(total)
        fresh = sweep(specs, scenario1(), n, trials=total, seed=2, chunk=512,
                      ks=ks, devices=cuda)
        for nm in fresh.means:
            np.testing.assert_array_equal(got.means[nm], fresh.means[nm])
            np.testing.assert_array_equal(got.stderr[nm], fresh.stderr[nm])
    ref = completion_samples(specs[0], scenario1(), n, trials=8192, seed=2,
                             chunk=512, k=ks, devices=cuda)
    np.testing.assert_array_equal(
        rs.samples()["cs"].reshape(ref.shape), ref.cpu().numpy())


def test_cached_rounds_function_same_bits_on_card(cuda):
    """A rounds evaluator from the cache, called twice on the card (the
    adaptive spec through the greedy_assign kernel, reissue deadlines),
    gives the same bits: it carries no state from one call to the next."""
    n, r = 12, 3
    proc = MarkovRegimeProcess(base=scenario1(), persistence=0.9)
    specs = (adaptive_spec("adapt", cyclic_to_matrix(n, r)),
             to_spec("cs", cyclic_to_matrix(n, r)))
    args = (specs, proc, n, r, 9, 4, 0.7, 0.5, True, None, (cuda,), 2e-3,
            "reissue")
    fns = montecarlo._get_rounds_exec(*args)
    assert montecarlo._get_rounds_exec(*args) is fns
    fn = fns[cuda]
    tids = torch.arange(500, device=cuda)
    ops.reset_launch_counts()
    a_times, a_aux = fn(3, tids)
    b_times, b_aux = fn(3, tids)
    assert ops.LAUNCHES["greedy_assign"] == 2 * 4
    for nm in a_times:
        assert torch.equal(a_times[nm], b_times[nm])
        for key in a_aux[nm]:
            assert torch.equal(a_aux[nm][key], b_aux[nm][key])
    cell = GridCell("r", specs, n, proc, trials=500, rounds=4, k=9,
                    censored_feedback=True, deadline=2e-3,
                    deadline_policy="reissue")
    grid = stream_grid([cell], devices=cuda)
    ref = sweep_rounds(specs, proc, n, rounds=4, k=9, trials=500,
                       censored_feedback=True, deadline=2e-3,
                       deadline_policy="reissue", devices=cuda)
    for nm in ref.per_round:
        np.testing.assert_array_equal(grid.cell("r")["per_round"][nm],
                                      ref.per_round[nm])


SWA_SHAPES = [
    (1, 128, 2, 2, 64, 32), (1, 200, 1, 1, 32, 64), (1, 256, 2, 2, 128, 100),
    (1, 64, 4, 4, 16, 8), (1, 96, 1, 1, 64, 96), (1, 130, 2, 2, 32, 17),
    (1, 64, 1, 1, 32, 1), (3, 77, 6, 2, 16, 5), (2, 300, 8, 4, 256, 70),
    (2, 129, 8, 1, 128, 1000)]
# the tensor-core kernel's tiling: T off the 64-row tiles and 128-row
# blocks, W off the 64-key tiles, W = 1 and W >= T, K = 1 and K = H, an odd
# group (H / K = 3), B > 1, every dh it takes, and two heads of one KV group
# per block (H / K even)
SWA_TC_SHAPES = [
    (1, 130, 2, 2, 64, 70), (2, 321, 4, 2, 128, 100), (1, 257, 4, 4, 256, 1),
    (2, 190, 4, 2, 64, 500), (1, 64, 2, 1, 256, 64), (2, 300, 8, 1, 64, 130),
    (1, 250, 3, 3, 128, 90), (2, 200, 6, 2, 128, 64), (3, 65, 4, 4, 64, 65),
    (1, 1100, 8, 4, 256, 1024), (2, 513, 4, 2, 256, 129)]


@pytest.mark.parametrize("B,T,H,K,dh,W", SWA_SHAPES + SWA_TC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_matches_plain(cuda, B, T, H, K, dh, W, dtype):
    """Each call launches one kernel: the float32 tensor-core one
    (error-compensated TF32) for float32, the wgmma one for bfloat16 at dh
    64, 128 and 256, the CUDA-core one for bfloat16 at dh 16 and 32.  The
    float32 kernel also keeps float32 accuracy: against a float64
    evaluation of the same inputs its max-abs error is at most 10x the
    plain float32 version's own (a single TF32 product misses that by
    orders of magnitude; tests/test_torch_swa_split.py)."""
    gen = np.random.default_rng(B * T + W)
    q = torch.as_tensor(0.5 * gen.standard_normal((B, T, H, dh)),
                        dtype=torch.float32).to(cuda, dtype)
    k = torch.as_tensor(0.5 * gen.standard_normal((B, T, K, dh)),
                        dtype=torch.float32).to(cuda, dtype)
    v = torch.as_tensor(gen.standard_normal((B, T, K, dh)),
                        dtype=torch.float32).to(cuda, dtype)
    before = dict(ops.LAUNCHES)
    got = ops.swa_attention(q, k, v, window=W)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    tensor_core = dtype == torch.bfloat16 and dh in (64, 128, 256)
    assert ops.swa_route(dtype, dh) == (
        "tensor_core_f32" if f32 else
        "tensor_core" if tensor_core else "cuda_core")
    assert ops.LAUNCHES["swa_attention"] == before["swa_attention"] + 1
    assert (ops.LAUNCHES["swa_attention_wgmma"]
            == before["swa_attention_wgmma"] + tensor_core)
    assert (ops.LAUNCHES["swa_attention_f32"]
            == before["swa_attention_f32"] + f32)
    want = ref.swa_attention_ref(q, k, v, W)
    assert got.dtype == dtype and got.shape == q.shape
    if f32:
        assert (got.float() - want.float()).abs().max().item() < 2e-4
        exact = ref.swa_attention_ref(q.double(), k.double(), v.double(), W)
        err = (got.double() - exact).abs().max().item()
        assert err <= 10 * (want.double() - exact).abs().max().item()
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-3)


def _swa_f32_launch(q, k, v, W, plan):
    """The float32 swa kernel launched past the wrapper on ``plan``."""
    out = ops._swa_f32_run(q, k, v, W, plan)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("B,T,H,K,dh,W", [
    (2, 300, 8, 4, 256, 70), (1, 1100, 8, 4, 256, 1024), (1, 257, 4, 4, 256, 1),
    (2, 300, 8, 1, 64, 130), (1, 250, 3, 3, 128, 90)])
def test_swa_f32_split_ranges_merge(cuda, B, T, H, K, dh, W):
    """A plan that splits the KV ranges past half the longest in two and
    one that splits none give the plain version's result within 2e-4 and the float64
    guard, and the split one gives the same bits twice (the merge does not
    depend on which half finishes last)."""
    gen = np.random.default_rng(B * T + W + 1)
    q, k, v = (torch.as_tensor(s * gen.standard_normal(shape),
                               dtype=torch.float32).to(cuda)
               for s, shape in ((0.5, (B, T, H, dh)), (0.5, (B, T, K, dh)),
                                (1.0, (B, T, K, dh))))
    split = ops.swa_f32_plan(B, T, H, K, dh, min(W, T), 0.5)
    whole = ops.swa_f32_plan(B, T, H, K, dh, min(W, T), 1)
    assert split.pairs > 0 and whole.pairs == 0
    want = ref.swa_attention_ref(q, k, v, W)
    exact = ref.swa_attention_ref(q.double(), k.double(), v.double(), W)
    bound = 10 * (want.double() - exact).abs().max().item()
    a = _swa_f32_launch(q, k, v, W, split)
    for got in (a, _swa_f32_launch(q, k, v, W, whole)):
        assert (got - want).abs().max().item() < 2e-4
        assert (got.double() - exact).abs().max().item() <= bound
    assert torch.equal(a, _swa_f32_launch(q, k, v, W, split))


def test_swa_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 16, 4, 32), device=cuda)
    k = torch.zeros((1, 16, 2, 32), device=cuda)
    before = ops.LAUNCHES["swa_attention"]
    with pytest.raises(TypeError):
        ops.swa_attention(q.double(), k.double(), k.double(), window=4)
    with pytest.raises(TypeError):
        ops.swa_attention(q, k.bfloat16(), k, window=4)
    with pytest.raises(ValueError, match="head dims"):
        ops.swa_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                          k[..., :24].contiguous(), window=4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.swa_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                          k, window=4)
    with pytest.raises(ValueError, match="CUDA"):
        ops.swa_attention(q, k.cpu(), k, window=4)
    with pytest.raises(ValueError, match="window"):
        ops.swa_attention(q, k, k, window=0)
    # the tensor-core route's TMA needs 16-byte aligned rows: a contiguous
    # view two bytes into its storage is refused
    flat = torch.zeros(1 + 16 * 4 * 64, dtype=torch.bfloat16, device=cuda)
    qm = flat[1:].view(1, 16, 4, 64)
    km = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        ops.swa_attention(qm, km, km, window=4)
    # so does the float32 route's cp.async: a view one float in
    flat = torch.zeros(1 + 16 * 4 * 32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        ops.swa_attention(flat[1:].view(1, 16, 4, 32), k, k, window=4)
    assert ops.LAUNCHES["swa_attention"] == before


@torch.inference_mode()
def test_lm_on_card_matches_cpu_and_counts_launches(cuda):
    """gemma3-4b's smoke width with 7 layers (6 swa): the logits of a full
    forward and of a prefill past the window plus decode steps agree with
    the CPU (plain attention) within rel 1e-4; one launch of the float32
    tensor-core kernel per swa layer for the forward and for the prefill,
    none for decode."""
    cfg = dataclasses.replace(get_config("gemma3-4b").smoke(), n_layers=7)
    cpu_model = init_params(cfg, seed=3, device="cpu")
    gpu_model = init_params(cfg, seed=3, device="cpu").to(cuda)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 48)))

    def rel(a, b):
        return ((a.cpu() - b).abs().max() / b.abs().max()).item()

    before = ops.LAUNCHES["swa_attention"]
    before_f32 = ops.LAUNCHES["swa_attention_f32"]
    a, _, _ = forward(gpu_model, cfg, toks.to(cuda))
    b, _, _ = forward(cpu_model, cfg, toks)
    assert ops.LAUNCHES["swa_attention"] == before + 6
    assert ops.LAUNCHES["swa_attention_f32"] == before_f32 + 6
    assert rel(a, b) < 1e-4
    ca = init_cache(cfg, 2, 64, device=cuda)
    cb = init_cache(cfg, 2, 64, device="cpu")
    a, _, ca = forward(gpu_model, cfg, toks[:, :40].to(cuda), cache=ca)
    b, _, cb = forward(cpu_model, cfg, toks[:, :40], cache=cb)
    assert ops.LAUNCHES["swa_attention"] == before + 12
    assert ops.LAUNCHES["swa_attention_f32"] == before_f32 + 12
    assert rel(a, b) < 1e-4
    for t in range(40, 48):
        a, _, ca = forward(gpu_model, cfg, toks[:, t:t + 1].to(cuda),
                           cache=ca)
        b, _, cb = forward(cpu_model, cfg, toks[:, t:t + 1], cache=cb)
        assert rel(a, b) < 1e-4
    assert ops.LAUNCHES["swa_attention"] == before + 12
    assert ops.LAUNCHES["swa_attention_f32"] == before_f32 + 12


def test_sharded_sweep_forms_on_card(cuda):
    """The int form of ``devices`` (the first N cards), a sequence naming
    cuda:0 and the card repeated three times (7 chunks, padded to 9) give
    one result bit for bit, statistics and per-trial samples."""
    specs = [to_spec("cs", cyclic_to_matrix(8, 3)), lb_spec(3)]
    kw = dict(trials=3300, chunk=500, seed=1)
    a = sweep(specs, scenario1(), 8, devices=1, **kw)
    for devs in (["cuda:0"], [torch.device("cuda", 0)] * 3):
        b = sweep(specs, scenario1(), 8, devices=devs, **kw)
        for name in a.means:
            assert np.array_equal(a.means[name], b.means[name])
            assert np.array_equal(a.stderr[name], b.stderr[name])
    s1 = completion_samples(specs[0], scenario1(), 8, k=6, devices=1, **kw)
    s3 = completion_samples(specs[0], scenario1(), 8, k=6,
                            devices=["cuda:0"] * 3, **kw)
    assert s3.device.type == "cuda" and torch.equal(s1, s3)


def test_init_params_equal_on_card_and_cpu(cuda):
    """``init_params`` of gemma3-4b's smoke config is a function of (cfg,
    seed): the card's weights equal the CPU's.  The Philox words are the
    same integers on both devices; the one transcendental, float32
    ``erfinv``, may part in its last bits, so each element is held within
    ``INIT_ERFINV_ULPS`` units in the last place of the CPU's value, and
    biases and norm scales exactly."""
    cfg = get_config("gemma3-4b").smoke()
    tid = torch.tensor([0, 3, 2 ** 33])
    assert torch.equal(rng.random_bits(7, tid.to(cuda), 0, 4096).cpu(),
                       rng.random_bits(7, tid, 0, 4096))
    a = init_params(cfg, seed=7, device=cuda)
    b = init_params(cfg, seed=7, device="cpu")
    inf = torch.tensor(float("inf"))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        p = p.detach().cpu()
        assert p.dtype == q.dtype and p.shape == q.shape, name
        ulp = torch.nextafter(q.abs(), inf) - q.abs()
        assert ((p - q).abs() <= INIT_ERFINV_ULPS * ulp).all(), name
        if name.endswith("scale") or name.endswith(".b"):
            assert torch.equal(p, q), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernels_refuse_calls_autograd_would_record(cuda, dtype):
    """The kernels write through raw pointers, so their output has no
    history: under autograd the wrapper raises instead of dropping the
    gradients of q, k, v; without grad it launches."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 64, 8, 64, generator=gen, device=cuda,
                           dtype=dtype) for _ in range(3))
    before = ops.LAUNCHES["swa_attention"]
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.swa_attention(q.requires_grad_(), k, v, window=16)
    assert ops.LAUNCHES["swa_attention"] == before
    with torch.no_grad():
        out = ops.swa_attention(q, k, v, window=16)
    assert out.grad_fn is None and ops.LAUNCHES["swa_attention"] == before + 1
    ops.swa_attention(q.detach(), k, v, window=16)
    assert ops.LAUNCHES["swa_attention"] == before + 2


#: the bfloat16 card-vs-CPU training check compares the updates the two
#: devices make from one start: the norm of their difference within this
#: share of the CPU update's norm, and 99 % of the elements within one
#: learning rate of it.  A step that leaves the weights as they were has a
#: gap of 1 and fails; so does one that moves them the wrong way.
TRAIN_BF16_UPDATE_REL = 0.1
TRAIN_BF16_UPDATE_Q = 0.99


def _update_gap(d_card, d_cpu):
    """(norm of the difference over the CPU update's norm, the
    ``TRAIN_BF16_UPDATE_Q`` quantile of the elementwise difference)."""
    diff = torch.cat([(a - b).flatten() for a, b in zip(d_card, d_cpu)])
    ref_norm = torch.cat([b.flatten() for b in d_cpu]).norm()
    return ((diff.norm() / ref_norm).item(),
            torch.quantile(diff.abs()[::max(1, diff.numel() // 2 ** 24)],
                           TRAIN_BF16_UPDATE_Q).item())


def test_bf16_train_step_on_card_matches_cpu(cuda):
    """gemma3-4b's smoke config in bfloat16, two straggler-scheduled AdamW
    steps on one CPU-drawn trace from one set of weights, the card against
    the CPU: the rounds (completion times, winner weights) exact, the loss
    within rel 3e-2 (the bfloat16 tolerance above) and the update each
    device made (its weights after the steps less the start) within
    ``TRAIN_BF16_UPDATE_REL`` of the CPU's in norm and one learning rate
    elementwise at the ``TRAIN_BF16_UPDATE_Q`` quantile."""
    cfg = dataclasses.replace(get_config("gemma3-4b").smoke(),
                              param_dtype="bfloat16", dtype="bfloat16")
    n, r, k, lr, steps = 4, 2, 3, 1e-3, 2
    T1, T2 = MarkovRegimeProcess(p_slow=0.3).sample_rounds(5, 1, n, r, steps,
                                                           device="cpu")
    trace = DelayTrace(T1.numpy(), T2.numpy())
    rc = RoundConfig(n=n, k=k, kind="ss", r=r)
    part = TaskPartition(n=n, global_batch=8, seq_len=48,
                         vocab=cfg.vocab_size, source="bigram")
    opt = adamw(lr)
    runs = {}
    first = init_train_state(cfg, opt, seed=0, device="cpu")
    start = [p.detach().float().clone() for p in first.params.parameters()]
    for dev in ("cpu", cuda):
        state = init_train_state(cfg, opt, seed=0, device=dev)
        # one start, bit for bit (float32 erfinv may part in the last bits
        # between the devices, test_init_params_equal_on_card_and_cpu)
        state.params.load_state_dict(first.params.state_dict())
        step = make_straggler_train_step(cfg, opt, rc, TraceProcess(trace))
        cl, hist = None, []
        for t in range(steps):
            toks, labs = lm_task_batches(part, rc.to_matrix(), t, device=dev)
            state, m, cl = step(state, toks, labs, 0, cl)
            hist.append({key: v.cpu() for key, v in m.items()})
        runs[str(dev)] = (state, hist)
    (cs, ch), (gs, gh) = runs["cpu"], runs[str(cuda)]
    for a, b in zip(gh, ch):
        for key in ("completion_time", "weights", "delivered_tasks"):
            assert torch.equal(a[key], b[key]), key
        assert abs(float(a["loss"]) - float(b["loss"])) <= \
            3e-2 * abs(float(b["loss"]))
        assert torch.isfinite(a["grad_norm"])
    d_cpu = [p.detach().float() - w for p, w in
             zip(cs.params.parameters(), start)]
    d_card = [p.detach().float().cpu() - w for p, w in
              zip(gs.params.parameters(), start)]

    def within(d):
        rel, q = _update_gap(d, d_cpu)
        return rel <= TRAIN_BF16_UPDATE_REL and q <= lr

    rel, q = _update_gap(d_card, d_cpu)
    print(f"bf16 update card vs CPU: rel {rel:.4e}, q{TRAIN_BF16_UPDATE_Q:g} "
          f"{q:.4e} (lr {lr:g})")
    assert within(d_card), (rel, q)
    # the gate fails a card that took no step, or stepped the wrong way
    assert not within([torch.zeros_like(d) for d in d_cpu])
    assert not within([-d for d in d_cpu])


def test_trainer_launches_greedy_assign_once_a_step(cuda, capsys):
    res = train_cli.main(["--arch", "gemma3-4b", "--smoke", "--steps", "3",
                          "--seq", "32", "--adaptive", "--cluster",
                          "markov"])
    assert [h["launches"]["greedy_assign"] for h in res.history] == [1] * 3
    assert all(h["launches"]["swa_attention"] == 0 for h in res.history)
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert "done: 3 rounds" in capsys.readouterr().out
