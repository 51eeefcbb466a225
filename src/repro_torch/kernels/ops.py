"""Public wrappers of the port's kernels.

A wrapper looks at where its tensors lie: on the CPU it runs the plain
PyTorch version (``ref``), on a CUDA device it launches the hand-written
kernel and raises if that is not possible; there is no fallback from the
card to the plain version.  ``LAUNCHES`` counts the kernel launches of each
wrapper (one per call that reached the card), so a run can show that its
main path went through the kernels.

``swa_attention`` is also a ``torch.library`` custom op
(``repro_torch::swa_attention``) whose CUDA implementation is the launch,
whose fake implementation gives the output's shape alone, and which
``torch.utils.flop_counter`` counts by the band of visible pairs, not the
dense T x T: so the dry run (``launch/dryrun.py``) traces a model through
the kernel on ``meta`` without allocating.  ``gram_matvec`` and
``greedy_assign`` launch directly: the engine that calls them paces them
from the host and reads their results there, and no dry run reaches them.
"""
from __future__ import annotations

import heapq
import math
from functools import lru_cache
from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build, ref

__all__ = ["gram_matvec", "batched_gram_matvec", "gram_plan", "GramPlan",
           "gram_onepass_max_d", "gram_tall_plan", "TallPlan",
           "greedy_assign", "greedy_route", "greedy_smem", "swa_attention",
           "swa_route", "swa_f32_plan", "swa_f32_makespan", "SwaF32Plan",
           "GREEDY_MAX_N", "GREEDY_WARP_MAX_N", "SWA_HEAD_DIMS",
           "SWA_TENSOR_CORE_HEAD_DIMS", "LAUNCHES", "reset_launch_counts",
           "swa_flops", "register_swa_sharding"]

#: kernel name -> launches since the last ``reset_launch_counts``;
#: "gram_matvec" counts the calls of both of its routes,
#: "gram_matvec_onepass" those of the one-pass route alone;
#: "greedy_assign_need" counts the greedy_assign launches that carry need
#: rows (the reissue priority), a subset of "greedy_assign";
#: "swa_attention" counts the launches of all three of its routes,
#: "swa_attention_wgmma" those of the bfloat16 tensor-core route alone,
#: "swa_attention_f32" those of the float32 tensor-core route alone
LAUNCHES = {"gram_matvec": 0, "gram_matvec_onepass": 0, "greedy_assign": 0,
            "greedy_assign_need": 0, "swa_attention": 0, "swa_attention_wgmma": 0,
            "swa_attention_f32": 0}

#: the greedy_assign kernel's layout, mirrored from csrc/greedy_assign.cu
#: (kMaxN, kWideMaxN, kCap, kWideWarps and kTileStride there): the largest n
#: of its warp route (W in shared memory), the largest n it takes at all
#: (the wide route keeps a trial's state, 18 bytes a task, and one W tile a
#: warp in shared memory: 215 296 bytes at 8192, under the 227 KB a block
#: may opt into on an H100), the nonzeros a row's list keeps, the most warps
#: of a wide block and the row stride of a warp's W tile.
#: tests/test_torch_greedy_route.py reads these values from the source.
GREEDY_WARP_MAX_N = 128
GREEDY_MAX_N = 8192
GREEDY_CAP = 16
GREEDY_WIDE_WARPS = 16
GREEDY_TILE_STRIDE = 33

#: the head dims the swa_attention kernels are compiled for
SWA_HEAD_DIMS = (16, 32, 64, 128, 256)

#: the head dims of the bfloat16 tensor-core (wgmma) route; float32 takes
#: its own tensor-core route at every dh in SWA_HEAD_DIMS
SWA_TENSOR_CORE_HEAD_DIMS = (64, 128, 256)

#: the one-pass gram_matvec kernel's tile layout, mirrored from
#: csrc/gram_matvec_onepass.cu (kThreads, kStages, kMaxCluster, kHeader,
#: kMaxBox, kSmemLimit there): its block size, the mbarrier stages of a
#: tile, its largest cluster, the bytes before the tile, the widest TMA box
#: and the most shared memory a block may use on an H100.  The launcher
#: refuses a plan whose shared memory differs from its own count, and
#: tests/test_torch_gram_plan.py reads these values from the source.
GRAM_THREADS = 256
GRAM_STAGES = 4
GRAM_MAX_CLUSTER = 8
GRAM_HEADER = 128
GRAM_MAX_BOX = 256
GRAM_SMEM_LIMIT = 232448
#: the fewest rows gram_plan gives a CTA where d allows, and the most
#: elements it puts in a tile: 192 KB in float32 (one CTA an SM), 96 KB in
#: bfloat16 (two).  The budget is the best of the widths that
#: benchmarks_torch/gram_tiles.py timed at (64, 4096, 1024) on an H100
#: (PERF.md); no path of the repo sends that shape, and the DGD shape
#: fits one tile whatever the budget.
GRAM_MIN_ROWS = 16
GRAM_TILE_ELEMS = 48 * 1024

#: the two-pass gram_matvec kernel's layout, mirrored from
#: csrc/gram_matvec.cu (kThreads and kFoldMax there): its block size and the
#: most partials of u (slabs x b) that each CTA of its second pass folds.
#: tests/test_torch_gram_tall.py reads these values from the source.
TALL_THREADS = 256
TALL_FOLD_MAX = 8192
#: gram_tall_plan's aims: the CTAs a pass spreads a call over (two per SM of
#: a 132-SM H100, a constant so that the plan, and so the bits, do not
#: depend on the card), the fewest bytes of X a CTA reads where the task is
#: that tall, and the bytes a column block is rounded to (one cache line).
TALL_ITEMS = 264
TALL_MIN_BYTES = 16384
TALL_LINE = 128

#: the float32 swa_attention kernel's layout, mirrored from
#: csrc/swa_attention_f32.cu (kThreads, kRows and Cfg::kKeys there): its
#: block size, the query rows (head, position) a block holds, and the keys
#: of a KV tile (32 at dh 256, else 64).  tests/test_torch_swa_plan.py reads
#: these values from the source.
SWA_F32_THREADS = 256
SWA_F32_ROWS = 128
SWA_F32_KEYS = {16: 64, 32: 64, 64: 64, 128: 64, 256: 32}
#: swa_f32_plan's model, in KV-tile times: what a block costs beyond its
#: tiles (Q, the prologue, the epilogue) and what a split half costs beyond
#: that (its state written, the other's merged), both fitted by
#: benchmarks_torch/swa_f32.py to the kernel's times on an H100; and the
#: shares of the longest KV range past which its plans split ranges
SWA_F32_BLOCK_COST = 0.75
SWA_F32_SPLIT_COST = 0.25
SWA_F32_SHARES = (1, 0.75, 0.5)
#: the blocks the model runs at once: one a multiprocessor of an H100 SXM.
#: A constant, not the card's count, so that a call's plan, and with it the
#: bits of its result, depend on the shape alone.
SWA_F32_SLOTS = 132

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class GramPlan(NamedTuple):
    """How a CUDA call of ``batched_gram_matvec`` runs.  ``route`` is
    ``"onepass"`` (``csrc/gram_matvec_onepass.cu``: clusters of ``c`` CTAs,
    each holding ``R`` rows of a column block of ``C`` columns in ``smem``
    bytes of shared memory, ``nbc`` column blocks) or ``"twopass"``
    (``csrc/gram_matvec.cu``; the other fields 0)."""
    route: str
    c: int
    R: int
    C: int
    nbc: int
    smem: int


def _gram_tile_rows(R: int) -> int:
    """Rows a tile holds room for: a whole number of boxes per stage, each
    a multiple of 8 rows and at most ``GRAM_MAX_BOX`` (``boxes`` x
    ``box_rows`` in the kernel's source)."""
    nbox = GRAM_STAGES * -(-R // (GRAM_STAGES * GRAM_MAX_BOX))
    return nbox * ((-(-R // nbox) + 7) & ~7)


def _gram_smem(R: int, C: int, item: int) -> int:
    """Shared memory of one CTA (``smem_bytes`` in the kernel's source): the
    barriers' header, the tile (rounded up to 128 bytes), then float32
    theta, the row groups' column sums, two parts of u and u, each rounded
    up to 4 floats."""
    def r4(v):
        return (v + 3) & ~3
    return (GRAM_HEADER + ((_gram_tile_rows(R) * C * item + 127) & ~127)
            + 4 * (r4(R) + r4(max(GRAM_THREADS * (16 // item), C)) + 3 * r4(C)))


@lru_cache(maxsize=256)
def gram_plan(n: int, d: int, b: int, dtype: torch.dtype) -> GramPlan:
    """The plan of a CUDA ``batched_gram_matvec`` call on Xs (n, d, b).

    A cluster holds one column block of one task over its whole height:
    c = min(8, ceil(d / 16)) CTAs of R = ceil(d / c) rows.  If a tile of the
    whole width fits (at most ``GRAM_TILE_ELEMS`` elements, within
    ``GRAM_SMEM_LIMIT``), one block covers b (one launch).  Otherwise c = 8
    and the block takes the widest C that fits and TMA's box (256 columns),
    in steps of 64 bytes (16 where even 64 do not fit, and at least 16
    bytes), evened out over ceil(b / C) blocks.  A column that 8 CTAs
    cannot hold 16 bytes wide within ``GRAM_SMEM_LIMIT`` takes the two-pass
    kernel."""
    if dtype not in _DTYPES:
        raise TypeError(f"gram_matvec takes float32 or bfloat16, got {dtype}")
    item = 2 if dtype == torch.bfloat16 else 4
    q = min(b, 16 // item)                  # the narrowest block: 16 bytes

    def cdiv(a, m):
        return -(-a // m)

    def cluster(c):
        R = cdiv(d, c)
        return cdiv(d, R), R                # no CTA left without rows

    def fits(C):
        return (_gram_tile_rows(R) * C <= GRAM_TILE_ELEMS
                and _gram_smem(R, C, item) <= GRAM_SMEM_LIMIT)

    c, R = cluster(min(GRAM_MAX_CLUSTER, max(1, cdiv(d, GRAM_MIN_ROWS))))
    if fits(b):
        return GramPlan("onepass", c, R, b, 1, _gram_smem(R, b, item))
    c, R = cluster(GRAM_MAX_CLUSTER)
    if _gram_smem(R, q, item) > GRAM_SMEM_LIMIT or n * cdiv(b, q) >= 2 ** 31:
        return GramPlan("twopass", 0, 0, 0, 0, 0)
    step = 64 // item if fits(min(b, 64 // item)) else q
    C = max(step, min(GRAM_MAX_BOX, b) // step * step)
    while C > step and not fits(C):
        C -= step
    nbc = cdiv(b, C)
    C = min(b, cdiv(cdiv(b, nbc), step) * step)
    return GramPlan("onepass", c, R, C, nbc, _gram_smem(R, C, item))


@lru_cache(maxsize=64)
def gram_onepass_max_d(b: int, dtype: torch.dtype) -> int:
    """The largest d whose columns of width b the one-pass route holds
    (``gram_plan(1, d, b, dtype)``); every taller task takes the two-pass
    kernel."""
    lo, hi = 1, 1 << 24
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if gram_plan(1, mid, b, dtype).route == "onepass":
            lo = mid
        else:
            hi = mid
    return lo


class TallPlan(NamedTuple):
    """How the two-pass kernel (``csrc/gram_matvec.cu``) splits a call on
    Xs (n, d, b).  A thread loads ``vec`` elements at once (16 bytes where b
    is a multiple of that, else 1).  Pass 1 (u = Xᵀθ) runs a CTA per (task,
    slab of ``rows1`` rows, column block of ``qb`` vectors): ``s1`` slabs
    and ``ncb`` blocks a task; pass 2 (y = X u) a CTA per slab of ``rows2``
    rows, ``s2`` a task, with ``tr`` threads sharing a row."""
    vec: int
    qb: int
    ncb: int
    rows1: int
    s1: int
    rows2: int
    s2: int
    tr: int


@lru_cache(maxsize=256)
def gram_tall_plan(n: int, d: int, b: int, dtype: torch.dtype) -> TallPlan:
    """The plan of the two-pass kernel for Xs (n, d, b), from the shape and
    dtype alone.

    Pass 1 aims at ``TALL_ITEMS`` CTAs: a column block is at most
    ``TALL_THREADS`` vectors wide, and a task is cut into as many slabs as
    reach that count, as long as its partials (slabs x b floats) stay within
    ``TALL_FOLD_MAX``; where that caps the slabs, narrower column blocks
    (whole cache lines, ``TALL_LINE`` bytes) make up the count.  A slab
    holds at least ``TALL_MIN_BYTES`` of X where d allows.  Pass 2 aims at
    the same count with slabs of whole rows; a row takes one thread when it
    has at most 4 vectors, else up to a warp, about 2 vectors a thread."""
    if dtype not in _DTYPES:
        raise TypeError(f"gram_matvec takes float32 or bfloat16, got {dtype}")
    item = 2 if dtype == torch.bfloat16 else 4

    def cdiv(a, m):
        return -(-a // m)

    vec = 16 // item if b % (16 // item) == 0 else 1
    Q = b // vec                            # vectors a row
    line = max(1, TALL_LINE // (vec * item))
    ncb = cdiv(Q, TALL_THREADS)
    s1 = max(1, min(cdiv(TALL_ITEMS, n * ncb), TALL_FOLD_MAX // b))
    if n * s1 * ncb < TALL_ITEMS:
        ncb = max(ncb, min(cdiv(TALL_ITEMS, n * s1), cdiv(Q, line)))
    qb = min(Q, cdiv(cdiv(Q, ncb), line) * line)
    ncb = cdiv(Q, qb)
    s1 = min(s1, max(1, d // cdiv(TALL_MIN_BYTES, qb * vec * item)))
    rows1 = cdiv(d, s1)
    s2 = max(1, min(cdiv(TALL_ITEMS, n), d // cdiv(TALL_MIN_BYTES, b * item)))
    rows2 = cdiv(d, s2)
    tr = 1 if Q <= 4 else min(32, 1 << ((Q // 2).bit_length() - 1))
    return TallPlan(vec, qb, ncb, rows1, cdiv(d, rows1), rows2,
                    cdiv(d, rows2), tr)


def gram_matvec(X: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """h(X) = X X^T theta.  X (d, b), theta (d,) -> (d,), X's dtype."""
    if X.dim() != 2:
        raise ValueError(f"X must be (d, b), got shape {tuple(X.shape)}")
    return batched_gram_matvec(X.unsqueeze(0), theta)[0]


def batched_gram_matvec(Xs: torch.Tensor,
                        theta: torch.Tensor) -> torch.Tensor:
    """h over a batch of tasks: Xs (n, d, b), theta (d,) -> (n, d) in Xs's
    dtype, accumulated in float32.  On the card this is the route
    ``gram_plan`` names: the one-pass kernel
    (``csrc/gram_matvec_onepass.cu``, one launch when a cluster holds a
    task's whole width, plus a fold of the column blocks' partials
    otherwise) or, for a column no cluster can hold, the two-pass kernel
    (``csrc/gram_matvec.cu``, d split into slabs over every SM as
    ``gram_tall_plan`` says).  A build or launch failure of either raises.
    CPU tensors take the plain version."""
    if Xs.device.type == "cpu" and theta.device.type == "cpu":
        return ref.batched_gram_matvec_ref(Xs, theta)
    if Xs.device.type != "cuda" or theta.device != Xs.device:
        raise ValueError(f"gram_matvec needs Xs and theta on one CUDA device "
                         f"(or both on the CPU); got {Xs.device} and "
                         f"{theta.device}")
    if Xs.dtype not in _DTYPES or theta.dtype != Xs.dtype:
        raise TypeError(f"gram_matvec takes float32 or bfloat16 Xs and theta "
                        f"of the same dtype; got {Xs.dtype} and {theta.dtype}")
    if Xs.dim() != 3 or theta.shape != (Xs.shape[1],):
        raise ValueError(f"need Xs (n, d, b) and theta (d,); got "
                         f"{tuple(Xs.shape)} and {tuple(theta.shape)}")
    n, d, b = Xs.shape
    if min(n, d, b) < 1 or n > 65535 or Xs.numel() >= 2 ** 40:
        raise ValueError(f"gram_matvec shape out of range: {tuple(Xs.shape)}")
    if not (Xs.is_contiguous() and theta.is_contiguous()):
        raise ValueError("gram_matvec needs contiguous Xs and theta")
    plan = gram_plan(n, d, b, Xs.dtype)
    y = torch.empty((n, d), dtype=Xs.dtype, device=Xs.device)
    onepass = plan.route == "onepass"
    if onepass:
        P = (torch.empty((n, plan.nbc, d), dtype=torch.float32,
                         device=Xs.device) if plan.nbc > 1 else None)
        lib = build.library("gram_matvec_onepass")
        launch, error_string = (lib.gram_onepass_launch,
                                lib.gram_onepass_error_string)
        args = (Xs.data_ptr(), theta.data_ptr(), y.data_ptr(),
                None if P is None else P.data_ptr(), n, d, b,
                _DTYPES[Xs.dtype], plan.c, plan.R, plan.C, plan.nbc,
                plan.smem)
    else:
        tall = gram_tall_plan(n, d, b, Xs.dtype)
        # u (n, b), then the partials (n, s1, b) when a task has slabs
        scratch = torch.empty(n * b * (1 + (tall.s1 > 1) * tall.s1),
                              dtype=torch.float32, device=Xs.device)
        lib = build.library("gram_matvec")
        launch, error_string = (lib.gram_matvec_launch,
                                lib.gram_matvec_error_string)
        args = (Xs.data_ptr(), theta.data_ptr(),
                scratch[n * b:].data_ptr() if tall.s1 > 1 else None,
                scratch.data_ptr(), y.data_ptr(), n, d, b, _DTYPES[Xs.dtype],
                *tall)
    stream = torch.cuda.current_stream(Xs.device).cuda_stream
    with torch.cuda.device(Xs.device):
        err = launch(*args, stream)
    if err:
        msg = error_string(err).decode()
        raise RuntimeError(f"gram_matvec launch failed ({plan.route} route):"
                           f" CUDA error {err} ({msg})")
    LAUNCHES["gram_matvec"] += 1
    if onepass:
        LAUNCHES["gram_matvec_onepass"] += 1
    return y


def greedy_route(n: int) -> str:
    """Which route of the greedy_assign kernel a CUDA call at n takes:
    ``"warp_smem"`` (n <= ``GREEDY_WARP_MAX_N``: one warp a trial, W in
    shared memory) or ``"wide"`` (up to ``GREEDY_MAX_N``: one block a trial,
    W read through L2)."""
    if not 1 <= n <= GREEDY_MAX_N:
        raise ValueError(f"greedy_assign takes 1 <= n <= {GREEDY_MAX_N}; "
                         f"got n={n}")
    return "warp_smem" if n <= GREEDY_WARP_MAX_N else "wide"


def greedy_smem(n: int) -> int:
    """Bytes of dynamic shared memory of one greedy_assign block at n on its
    route (the kernel's own count, ``greedy_assign_smem`` in its source).
    warp_smem: W at row stride n | 1, plus each row's nonzero list (value,
    column) and length where a lane holds one row (n <= 32).  wide: the
    warps' two 8-byte reduction slots (for the most warps), one 32-row W
    tile a warp, and cov, epick, order, worker_of_row and two flag bytes a
    task."""
    if greedy_route(n) == "warp_smem":
        lists = 2 * GREEDY_CAP * n + n if n <= 32 else 0
        return (n * (n | 1) + lists) * 4
    warps = min(GREEDY_WIDE_WARPS, -(-n // 32))
    return (2 * GREEDY_WIDE_WARPS * 8 + warps * 32 * GREEDY_TILE_STRIDE * 4
            + n * 18)


def greedy_assign(W: torch.Tensor, order: torch.Tensor, epick: torch.Tensor,
                  need_row: torch.Tensor | None = None) -> torch.Tensor:
    """Batched greedy row assignment (see ``ref.greedy_assign_ref``):
    ``W`` (n, n) coverage weights, ``order``/``epick``/``need_row`` (B, n)
    per-trial pick data -> ``worker_of_row`` (B, n) int32.  On the card
    this is the ``greedy_assign`` CUDA kernel (``csrc/greedy_assign.cu``) on
    the route ``greedy_route(n)`` names, for n <= ``GREEDY_MAX_N`` and
    B * n < 2**31; CPU tensors take the plain version.  Inputs are cast to
    the kernel's types (float32 weights, int32 pickers) as the JAX wrapper
    casts them."""
    tensors = [W, order, epick] + ([] if need_row is None else [need_row])
    if all(t.device.type == "cpu" for t in tensors):
        return ref.greedy_assign_ref(W, order, epick, need_row)
    dev = order.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"greedy_assign needs every input on one CUDA "
                         f"device (or all on the CPU); got "
                         f"{[str(t.device) for t in tensors]}")
    if order.dim() != 2:
        raise ValueError(f"order must be (B, n), got {tuple(order.shape)}")
    B, n = order.shape
    if (W.shape != (n, n) or epick.shape != (B, n)
            or (need_row is not None and need_row.shape != (B, n))):
        raise ValueError(
            f"greedy_assign needs W ({n}, {n}) and epick/need_row ({B}, "
            f"{n}); got W {tuple(W.shape)}, epick {tuple(epick.shape)}"
            + ("" if need_row is None
               else f", need_row {tuple(need_row.shape)}"))
    if B < 1 or not 1 <= n <= GREEDY_MAX_N:
        raise ValueError(f"greedy_assign takes B >= 1 and 1 <= n <= "
                         f"{GREEDY_MAX_N}; got B={B}, n={n}")
    if B * n >= 2 ** 31:
        raise ValueError(f"greedy_assign batch too large: B*n = {B * n}")
    W = W.to(torch.float32).contiguous()
    order = order.to(torch.int32).contiguous()
    epick = epick.to(torch.float32).contiguous()
    if need_row is not None:
        need_row = need_row.to(torch.float32).contiguous()
    out = torch.empty((B, n), dtype=torch.int32, device=dev)
    lib = build.library("greedy_assign")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.greedy_assign_launch(
            W.data_ptr(), order.data_ptr(), epick.data_ptr(),
            None if need_row is None else need_row.data_ptr(),
            out.data_ptr(), B, n, stream)
    if err:
        msg = lib.greedy_assign_error_string(err).decode()
        raise RuntimeError(f"greedy_assign launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["greedy_assign"] += 1
    if need_row is not None:
        LAUNCHES["greedy_assign_need"] += 1
    return out


class SwaF32Plan(NamedTuple):
    """How a CUDA call of the float32 swa_attention kernel
    (``csrc/swa_attention_f32.cu``) runs.  A block holds ``nh`` query heads
    of one KV group at ``npos`` consecutive positions (``SWA_F32_ROWS``
    rows) and walks KV tiles of ``keys`` keys.  ``items`` is the work in
    launch order, each ``(x, kt0, kt1, code)``: query tile x (positions x *
    npos ...), KV tiles kt0..kt1, and code -1 where that is the tile's whole
    range, else 2 * pair + half for one half of a range split in two (the
    two halves write their partial state to scratch slots 2 * pair and 2 *
    pair + 1; the later one merges).  Every item runs once for each head
    group and batch row."""
    nh: int
    npos: int
    keys: int
    items: tuple
    pairs: int


@lru_cache(maxsize=256)
def swa_f32_plan(B: int, T: int, H: int, K: int, dh: int, window: int,
                 split: float | None = None) -> SwaF32Plan:
    """The plan of a float32 CUDA ``swa_attention`` call, from the shape.

    nh is the largest power of two (at most 8) that divides H / K.  Query
    tile x sees the KV tiles from max(0, x * npos - W + 1) // keys to its
    last position's.  The ranges longer than ``split`` times the longest
    are split in two halves (1 splits none), and the items run longest
    first.  ``split`` None takes, of ``SWA_F32_SHARES``, the share whose
    plan has the shortest ``swa_f32_makespan`` (ties: the larger share)."""
    if split is None:
        return min((swa_f32_plan(B, T, H, K, dh, window, share)
                    for share in SWA_F32_SHARES),
                   key=lambda plan: swa_f32_makespan(plan, B, H))
    G = H // K
    nh = 1
    while nh < 8 and G % (2 * nh) == 0:
        nh *= 2
    npos = SWA_F32_ROWS // nh
    keys = SWA_F32_KEYS[dh]
    w = min(window, T)
    spans = [(x, max(0, x * npos - w + 1) // keys,
              (min((x + 1) * npos, T) - 1) // keys)
             for x in range(-(-T // npos))]
    cap = math.ceil(max(hi - lo + 1 for _, lo, hi in spans) * split)
    items = []                          # (x, kt0, kt1, half or -1)
    for x, lo, hi in spans:
        if hi - lo + 1 <= cap:
            items.append((x, lo, hi, -1))
        else:
            mid = lo + (hi - lo + 2) // 2
            items += [(x, lo, mid - 1, 0), (x, mid, hi, 1)]
    items.sort(key=lambda it: (it[1] - it[2], -it[0], it[3]))
    pair = {}
    out = []
    for x, lo, hi, half in items:
        code = -1 if half < 0 else 2 * pair.setdefault(x, len(pair)) + half
        out.append((x, lo, hi, code))
    return SwaF32Plan(nh, npos, keys, tuple(out), len(pair))


def swa_f32_makespan(plan: SwaF32Plan, B: int, H: int,
                     block_cost: float = SWA_F32_BLOCK_COST,
                     split_cost: float = SWA_F32_SPLIT_COST) -> float:
    """The plan's modelled time in KV-tile times: each of its (H / nh) * B
    blocks an item costs the item's tiles plus ``block_cost`` (a split
    half ``split_cost`` more) and runs, in plan order, on the first of
    ``SWA_F32_SLOTS`` slots to free."""
    free = [0.0] * SWA_F32_SLOTS
    for _, lo, hi, code in plan.items:
        cost = hi - lo + 1 + block_cost + (split_cost if code >= 0 else 0)
        for _ in range((H // plan.nh) * B):
            heapq.heapreplace(free, free[0] + cost)
    return max(free)


@lru_cache(maxsize=64)
def _swa_f32_table(plan: SwaF32Plan, device: torch.device) -> torch.Tensor:
    """The plan's items as an int32 (n, 4) tensor on ``device``, made once
    per plan and device."""
    return torch.tensor(plan.items, dtype=torch.int32).to(device)


def _swa_f32_run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int, plan: SwaF32Plan, lib=None) -> torch.Tensor:
    """One launch of the float32 swa kernel (``lib``: the built
    ``csrc/swa_attention_f32.cu`` or a copy with its entry points) on
    ``plan``, for inputs the caller has checked; counts nothing.  Scratch
    is sized here, and only here, from the kernel's state layout: per split
    half and block, each thread's accumulator (dh / 2 floats), row maxima
    and sums (4); a count per pair, zeroed, says which half merges."""
    B, T, H, dh = q.shape
    dev = q.device
    per = (H // plan.nh) * B
    scratch = torch.empty(
        2 * plan.pairs * per * SWA_F32_THREADS * (dh // 2 + 4),
        dtype=torch.float32, device=dev) if plan.pairs else None
    counts = (torch.zeros(plan.pairs * per, dtype=torch.int32, device=dev)
              if plan.pairs else None)
    lib = lib or build.library("swa_attention_f32")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.swa_f32_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H,
            k.shape[2], dh, min(window, T),
            _swa_f32_table(plan, dev).data_ptr(), len(plan.items), plan.nh,
            None if scratch is None else scratch.data_ptr(),
            None if counts is None else counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"swa_attention launch failed (tensor_core_f32 "
                           f"kernel): error {err} "
                           f"({lib.swa_f32_error_string(err).decode()})")
    return out


def swa_route(dtype: torch.dtype, dh: int) -> str:
    """Which swa_attention kernel a CUDA call of this dtype and head dim
    launches: ``"tensor_core_f32"`` (``csrc/swa_attention_f32.cu``, TF32
    mma.sync with each float32 product taken as three or four TF32 ones, so
    float32 accuracy) for float32; ``"tensor_core"``
    (``csrc/swa_attention_wgmma.cu``, wgmma fed by TMA) for bfloat16 at dh
    in ``SWA_TENSOR_CORE_HEAD_DIMS``; ``"cuda_core"``
    (``csrc/swa_attention.cu``) for the narrow bfloat16 heads."""
    if dtype == torch.float32:
        return "tensor_core_f32"
    if dtype == torch.bfloat16 and dh in SWA_TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int) -> torch.Tensor:
    """Causal sliding-window attention over one chunk of fresh tokens (see
    ``ref.swa_attention_ref``): q (B, T, H, dh), k/v (B, T, K, dh) with
    H % K == 0 -> (B, T, H, dh) in q's dtype; position t sees (t - window,
    t], query head h reads KV head h // (H // K).  On the card this is one
    launch for the whole batch of the kernel ``swa_route`` names: the
    float32 tensor-core kernel (``csrc/swa_attention_f32.cu``), the bfloat16
    one (``csrc/swa_attention_wgmma.cu``) or the CUDA-core one
    (``csrc/swa_attention.cu``); float32 or bfloat16, contiguous, dh in
    ``SWA_HEAD_DIMS``.  A build or launch failure of any raises, and so
    does a CUDA call that autograd would record (the kernels are
    forward-only).  CPU tensors take the plain version; ``meta`` tensors
    the op's fake implementation (the output's shape alone)."""
    if not isinstance(window, int) or window < 1:
        raise ValueError(f"swa_attention needs an integer window >= 1, got "
                         f"{window!r}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"swa_attention needs q (B, T, H, dh) and k, v "
                         f"(B, T, K, dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, dh = q.shape
    K = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, T, dh) or K < 1 or H % K:
        raise ValueError(f"swa_attention needs k, v (B={B}, T={T}, K, "
                         f"dh={dh}) with H={H} a multiple of K; got "
                         f"{tuple(k.shape)}")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.swa_attention_ref(q, k, v, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the kernels write through raw pointers: their output would enter
        # the graph with no history and the gradients of q, k, v would be
        # lost without a word
        raise RuntimeError(
            "swa_attention's kernels are forward-only: call them under "
            "torch.no_grad() or on tensors that do not require grad (a "
            "backward kernel is later work, ROADMAP.md section 2); under "
            "autograd the model takes models.layers.attention_core")
    dev = q.device
    if dev.type not in ("cuda", "meta") or k.device != dev or v.device != dev:
        raise ValueError(f"swa_attention needs q, k, v on one CUDA device "
                         f"(or all on the CPU); got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"swa_attention takes float32 or bfloat16 q, k, v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in SWA_HEAD_DIMS:
        raise ValueError(f"swa_attention takes head dims {SWA_HEAD_DIMS}; "
                         f"got {dh}")
    if min(B, T, H) < 1 or B > 65535 or H > 65535 or q.numel() >= 2 ** 40:
        raise ValueError(f"swa_attention shape out of range: "
                         f"{tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("swa_attention needs contiguous q, k, v")
    return torch.ops.repro_torch.swa_attention(q, k, v, window)


def _swa_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int) -> torch.Tensor:
    """The CUDA implementation of ``repro_torch::swa_attention``: one
    launch of the kernel ``swa_route`` names, on inputs ``swa_attention``
    has checked."""
    B, T, H, dh = q.shape
    K = k.shape[2]
    dev = q.device
    route = swa_route(q.dtype, dh)
    # TMA and cp.async read rows of q, k, v from 16-byte aligned addresses
    if route != "cuda_core" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("swa_attention needs 16-byte aligned q, k, v")
    if route == "tensor_core_f32":
        out = _swa_f32_run(q, k, v, window,
                           swa_f32_plan(B, T, H, K, dh, min(window, T)))
        LAUNCHES["swa_attention"] += 1
        LAUNCHES["swa_attention_f32"] += 1
        return out
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "tensor_core":
        lib = build.library("swa_attention_wgmma")
        launch, error_string = lib.swa_wgmma_launch, lib.swa_wgmma_error_string
        args = ()
    else:
        lib = build.library("swa_attention")
        launch = lib.swa_attention_launch
        error_string = lib.swa_attention_error_string
        args = (_DTYPES[q.dtype],)
    with torch.cuda.device(dev):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, T, H, K, dh, min(window, T), *args, stream)
    if err:
        msg = error_string(err).decode()
        raise RuntimeError(f"swa_attention launch failed ({route} kernel): "
                           f"error {err} ({msg})")
    LAUNCHES["swa_attention"] += 1
    if route == "tensor_core":
        LAUNCHES["swa_attention_wgmma"] += 1
    return out


_swa_op = torch.library.custom_op("repro_torch::swa_attention", _swa_cuda,
                                  mutates_args=(), device_types="cuda")


@_swa_op.register_fake
def _(q, k, v, window):
    return torch.empty_like(q)


def swa_flops(B: int, T: int, H: int, dh: int, window: int) -> int:
    """The arithmetic of causal window attention, counted as
    ``torch.utils.flop_counter`` counts a matmul: two products (QKᵀ and
    PV) of 2 dh each per visible (query, key) pair, over the pairs that
    position t sees, min(t + 1, W) of them: 4 B H dh sum_t min(t + 1,
    W)."""
    W = min(window, T)
    pairs = W * (W + 1) // 2 + (T - W) * W
    return 4 * B * H * dh * pairs


def register_swa_sharding() -> None:
    """DTensor's sharding rule of ``repro_torch::swa_attention`` (the mesh
    builders of ``launch/mesh.py`` call it): on each mesh axis q, k and v
    come sharded alike, on the batch or on the heads (q's H with k / v's
    K: whole KV groups a rank), or all three replicated (every head count
    fell back, which ``shard`` records), and the op runs on each rank's
    block as it stands.  Any other placement (q's heads sharded where k's
    KV heads do not divide the axis) raises with the op's name: the rule
    offers no replicated fallback that would gather q and run the whole
    band on every rank.  Once per process."""
    global _SWA_SHARDING
    if _SWA_SHARDING:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.swa_attention.default)
    def _rule(q, k, v, window):
        for i, (pq, pk, pv) in enumerate(zip(q.placements, k.placements,
                                             v.placements)):
            if not (pq == pk == pv and (pq.is_replicate()
                                        or pq in (Shard(0), Shard(2)))):
                raise RuntimeError(
                    f"repro_torch::swa_attention: DTensor cannot shard q "
                    f"{tuple(q.placements)}, k {tuple(k.placements)}, v "
                    f"{tuple(v.placements)} (mesh dim {i}): q, k and v "
                    f"must be sharded alike on the batch or the heads, or "
                    f"all replicated")
        # replicated first: the inputs' own placements are then the first
        # strategy with nothing to redistribute, which DTensor takes
        return [([p], [p, p, p, None])
                for p in (Replicate(), Shard(0), Shard(2))]

    _SWA_SHARDING = True


_SWA_SHARDING = False


@register_flop_formula(torch.ops.repro_torch.swa_attention)
def _(q_shape, k_shape, v_shape, window, *args, out_shape=None,
      **kwargs) -> int:
    B, T, H, dh = q_shape
    return swa_flops(B, T, H, dh, window)
