"""The greedy_assign CUDA kernel's two decisions, emulated in torch on the
CPU and held against the plain version (``ref.greedy_assign_ref``).

The kernel (``csrc/greedy_assign.cu``) folds each row's score over the
row's nonzero columns of W only, in ascending order, padded with (column
0, +0) terms up to the longest list, and folds densely over every column
while some coverage entry is non-finite, where a row has more nonzeros
than its cap (``kCap``) and wherever n > 32.  It picks the row by two
minimum reductions over an order-preserving uint32 key (NaN first, -0 as
+0, taken rows at FLT_MAX's key), the reissue restriction by one more.
The card tests (``tests/test_torch_card.py``) hold the kernel itself to
the plain version; here each decision is checked where it can be: (a) the
sparse fold equals the dense one bit for bit while the coverage is
finite, (b) it does not when a coverage entry is inf or NaN, (c) the key
orders as the kernel's ``before()`` and ``torch.argmin`` do, (d) the
whole emulated pick loop, reissue rule and non-finite inputs included,
gives the plain version's output, with the trials it folds densely where
the card tests expect the kernel's own count to find them, (e) past
n = 128 the wide route's argmin, one min over each row's packed (key << 32
| row), picks the same row, and its whole loop gives the plain version's
output.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (cyclic_to_matrix, random_assignment_to_matrix,
                              staircase_to_matrix)
from repro_torch.core.scheduling import _greedy_matrices
from repro_torch.kernels import ref

BIG = torch.finfo(torch.float32).max
KEY_FLT_MAX = 0xff7fffff
ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "greedy_assign.cu"
#: the most nonzeros a row's list keeps (the kernel's kCap)
CAP = int(re.search(r"constexpr int kCap = (\d+);", SOURCE.read_text())[1])


def key_of(x: torch.Tensor) -> torch.Tensor:
    """The kernel's key_of as int64: NaN -> 0, -0 -> +0, else the float
    order mapped onto unsigned 32-bit integers."""
    u = x.view(torch.int32).to(torch.int64) & 0xffffffff
    u = torch.where(u == 0x80000000, 0, u)
    k = torch.where(u >= 0x80000000, (~u) & 0xffffffff, u | 0x80000000)
    return torch.where(torch.isnan(x), 0, k)


def dense_fold(W, cov):
    """The plain version's scores: a left fold over every column."""
    acc = torch.zeros_like(cov)
    for j in range(W.shape[0]):
        acc = acc + cov[:, j:j + 1] * W[:, j]
    return acc


def sparse_lists(W, cap=None):
    """Each row's nonzero (column, value) pairs, ascending, capped at
    ``cap`` (default the kernel's) and padded with (0, +0) to the
    longest list, as the kernel holds them."""
    n = W.shape[0]
    nnz = (W != 0).sum(dim=1)
    K = min(int(nnz.max()), cap or CAP)
    cols = torch.zeros((n, K), dtype=torch.long)
    vals = torch.zeros((n, K), dtype=torch.float32)
    for p in range(n):
        nz = torch.nonzero(W[p] != 0).flatten()[:K]
        cols[p, :len(nz)] = nz
        vals[p, :len(nz)] = W[p, nz]
    return cols, vals


def sparse_fold(cols, vals, cov):
    """The kernel's sparse fold: the same left fold over the lists."""
    acc = torch.zeros_like(cov)
    for k in range(cols.shape[1]):
        acc = acc + cov[:, cols[:, k]] * vals[:, k]
    return acc


def pick(key, need_row, taken):
    """The kernel's argmin: with reissue priorities, one reduction over the
    untaken needed rows' keys decides the restriction; then the least key
    and the least row holding it."""
    B, n = key.shape
    rows = torch.arange(n)
    if need_row is not None:
        pref = (need_row > 0) & ~taken
        m = torch.where(pref, key, KEY_FLT_MAX).amin(dim=-1, keepdim=True)
        has = (m != 0) & (m < KEY_FLT_MAX)
        key = torch.where(has & ~pref, KEY_FLT_MAX, key)
    m = key.amin(dim=-1, keepdim=True)
    return torch.where(key == m, rows, n).amin(dim=-1)


def emulate_kernel(W, order, epick, need_row=None):
    """The kernel's pick loop in torch: returns worker_of_row (B, n) int32
    and which trials took the dense fold at least once."""
    B, n = order.shape
    cols, vals = sparse_lists(W)
    sparse_ok = n <= 32 and int((W != 0).sum(dim=1).max()) <= CAP
    rows = torch.arange(n)
    cov = torch.zeros((B, n), dtype=torch.float32)
    taken = torch.zeros((B, n), dtype=torch.bool)
    wout = torch.zeros((B, n), dtype=torch.int32)
    finite = torch.ones(B, dtype=torch.bool)
    dense_used = torch.zeros(B, dtype=torch.bool)
    for t in range(n):
        sparse = finite & sparse_ok
        dense_used |= ~sparse
        score = torch.where(sparse[:, None], sparse_fold(cols, vals, cov),
                            dense_fold(W, cov))
        key = torch.where(taken, KEY_FLT_MAX, key_of(score))
        p = pick(key, need_row, taken)
        hit = rows == p[:, None]
        wout = torch.where(hit, order[:, t:t + 1], wout)
        taken |= hit
        if t + 1 < n:
            cov = cov + W[p] / epick[:, t:t + 1]
            finite = torch.isfinite(cov).all(dim=-1)
    return wout, dense_used


def schedule(kind, n):
    """A TO matrix of the repo's schemes at n workers (ragged: CS with
    loads cycling 1..r)."""
    r = min(n, 8 if n > 64 else 3)
    if kind == "cs":
        return cyclic_to_matrix(n, r)
    if kind == "ss":
        return staircase_to_matrix(n, r)
    if kind == "ra":
        return random_assignment_to_matrix(n, seed=n)
    return cyclic_to_matrix(n, r, loads=[1 + i % r for i in range(n)])


def inputs(kind, n, B, est="random", seed=0, need=False):
    """(W, order, epick, need_row) as ``greedy_row_assignment_batch`` builds
    them, from numpy draws: estimates random, all equal (ties) or with
    +inf entries."""
    gen = np.random.default_rng(seed + n)
    C = schedule(kind, n)
    W, A = _greedy_matrices(tuple(map(tuple, C.tolist())), 0.5)
    e = (np.full((B, n), 0.25, np.float32) if est == "ties"
         else gen.uniform(0.01, 1.0, (B, n)).astype(np.float32))
    if est == "infs":
        e[gen.random((B, n)) < 0.2] = np.inf
    e = torch.as_tensor(e)
    order = torch.argsort(e, dim=-1, stable=True)
    epick = torch.clamp(torch.take_along_dim(e, order, dim=-1), min=1e-30)
    need_row = None
    if need:
        nd = torch.as_tensor(gen.random((B, n)) < 0.3)
        need_row = (nd[:, None, :] & torch.as_tensor(A > 0)[None]).sum(-1)
        need_row = need_row.float()
    return torch.as_tensor(W), order.to(torch.int32), epick, need_row


def bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("kind", ["cs", "ss", "ra", "ragged"])
@pytest.mark.parametrize("n", [1, 12, 15, 16, 33, 128])
@pytest.mark.parametrize("est", ["random", "ties", "infs"])
def test_sparse_fold_equals_dense_while_cov_is_finite(kind, n, est):
    """(a) Along the plain version's own picks, every score of the sparse
    fold equals the dense fold's bit for bit (lists uncapped here, so RA's
    full rows count too; the cap only sends a launch to the dense fold)."""
    W, order, epick, _ = inputs(kind, n, 6, est)
    cols, vals = sparse_lists(W, cap=n)
    cov = torch.zeros((6, n), dtype=torch.float32)
    taken = torch.zeros((6, n), dtype=torch.bool)
    for t in range(n):
        assert torch.isfinite(cov).all()
        dense = dense_fold(W, cov)
        assert torch.equal(bits(sparse_fold(cols, vals, cov)), bits(dense))
        p = torch.argmin(torch.where(taken, BIG, dense), dim=-1)
        taken |= torch.arange(n) == p[:, None]
        cov = cov + W[p] / epick[:, t:t + 1]


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_folds_part_where_a_cov_entry_is_not_finite(bad):
    """(b) A non-finite cov[j] makes the dense fold NaN in every row that
    does not cover task j; the sparse fold skips that term.  This is why
    the kernel folds densely while any entry is non-finite."""
    W = torch.as_tensor(_greedy_matrices(
        tuple(map(tuple, cyclic_to_matrix(12, 3).tolist())), 0.5)[0])
    gen = np.random.default_rng(3)
    cov = torch.as_tensor(gen.uniform(0.0, 5.0, (1, 12)), dtype=torch.float32)
    cov[0, 4] = bad
    cols, vals = sparse_lists(W)
    dense, sparse = dense_fold(W, cov)[0], sparse_fold(cols, vals, cov)[0]
    skips = W[:, 4] == 0
    assert skips.any() and torch.isnan(dense[skips]).all()
    assert torch.isfinite(sparse[skips]).all()
    assert torch.equal(bits(sparse[~skips]), bits(dense[~skips]))


def before(a, ia, b, ib):
    """The order the kernel's argmin keeps (its earlier before()): NaN
    first, then the float order, ties to the lower row."""
    na, nb = np.isnan(a), np.isnan(b)
    if na != nb:
        return bool(na)
    if not na and a != b:
        return a < b
    return ia < ib


def test_key_orders_like_before():
    """(c) (key, row) in lexicographic order is before()'s order: every
    NaN first, -0 equal to +0, +-inf, FLT_MAX and subnormals in place,
    ties to the lower row."""
    tiny = np.float32(1e-45)
    vals = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, BIG, -BIG,
                     tiny, -tiny, 1.0, -1.0, 1.0, 2.5, -2.5, np.nan,
                     np.float32(1.1754942e-38), 3.0e38, 0.0],
                    dtype=np.float32)
    nan_bits = np.array([0x7fc00001, 0xffc00000, 0x7f800001],
                        dtype=np.uint32).view(np.float32)
    vals = np.concatenate([vals, nan_bits])
    keys = key_of(torch.as_tensor(vals)).tolist()
    for i in range(len(vals)):
        for j in range(len(vals)):
            if i != j:
                assert ((keys[i], i) < (keys[j], j)) == before(
                    vals[i], i, vals[j], j), (vals[i], vals[j])
    assert key_of(torch.tensor([BIG])).item() == KEY_FLT_MAX
    found = re.findall(r"kKeyFltMax = (0x[0-9a-f]+)u", SOURCE.read_text())
    assert found == [hex(KEY_FLT_MAX)]


@pytest.mark.parametrize("seed", range(4))
def test_two_reductions_are_torch_argmin(seed):
    """(c) The least key, then the least row holding it, is torch.argmin
    on rows with NaNs, signed zeros, infinities and many ties."""
    gen = np.random.default_rng(seed)
    pool = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, BIG, 1.0, -1.0,
                     0.5], dtype=np.float32)
    x = torch.as_tensor(pool[gen.integers(0, len(pool), (500, 9))])
    x[::7] = torch.as_tensor(gen.standard_normal((72, 9)),
                             dtype=torch.float32)
    taken = torch.zeros(x.shape, dtype=torch.bool)
    assert torch.equal(pick(key_of(x), None, taken), torch.argmin(x, dim=-1))


#: the card tests' cases: direct calls with NaN or zero estimates, W whose
#: coverage overflows, a row denser than the register cap
CASES = ["plain", "need", "ties", "infs", "nan_epick", "zero_epick",
         "huge_w", "huge_w_need", "dense_row"]


def case_inputs(n, B, case, seed=0):
    kind = "cs"
    W, order, epick, need_row = inputs(
        kind, n, B, "ties" if case == "ties" else
        "infs" if case == "infs" else "random", seed,
        need=case in ("need", "huge_w_need"))
    gen = np.random.default_rng(seed + 7)
    if case == "nan_epick":
        epick = torch.where(torch.as_tensor(gen.random((B, n)) < 0.2),
                            float("nan"), epick)
    elif case == "zero_epick":
        epick = torch.where(torch.as_tensor(gen.random((B, n)) < 0.2),
                            0.0, epick)
    elif case.startswith("huge_w"):
        W = W * 1e38
    elif case == "dense_row":
        W = W.clone()
        W[0] = 0.25
    return W, order, epick, need_row


@pytest.mark.parametrize("n", [1, 12, 16, 17, 20, 32, 33, 70])
@pytest.mark.parametrize("case", CASES)
def test_emulated_kernel_equals_plain(n, case):
    """(d) The emulated pick loop gives the plain version's output on every
    case, and folds densely where the card tests expect the kernel's count
    to say so: every trial past n = 32 or where a row is over the cap
    (n = 16 is at it, 17 past it), some where the coverage goes
    non-finite, none otherwise."""
    B = 40
    W, order, epick, need_row = case_inputs(n, B, case, seed=n)
    got, dense_used = emulate_kernel(W, order, epick, need_row)
    want = ref.greedy_assign_ref(W, order, epick, need_row)
    assert torch.equal(got, want)
    if n > 32 or (case == "dense_row" and n > CAP):
        assert dense_used.all()
    elif case in ("nan_epick", "zero_epick", "huge_w", "huge_w_need") and n > 1:
        assert dense_used.any()
    elif case in ("plain", "need", "ties", "infs", "dense_row"):
        assert not dense_used.any()


def test_sparse_only_would_part_from_plain():
    """Without the dense fallback the picks part from the plain version
    once the coverage overflows (W scaled by 1e38): the fallback is needed,
    not only safe."""
    W, order, epick, _ = case_inputs(12, 200, "huge_w", seed=1)
    cols, vals = sparse_lists(W)
    B, n = order.shape
    cov = torch.zeros((B, n), dtype=torch.float32)
    taken = torch.zeros((B, n), dtype=torch.bool)
    wout = torch.zeros((B, n), dtype=torch.int32)
    rows = torch.arange(n)
    for t in range(n):
        key = torch.where(taken, KEY_FLT_MAX,
                          key_of(sparse_fold(cols, vals, cov)))
        p = pick(key, None, taken)
        hit = rows == p[:, None]
        wout = torch.where(hit, order[:, t:t + 1], wout)
        taken |= hit
        cov = cov + W[p] / epick[:, t:t + 1]
    assert not torch.equal(wout, ref.greedy_assign_ref(W, order, epick))


# ---- the wide route (n > 128): one block a trial, a packed argmin ----------

def pick_packed(key, need_row, taken):
    """The wide route's argmin: each row's (key << 32 | row) as an unsigned
    64-bit integer; the least over every row, and with reissue priorities
    the least over the untaken needed rows, taken where its key is neither
    0 (a NaN) nor at or above FLT_MAX's (an empty set's all-ones value is
    past both).  The kernel reduces per lane, per warp and over the warps;
    min is associative and commutative, so one min over the row stands for
    any split."""
    k = key.numpy().astype(np.uint64)
    n = k.shape[-1]
    packed = (k << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    best = packed.min(axis=-1)
    if need_row is not None:
        pref = ((need_row > 0) & ~taken).numpy()
        best_need = np.where(pref, packed,
                             np.uint64(0xffffffffffffffff)).min(axis=-1)
        m = best_need >> np.uint64(32)
        best = np.where((m != 0) & (m < KEY_FLT_MAX), best_need, best)
    return torch.as_tensor((best & np.uint64(0xffffffff)).astype(np.int64))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("with_need", [False, True])
def test_packed_min_is_the_warp_routes_pick(seed, with_need):
    """The wide route's packed argmin picks the warp route's row (and so
    torch.argmin's and the plain version's) on rows with NaNs, signed
    zeros, infinities, FLT_MAX, many ties, taken rows and needed rows."""
    gen = np.random.default_rng(seed)
    pool = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, BIG, 1.0, -1.0,
                     0.5], dtype=np.float32)
    x = torch.as_tensor(pool[gen.integers(0, len(pool), (600, 11))])
    x[::5] = torch.as_tensor(gen.standard_normal((120, 11)),
                             dtype=torch.float32)
    taken = torch.as_tensor(gen.random((600, 11)) < 0.3)
    need_row = (torch.as_tensor(gen.integers(0, 3, (600, 11)),
                                dtype=torch.float32) if with_need else None)
    key = torch.where(taken, KEY_FLT_MAX, key_of(x))
    assert torch.equal(pick_packed(key, need_row, taken),
                       pick(key, need_row, taken))


def emulate_wide(W, order, epick, need_row=None):
    """The wide route's pick loop in torch: the dense fold of every row,
    the packed argmin, the update skipped after the last pick."""
    B, n = order.shape
    rows = torch.arange(n)
    cov = torch.zeros((B, n), dtype=torch.float32)
    taken = torch.zeros((B, n), dtype=torch.bool)
    wout = torch.zeros((B, n), dtype=torch.int32)
    for t in range(n):
        key = torch.where(taken, KEY_FLT_MAX, key_of(dense_fold(W, cov)))
        p = pick_packed(key, need_row, taken)
        hit = rows == p[:, None]
        wout = torch.where(hit, order[:, t:t + 1], wout)
        taken |= hit
        if t + 1 < n:
            cov = cov + W[p] / epick[:, t:t + 1]
    return wout


@pytest.mark.parametrize("case", CASES)
def test_emulated_wide_route_equals_plain(case):
    """The wide route's loop at n = 130 gives the plain version's output on
    every case the card tests send it."""
    W, order, epick, need_row = case_inputs(130, 6, case, seed=130)
    assert torch.equal(emulate_wide(W, order, epick, need_row),
                       ref.greedy_assign_ref(W, order, epick, need_row))
