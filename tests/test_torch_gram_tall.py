"""gram_tall_plan, the plan of the split-d two-pass gram_matvec kernel
(csrc/gram_matvec.cu) for tasks past the one-pass limit: its slabs cover
each row once and its column blocks each column once, it depends on the
shape and dtype alone, every index fits the kernel's types, the partials a
task folds stay within the kernel's cap, and its layout constants are the
kernel source's.  Then the plain version at d just past the one-pass limit
against the JAX package's oracle (its plain ``gram_matvec_ref``: Pallas
interpret mode is too slow at this height), and the plan's own order of
sums (slab partials folded in slab order, then X u) against the same
oracle, at the tolerances of tests/test_kernels.py (rel 1e-5 in float32,
3e-2 in bfloat16)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

from torch_parity import rel_err
from torch_parity import one_thread  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = [torch.float32, torch.bfloat16]
ITEM = {torch.float32: 4, torch.bfloat16: 2}

# tasks past the one-pass limit at the widths the smoke and the card tests
# send (b = 1, 3, 8, 256, several tasks), a width past a block of threads,
# one so wide the fold's cap leaves one slab, and the one-pass shapes where
# the smoke times this kernel too
TALL_SHAPES = [(1, 90113, 8), (15, 90113, 8), (1, 87617, 8), (1, 226977, 1),
               (1, 112289, 3), (1, 100000, 256), (1, 91297, 4),
               (2, 91112, 64), (1, 100000, 1500), (3, 95000, 40000),
               (15, 400, 60), (4, 37, 53), (8, 3000, 700), (64, 4096, 1024),
               (65535, 100, 2), (1, 1, 1)]


def _cdiv(a, m):
    return -(-a // m)


@pytest.mark.parametrize("n,d,b", TALL_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tall_plan_covers_each_element_once(n, d, b, dtype):
    p = ops.gram_tall_plan(n, d, b, dtype)
    item = ITEM[dtype]
    # vectors of 16 bytes where b is a multiple of that, else elements
    assert p.vec in (1, 16 // item) and b % p.vec == 0
    assert p.vec > 1 or b % (16 // item)
    Q = b // p.vec
    # column blocks: whole threads' worth, each column once
    assert 1 <= p.qb <= min(Q, ops.TALL_THREADS)
    cols = np.zeros(Q, np.int64)
    for cb in range(p.ncb):
        lo, hi = cb * p.qb, min((cb + 1) * p.qb, Q)
        assert lo < hi, f"column block {cb} holds no columns"
        cols[lo:hi] += 1
    assert (cols == 1).all()
    # the slabs of both passes: each row once, none empty
    for rows, s in ((p.rows1, p.s1), (p.rows2, p.s2)):
        assert rows >= 1 and s == _cdiv(d, rows)
        seen = np.zeros(d, np.int64)
        for k in range(s):
            lo, hi = k * rows, min((k + 1) * rows, d)
            assert lo < hi, f"slab {k} holds no rows"
            seen[lo:hi] += 1
        assert (seen == 1).all()
    # a pass-2 CTA folds at most TALL_FOLD_MAX partials
    assert p.s1 == 1 or p.s1 * b <= ops.TALL_FOLD_MAX
    # pass 2: a power of two of threads a row, at most a warp
    assert p.tr in (1, 2, 4, 8, 16, 32) and (p.tr == 1) == (Q <= 4)


@pytest.mark.parametrize("n,d,b", TALL_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tall_plan_indices_fit_the_kernels_types(n, d, b, dtype):
    """Grid sizes and row offsets are int in the kernel, element offsets
    size_t; a grid has at most 65 535 rows of tasks."""
    p = ops.gram_tall_plan(n, d, b, dtype)
    assert n <= 65535
    assert p.s1 * p.ncb < 2 ** 31 and p.s2 < 2 ** 31
    assert p.s1 * p.rows1 < 2 ** 31 and p.s2 * p.rows2 < 2 ** 31
    assert p.ncb * p.qb * p.vec < 2 ** 31
    assert ops.TALL_THREADS // p.qb >= 1


@pytest.mark.parametrize("n,d,b", [(1, 90113, 8), (15, 90113, 8),
                                   (1, 100000, 256)])
def test_tall_plan_depends_on_the_shape_alone(n, d, b):
    """The plan is a function of (n, d, b, dtype): the same from a cold
    cache, and the slab counts aim at TALL_ITEMS CTAs whatever the card (no
    query of the device).  At the dgd-tall shapes a pass runs at least as
    many CTAs as a 132-SM card has SMs."""
    p = ops.gram_tall_plan(n, d, b, torch.float32)
    assert ops.gram_tall_plan.__wrapped__(n, d, b, torch.float32) == p
    assert n * p.s1 * p.ncb >= 132 and n * p.s2 >= 132
    assert n * p.s1 * p.ncb <= 2 * ops.TALL_ITEMS
    assert n * p.s2 <= 2 * ops.TALL_ITEMS


def test_tall_plan_rejects_other_dtypes():
    with pytest.raises(TypeError):
        ops.gram_tall_plan(1, 8, 4, torch.float64)


SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "gram_matvec.cu")


@pytest.mark.parametrize("name,mirror", [
    ("kThreads", "TALL_THREADS"), ("kFoldMax", "TALL_FOLD_MAX")])
def test_tall_plan_constants_are_the_kernels(name, mirror):
    """gram_tall_plan's layout constants are the kernel source's own."""
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert found == [str(getattr(ops, mirror))]


def _inputs(n, d, b, dtype, seed=0):
    gen = np.random.default_rng(seed + 11 * d + b)
    Xs = gen.standard_normal((n, d, b), dtype=np.float32)
    th = gen.standard_normal(d, dtype=np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    return ((torch.as_tensor(Xs).to(tdt), torch.as_tensor(th).to(tdt)),
            (jnp.asarray(Xs).astype(jdt), jnp.asarray(th).astype(jdt)))


def _past_limit(b, dtype):
    return ops.gram_onepass_max_d(b, getattr(torch, dtype)) + 1


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_oracle_past_the_one_pass_limit(b, dtype):
    d = _past_limit(b, dtype)
    (Xs, th), (Xj, thj) = _inputs(1, d, b, dtype)
    got = ops.batched_gram_matvec(Xs, th)            # CPU: the plain version
    assert got.dtype == Xs.dtype and got.shape == (1, d)
    assert torch.equal(got, ref.batched_gram_matvec_ref(Xs, th))
    want = jax.vmap(jref.gram_matvec_ref, in_axes=(0, None))(Xj, thj)
    assert rel_err(got.float(), np.asarray(want, np.float32)) < TOL[dtype]


def _plan_order(Xs, th, p):
    """h in the plan's order of sums, in float32: per-slab partials of
    u = X^T theta over each column block, folded in slab order, then X u
    over pass 2's slabs (the kernel's association within a slab is its own;
    this checks what the plan covers)."""
    n, d, b = Xs.shape
    X, t = Xs.float(), th.float()
    cols = p.qb * p.vec
    part = torch.zeros(n, p.s1, b)
    for s in range(p.s1):
        rows = slice(s * p.rows1, min(d, (s + 1) * p.rows1))
        for cb in range(p.ncb):
            c = slice(cb * cols, min(b, (cb + 1) * cols))
            part[:, s, c] = torch.einsum("ndb,d->nb", X[:, rows, c], t[rows])
    u = part[:, 0]
    for s in range(1, p.s1):
        u = u + part[:, s]
    y = torch.empty(n, d)
    for s in reversed(range(p.s2)):
        rows = slice(s * p.rows2, min(d, (s + 1) * p.rows2))
        y[:, rows] = torch.einsum("ndb,nb->nd", X[:, rows], u)
    return y.to(Xs.dtype)


@pytest.mark.parametrize("n,b", [(1, 8), (15, 8), (1, 1), (1, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_order_matches_jax_oracle_past_the_one_pass_limit(n, b, dtype):
    d = _past_limit(b, dtype)
    if b == 256:
        d = 2000          # narrowed column blocks, at a CPU size
    p = ops.gram_tall_plan(n, d, b, getattr(torch, dtype))
    assert p.s1 > 1 and p.s2 > 1
    (Xs, th), (Xj, thj) = _inputs(n, d, b, dtype, seed=1)
    got = _plan_order(Xs, th, p)
    want = jax.vmap(jref.gram_matvec_ref, in_axes=(0, None))(Xj, thj)
    assert rel_err(got.float(), np.asarray(want, np.float32)) < TOL[dtype]
