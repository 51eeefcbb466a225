"""gram_plan, the tile plan of the one-pass gram_matvec kernel
(csrc/gram_matvec_onepass.cu): every tile fits its shared-memory budget,
the plan covers every row and column exactly once, the paper's DGD shape
and (4, 300, 200) take one column block, and only a column that no cluster
can hold goes to the two-pass kernel, at the d gram_onepass_max_d names;
the plan's layout constants are the kernel source's.  Then the plain
version at the plan's edge shapes (b = 1, b = 53, d = 513) against the JAX
package's oracle and its Pallas kernel in interpret mode, at the
tolerances of tests/test_kernels.py (rel 1e-5 in float32, 3e-2 in bfloat16)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

from torch_parity import rel_err
from torch_parity import one_thread  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = [torch.float32, torch.bfloat16]
ITEM = {torch.float32: 4, torch.bfloat16: 2}

# the smoke and card-test shapes, ragged rows and columns, b = 1, a task
# wider than any tile, d at and past the one-pass limit
PLAN_SHAPES = [(15, 400, 60), (4, 300, 200), (4, 37, 53), (2, 8, 1),
               (1, 512, 64), (3, 100, 300), (3, 2000, 300), (8, 3000, 700),
               (64, 4096, 1024), (1, 513, 1), (1, 17, 7), (1, 3, 100000),
               (2, 1000, 53), (5, 91296, 4), (1, 91297, 4), (2, 60000, 32),
               (1, 200000, 64)]


@pytest.mark.parametrize("n,d,b", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_and_covers_each_element_once(n, d, b, dtype):
    plan = ops.gram_plan(n, d, b, dtype)
    item, q = ITEM[dtype], 16 // ITEM[dtype]
    if plan.route == "twopass":
        # not even a tile 16 bytes wide over 8 CTAs fits a CTA's memory
        R = -(-d // ops.GRAM_MAX_CLUSTER)
        assert ops._gram_smem(R, min(b, q), item) > ops.GRAM_SMEM_LIMIT
        assert plan == ops.GramPlan("twopass", 0, 0, 0, 0, 0)
        return
    assert plan.route == "onepass"
    assert 1 <= plan.c <= ops.GRAM_MAX_CLUSTER
    assert plan.smem == ops._gram_smem(plan.R, plan.C, item)
    assert plan.smem <= ops.GRAM_SMEM_LIMIT
    rows = ops._gram_tile_rows(plan.R)
    # 4 boxes of <= 256 rows per 1 024 rows, each at most 7 rows past R
    assert plan.R <= rows < plan.R + 32 * -(-plan.R // 1024)
    if plan.C > min(b, q):          # wider than the narrowest: within budget
        assert rows * plan.C <= ops.GRAM_TILE_ELEMS
    rows = np.zeros(d, np.int64)
    for rank in range(plan.c):
        lo, hi = rank * plan.R, min((rank + 1) * plan.R, d)
        assert lo < hi, f"CTA {rank} holds no rows"
        rows[lo:hi] += 1
    assert (rows == 1).all()
    assert 1 <= plan.C <= b and plan.nbc == -(-b // plan.C)
    assert plan.nbc <= 65535
    cols = np.zeros(b, np.int64)
    for jb in range(plan.nbc):
        cols[jb * plan.C:min((jb + 1) * plan.C, b)] += 1
    assert (cols == 1).all()
    if plan.nbc > 1:
        # column blocks start on 16-byte boundaries and fit a TMA box
        assert plan.C * item % 16 == 0 and plan.C <= ops.GRAM_MAX_BOX


@pytest.mark.parametrize("n,d,b", [(15, 400, 60), (4, 300, 200)])
def test_a_cluster_holds_the_dgd_shapes_whole(n, d, b):
    """One column block: the one-pass kernel writes y in one launch."""
    plan = ops.gram_plan(n, d, b, torch.float32)
    assert plan.route == "onepass" and plan.nbc == 1 and plan.C == b


@pytest.mark.parametrize("n,d,b", [(3, 2000, 300), (8, 3000, 700),
                                   (64, 4096, 1024)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_tasks_take_column_blocks(n, d, b, dtype):
    """Tasks wider than a tile take several blocks, whose float32 partials
    add at most ~6 % to X's bytes at the large shape."""
    plan = ops.gram_plan(n, d, b, dtype)
    assert plan.route == "onepass" and plan.nbc > 1
    if (n, d, b) == (64, 4096, 1024):
        assert 2 * n * plan.nbc * d * 4 <= 0.06 * n * d * b * ITEM[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_pass_only_past_the_one_pass_limit(dtype):
    """The route changes once, at the d where a tile of 8 CTAs 16 bytes
    wide no longer fits, whatever n and b (at least 16 bytes) are."""
    item, q = ITEM[dtype], 16 // ITEM[dtype]
    d = ops.gram_onepass_max_d(q, dtype)
    assert ops._gram_smem(-(-d // 8), q, item) <= ops.GRAM_SMEM_LIMIT
    assert ops._gram_smem(-(-(d + 1) // 8), q, item) > ops.GRAM_SMEM_LIMIT
    for n, b in [(1, q), (3, 2 * q), (2, 53), (1, 1024)]:
        assert ops.gram_plan(n, d, b, dtype).route == "onepass"
        assert ops.gram_plan(n, d + 1, b, dtype).route == "twopass"
        assert ops.gram_plan(n, 2 * d, b, dtype).route == "twopass"
    for d_small in (1, 37, 400, 4096, d // 2):
        assert ops.gram_plan(1, d_small, 64, dtype).route == "onepass"


def test_plan_rejects_other_dtypes():
    with pytest.raises(TypeError):
        ops.gram_plan(1, 8, 4, torch.float64)


def _inputs(n, d, b, dtype, seed=0):
    gen = np.random.default_rng(seed + 7 * d + b)
    Xs = gen.standard_normal((n, d, b), dtype=np.float32)
    th = gen.standard_normal(d, dtype=np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    return ((torch.as_tensor(Xs).to(tdt), torch.as_tensor(th).to(tdt)),
            (jnp.asarray(Xs).astype(jdt), jnp.asarray(th).astype(jdt)))


@pytest.mark.parametrize("d,b", [(513, 1), (100, 1), (513, 53), (200, 53),
                                 (513, 37), (513, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_oracle_at_edge_shapes(d, b, dtype):
    (Xs, th), (Xj, thj) = _inputs(1, d, b, dtype)
    got = ref.gram_matvec_ref(Xs[0], th)
    assert got.dtype == Xs.dtype and got.shape == (d,)
    assert rel_err(got.float(), np.asarray(jref.gram_matvec_ref(
        Xj[0], thj), np.float32)) < TOL[dtype]
    assert torch.equal(ops.gram_matvec(Xs[0], th), got)   # CPU: plain


@pytest.mark.parametrize("n,d,b", [(3, 513, 1), (2, 513, 53), (1, 300, 37)])
def test_plain_matches_pallas_interpret_at_edge_shapes(n, d, b):
    (Xs, th), (Xj, thj) = _inputs(n, d, b, "float32")
    got = ops.batched_gram_matvec(Xs, th)
    assert got.shape == (n, d)
    want = jops.batched_gram_matvec(Xj, thj, interpret=True)
    assert rel_err(got, want) < TOL["float32"]


SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "gram_matvec_onepass.cu")


@pytest.mark.parametrize("name,mirror", [
    ("kThreads", "GRAM_THREADS"), ("kStages", "GRAM_STAGES"),
    ("kMaxCluster", "GRAM_MAX_CLUSTER"), ("kHeader", "GRAM_HEADER"),
    ("kMaxBox", "GRAM_MAX_BOX"), ("kSmemLimit", "GRAM_SMEM_LIMIT")])
def test_plan_constants_are_the_kernels(name, mirror):
    """gram_plan's layout constants are the kernel source's own."""
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert found == [str(getattr(ops, mirror))]


def test_one_pass_limit_is_where_the_route_changes():
    """gram_onepass_max_d is the last d of the one-pass route at each
    width; the narrower the column, the taller the task it holds."""
    for dtype in DTYPES:
        last = None
        for b in (1, 2, 4, 8, 64):
            d = ops.gram_onepass_max_d(b, dtype)
            assert ops.gram_plan(1, d, b, dtype).route == "onepass"
            assert ops.gram_plan(1, d + 1, b, dtype).route == "twopass"
            assert last is None or d <= last
            last = d
