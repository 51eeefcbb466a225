"""gram_matvec: the port's plain version against the JAX package's oracle at
the shapes and tolerances of tests/test_kernels.py (rel 1e-5 in float32,
3e-2 in bfloat16), the wrapper's CPU path and its input checks.  The CUDA
kernel is held against the plain version in tests/test_torch_card.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

from torch_parity import np_of, rel_err
from torch_parity import one_thread  # noqa: F401

SHAPES = [(64, 32), (128, 128), (300, 200), (100, 300), (512, 64), (37, 53)]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(d, b, dtype, n=None, seed=0):
    gen = np.random.default_rng(d * 1000 + b + seed)
    X = gen.standard_normal((d, b) if n is None else (n, d, b),
                            dtype=np.float32)
    th = gen.standard_normal(d, dtype=np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    return ((torch.as_tensor(X).to(tdt), torch.as_tensor(th).to(tdt)),
            (jnp.asarray(X).astype(jdt), jnp.asarray(th).astype(jdt)))


@pytest.mark.parametrize("d,b", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_oracle(d, b, dtype):
    (X, th), (Xj, thj) = _inputs(d, b, dtype)
    got = ref.gram_matvec_ref(X, th)
    want = jref.gram_matvec_ref(Xj, thj)
    assert got.dtype == X.dtype and got.shape == (d,)
    assert rel_err(got.float(), np.asarray(want, np.float32)) < TOL[dtype]
    assert torch.equal(ops.gram_matvec(X, th), got)   # CPU: the plain path


@pytest.mark.parametrize("d,b", [(37, 53), (300, 200)])
def test_wrapper_matches_pallas_interpret(d, b):
    (X, th), (Xj, thj) = _inputs(d, b, "float32")
    want = jops.gram_matvec(Xj, thj, interpret=True)
    assert rel_err(ops.gram_matvec(X, th), want) < TOL["float32"]


def test_batched_is_the_task_sum_of_eq48():
    """sum_i h(X_i) = X^T X theta (paper eq. 48), and the batched plain
    version equals the JAX package's batched wrapper."""
    n, d, b = 4, 96, 48
    (Xs, th), (Xsj, thj) = _inputs(d, b, "float32", n=n)
    hs = ops.batched_gram_matvec(Xs, th)
    assert hs.shape == (n, d)
    Xf = np.concatenate(list(np_of(Xs).astype(np.float64)), axis=1)
    want = Xf @ (Xf.T @ np_of(th).astype(np.float64))
    np.testing.assert_allclose(np_of(hs.sum(0)), want, rtol=1e-4, atol=1e-3)
    assert rel_err(hs, jops.batched_gram_matvec(Xsj, thj, interpret=True)
                   ) < TOL["float32"]


def test_cpu_path_launches_nothing():
    ops.reset_launch_counts()
    (Xs, th), _ = _inputs(20, 8, "float32", n=3)
    ops.batched_gram_matvec(Xs, th)
    assert ops.LAUNCHES["gram_matvec"] == 0


@pytest.mark.parametrize("make", [
    lambda: (torch.zeros(2, 4, 3, device="meta"), torch.zeros(4, device="meta")),
    lambda: (torch.zeros(2, 4, 3), torch.zeros(4, device="meta")),
])
def test_wrapper_rejects_non_cuda_devices(make):
    with pytest.raises(ValueError):
        ops.batched_gram_matvec(*make())


def test_gram_matvec_needs_a_matrix():
    with pytest.raises(ValueError):
        ops.gram_matvec(torch.zeros(2, 3, 4), torch.zeros(3))
