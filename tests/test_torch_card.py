"""The port on a CUDA card: the gram_matvec kernel against its plain
version (rel 1e-5 in float32, 3e-2 in bfloat16, the tolerances of
tests/test_kernels.py), its launch counter and input checks, and the
engine's per-trial samples on the card against its own CPU run.

Skipped without a card.  This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (completion_samples, cyclic_to_matrix, lb_spec,
                              pc_spec, scenario1, to_spec)
from repro_torch.kernels import ops, ref

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


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


@pytest.mark.parametrize("n,d,b", [(15, 400, 60), (4, 37, 53), (4, 300, 200),
                                   (1, 512, 64), (3, 100, 300), (2, 8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, n, d, b, dtype):
    Xs, th = _inputs(n, d, b, dtype, cuda)
    before = ops.LAUNCHES["gram_matvec"]
    got = ops.batched_gram_matvec(Xs, th)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gram_matvec"] == before + 1
    want = ref.batched_gram_matvec_ref(Xs, th)
    assert got.dtype == dtype and got.device == Xs.device
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert rel < TOL[dtype], rel


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
