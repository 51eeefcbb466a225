"""PC / PCMM codec: the port's float64 torch against the JAX package's
numpy.  Encode and worker compute agree within rel 1e-12.  Decode is a
least-squares solve, and two backward-stable solvers (numpy's LAPACK and
torch's) differ by up to about cond(A) * eps: decodes agree within rel
1e-12 where the system is well conditioned, and within 10 * cond(A) * eps
otherwise, and both stay that close to the exact X^T X theta.  (At n = 15
the raster-order PCMM decode of the reference itself is off by orders of
magnitude; see ROADMAP.md §3.)"""
import numpy as np
import pytest
import torch

from repro.core import coded as jc
from repro.core import delays as jd
from repro_torch.core import coded as tc
from repro_torch.core import delays as td

from torch_parity import np_of, rel_err, z_scores
from torch_parity import one_thread  # noqa: F401

SIZES = [(6, 2, 20, 8), (5, 3, 12, 5), (4, 4, 9, 3)]


def _data(n, d, b, seed=0):
    gen = np.random.default_rng(seed)
    return gen.standard_normal((n, d, b)), gen.standard_normal(d)


def _decode_tol(A) -> float:
    return max(1e-12, 10 * np.linalg.cond(A) * np.finfo(np.float64).eps)


def _exact(X, th):
    Xf = np.concatenate(list(X), axis=1)
    return Xf @ (Xf.T @ th)


@pytest.mark.parametrize("n,r,d,b", SIZES)
def test_thresholds_equal(n, r, d, b):
    assert tc.pc_threshold(n, r) == jc.pc_threshold(n, r)
    assert tc.pcmm_threshold(n) == jc.pcmm_threshold(n)


@pytest.mark.parametrize("n,r,d,b", SIZES)
@pytest.mark.parametrize("subset", ["first", "last", "random"])
def test_pc_matches_numpy(n, r, d, b, subset):
    X, th = _data(n, d, b)
    Xt_j, al_j, gi_j = jc.pc_encode(X, r)
    Xt_t, al_t, gi_t = tc.pc_encode(torch.as_tensor(X), r)
    assert rel_err(Xt_t, Xt_j) < 1e-12
    np.testing.assert_array_equal(al_t, al_j)
    np.testing.assert_array_equal(gi_t, gi_j)
    res_j = np.stack([jc.pc_worker_compute(Xt_j[i], th) for i in range(n)])
    res_t = tc.pc_worker_compute(Xt_t, torch.as_tensor(th))
    assert rel_err(res_t, res_j) < 1e-12
    kth = jc.pc_threshold(n, r)
    order = {"first": np.arange(kth), "last": np.arange(n)[-kth:],
             "random": np.random.default_rng(n).permutation(n)[:kth]}[subset]
    dec_j = jc.pc_decode(res_j[order], al_j[order], n, r)
    dec_t = tc.pc_decode(res_t[torch.as_tensor(order)], al_t[order], n, r)
    tol = _decode_tol(np.vander(al_j[order], kth, increasing=True))
    assert rel_err(dec_t, dec_j) < tol
    assert rel_err(dec_t, _exact(X, th)) < tol


@pytest.mark.parametrize("n,r,d,b", SIZES)
@pytest.mark.parametrize("subset", ["first", "last", "random"])
def test_pcmm_matches_numpy(n, r, d, b, subset):
    X, th = _data(n, d, b, seed=1)
    Xh_j, be_j = jc.pcmm_encode(X, r)
    Xh_t, be_t = tc.pcmm_encode(torch.as_tensor(X), r)
    assert rel_err(Xh_t, Xh_j) < 1e-12
    np.testing.assert_array_equal(be_t, be_j)
    res_j = np.stack([jc.pcmm_worker_compute(Xh_j[i, j], th)
                      for i in range(n) for j in range(r)])
    res_t = tc.pcmm_worker_compute(Xh_t.reshape(n * r, d, b),
                                   torch.as_tensor(th))
    assert rel_err(res_t, res_j) < 1e-12
    need = jc.pcmm_threshold(n)
    order = {"first": np.arange(need), "last": np.arange(n * r)[-need:],
             "random": np.random.default_rng(n).permutation(n * r)[:need]
             }[subset]
    pts = be_j.reshape(-1)[order]
    dec_j = jc.pcmm_decode(res_j[order], pts, n)
    dec_t = tc.pcmm_decode(res_t[torch.as_tensor(order)], pts, n)
    lo, hi = min(pts.min(), 1.0) - 1e-9, max(pts.max(), float(n)) + 1e-9
    tol = _decode_tol(np.polynomial.chebyshev.chebvander(
        (2 * pts - (lo + hi)) / (hi - lo), need - 1))
    assert rel_err(dec_t, dec_j) < tol
    assert rel_err(dec_t, _exact(X, th)) < tol


def test_decode_needs_enough_results():
    with pytest.raises(ValueError):
        tc.pc_decode(torch.zeros(2, 3, dtype=torch.float64), [1.0, 2.0], 6, 2)
    with pytest.raises(ValueError):
        tc.pcmm_decode(torch.zeros(3, 3, dtype=torch.float64), [1, 2, 3], 4)
    with pytest.raises(ValueError):
        tc.simulate_pcmm_completion(td.scenario1(), 6, 1, trials=4,
                                    devices="cpu")


@pytest.mark.parametrize("which", ["pc", "pcmm"])
def test_coded_completion_matches_jax(which):
    """The coded completion times through the port's engine against the
    JAX package's, 20 000 trials, within 4 combined standard errors."""
    n, r, trials = 8, 2, 20000
    fj = getattr(jc, f"simulate_{which}_completion")
    ft = getattr(tc, f"simulate_{which}_completion")
    a = np_of(fj(jd.scenario1(), n, r, trials=trials)).astype(np.float64)
    b = np_of(ft(td.scenario1(), n, r, trials=trials,
                 devices="cpu")).astype(np.float64)
    assert a.shape == b.shape == (trials,)
    z = z_scores(a.mean(), a.std() / np.sqrt(trials),
                 b.mean(), b.std() / np.sqrt(trials))
    assert z < 4, z
