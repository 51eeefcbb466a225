"""Statistical models for per-task computation (T^(1)) and per-result
communication (T^(2)) delays (paper Sec. II and Sec. VI-C); counterpart of
``repro.core.delays``.

A model samples per trial: ``model.sample(seed, tids, n, r)`` returns
``(T1, T2)`` of shape ``(len(tids), n, r)`` in float32 on ``tids``'s device,
where trial ``t``'s draws are a pure function of ``(seed, t)`` through the
counter-based generator (``rng``), so they do not depend on chunking or on
the device.  The two frameworks draw different random numbers: parity with
the JAX models is by distribution, not by value.

Streams: truncated-Gaussian T1 draws use streams 0 (slots) and 1 (worker
effect), T2 streams 2 and 3; the straggler mask of
``BimodalStragglerDelays`` is stream 4; the other models use 0 for T1 and 1
for T2.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from . import rng

__all__ = [
    "DelayModel", "TruncatedGaussianDelays", "ShiftedExponentialDelays",
    "BimodalStragglerDelays", "EmpiricalDelays", "scenario1", "scenario2",
    "ec2_like",
]

_SQRT2 = math.sqrt(2.0)


def _truncnorm_std(seed, tids, stream, shape, a, b) -> torch.Tensor:
    """Standard normal truncated to ``[a, b]`` (tensors broadcastable to
    ``shape``), sampled as ``jax.random.truncated_normal`` does: a uniform on
    ``[erf(a/sqrt2), erf(b/sqrt2))``, then ``sqrt2 * erfinv``, clipped to
    the open interval's float32 neighbours of ``a`` and ``b``."""
    lo = torch.erf(a / _SQRT2)
    hi = torch.erf(b / _SQRT2)
    f = rng.uniform(seed, tids, stream, shape)
    u = torch.maximum(lo, f * (hi - lo) + lo)
    z = _SQRT2 * torch.erfinv(u)
    inf = torch.tensor(math.inf, dtype=z.dtype, device=z.device)
    return torch.clamp(z, torch.nextafter(a, inf), torch.nextafter(b, -inf))


@dataclasses.dataclass(frozen=True)
class DelayModel:
    """Base class.  Subclasses implement ``_sample(seed, tids, n, r)``."""

    def sample(self, seed: int, tids: torch.Tensor, n: int, r: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        T1, T2 = self._sample(seed, tids, n, r)
        want = (tids.shape[0], n, r)
        if tuple(T1.shape) != want or tuple(T2.shape) != want:
            raise RuntimeError(f"{type(self).__name__} sampled "
                               f"{tuple(T1.shape)}/{tuple(T2.shape)}, "
                               f"expected {want}")
        return T1, T2

    def _sample(self, seed, tids, n, r):  # pragma: no cover - abstract
        raise NotImplementedError

    def as_process(self):
        """This model as a round-stateful ``DelayProcess``."""
        from .cluster import IIDProcess
        return IIDProcess(self)


@dataclasses.dataclass(frozen=True)
class TruncatedGaussianDelays(DelayModel):
    """Paper Sec. VI-C (eq. 66): per-worker truncated Gaussian delays on
    [mu - a, mu + b].  ``mu1/mu2`` may be scalars or length-n vectors
    (scenario 2 uses per-worker means).  ``rho`` in [0, 1) makes slots at the
    same worker positively correlated via a shared worker effect."""
    mu1: tuple | float = 1e-4
    sigma1: float = 1e-4
    a1: float = 3e-5
    mu2: tuple | float = 5e-4
    sigma2: float = 2e-4
    a2: float = 2e-4
    b1: float | None = None  # defaults to a1 (symmetric, as in the paper)
    b2: float | None = None
    rho: float = 0.0

    def _one(self, seed, tids, stream, n, r, mu, sigma, a, b):
        dev = tids.device
        mu = torch.as_tensor(np.asarray(mu, np.float32), device=dev)
        mu = torch.broadcast_to(mu, (n,)).reshape(1, n, 1)
        sigma = torch.tensor(sigma, dtype=torch.float32, device=dev)
        b = a if b is None else b
        lo, hi = mu - a, mu + b
        if self.rho > 0.0:
            # worker-level effect + slot-level effect, equicorrelated rho
            m3 = torch.tensor(-3.0, device=dev)
            p3 = torch.tensor(3.0, device=dev)
            w = _truncnorm_std(seed, tids, stream + 1, (n, 1), m3, p3)
            e = _truncnorm_std(seed, tids, stream, (n, r), m3, p3)
            z = math.sqrt(self.rho) * w + math.sqrt(1 - self.rho) * e
        else:
            z = _truncnorm_std(seed, tids, stream, (n, r),
                               (lo - mu) / sigma, (hi - mu) / sigma)
        return torch.clamp(mu + sigma * z, lo, hi)

    def _sample(self, seed, tids, n, r):
        T1 = self._one(seed, tids, 0, n, r, self.mu1, self.sigma1, self.a1,
                       self.b1)
        T2 = self._one(seed, tids, 2, n, r, self.mu2, self.sigma2, self.a2,
                       self.b2)
        return T1, T2


@dataclasses.dataclass(frozen=True)
class ShiftedExponentialDelays(DelayModel):
    """Classic straggler model (Lee et al. [3]): T = shift + Exp(mean)."""
    shift1: float = 1e-4
    mean1: float = 5e-5
    shift2: float = 2e-4
    mean2: float = 1e-4

    def _sample(self, seed, tids, n, r):
        def expo(stream):
            return -torch.log1p(-rng.uniform(seed, tids, stream, (n, r)))
        T1 = self.shift1 + self.mean1 * expo(0)
        T2 = self.shift2 + self.mean2 * expo(1)
        return T1, T2


@dataclasses.dataclass(frozen=True)
class BimodalStragglerDelays(DelayModel):
    """Persistent-straggler model: with prob ``p_straggle`` a worker's entire
    row is slowed by factor ``slow`` for the round.  Base delays are
    truncated Gaussian."""
    base: TruncatedGaussianDelays = TruncatedGaussianDelays()
    p_straggle: float = 0.2
    slow: float = 5.0

    def _sample(self, seed, tids, n, r):
        T1, T2 = self.base._sample(seed, tids, n, r)
        mask = rng.uniform(seed, tids, 4, (n, 1)) < self.p_straggle
        f = torch.where(mask, float(self.slow), 1.0)
        return T1 * f, T2 * f


@dataclasses.dataclass(frozen=True)
class EmpiricalDelays(DelayModel):
    """Bootstrap-resample measured per-task delays.  ``samples1/2`` are
    arrays of shape (n_measured, n) — rows = measured rounds."""
    samples1: tuple = ()
    samples2: tuple = ()

    def _sample(self, seed, tids, n, r):
        dev = tids.device
        s1 = torch.as_tensor(np.asarray(self.samples1, np.float32), device=dev)
        s2 = torch.as_tensor(np.asarray(self.samples2, np.float32), device=dev)
        if s1.dim() != 2 or s1.shape[1] != n:
            raise ValueError(f"samples1 must be (rounds, n={n}); got "
                             f"{tuple(s1.shape)}")
        if s2.dim() != 2 or s2.shape[1] != n:
            raise ValueError(f"samples2 must be (rounds, n={n}); got "
                             f"{tuple(s2.shape)}")
        i1 = rng.random_bits(seed, tids, 0, n * r).reshape(-1, n, r) % s1.shape[0]
        i2 = rng.random_bits(seed, tids, 1, n * r).reshape(-1, n, r) % s2.shape[0]
        w = torch.arange(n, device=dev).reshape(1, n, 1)
        return s1[i1, w], s2[i2, w]


# ---- Paper's two numerical scenarios (Sec. VI-C, Fig. 4) -------------------

def scenario1() -> TruncatedGaussianDelays:
    """mu1 = 1e-4, mu2 = 5e-4 for all workers."""
    return TruncatedGaussianDelays(mu1=1e-4, mu2=5e-4)


def scenario2(n: int, seed: int = 0) -> TruncatedGaussianDelays:
    """Per-worker means: mu1 a random permutation of {1e-4, 4/3e-4, ...,
    (2+n)/3 e-4}; mu2 of {5e-4, 5.5e-4, ..., (9+n)/2 e-4}."""
    gen = np.random.default_rng(seed)
    mu1 = (2 + np.arange(1, n + 1)) / 3 * 1e-4
    mu2 = (9 + np.arange(1, n + 1)) / 2 * 1e-4
    return TruncatedGaussianDelays(mu1=tuple(gen.permutation(mu1).tolist()),
                                   mu2=tuple(gen.permutation(mu2).tolist()))


def ec2_like(n: int, seed: int = 0, comm_over_comp: float = 5.0
             ) -> TruncatedGaussianDelays:
    """Fig. 3-style: communication dominates computation by ~comm_over_comp;
    mild heterogeneity across workers."""
    gen = np.random.default_rng(seed)
    mu1 = 1e-4 * (1.0 + 0.3 * gen.random(n))
    mu2 = comm_over_comp * 1e-4 * (1.0 + 0.3 * gen.random(n))
    return TruncatedGaussianDelays(mu1=tuple(mu1.tolist()),
                                   mu2=tuple(mu2.tolist()))
