"""Coded-computation baselines the paper compares against (Sec. VI-B), in
float64 torch; counterpart of ``repro.core.coded``.

* PC   — polynomially coded regression [13]: worker i stores r coded
         matrices (one per group of G = ceil(n/r) data parts), computes the
         SUM of its r Gram-vector products and sends ONE message; the master
         recovers X^T X theta from any 2G - 1 workers by interpolation.
* PCMM — polynomially coded multi-message [17]: worker i stores r Lagrange-
         coded matrices (each mixing ALL n parts, evaluated at distinct
         points beta_{i,j}), computes them sequentially and sends each result
         at once; the master recovers from any 2n - 1 computations.

The codec is real: encode, worker compute and decode interpolate, so tests
check exact recovery.  Completion times (eqs. 51-52, 56-57) come from the
port's engine.  Coded data and results live on the caller's device;
evaluation points are returned as numpy float64 arrays.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from . import montecarlo

__all__ = [
    "pc_threshold", "pcmm_threshold", "pc_encode", "pc_worker_compute",
    "pc_decode", "pcmm_encode", "pcmm_worker_compute", "pcmm_decode",
    "simulate_pc_completion", "simulate_pcmm_completion",
]


def pc_threshold(n: int, r: int) -> int:
    return 2 * math.ceil(n / r) - 1


def pcmm_threshold(n: int) -> int:
    return 2 * n - 1


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64) if not torch.is_tensor(x)
                           else x, device=device).to(torch.float64)


def _lagrange_basis(points: np.ndarray, x: np.ndarray) -> np.ndarray:
    """L[m, t] = prod_{p != m} (x[t] - points[p]) / (points[m] - points[p])."""
    P = len(points)
    x = np.atleast_1d(x).astype(np.float64)
    L = np.ones((P, len(x)))
    for m in range(P):
        for p in range(P):
            if p != m:
                L[m] *= (x - points[p]) / (points[m] - points[p])
    return L


def _vander(x: torch.Tensor, cols: int) -> torch.Tensor:
    """Increasing-power Vandermonde matrix (len(x), cols), built by
    repeated multiplication as numpy's ``vander`` does."""
    v = [torch.ones_like(x)]
    for _ in range(1, cols):
        v.append(v[-1] * x)
    return torch.stack(v, dim=-1)


# --------------------------------- PC ----------------------------------------

def _pc_groups(n: int, r: int) -> Tuple[np.ndarray, int]:
    """Partition task indices [n] into r groups of size G = ceil(n/r),
    padded with -1 (zero data)."""
    G = math.ceil(n / r)
    idx = np.full((r, G), -1, dtype=np.int64)
    flat = np.arange(n)
    for j in range(r):
        chunk = flat[j * G:(j + 1) * G]
        idx[j, :len(chunk)] = chunk
    return idx, G


def pc_encode(X_parts: torch.Tensor, r: int, alphas=None
              ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Encode the n data parts X_parts (n, d, b) for PC.  Returns (Xt,
    alphas, group_idx) with Xt (n, r, d, b) float64: Xt[i, j] = p_j(alpha_i),
    p_j the degree-(G-1) polynomial through group j's parts at 1..G."""
    X = X_parts.to(torch.float64)
    n, d, b = X.shape
    group_idx, G = _pc_groups(n, r)
    if alphas is None:
        alphas = np.arange(1, n + 1, dtype=np.float64)   # worker eval points
    alphas = np.asarray(alphas, np.float64)
    pts = np.arange(1, G + 1, dtype=np.float64)          # interpolation nodes
    L = _f64(_lagrange_basis(pts, alphas), X.device)     # (G, n)
    Xt = X.new_zeros((n, r, d, b))
    for j in range(r):
        m = np.nonzero(group_idx[j] >= 0)[0]
        Lm = L[torch.as_tensor(m, device=X.device)]
        parts = X[torch.as_tensor(group_idx[j, m], device=X.device)]
        Xt[:, j] = torch.einsum("mi,mdb->idb", Lm, parts)
    return Xt, alphas, group_idx


def pc_worker_compute(Xt_i: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Worker i's single message sum_j Xt[i,j] (Xt[i,j]^T theta): Xt_i
    (..., r, d, b) -> (..., d)."""
    theta = theta.to(Xt_i.dtype)
    u = torch.einsum("...jdb,d->...jb", Xt_i, theta)
    return torch.einsum("...jdb,...jb->...d", Xt_i, u)


def pc_decode(results: torch.Tensor, alphas_rx, n: int, r: int
              ) -> torch.Tensor:
    """Interpolate phi(x) = sum_j p_j(x) p_j(x)^T theta (degree 2G-2) from
    >= 2G-1 worker results (w, d), then return sum_{m=1..G} phi(m) =
    X^T X theta."""
    G = math.ceil(n / r)
    need = 2 * G - 1
    if len(alphas_rx) < need:
        raise ValueError(f"PC needs {need} results, got {len(alphas_rx)}")
    dev = results.device
    A = _vander(_f64(alphas_rx, dev), need)
    coef = torch.linalg.lstsq(A, results.to(torch.float64)).solution
    V = _vander(torch.arange(1, G + 1, dtype=torch.float64, device=dev), need)
    return (V @ coef).sum(dim=0)


# -------------------------------- PCMM ---------------------------------------

def pcmm_encode(X_parts: torch.Tensor, r: int, betas=None
                ) -> Tuple[torch.Tensor, np.ndarray]:
    """Lagrange-code all n parts; worker i's j-th matrix is the degree-(n-1)
    polynomial through X_1..X_n (at nodes 1..n) evaluated at beta[i, j].
    Returns (Xh, betas): Xh (n, r, d, b) float64."""
    X = X_parts.to(torch.float64)
    n, d, b = X.shape
    if betas is None:
        # Chebyshev points spanning the interpolation nodes [1, n]
        m = n * r
        cheb = np.cos((2 * np.arange(1, m + 1) - 1) / (2 * m) * np.pi)
        betas = (0.5 * (1 + n) + 0.5 * (n - 0.5) * cheb).reshape(n, r)
    betas = np.asarray(betas, np.float64)
    nodes = np.arange(1, n + 1, dtype=np.float64)
    L = _f64(_lagrange_basis(nodes, betas.reshape(-1)), X.device)  # (n, n*r)
    Xh = torch.einsum("mp,mdb->pdb", L, X).reshape(n, r, d, b)
    return Xh, betas


def pcmm_worker_compute(Xh_ij: torch.Tensor,
                        theta: torch.Tensor) -> torch.Tensor:
    """One sequential message Xh_ij (Xh_ij^T theta): (..., d, b) -> (..., d)."""
    theta = theta.to(Xh_ij.dtype)
    u = torch.einsum("...db,d->...b", Xh_ij, theta)
    return torch.einsum("...db,...b->...d", Xh_ij, u)


def _chebvander(x: torch.Tensor, deg: int) -> torch.Tensor:
    """Chebyshev-T Vandermonde matrix (len(x), deg + 1), by numpy's
    ``chebvander`` recurrence."""
    v = [torch.ones_like(x)]
    if deg > 0:
        v.append(x)
        x2 = 2 * x
        for _ in range(2, deg + 1):
            v.append(v[-1] * x2 - v[-2])
    return torch.stack(v, dim=-1)


def pcmm_decode(results: torch.Tensor, betas_rx, n: int) -> torch.Tensor:
    """Interpolate phi2(x) (degree 2n-2) from >= 2n-1 results in a Chebyshev
    basis over the hull of {received points} and {1..n}, then return
    sum_{i=1..n} phi2(i) = X^T X theta."""
    need = 2 * n - 1
    if len(betas_rx) < need:
        raise ValueError(f"PCMM needs {need} results, got {len(betas_rx)}")
    x = np.asarray(betas_rx, np.float64)
    nodes = np.arange(1, n + 1, dtype=np.float64)
    lo = min(x.min(), nodes.min()) - 1e-9
    hi = max(x.max(), nodes.max()) + 1e-9
    dev = results.device
    A = _chebvander(_f64((2 * x - (lo + hi)) / (hi - lo), dev), need - 1)
    coef = torch.linalg.lstsq(A, results.to(torch.float64)).solution
    V = _chebvander(_f64((2 * nodes - (lo + hi)) / (hi - lo), dev), need - 1)
    return (V @ coef).sum(dim=0)


# --------------------- completion-time simulation ----------------------------

def simulate_pc_completion(model, n: int, r: int, *, trials: int = 10000,
                           seed: int = 0, chunk: int | None = None,
                           devices=None) -> torch.Tensor:
    """eq. (51)-(52): worker i's single message lands at
    sum_j T1[i, j] + T2[i, -1]; completion = (2*ceil(n/r)-1)-th order stat."""
    return montecarlo.completion_samples(
        montecarlo.pc_spec(r), model, n, trials=trials, seed=seed,
        chunk=chunk, devices=devices)


def simulate_pcmm_completion(model, n: int, r: int, *, trials: int = 10000,
                             seed: int = 0, chunk: int | None = None,
                             devices=None) -> torch.Tensor:
    """eq. (56)-(57): all n*r slot arrivals; completion = (2n-1)-th order
    statistic (requires n*r >= 2n-1)."""
    if n * r < pcmm_threshold(n):
        raise ValueError(f"PCMM infeasible: n*r={n*r} < 2n-1={2*n-1}")
    return montecarlo.completion_samples(
        montecarlo.pcmm_spec(r), model, n, trials=trials, seed=seed,
        chunk=chunk, devices=devices)
