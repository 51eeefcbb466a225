"""Plain PyTorch versions of the port's kernels: what the CPU path runs and
what the card's kernels are held against."""
from __future__ import annotations

import torch

__all__ = ["gram_matvec_ref", "batched_gram_matvec_ref"]


def gram_matvec_ref(X: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The paper's per-task computation h(X_i) = X_i X_i^T theta, X (d, b),
    theta (d,) -> (d,).  Computed as X @ (X^T @ theta) in float32, never
    forming the (d, d) Gram matrix; the result has X's dtype."""
    u = torch.einsum("db,d->b", X.float(), theta.float())
    return torch.einsum("db,b->d", X.float(), u).to(X.dtype)


def batched_gram_matvec_ref(Xs: torch.Tensor,
                            theta: torch.Tensor) -> torch.Tensor:
    """``gram_matvec_ref`` over a leading task axis: Xs (n, d, b) -> (n, d)."""
    u = torch.einsum("ndb,d->nb", Xs.float(), theta.float())
    return torch.einsum("ndb,nb->nd", Xs.float(), u).to(Xs.dtype)
