"""The paper's linear-regression scenario (Sec. VI-C) and its n-way task
partitioning; counterpart of the regression part of ``repro.data.pipeline``.
The language-model half waits for the port's LM slice."""
from __future__ import annotations

from typing import Tuple

import torch

from ..device import resolve_device

__all__ = ["regression_dataset", "regression_tasks"]


def regression_dataset(generator: torch.Generator, N: int, d: int,
                       noise: float = 0.1, *, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paper Sec. VI-C: X ~ N(0,1)^{N x d}; y_i = (x_i + z)^T u, u uniform.
    Drawn from ``generator`` on its own device, returned on ``device``."""
    dev = resolve_device(device)
    g_dev = generator.device
    X = torch.randn(N, d, generator=generator, device=g_dev)
    Z = noise * torch.randn(N, d, generator=generator, device=g_dev)
    u = torch.rand(d, generator=generator, device=g_dev)
    y = (X + Z) @ u
    return X.to(dev), y.to(dev), u.to(dev)


def regression_tasks(X: torch.Tensor, y: torch.Tensor, n: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split rows into n equal task shards: (n, N/n, d), (n, N/n)."""
    N, d = X.shape
    b = N // n
    return X[:n * b].reshape(n, b, d), y[:n * b].reshape(n, b)
