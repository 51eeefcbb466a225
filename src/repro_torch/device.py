"""Where the port computes.  Entry points take ``device=``; ``None`` means
the CUDA card, and there is no silent fallback to the CPU: without a card
the caller has to ask for ``device="cpu"`` (as the CPU tests do)."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a string or ``torch.device`` passes through.
    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    return dev
