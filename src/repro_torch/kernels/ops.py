"""Public wrappers of the port's kernels.

A wrapper looks at where its tensors lie: on the CPU it runs the plain
PyTorch version (``ref``), on a CUDA device it launches the hand-written
kernel and raises if that is not possible; there is no fallback from the
card to the plain version.  ``LAUNCHES`` counts the kernel launches of each
wrapper (one per call that reached the card), so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import torch

from . import build, ref

__all__ = ["gram_matvec", "batched_gram_matvec", "LAUNCHES",
           "reset_launch_counts"]

#: kernel name -> launches since the last ``reset_launch_counts``
LAUNCHES = {"gram_matvec": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gram_matvec(X: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """h(X) = X X^T theta.  X (d, b), theta (d,) -> (d,), X's dtype."""
    if X.dim() != 2:
        raise ValueError(f"X must be (d, b), got shape {tuple(X.shape)}")
    return batched_gram_matvec(X.unsqueeze(0), theta)[0]


def batched_gram_matvec(Xs: torch.Tensor,
                        theta: torch.Tensor) -> torch.Tensor:
    """h over a batch of tasks in one launch: Xs (n, d, b), theta (d,) ->
    (n, d) in Xs's dtype, accumulated in float32.  On the card this is the
    ``gram_matvec`` CUDA kernel (``csrc/gram_matvec.cu``); CPU tensors take
    the plain version."""
    if Xs.device.type == "cpu" and theta.device.type == "cpu":
        return ref.batched_gram_matvec_ref(Xs, theta)
    if Xs.device.type != "cuda" or theta.device != Xs.device:
        raise ValueError(f"gram_matvec needs Xs and theta on one CUDA device "
                         f"(or both on the CPU); got {Xs.device} and "
                         f"{theta.device}")
    if Xs.dtype not in _DTYPES or theta.dtype != Xs.dtype:
        raise TypeError(f"gram_matvec takes float32 or bfloat16 Xs and theta "
                        f"of the same dtype; got {Xs.dtype} and {theta.dtype}")
    if Xs.dim() != 3 or theta.shape != (Xs.shape[1],):
        raise ValueError(f"need Xs (n, d, b) and theta (d,); got "
                         f"{tuple(Xs.shape)} and {tuple(theta.shape)}")
    n, d, b = Xs.shape
    if min(n, d, b) < 1 or n > 65535 or Xs.numel() >= 2 ** 40:
        raise ValueError(f"gram_matvec shape out of range: {tuple(Xs.shape)}")
    if not (Xs.is_contiguous() and theta.is_contiguous()):
        raise ValueError("gram_matvec needs contiguous Xs and theta")
    u = torch.empty((n, b), dtype=torch.float32, device=Xs.device)
    y = torch.empty((n, d), dtype=Xs.dtype, device=Xs.device)
    lib = build.library("gram_matvec")
    stream = torch.cuda.current_stream(Xs.device).cuda_stream
    with torch.cuda.device(Xs.device):
        err = lib.gram_matvec_launch(Xs.data_ptr(), theta.data_ptr(),
                                     u.data_ptr(), y.data_ptr(), n, d, b,
                                     _DTYPES[Xs.dtype], stream)
    if err:
        msg = lib.gram_matvec_error_string(err).decode()
        raise RuntimeError(f"gram_matvec launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["gram_matvec"] += 1
    return y
