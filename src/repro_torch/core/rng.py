"""Counter-based per-trial random numbers (Philox-4x32-10 in torch integer
ops) — the port's counterpart of the engine's ``fold_in`` trial keys
(``repro.core.montecarlo.trial_keys``).

Every random word is a pure function of ``(seed, global trial id, stream,
element index)``: Philox's 128-bit counter is ``(element block, trial id low
word, stream, trial id high word)`` and its key is the 64-bit seed.  So
per-trial draws do not depend on how the trial axis is chunked (the common
random numbers the engine relies on), and CPU and GPU produce the same bits:
the arithmetic is exact integer arithmetic in ``int64`` tensors holding
unsigned 32-bit values.  Torch has no unsigned 64-bit multiply on CUDA and a
32x32-bit product overflows ``int64``, so each ``mulhilo`` splits its
operand into 16-bit halves (partial products below 2**48).

Streams separate independent draws of one trial (a model's T1 and T2, a
worker effect, a straggler mask); the delay models and processes document
theirs.

Rounds: a run over consecutive rounds keys each round by its own seed,
``round_seed(seed, i)``, with ``i = 0`` for the process's initial state and
``i = t + 1`` for round ``t`` (the counterpart of the JAX engine splitting
each trial's key into ``rounds + 1`` subkeys: subkey 0 initializes the
process, subkey ``t + 1`` drives round ``t``).  The trial id stays the
global one, so multi-round draws are chunk-invariant as well.
"""
from __future__ import annotations

import math

import torch

__all__ = ["philox4x32", "random_bits", "uniform", "normal", "round_seed"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Philox-4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
_MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of ``m * x`` for a constant ``m < 2**32`` and
    ``x`` holding values below ``2**32``, without leaving ``int64``."""
    p_lo = m * (x & 0xFFFF)                   # < 2**48
    p_hi = m * (x >> 16)                      # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)      # < 2**49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 on broadcastable ``int64`` counter words (values in
    ``[0, 2**32)``) under the key ``(k0, k1)``; returns the four output
    words as ``int64`` tensors."""
    for rnd in range(ROUNDS):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if rnd + 1 < ROUNDS:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def random_bits(seed: int, tids: torch.Tensor, stream: int,
                count: int, *, start: int = 0) -> torch.Tensor:
    """``count`` random 32-bit words per trial, shape ``(len(tids), count)``
    (``int64`` holding values in ``[0, 2**32)``), on ``tids``'s device.
    Word ``e`` of trial ``t`` is output word ``e % 4`` of Philox at counter
    ``(e // 4, t mod 2**32, stream, t >> 32)``; the words returned are
    ``start .. start + count - 1`` (``start`` a multiple of 4), so a long
    stream can be drawn slab by slab."""
    seed, start = int(seed), int(start)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    if start < 0 or start % 4:
        raise ValueError(f"start must be a non-negative multiple of 4, got "
                         f"{start}")
    tids = tids.to(torch.int64).reshape(-1, 1)
    blocks = torch.arange(start // 4, start // 4 + math.ceil(count / 4),
                          dtype=torch.int64,
                          device=tids.device).reshape(1, -1)
    out = philox4x32(blocks, tids & _MASK32,
                     torch.full_like(blocks, int(stream) & _MASK32),
                     tids >> 32, seed & _MASK32, seed >> 32)
    words = torch.stack(torch.broadcast_tensors(*out), dim=-1)
    return words.reshape(tids.shape[0], -1)[:, :count]


def uniform(seed: int, tids: torch.Tensor, stream: int,
            shape) -> torch.Tensor:
    """Per-trial float32 uniforms on ``[0, 1)``, shape ``(len(tids),
    *shape)``: the top 24 bits of each word, scaled exactly by 2**-24."""
    shape = tuple(int(s) for s in shape)
    bits = random_bits(seed, tids, stream, math.prod(shape))
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    return u.reshape((bits.shape[0],) + shape)


def normal(seed: int, tids: torch.Tensor, stream: int,
           shape, *, start: int = 0) -> torch.Tensor:
    """Per-trial float32 standard normals, shape ``(len(tids), *shape)``:
    ``sqrt(2) * erfinv(2u - 1)`` with ``u`` the top 23 bits of each word
    placed at the centres of their bins, ``(b + 0.5) * 2**-23``, so ``u``
    lies in the open interval (0, 1) and ``2u - 1`` is exact.  ``start``
    as in ``random_bits``."""
    shape = tuple(int(s) for s in shape)
    bits = random_bits(seed, tids, stream, math.prod(shape), start=start)
    v = ((bits >> 9) * 2 + 1).to(torch.float32) * (2.0 ** -23) - 1.0
    z = math.sqrt(2.0) * torch.erfinv(v)
    return z.reshape((bits.shape[0],) + shape)


def round_seed(seed: int, index: int) -> int:
    """The seed of round stream ``index`` of a run seeded ``seed``:
    ``seed << 32 | index``.  Index 0 is the process's initial state, index
    ``t + 1`` round ``t``.  Both must lie in ``[0, 2**32)``."""
    seed, index = int(seed), int(index)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"a multi-round seed must be in [0, 2**32), got "
                         f"{seed}")
    if not 0 <= index < 2 ** 32:
        raise ValueError(f"round index must be in [0, 2**32), got {index}")
    return (seed << 32) | index
