"""Data of the port: the paper's n-way task partitioning with TO-ordered
per-worker micro-batching for LM training, and the regression scenario
(Sec. VI); counterpart of ``repro.data.pipeline``.

One SGD round splits the global batch into ``n`` logical tasks (paper
Remark 1: each task = one mini-batch).  ``lm_task_batches`` builds the
slot-major tensors the straggler train step consumes:

    slots[s, i] = micro-batch of task C[i, s]   — shape (r, n, b, S)

so worker *i* running slot ``s`` processes exactly the task the TO matrix
prescribes.  A task's micro-batch is a pure function of (data seed, step,
task), drawn from the port's counter-based ``core/rng.py`` on the CPU: two
workers holding one task get identical data (redundancy without data
exchange), and a task's tokens are the same bits wherever the model runs.
The JAX package draws with threefry, so the two packages' token streams
differ; they agree in distribution.

Philox streams (``core/rng.py``), under the seed ``round_seed(seed,
step)`` with the task as the trial id: 0 the uniform source's tokens, 1
the bigram chain's first tokens, 2 the uniforms of its later ones.  The
chain's transition logits are drawn once, from seed ``1234``, stream 3.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..core import rng
from ..device import resolve_device

__all__ = ["TaskPartition", "synthetic_tokens", "bigram_tokens",
           "task_tokens", "lm_task_batches", "regression_dataset",
           "regression_tasks"]

STREAM_UNIFORM = 0
STREAM_FIRST = 1
STREAM_CHAIN = 2
STREAM_TRANSITIONS = 3
CHAIN_SEED = 1234


@dataclasses.dataclass(frozen=True)
class TaskPartition:
    """Static description of the round's data layout."""
    n: int              # number of tasks / logical workers
    global_batch: int   # sequences per round
    seq_len: int
    vocab: int
    seed: int = 0
    source: str = "uniform"   # uniform | bigram

    @property
    def task_batch(self) -> int:
        if self.global_batch % self.n:
            raise ValueError(f"global_batch {self.global_batch} not "
                             f"divisible by n={self.n}")
        return self.global_batch // self.n


def _below(bits: torch.Tensor, vocab: int) -> torch.Tensor:
    """32-bit words to integers in [0, vocab) by multiply-shift."""
    return (bits * int(vocab)) >> 32


def synthetic_tokens(seed: int, tasks: torch.Tensor, batch: int, seq: int,
                     vocab: int) -> torch.Tensor:
    """Uniform tokens (len(tasks), batch, seq), int64, one stream per
    task."""
    bits = rng.random_bits(seed, tasks, STREAM_UNIFORM, batch * seq)
    return _below(bits, vocab).reshape(len(tasks), batch, seq)


@functools.lru_cache(maxsize=4)
def _chain_cdf(vocab: int, temperature: float) -> torch.Tensor:
    """The fixed bigram chain: per current token, the cumulative
    probabilities of the next one, softmax(z / temperature) with z standard
    normal (vocab, vocab), float64 on the CPU."""
    z = rng.normal(CHAIN_SEED, torch.zeros(1, dtype=torch.int64),
                   STREAM_TRANSITIONS, (vocab, vocab))[0]
    return torch.softmax(z.double() / temperature, dim=-1).cumsum(dim=-1)


def bigram_tokens(seed: int, tasks: torch.Tensor, batch: int, seq: int,
                  vocab: int, temperature: float = 0.5,
                  chain_vocab: int = 1024) -> torch.Tensor:
    """Learnable synthetic source (len(tasks), batch, seq), int64: tokens
    follow a fixed random bigram chain on the first min(vocab,
    chain_vocab) ids, so an LM can reduce its loss on them (a full vocab x
    vocab chain would be O(V^2) memory).  Each next token is drawn by
    inverting its row's cumulative distribution at one uniform."""
    vocab = min(vocab, chain_vocab)
    cdf = _chain_cdf(vocab, float(temperature))
    nt = len(tasks)
    tok = _below(rng.random_bits(seed, tasks, STREAM_FIRST, batch),
                 vocab).reshape(nt * batch)
    out = [tok]
    if seq > 1:
        bits = rng.random_bits(seed, tasks, STREAM_CHAIN, (seq - 1) * batch)
        u = ((bits >> 8).double() * (2.0 ** -24)).reshape(nt, seq - 1, batch)
        u = u.transpose(0, 1).reshape(seq - 1, nt * batch, 1)
        for t in range(seq - 1):
            rows = cdf[tok]
            tok = torch.searchsorted(rows, u[t] * rows[:, -1:], right=True)
            tok = tok.clamp_(max=vocab - 1)[:, 0]
            out.append(tok)
    return torch.stack(out, dim=-1).reshape(nt, batch, seq)


def task_tokens(part: TaskPartition, step: int, tasks) -> torch.Tensor:
    """Micro-batches of the given tasks, (len(tasks), b, S + 1) int64 on
    the CPU: inputs plus the next-token labels by a shift."""
    tasks = torch.as_tensor(np.asarray(tasks, np.int64).reshape(-1))
    seed = rng.round_seed(part.seed, step)
    gen = bigram_tokens if part.source == "bigram" else synthetic_tokens
    return gen(seed, tasks, part.task_batch, part.seq_len + 1, part.vocab)


def lm_task_batches(part: TaskPartition, C: np.ndarray, step: int, *,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot-major batches for the TO matrix ``C`` (n, r): (inputs (r, n, b,
    S), labels (r, n, b, S)), int64 on ``device``.  ``MASKED`` (-1) slots
    of a ragged ``C`` get an all-zero micro-batch (the straggler step gives
    them zero weight)."""
    C = np.asarray(C)
    n = C.shape[0]
    if n != part.n:
        raise ValueError(f"C has {n} rows for a partition of n={part.n}")
    uniq = np.unique(C[C >= 0])
    toks = task_tokens(part, step, uniq)             # each task once
    filler = torch.zeros((1,) + toks.shape[1:], dtype=toks.dtype)
    pos = np.searchsorted(uniq, C)                   # task -> its row
    idx = np.where(C >= 0, pos, len(uniq))
    slots = torch.cat([toks, filler])[torch.as_tensor(idx.T)]  # (r, n, ...)
    slots = slots.to(resolve_device(device))
    return slots[..., :-1], slots[..., 1:]

# ---------------- linear-regression scenario (paper Sec. VI) ----------------

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
