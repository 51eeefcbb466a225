"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from fixed seeds and handed to both packages;
results come back as numpy arrays.  Nothing here changes global state on
import: no JAX config updates, no global seeding, no thread settings.
The ``one_thread`` fixture, imported into a test module, runs that
module's torch ops on one CPU thread and restores the count after it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cluster import DelayProcess as JaxDelayProcess
from repro_torch.core.cluster import DelayProcess as TorchDelayProcess

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small ops on one CPU thread: under the suite's parallel
    workers, eight threads each oversubscribe a shared machine and take
    many times as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_of(x) -> np.ndarray:
    """A torch tensor or JAX array as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got = np.asarray(np_of(got), np.float64)
    want = np.asarray(np_of(want), np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


def assert_bit_equal(got, want):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def z_scores(mean_a, se_a, mean_b, se_b) -> np.ndarray:
    """|a - b| in combined standard errors, elementwise."""
    mean_a, mean_b = np.asarray(mean_a), np.asarray(mean_b)
    se = np.sqrt(np.asarray(se_a) ** 2 + np.asarray(se_b) ** 2)
    return np.abs(mean_a - mean_b) / np.maximum(se, 1e-300)


def quantile_z(a: np.ndarray, b: np.ndarray, q: float) -> float:
    """Two-sample check of one quantile on the probability scale: at the
    pooled q-quantile x, the shares of ``a`` and of ``b`` at or below x, in
    combined binomial standard errors (atoms, e.g. clipped bounds, count on
    both sides alike)."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    x = np.quantile(np.concatenate([a, b]), q)
    pa, pb = float(np.mean(a <= x)), float(np.mean(b <= x))
    p = (pa * a.size + pb * b.size) / (a.size + b.size)
    if p in (0.0, 1.0):
        return 0.0
    return abs(pa - pb) / np.sqrt(p * (1 - p) * (1 / a.size + 1 / b.size))


def load_example(name: str):
    """A module of the JAX package's ``examples/`` directory, loaded from
    its file without registering it in ``sys.modules``."""
    path = REPO / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True, eq=False)
class JaxTableProcess(JaxDelayProcess):
    """Replays fixed per-round delay tables T1/T2 (rounds, n, r) through the
    JAX package's process protocol; keys are ignored, the state is the round
    index."""
    T1: np.ndarray = None
    T2: np.ndarray = None

    def init(self, keys, n):
        return jnp.zeros((), jnp.int32)

    def step(self, state, keys, n, r):
        T1 = jnp.asarray(self.T1)[state][None, :, :r]
        T2 = jnp.asarray(self.T2)[state][None, :, :r]
        return state + 1, T1, T2


@dataclasses.dataclass(frozen=True, eq=False)
class TorchTableProcess(TorchDelayProcess):
    """The same replay through the port's process protocol."""
    T1: np.ndarray = None
    T2: np.ndarray = None

    def init(self, seed, tids, n):
        return 0

    def step(self, state, seed, tids, n, r):
        dev = tids.device
        T1 = torch.as_tensor(self.T1[state][None, :, :r], device=dev)
        T2 = torch.as_tensor(self.T2[state][None, :, :r], device=dev)
        return state + 1, T1, T2


def delay_tables(seed: int, rounds: int, n: int, r: int,
                 scale: float = 1e-4):
    """Positive float32 delay tables (rounds, n, r) from numpy."""
    gen = np.random.default_rng(seed)
    T1 = (scale * (0.5 + gen.random((rounds, n, r)))).astype(np.float32)
    T2 = (5 * scale * (0.5 + gen.random((rounds, n, r)))).astype(np.float32)
    return T1, T2


def tie_exact_tables(seed: int, rounds: int, n: int, r: int,
                     trials: int | None = None, lo: int = 8, hi: int = 14):
    """The tie-exact family of delay tables: T1 is constant per (trial,
    worker) across rounds and slots and a power of two, ``2**-e`` with e in
    [lo, hi); T2 is arbitrary positive.  With feedback_beta = coverage_gamma
    = 0.5 every delay estimate stays that power of two, every greedy score is
    exact in float32, and no summation order can change a pick.  Shapes are
    (rounds, n, r), or (rounds, trials, n, r) when ``trials`` is given."""
    gen = np.random.default_rng(seed)
    lead = () if trials is None else (trials,)
    e = gen.integers(lo, hi, size=(1,) + lead + (n, 1))
    T1 = np.broadcast_to(2.0 ** -e, (rounds,) + lead + (n, r))
    T2 = 5e-4 * (0.5 + gen.random((rounds,) + lead + (n, r)))
    return T1.astype(np.float32), T2.astype(np.float32)
