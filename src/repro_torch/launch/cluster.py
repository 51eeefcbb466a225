"""Cluster helpers shared by the port's launchers (the live CLI, and the
trainer CLI once LM training is ported): ``derive_seeds`` and
``build_cluster``, counterparts of ``repro.launch.train``'s.

``derive_seeds`` returns the JAX package's integer seeds bit for bit, so
one ``--seed`` builds the same cluster in either package.  The JAX package
derives them with ``jax.random.fold_in`` on ``jax.random.PRNGKey(seed)``;
both are the Threefry-2x32 block cipher (20 rounds), evaluated here in
numpy ``uint32`` arithmetic:

* ``PRNGKey(s)`` is the key ``(0, s mod 2**32)`` (the JAX package runs
  without 64-bit mode, where a seed is taken to 32 bits; with it the high
  word would be ``s >> 32``);
* ``fold_in(key, i)`` is ``threefry2x32(key, (0, i))``.
"""
from __future__ import annotations

import numpy as np

from ..core import (AR1Process, BimodalStragglerDelays, TraceProcess,
                    ec2_cluster, heterogeneous_scales, load_trace,
                    make_scenario, scenario1)

__all__ = ["derive_seeds", "build_cluster"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.uint32, d: int) -> np.uint32:
    return np.uint32((x << np.uint32(d)) | (x >> np.uint32(32 - d)))


def _threefry2x32(key, count) -> np.ndarray:
    """The Threefry-2x32 block (20 rounds) of one counter pair ``count``
    under ``key``: two ``uint32`` words in, two out."""
    k0, k1 = (np.uint32(v) for v in key)
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ _PARITY))
    x0, x1 = (np.uint32(v) for v in count)
    with np.errstate(over="ignore"):
        x0 = np.uint32(x0 + ks[0])
        x1 = np.uint32(x1 + ks[1])
        for i in range(5):
            for rot in _ROTATIONS[i % 2]:
                x0 = np.uint32(x0 + x1)
                x1 = np.uint32(_rotl(x1, rot) ^ x0)
            x0 = np.uint32(x0 + ks[(i + 1) % 3])
            x1 = np.uint32(x1 + ks[(i + 2) % 3] + np.uint32(i + 1))
    return np.array([x0, x1], np.uint32)


def _prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (without 64-bit mode) as a ``uint32``
    pair."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` as a ``uint32`` pair."""
    return _threefry2x32(key, (0, int(data) & 0xFFFFFFFF))


def derive_seeds(seed: int) -> dict:
    """Every randomness stream of a run from one root ``--seed``, as the
    JAX package derives them (``fold_in`` on the root key): ``init_key``
    and ``delay_root`` as ``uint32`` key pairs, ``data_seed``,
    ``schedule_seed`` and ``cluster_seed`` as integers (each the second
    word of its folded key).  Same seed -> same run, in either package."""
    root = _prng_key(seed)

    def _int(i):
        return int(_fold_in(root, i)[1])

    return {"init_key": _fold_in(root, 0),
            "delay_root": _fold_in(root, 1),
            "data_seed": _int(2),
            "schedule_seed": _int(3),
            "cluster_seed": _int(4)}


def build_cluster(args, seeds):
    """The round delay source: an i.i.d. model, a stateful process, or a
    recorded trace replay.  ``--straggle`` layers i.i.d. bimodal slowdowns
    on the base model in the parametric modes (stateful processes add
    their own regime chain on top); ``--scenario`` overlays a named fault
    scenario (spot preemption, partition, ...) on whatever source was
    built."""
    if args.cluster == "trace":
        if not args.trace:
            raise SystemExit("--cluster trace needs --trace PATH "
                             "(a file written by --save-trace or "
                             "repro_torch.core.save_trace)")
        delay = TraceProcess(load_trace(args.trace),
                             pad_rounds=args.trace_pad)
        if getattr(args, "scenario", "none") != "none":
            raise SystemExit("--scenario cannot overlay a trace replay: "
                             "the recording already realized its faults")
        return delay
    base = (BimodalStragglerDelays(p_straggle=0.3, slow=8.0)
            if args.straggle else scenario1())
    if args.cluster == "iid":
        delay = base
    elif args.cluster == "markov":
        delay = ec2_cluster(args.n, spread=args.spread, p_slow=args.p_slow,
                            persistence=args.persistence, slow=args.slow,
                            base=base, seed=seeds["cluster_seed"])
    else:
        delay = AR1Process(base=base,
                           worker_scale=heterogeneous_scales(
                               args.n, args.spread,
                               seed=seeds["cluster_seed"]),
                           rho=args.persistence, sigma=0.4)
    if getattr(args, "scenario", "none") != "none":
        delay = make_scenario(args.scenario, delay, args.n)
    return delay
