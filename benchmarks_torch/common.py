"""Shared helpers of the port's paper-figure benchmarks; counterpart of
``benchmarks/common.py``.

``scheme_means`` and ``scheme_mean_table`` evaluate every scheme at a grid
point through one engine call (``repro_torch.core.sweep``): the delays are
sampled once, keyed by (seed, trial id), and every scheme is scored against
the same draws, so scheme differences are paired-sample estimates.
``device`` is where the engine runs: the card by default, ``"cpu"`` on
request.

``emit`` prints the CSV row ``name,us_per_call,derived`` and records it;
``run.py`` drains the rows after each job into ``BENCH_<name>.json``.
"""
from __future__ import annotations

import re
import time

import numpy as np
import torch

from repro_torch.core import (cyclic_to_matrix, lb_spec, pc_spec, pcmm_spec,
                              random_assignment_to_matrix,
                              staircase_to_matrix, sweep, to_spec)


def _grid_specs(n: int, r: int, *, seed: int, include_coded: bool,
                include_ra: bool) -> list:
    specs = [to_spec("cs", cyclic_to_matrix(n, r)),
             to_spec("ss", staircase_to_matrix(n, r))]
    if include_ra:
        specs.append(to_spec("ra", random_assignment_to_matrix(n, seed=seed)))
    if include_coded and r >= 2:
        specs.append(pc_spec(r))
        if n * r >= 2 * n - 1:
            specs.append(pcmm_spec(r))
    specs.append(lb_spec(r))
    return specs


def scheme_means(model, n: int, r: int, k: int, *, trials: int = 20000,
                 seed: int = 0, include_coded: bool = True,
                 include_ra: bool = True, chunk: int | None = None,
                 device=None) -> dict:
    """Average completion time of every scheme at one (n, r, k) point, from
    one sweep over shared delay draws, in the delay model's unit."""
    specs = _grid_specs(n, r, seed=seed, include_coded=include_coded,
                        include_ra=include_ra)
    res = sweep(specs, model, n, trials=trials, seed=seed, chunk=chunk,
                devices=device)
    # coded schemes always report their own decode thresholds (k ignored)
    return {spec.name: res.at_k(spec.name, k) for spec in specs}


def scheme_mean_table(model, n: int, r: int, *, trials: int = 20000,
                      seed: int = 0, include_coded: bool = False,
                      include_ra: bool = True, chunk: int | None = None,
                      device=None) -> dict:
    """Average completion time of every scheme for every k in 1..n from one
    sweep (one sort of the shared task arrivals).  Returns ``{scheme: (n,)
    per-k means}``; coded schemes keep their own thresholds, broadcast
    across k."""
    specs = _grid_specs(n, r, seed=seed, include_coded=include_coded,
                        include_ra=include_ra)
    res = sweep(specs, model, n, trials=trials, seed=seed, chunk=chunk,
                devices=device)
    out = {}
    for spec in specs:
        if spec.name in res.fixed:     # coded: own threshold, constant in k
            out[spec.name] = np.full(n, res.at_k(spec.name))
        else:
            out[spec.name] = np.asarray(res.means[spec.name])
    return out


class Timer:
    """Wall time of a block, in microseconds (``.us``).  A timed block ends
    in a host read of its results (the engine returns host numbers), so the
    time covers the device work and not only the launches; on exit the card,
    if one is in use, is synchronized as well."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.us = (time.perf_counter() - self.t0) * 1e6


# ------------------- machine-readable result collection ----------------------

_ROWS: list[dict] = []

_LEADING_NUMBER = re.compile(
    r"\s*[-+]?(?:\d[\d,]*(?:\.\d+)?(?:[eE][-+]?\d+)?"
    r"|(?:nan|inf)(?=$|[^a-z]|ms$|us$|s$|x$))",
    re.IGNORECASE)


def _parse_value(v: str):
    """Best-effort numeric parse of a derived field value: strips thousands
    separators and trailing unit suffixes (``0.123ms``, ``5.85x``, ``+8.1%``,
    ``1,234_trials_schemes_per_s``); ``nan`` and ``inf`` (as Python formats
    them, e.g. ``nanms``) parse to floats, so that the harness's finite
    screen sees them; non-numeric values stay strings."""
    m = _LEADING_NUMBER.match(v)
    if m and m.group(0).strip():
        try:
            return float(m.group(0).replace(",", ""))
        except ValueError:
            pass
    return v


def _parse_derived(derived: str) -> dict:
    out = {}
    for part in derived.split(";"):
        key, sep, val = part.partition("=")
        if sep:
            out[key.strip()] = _parse_value(val)
    return out


def emit(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)
    _ROWS.append({"name": name, "us_per_call": float(us_per_call),
                  "derived": _parse_derived(derived),
                  "derived_raw": derived})


def drain_rows() -> list[dict]:
    """Return the rows emitted since the last drain and clear the buffer."""
    out = list(_ROWS)
    _ROWS.clear()
    return out
