"""Carry the JAX side's state into the port.

This system has no model weights: its state is delay-model parameters, TO
matrices, round configurations, the regression data and parameters, and
delay tables.  The JAX package hands them over as numpy arrays and plain
dicts (``dataclasses.asdict`` of its frozen specs, ``RoundConfig.to_dict``,
``np.asarray`` of its arrays); these functions turn them into the port's
objects, so both packages can compute on the same inputs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .core import delays, scheduling
from .core.spec import RoundConfig
from .device import resolve_device

__all__ = ["delay_model", "to_matrix", "round_config", "regression_state",
           "delay_tables"]

_MODELS = {cls.__name__: cls for cls in (
    delays.TruncatedGaussianDelays, delays.ShiftedExponentialDelays,
    delays.BimodalStragglerDelays, delays.EmpiricalDelays)}


def _frozen(v):
    """Lists (from ``asdict`` or JSON) back to the tuples the frozen
    dataclasses hold."""
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(_frozen(x) for x in v)
    return v


def delay_model(kind: str, fields: dict) -> delays.DelayModel:
    """The port's delay model of class name ``kind`` (e.g.
    ``"TruncatedGaussianDelays"``) from the JAX model's fields
    (``dataclasses.asdict(model)``)."""
    try:
        cls = _MODELS[kind]
    except KeyError:
        raise ValueError(f"unknown delay model {kind!r}; have "
                         f"{sorted(_MODELS)}") from None
    kw = {k: _frozen(v) for k, v in fields.items()}
    if cls is delays.BimodalStragglerDelays and isinstance(kw.get("base"),
                                                           dict):
        kw["base"] = delay_model("TruncatedGaussianDelays", kw["base"])
    return cls(**kw)


def to_matrix(C) -> np.ndarray:
    """A TO matrix (possibly ragged, ``MASKED`` = -1) as the port's int64
    numpy matrix, validated."""
    C = np.asarray(C).astype(np.int64)
    scheduling.validate_to_matrix(C)
    return C


def round_config(d: dict) -> RoundConfig:
    """A ``RoundConfig`` from the JAX side's ``RoundConfig.to_dict()``."""
    return RoundConfig.from_dict(d)


def regression_state(X, y, theta=None, *, device=None
                     ) -> Tuple[torch.Tensor, ...]:
    """Regression data ``X`` (N, d), targets ``y`` (N,) and optionally
    parameters ``theta`` (d,) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    out = [torch.as_tensor(np.array(a, np.float32), device=dev)
           for a in (X, y) + (() if theta is None else (theta,))]
    return tuple(out)


def delay_tables(T1, T2, *, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Delay tables ``T1``/``T2`` (..., n, r) as float32 tensors on
    ``device``; ``+inf`` entries (censored results) are kept."""
    dev = resolve_device(device)
    T1 = torch.as_tensor(np.array(T1, np.float32), device=dev)
    T2 = torch.as_tensor(np.array(T2, np.float32), device=dev)
    if T1.shape != T2.shape or T1.dim() < 2:
        raise ValueError(f"T1/T2 must share a (..., n, r) shape; got "
                         f"{tuple(T1.shape)} and {tuple(T2.shape)}")
    return T1, T2
