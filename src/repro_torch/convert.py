"""Carry the JAX side's state into the port.

The scheduling system's state is delay-model and process parameters, TO
matrices, round configurations, the regression data and parameters, delay
tables and traces, and an adaptive scheduler's feedback estimates; the LM
stack's is its parameter tree.  The JAX package hands them over as numpy
arrays and plain dicts (``dataclasses.asdict`` of its frozen specs,
``RoundConfig.to_dict``, ``np.asarray`` of its arrays); these functions
turn them into the port's objects, so both packages can compute on the
same inputs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .core import cluster, delays, scheduling
from .core.spec import RoundConfig
from .ckpt import from_numpy
from .core.trace import DelayTrace
from .device import resolve_device
from .models.config import ModelConfig
from .models.model import Transformer, plan_segments
from .train.steps import TrainState

__all__ = ["delay_model", "delay_process", "to_matrix", "round_config",
           "regression_state", "delay_tables", "delay_trace",
           "adaptive_scheduler", "lm_params", "train_state"]

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


_PROCESSES = {cls.__name__: cls for cls in (
    cluster.MarkovRegimeProcess, cluster.AR1Process)}


def delay_process(kind: str, fields: dict, *,
                  base_kind: str = "TruncatedGaussianDelays"
                  ) -> cluster.DelayProcess:
    """The port's ``MarkovRegimeProcess`` or ``AR1Process`` (class name
    ``kind``) from the JAX process's fields (``dataclasses.asdict``, which
    flattens the nested base model to a dict: ``base_kind`` names its
    class)."""
    try:
        cls = _PROCESSES[kind]
    except KeyError:
        raise ValueError(f"unknown delay process {kind!r}; have "
                         f"{sorted(_PROCESSES)}") from None
    kw = {k: _frozen(v) for k, v in fields.items() if k != "base"}
    if "base" in fields:
        base = fields["base"]
        kw["base"] = (base if isinstance(base, delays.DelayModel)
                      else delay_model(base_kind, base))
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


def delay_trace(T1, T2, meta=None) -> DelayTrace:
    """A recorded trace (the JAX ``DelayTrace``'s ``T1``, ``T2`` and
    ``meta``) as the port's ``DelayTrace``; the content digest is the
    same."""
    return DelayTrace(np.asarray(T1), np.asarray(T2), meta=meta)


def adaptive_scheduler(C, est=None, silent=None, *, device=None,
                       **kwargs) -> scheduling.AdaptiveScheduler:
    """The port's ``AdaptiveScheduler`` over base matrix ``C`` carrying a
    JAX scheduler's feedback state: its ``est`` (float64 per-worker
    estimates, +inf = never observed; None before any feedback) and
    ``silent`` counters.  ``kwargs`` are the scheduler's options (beta,
    gamma, dead_after, target_k)."""
    sch = scheduling.AdaptiveScheduler(np.asarray(C), device=device,
                                       **kwargs)
    n = sch.C.shape[0]
    if est is not None:
        est = np.array(est, np.float64)
        if est.shape != (n,):
            raise ValueError(f"est must have shape ({n},), got {est.shape}")
        sch.est = est
    if silent is not None:
        silent = np.array(silent, np.int64)
        if silent.shape != (n,):
            raise ValueError(f"silent must have shape ({n},), got "
                             f"{silent.shape}")
        sch.silent = silent
    return sch


def _flatten(tree, prefix: str):
    """(dotted name, leaf) pairs of a nested dict of arrays."""
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _unstack(params: dict, cfg: ModelConfig) -> dict:
    """The JAX LM parameter tree as {port name: numpy array}: each
    segment's (reps, ...) leaves are unstacked into one block per layer,
    in ``layer_specs`` order (rep-major, then the position in the period),
    for the periodic and the run-length plan alike; the encoder's stacked
    (encoder_layers, ...) blocks (a 1-tuple) into ``encoder.blocks.<l>``."""
    extra = set(params) - {"embed", "final_norm", "lm_head", "segments",
                           "pos_embed", "frontend_proj", "encoder"}
    if extra:
        raise NotImplementedError(
            f"parameters {sorted(extra)} belong to layers the port does not "
            f"run yet (ROADMAP.md)")
    out = {"embed": np.asarray(params["embed"])}
    if "pos_embed" in params:
        out["pos_embed"] = np.asarray(params["pos_embed"])
    for top in ("final_norm", "lm_head", "frontend_proj"):
        if top in params:
            out.update((n, np.asarray(a)) for n, a in _flatten(
                params[top], top + "."))
    layer = 0
    for seg, stacked in zip(plan_segments(cfg), params["segments"],
                            strict=True):
        for rep in range(seg.reps):
            for j in range(len(seg.specs)):
                for name, leaf in _flatten(stacked[j], f"blocks.{layer}."):
                    out[name] = np.asarray(leaf)[rep]
                layer += 1
    if "encoder" in params:
        enc = params["encoder"]
        (stacked,) = enc["blocks"]
        for layer in range(cfg.encoder_layers):
            for name, leaf in _flatten(stacked, f"encoder.blocks.{layer}."):
                out[name] = np.asarray(leaf)[layer]
        out.update((n, np.asarray(a)) for n, a in _flatten(
            enc["final_norm"], "encoder.final_norm."))
    return out


def _lists(tree):
    """Nested dicts keyed "0", "1", ... (a checkpoint read with
    ``ckpt.read_tree``) back to the lists the JAX tree holds."""
    if isinstance(tree, dict):
        out = {k: _lists(v) for k, v in tree.items()}
        if out and all(k.isdigit() for k in out) and \
                sorted(int(k) for k in out) == list(range(len(out))):
            return [out[str(i)] for i in range(len(out))]
        return out
    if isinstance(tree, (list, tuple)):
        return [_lists(v) for v in tree]
    return tree


def lm_params(params: dict, cfg: ModelConfig) -> dict:
    """The JAX package's LM parameters (``repro.models.init_params``'s tree,
    leaves as numpy arrays) as a state dict of the port's ``Transformer``
    for ``cfg`` (CPU tensors; ``load_state_dict`` casts and moves them)."""
    return {name: from_numpy(a) for name, a in
            _unstack(_lists(params), cfg).items()}


def train_state(params: dict, opt_state: dict, step, cfg: ModelConfig, *,
                device=None) -> TrainState:
    """The JAX package's ``TrainState`` (its ``params``, its ``opt_state``
    with ``step`` and the moment trees, e.g. ``m`` and ``v`` of AdamW, and
    its ``step``; leaves as numpy arrays, as ``jax.tree_util.tree_map(
    np.asarray, ...)`` or ``ckpt.read_tree`` of a JAX checkpoint give them)
    as the port's: trainable weights on ``device``, each moment unstacked
    like the weights (``lm_params``) and keyed by parameter name, in
    float32 on ``device``."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    model.load_state_dict(lm_params(params, cfg))
    model.requires_grad_(True)
    opt = {"step": torch.tensor(int(np.asarray(opt_state["step"])),
                                dtype=torch.int32)}
    for name, tree in opt_state.items():
        if name == "step":
            continue
        opt[name] = {k: from_numpy(a).to(device=dev, dtype=torch.float32)
                     for k, a in _unstack(_lists(tree), cfg).items()}
    return TrainState(model, opt, int(np.asarray(step)))
