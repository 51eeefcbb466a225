"""PyTorch/CUDA port of the straggler-scheduling system, held against the
JAX package ``repro`` (which it never imports).

Layout mirrors ``repro``: ``core`` (delays, schedules, completion times,
the single-round Monte-Carlo engine, coded baselines, the aggregator),
``kernels`` (hand-written Hopper kernels, their plain versions and
wrappers), ``data`` and ``configs``; ``dgd`` is the paper's Sec. VI
regression loop and ``convert`` carries the JAX side's state across.
Everything runs on the CUDA card unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
