"""Optimizers of the port (counterpart of ``repro.optim``)."""
from .optimizers import (Optimizer, adam, adamw, clip_by_global_norm,
                         clip_scale, constant_schedule, cosine_schedule,
                         global_norm, momentum, sgd)

__all__ = ["Optimizer", "sgd", "momentum", "adam", "adamw",
           "clip_by_global_norm", "clip_scale", "global_norm",
           "cosine_schedule", "constant_schedule"]
