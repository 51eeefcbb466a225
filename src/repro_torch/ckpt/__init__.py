"""Checkpoints of the port (counterpart of ``repro.ckpt``)."""
from .checkpoint import (from_numpy, latest_checkpoint, load_checkpoint,
                         read_tree, save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "read_tree", "from_numpy"]
