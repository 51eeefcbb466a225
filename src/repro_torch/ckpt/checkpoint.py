"""npz checkpoints of the port (counterpart of ``repro.ckpt.checkpoint``).

A tree is nested dicts, lists and tuples with tensors, numpy arrays or
Python numbers as leaves (``train.TrainState.tree`` gives a training
state's).  Each leaf is saved
under its path, the keys joined by ``|``.  bfloat16 leaves are written as
the JAX package writes them, raw two-byte ``|V2`` records, and read back
through a ``uint16`` view of the same bytes (``torch.Tensor.numpy``
refuses bfloat16).  Loading rebuilds the structure of a template, casting
each leaf to the template leaf's dtype and device.
"""
from __future__ import annotations

import os
import re
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "read_tree", "from_numpy"]

_SEP = "|"
_V2 = np.dtype("V2")


def _children(tree) -> Optional[Iterator[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return ((str(k), v) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    return None


def _leaves(tree, prefix: str = ""):
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from _leaves(child, f"{prefix}{_SEP}{key}" if prefix else key)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a numpy array; bfloat16 as ``|V2`` records of its bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(_V2)
        return t.numpy()
    return np.asarray(leaf)


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor copy of a numpy array; ``|V2`` records (and numpy's
    ``bfloat16`` of ``ml_dtypes``, as JAX hands its arrays over) become
    bfloat16 with the same bits."""
    if arr.dtype == _V2 or arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(path: str, tree, step: Optional[int] = None) -> str:
    """Save to ``path`` (".npz" appended if missing); with ``step``, to
    ``<path>-<step:08d>.npz``.  Returns the file's path."""
    if step is not None:
        path = f"{path}-{step:08d}"
    if not path.endswith(".npz"):
        path += ".npz"
    arrays = {k: _to_numpy(v) for k, v in _leaves(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    return path


def _restore(arr: np.ndarray, like, key: str):
    if tuple(arr.shape) != tuple(np.shape(like)):
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                         f"{tuple(np.shape(like))}")
    if torch.is_tensor(like):
        return from_numpy(arr).to(dtype=like.dtype, device=like.device)
    if isinstance(like, np.ndarray):
        return np.asarray(from_numpy(arr).to(torch.float32).numpy()
                          if arr.dtype == _V2 else arr, dtype=like.dtype)
    return type(like)(arr.item())


def _rebuild(tree, data, prefix: str):
    def key_of(k):
        return f"{prefix}{_SEP}{k}" if prefix else k

    if isinstance(tree, dict):
        return {k: _rebuild(v, data, key_of(str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, data, key_of(str(i)))
                          for i, v in enumerate(tree))
    if prefix not in data:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    return _restore(data[prefix], tree, prefix)


def load_checkpoint(path: str, template):
    """Restore into the structure of ``template``: each leaf takes the
    template leaf's shape (checked), dtype and device.  Raises ``KeyError`` for a
    missing leaf and ``ValueError`` for a shape mismatch."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as data:
        return _rebuild(template, data, "")


def read_tree(path: str) -> dict:
    """A checkpoint as nested dicts of numpy arrays, split at ``|`` (e.g.
    a JAX ``TrainState`` as ``{"0": params, "1": opt_state, "2": step}``,
    for ``convert.train_state``)."""
    if not path.endswith(".npz"):
        path += ".npz"
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            *inner, last = key.split(_SEP)
            for part in inner:
                node = node.setdefault(part, {})
            node[last] = data[key]
    return out


def latest_checkpoint(directory: str, prefix: str = "") -> Optional[str]:
    """The file ``<prefix>-<step>.npz`` in ``directory`` with the largest
    step, or None."""
    pat = re.compile(re.escape(prefix) + r"-(\d+)\.npz$")
    best, best_step = None, -1
    if not os.path.isdir(directory):
        return None
    for f in os.listdir(directory):
        m = pat.search(f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, f), int(m.group(1))
    return best
