"""Mesh dry runs at the smoke configs and ``test_torch_dryrun.SMALL``'s
shapes, for ``tests/test_torch_dryrun.py``: a mesh starts the fake
process group, global state, so the three groups run in a process of
their own, one after another, the group of each taken down before the
next starts its own:

* ``pod``: every mesh variant on the 16x16 mesh (``zero1`` on the train
  round, ``grouped``, ``batchshard``, ``puredp`` and ``ringdecode`` on the
  decode step of mistral-nemo-12b's smoke config, every layer full
  attention), its two baselines, and gemma3-4b's prefill (the swa
  kernel's op under its DTensor rule);
* ``multipod``: the CLI's ``--multi-pod`` decode step of phi4-mini-3.8b;
* ``local``: mistral-nemo-12b's train round, prefill and decode on a
  1 x 2 mesh (model axis 2), its one-layer prefill (tag ``onelayer``),
  its decode with one KV head (tag ``kv1``, baseline and ``grouped``:
  the head repeated once, to one a rank, before the cache is exchanged),
  and its sliding-window prefill with one KV head (the swa op's rule
  refuses q's heads sharded where k's are not: ``swa_refused.txt``
  holds the error).

Usage: ``python torch_mesh_dryrun.py OUT_DIR``.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import torch.distributed as dist

from repro_torch import configs as tconfigs
from repro_torch.configs import cli_config
from repro_torch.launch import dryrun
from test_torch_dryrun import SMALL

ARCH = "mistral-nemo-12b"
POD_RUNS = (("zero1", "train_4k"), ("grouped", "decode_32k"),
            ("batchshard", "decode_32k"), ("puredp", "decode_32k"),
            ("ringdecode", "decode_32k"))


def _small(layers: int | None = None, kv_heads: int | None = None,
           window: int | None = None) -> None:
    tconfigs.SHAPES.update(SMALL)
    dryrun.SHAPES.update(SMALL)

    def cfg(arch):
        c = cli_config(arch, smoke=True)
        if layers is not None:
            c = dataclasses.replace(c, n_layers=layers)
        if kv_heads is not None:
            c = dataclasses.replace(c, n_kv_heads=kv_heads)
        if window is not None:
            c = dataclasses.replace(c, sliding_window=window,
                                    local_global_pattern=(1, 0))
        return c

    dryrun.get_config = cfg


def run_group(group: str, out: str) -> None:
    _small()
    if group == "pod":
        for variant, shape in POD_RUNS:
            dryrun.run_one(ARCH, shape, variant=variant, mesh="16x16",
                           out_dir=out)
        for shape in ("train_4k", "decode_32k"):      # the baselines
            dryrun.run_one(ARCH, shape, mesh="16x16", out_dir=out)
        dryrun.run_one("gemma3-4b", "prefill_32k", mesh="16x16",
                       out_dir=out)
    elif group == "multipod":
        dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "decode_32k",
                     "--multi-pod", "--out-dir", out])
    elif group == "local":
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            dryrun.run_one(ARCH, shape, mesh="1x2", out_dir=out)
        _small(kv_heads=1)
        for variant in ("", "grouped"):
            dryrun.run_one(ARCH, "decode_32k", mesh="1x2", out_dir=out,
                           variant=variant, tag="kv1" + variant)
        _small(kv_heads=1, window=32)
        try:
            dryrun.run_one(ARCH, "prefill_32k", mesh="1x2", out_dir="")
        except RuntimeError as e:
            with open(os.path.join(out, "swa_refused.txt"), "w") as f:
                f.write(str(e))
        _small(layers=1)
        dryrun.run_one(ARCH, "prefill_32k", mesh="1x2", out_dir=out,
                       tag="onelayer")
    else:
        raise ValueError(group)


def main(out: str) -> None:
    for group in ("local", "pod", "multipod"):
        run_group(group, out)
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
