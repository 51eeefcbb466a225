"""Trial-axis sharding of the Monte-Carlo sweeps over several devices;
counterpart of the trial part of ``repro.sharding`` (``trial_devices``,
``TRIAL_AXIS`` and the layout of ``trial_mesh`` / ``shard_trials``).

The JAX package vmaps a chunk scan over a device axis and lets GSPMD split
it.  The port deals whole chunks instead: the global chunk sequence is cut
into contiguous blocks, one a device (``chunk_blocks``), each device runs
its block through the same per-chunk scans as one device would, and the
float32 per-chunk partials are combined on the host in float64 in global
chunk order.  A chunk's partials depend on its trial ids and its length
alone, so a sharded result equals the one-device result bit for bit on
devices of one type.  Launches on different cards from one host thread
are asynchronous, so ``issue_order`` interleaves the blocks (chunk 0 of
every block, then chunk 1, ...) to start every device early.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .device import resolve_device

__all__ = ["TRIAL_AXIS", "trial_devices", "chunk_blocks", "issue_order",
           "device_label", "cli_devices"]

TRIAL_AXIS = "trials"


def _canonical(dev: torch.device) -> torch.device:
    """``cuda`` without an index names the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def trial_devices(devices=None) -> Tuple[torch.device, ...]:
    """Resolve the ``devices`` argument of the sweeps, as the JAX package's
    ``trial_devices``: ``None`` means every local CUDA device; an int the
    first that many CUDA devices (``ValueError`` outside ``1..count``); a
    sequence is taken as it is, repeats included (``["cpu"] * 4`` runs
    four blocks on the CPU); a single device name or ``torch.device`` is
    that one device.  A list that mixes the CPU and CUDA is refused, and a
    CUDA device asked for without one raises, as ``resolve_device`` does:
    there is no fallback to the CPU."""
    if devices is None:
        resolve_device(None)
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if isinstance(devices, bool):
        raise ValueError(f"devices must be None, an int or devices, got "
                         f"{devices!r}")
    if isinstance(devices, int):
        count = torch.cuda.device_count()
        if not 1 <= devices <= count:
            raise ValueError(
                f"devices must be in 1..{count} (local CUDA device count), "
                f"got {devices}; name the devices (e.g. 'cpu') to run "
                f"elsewhere")
        return tuple(torch.device("cuda", i) for i in range(devices))
    if isinstance(devices, (str, torch.device)):
        devices = (devices,)
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("devices must name at least one device")
    kinds = sorted({d.type for d in devs})
    if len(kinds) > 1:
        raise ValueError(f"devices mix device types {kinds}: a sharded "
                         f"sweep is bit-exact only on devices of one type")
    return tuple(_canonical(resolve_device(d)) for d in devs)


def chunk_blocks(n_chunks: int, n_devices: int) -> List[range]:
    """The contiguous block of global chunk indices each device runs: the
    JAX package's layout, ``d_eff = min(n_devices, n_chunks)`` devices,
    the chunk count padded up to a multiple of ``d_eff`` and dealt
    ``nc_pad / d_eff`` a device.  The padded chunks hold no real trial and
    are not run, so the last blocks may be short or empty."""
    d_eff = min(int(n_devices), int(n_chunks))
    per = -(-int(n_chunks) // d_eff)
    return [range(j * per, min((j + 1) * per, n_chunks))
            for j in range(d_eff)]


def issue_order(n_chunks: int, devices: Sequence[torch.device]
                ) -> List[Tuple[int, torch.device]]:
    """``(global chunk index, device)`` pairs in the order they are issued:
    the blocks of ``chunk_blocks`` interleaved, one chunk of each in
    turn."""
    blocks = chunk_blocks(n_chunks, len(devices))
    out = []
    for step in range(max(len(b) for b in blocks)):
        for dev, block in zip(devices, blocks):
            if step < len(block):
                out.append((block[step], dev))
    return out


def device_label(devices: Sequence[torch.device]) -> str:
    """The device list as a run's artifact records it: ``"cpu"`` or
    ``"cuda:0"`` for one device, the names joined by commas for more."""
    return ",".join(str(_canonical(torch.device(d))) for d in devices)


def cli_devices(device: str, count=None):
    """The ``devices`` argument that the CLIs' ``--device`` and
    ``--devices N`` name: the device alone; with a count, the first N cards
    under ``cuda``, else the named device N times (``cpu`` x 4 runs four
    blocks on the CPU)."""
    if count is None:
        return device
    if device == "cuda":
        return int(count)
    return [device] * int(count)
