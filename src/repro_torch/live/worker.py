"""Live worker: executes assigned task rows sequentially, streaming one
``result`` message per completed message group; counterpart of
``repro.live.worker``.

With a shared ``seed`` each of the ``n`` workers draws the SAME full
``(rounds, n, r)`` delay tables (``sample_delay_tables``) and consumes only
its own machine row ``w``.  Delays belong to the MACHINE (worker-major
order), matching the engine's convention — the master applies the
scheduling permutation.  The tables come from the engine's own recording
pass (``montecarlo._capture_tables`` for trial id 0), so they agree bit for
bit with the trace ``sweep_rounds(process, trials=1, seed=seed,
record_trace=True)`` captures on the same device, and the live run's
recorded trace replays bit-exactly through the engine.

Virtual time vs. wall clock: delays are always *virtual* float32 values
from the delay process.  With ``time_scale == 0`` the worker computes as
fast as it can (semantics only — results, closes, and traces are
unchanged); with ``time_scale > 0`` each virtual unit costs that many wall
seconds, so deadline closes actually race the compute.
"""
from __future__ import annotations

import asyncio
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import montecarlo
from ..core.cluster import as_process
from ..core.montecarlo import message_boundaries
from ..core.spec import RoundConfig
from ..device import resolve_device
from .comm import CommClosedError, connect
from .protocol import (CLOSE, HELLO, RESULT, ROUND, ROUND_DONE, SHUTDOWN,
                       WELCOME)

__all__ = ["run_worker", "sample_delay_tables"]


def sample_delay_tables(process, seed: int, rounds: int, n: int, r: int, *,
                        device=None) -> Tuple[np.ndarray, np.ndarray]:
    """The full ``(rounds, n, r)`` float32 delay tables of trial id 0, drawn
    on ``device`` (the card by default) by the engine's own recording pass
    (``montecarlo._capture_tables``), not by a re-implementation of the
    draws: they equal ``sweep_rounds(..., trials=1, seed=seed,
    record_trace=True).trace`` on the same device bit for bit."""
    process = as_process(process)
    process.check_rounds(rounds)
    tids = torch.zeros(1, dtype=torch.int64, device=resolve_device(device))
    T1, T2 = montecarlo._capture_tables(process, n, r, rounds, seed, tids)
    return T1[:, 0], T2[:, 0]


async def _guarded(coro, comm) -> None:
    """Run one round's execution; a crash mid-round closes the channel (the
    master sees a dead worker instead of waiting forever) and re-raises
    when the round task is awaited."""
    try:
        await coro
    except asyncio.CancelledError:
        raise
    except CommClosedError:
        pass
    except BaseException:
        await comm.aclose()
        raise


async def _delayed_send(comm, msg: dict, delay_s: float,
                        close_evt: asyncio.Event, abort: bool) -> int:
    if delay_s > 0:
        await asyncio.sleep(delay_s)
    if abort and close_evt.is_set():
        return 0                       # message still in t2 flight: dropped
    try:
        await comm.send(msg)
    except CommClosedError:
        return 0
    return 1


async def _execute_round(comm, cfg: RoundConfig, msg: dict, t1: np.ndarray,
                         t2: np.ndarray, time_scale: float, abort: bool,
                         close_evt: asyncio.Event, worker: int) -> None:
    t = int(msg["round"])
    tasks = [int(x) for x in msg["tasks"]]
    load = len(tasks)
    eps = float(cfg.comm_eps)
    sent = 0
    aborted = False
    stalled = False
    sends: List[asyncio.Task] = []

    if load:
        # worker-local message grouping: load l -> min(budget, l) messages,
        # same split as the engine's per-worker slot map
        budget = min(cfg.messages or load, load)
        bounds = [int(b) for b in message_boundaries(load, budget)]
        closing = {b: li for li, b in enumerate(bounds)}
        elapsed = 0.0
        for j in range(load):
            if abort and close_evt.is_set():
                aborted = True
                break
            dt = float(t1[j])
            if not math.isfinite(dt):
                stalled = True         # slot never completes; row is stuck
                break
            if time_scale > 0:
                if abort:
                    try:
                        await asyncio.wait_for(close_evt.wait(),
                                               timeout=dt * time_scale)
                        aborted = True
                        break
                    except asyncio.TimeoutError:
                        pass
                else:
                    await asyncio.sleep(dt * time_scale)
            elapsed += dt
            li = closing.get(j)
            if li is None:
                continue
            d2 = float(t2[j])
            if not math.isfinite(d2):
                continue               # this message never arrives
            j0 = bounds[li - 1] + 1 if li else 0
            res = {"type": RESULT, "round": t, "worker": worker, "msg": li,
                   "slots": [j0, j], "tasks": tasks[j0:j + 1],
                   "t1": [float(x) for x in t1[:j + 1]], "t2": d2,
                   "arrival": elapsed + d2 + (li + 1) * eps}
            if time_scale > 0:
                sends.append(asyncio.create_task(_delayed_send(
                    comm, res, d2 * time_scale, close_evt, abort)))
            else:
                try:
                    await comm.send(res)
                    sent += 1
                except CommClosedError:
                    break
    if sends:
        sent += sum(await asyncio.gather(*sends))
    try:
        await comm.send({"type": ROUND_DONE, "round": t, "sent": sent,
                         "aborted": aborted, "stalled": stalled})
    except CommClosedError:
        pass


async def run_worker(address: str, process, *, device=None) -> None:
    """Connect to the master at ``address`` and serve rounds until
    ``shutdown`` (or the master hangs up).  The delay tables are drawn on
    ``device`` (the card by default)."""
    comm = await connect(address)
    try:
        await comm.send({"type": HELLO})
        welcome = await comm.recv()
        if welcome.get("type") != WELCOME:
            raise RuntimeError(f"expected welcome, got {welcome!r}")
        cfg = RoundConfig.from_dict(welcome["config"])
        w = int(welcome["worker"])
        rounds = int(welcome["rounds"])
        time_scale = float(welcome["time_scale"])
        abort = bool(welcome["abort_on_close"])
        T1, T2 = sample_delay_tables(process, cfg.seed, rounds, cfg.n,
                                     cfg.width, device=device)
        current: Optional[asyncio.Task] = None
        close_evt = asyncio.Event()
        cur_round = -1
        while True:
            try:
                msg = await comm.recv()
            except CommClosedError:
                break
            mt = msg.get("type")
            if mt == ROUND:
                if current is not None:
                    await current
                cur_round = int(msg["round"])
                close_evt = asyncio.Event()
                current = asyncio.create_task(_guarded(_execute_round(
                    comm, cfg, msg, T1[cur_round, w], T2[cur_round, w],
                    time_scale, abort, close_evt, w), comm))
            elif mt == CLOSE:
                if int(msg["round"]) == cur_round:
                    close_evt.set()
            elif mt == SHUTDOWN:
                if current is not None:
                    await current
                break
        if current is not None:
            if not current.done():
                current.cancel()
            try:
                await current            # surface a mid-round crash
            except asyncio.CancelledError:
                pass
    finally:
        await comm.aclose()
