"""Live master: drives rounds over any ``Comm`` transport, closing each
round at ``k`` distinct results (or at the deadline under the configured
fallback policy), feeding censored arrival feedback to the adaptive
scheduler, and recording every run as a replayable ``DelayTrace``;
counterpart of ``repro.live.master``.

Authoritative statistics come from the ASSEMBLED delay tables, scored on
the master's device with the engine's own arithmetic (the bucket evaluator
``montecarlo._build_bucket_eval``, through the evaluator cache, at the
engine's ``(1, n, r)`` chunk shape): ``s = cumsum(T1) + T2`` as the left
fold ``slot_arrival_times`` (eq. 1), the gather plan for per-task arrivals
(eq. 2), ``topk`` for the k-th order statistic.  Cells never covered by a
received message stay +inf — fault-censoring semantics, a version-2
trace.  Because the recorded tables are exactly the scorer's input,
``sweep_rounds(TraceProcess(result.trace), trials=1)`` reproduces
``result.per_round`` bit-for-bit for static configs (adaptive runs
re-derive greedy decisions on replay, so they match in distribution, not
bitwise).  An adaptive master's ``AdaptiveScheduler`` runs its greedy pick
loop on the same device: on the card, one ``greedy_assign`` kernel launch
a round.

Round-close protocol: the master counts distinct tasks over incoming
``result`` messages (under a closing deadline policy, only messages whose
virtual arrival beats the deadline count) and broadcasts ``close`` at
``k``; with ``time_scale > 0`` a wall-clock timer additionally enforces
the deadline.  It then keeps draining until every worker's ``round_done``
(a dropped connection counts as done — the dead worker's cells stay +inf),
so late in-flight results still land in the trace.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import montecarlo as mc
from ..core import scheduling
from ..core.spec import RoundConfig
from ..core.trace import DelayTrace
from ..device import resolve_device
from .comm import Comm, CommClosedError, Listener, listen
from .protocol import (CLOSE, HELLO, RESULT, ROUND, ROUND_DONE, SHUTDOWN,
                       WELCOME)
from .worker import run_worker

__all__ = ["Master", "LiveResult", "RoundReport", "run_live"]

_INPROC_SEQ = itertools.count()


@dataclasses.dataclass
class RoundReport:
    """One round's outcome, as the master saw it."""
    round: int
    t_done: float            # effective completion (deadline-capped)
    realized: int            # distinct results that made the round
    missed: bool             # blew the deadline (policy-dependent meaning)
    closed_early: bool       # master broadcast ``close`` before all done
    results: int             # result messages received (incl. post-close)
    stalled: int             # workers that reported a stuck slot
    dead: int                # connections lost by the end of the round


@dataclasses.dataclass
class LiveResult:
    """A live run: per-round completion times + the recorded trace."""
    config: RoundConfig
    per_round: np.ndarray    # (rounds,) float64 effective completion times
    realized: np.ndarray     # (rounds,) int distinct results per round
    missed: np.ndarray       # (rounds,) bool deadline misses
    trace: DelayTrace        # (rounds, 1, n, r) float32, +inf = censored
    reports: List[RoundReport]

    @property
    def mean(self) -> float:
        return float(self.per_round.mean())


def _make_scorer(cfg: RoundConfig, device: torch.device):
    """``(T1, T2, row_of_worker, loads_w) -> (v, tau, arr_w)`` over one
    round's machine-major (n, r) tables, computed on ``device`` — the
    arithmetic the engine and the aggregator's ``round_mask`` run, at the
    engine's (1, n, r) chunk shape, so a recorded trace replays
    bit-exactly.

    ``v`` is the k-th distinct-task arrival (float32 scalar), ``tau`` the
    per-task arrivals (n,), ``arr_w`` the worker-major per-slot message
    arrivals (the censored-feedback signal, the aggregator's ``arr_w =
    s2[row_of_worker]``); each comes back as numpy."""
    n, r = cfg.n, cfg.width
    if cfg.adaptive:
        base = cfg.base_matrix()
        if cfg.rebalance:
            sp_v = mc.to_spec("v", base)
            sp_tau = mc.tau_spec("tau", base)
        else:
            sp_v = mc.to_spec("v", base, messages=cfg.messages,
                              loads=cfg.loads)
            sp_tau = mc.tau_spec("tau", base, messages=cfg.messages,
                                 loads=cfg.loads)
    else:
        sp_v = cfg.to_scheme_spec("v")
        sp_tau = mc.tau_spec("tau", cfg.base_matrix(),
                             messages=cfg.messages, loads=cfg.loads,
                             comm_eps=cfg.comm_eps)
    sig, params, slots = mc._eval_layout((sp_v, sp_tau), n, r, cfg.k)
    # the live scorer holds no delay model: its cache entry is the bucket
    # evaluator alone, one per (bucket, device)
    eval_fn = mc._cached(mc._EXEC_CACHE, (sig, "live", device),
                         lambda: mc._build_bucket_eval(sig))
    pt = mc.params_on(params, device)
    g_v, i_v = slots["v"]
    g_tau, i_tau = slots["tau"]
    mmap = mc._slot_map_of(sp_v)
    mm_t = None if mmap is None else mc._index_on(mmap, device)
    rebalance = cfg.rebalance
    cols = torch.arange(r, device=device)[None, :]

    def score(T1, T2, row_of_worker, loads_w):
        T1 = torch.as_tensor(T1, dtype=torch.float32, device=device)
        T2 = torch.as_tensor(T2, dtype=torch.float32, device=device)
        row_of = mc._index_on(row_of_worker, device)
        # eq. 1 at the engine's (chunk=1, n, r) shape
        s = mc.slot_arrival_times(T1[None], T2[None])[0]
        worker_of_row = torch.argsort(row_of)
        s2 = s[worker_of_row]                            # row-major arrivals
        if mm_t is None:
            arr2 = s2
        elif mm_t.dim() == 1:
            arr2 = s2[..., mm_t]
        else:
            arr2 = torch.take_along_dim(s2, mm_t, dim=-1)
        if rebalance:
            l_row = mc._index_on(loads_w, device)[worker_of_row]
            live_slots = cols < l_row[:, None]
            s2 = torch.where(live_slots, s2, mc.INF)
            arr2 = torch.where(live_slots, arr2, mc.INF)
        out = eval_fn(s2[None], pt)
        return (np.float32(out[g_v][0, i_v, -1].item()),
                out[g_tau][0, i_tau].cpu().numpy(),
                arr2[row_of].cpu().numpy())

    return score


def _make_scheduler(cfg: RoundConfig, device: torch.device):
    """The adaptive scheduler exactly as ``StragglerAggregator`` builds it,
    on ``device`` (or None for static schedules)."""
    if not cfg.adaptive:
        return None
    kw = dict(beta=cfg.feedback_beta, gamma=cfg.coverage_gamma,
              device=device)
    if cfg.dead_after is not None:
        kw.update(dead_after=cfg.dead_after, target_k=cfg.k)
    if cfg.rebalance:
        return scheduling.AdaptiveScheduler(cfg.base_matrix(),
                                            loads=cfg.loads, rebalance=True,
                                            **kw)
    return scheduling.AdaptiveScheduler(cfg.to_matrix(), **kw)


async def _pump(w: int, comm: Comm, queue: asyncio.Queue) -> None:
    """Forward every message from worker ``w`` into the central queue;
    ``(w, None)`` marks a dropped connection."""
    try:
        while True:
            queue.put_nowait((w, await comm.recv()))
    except CommClosedError:
        queue.put_nowait((w, None))


class Master:
    """Owns ``n`` worker connections and runs ``rounds`` rounds.

    ``time_scale`` maps virtual delay units to wall seconds (0 = as fast
    as possible: semantics identical, no waiting); ``abort_on_close``
    tells workers to cancel outstanding work when the round closes (real
    cluster behavior — leaves +inf holes in the trace) or to finish and
    deliver everything (dense tables: the live run then matches
    ``sweep_rounds(process, trials=1, seed)`` exactly).  ``device`` is
    where the master scores rounds and schedules: the card by default
    (``RuntimeError`` without one), ``"cpu"`` on request.
    """

    def __init__(self, config: RoundConfig, *, rounds: int,
                 listener: Listener, time_scale: float = 0.0,
                 abort_on_close: bool = True, device=None):
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        self.config = config
        self.rounds = int(rounds)
        self.listener = listener
        self.time_scale = float(time_scale)
        self.abort_on_close = bool(abort_on_close)
        self.device = resolve_device(device)
        self.scheduler = _make_scheduler(config, self.device)
        self._score = _make_scorer(config, self.device)
        self._comms: Dict[int, Comm] = {}

    async def _handshake(self) -> None:
        cfg_dict = self.config.to_dict()
        for w in range(self.config.n):
            comm = await self.listener.accept()
            hello = await comm.recv()
            if hello.get("type") != HELLO:
                raise RuntimeError(f"expected hello, got {hello!r}")
            await comm.send({"type": WELCOME, "worker": w,
                             "config": cfg_dict, "rounds": self.rounds,
                             "time_scale": self.time_scale,
                             "abort_on_close": self.abort_on_close})
            self._comms[w] = comm

    async def _broadcast(self, msg: dict, alive: Optional[set] = None):
        for w, comm in self._comms.items():
            if alive is not None and w not in alive:
                continue
            try:
                await comm.send(msg)
            except CommClosedError:
                pass

    def _plan_round(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(C_eff worker-major, row_of_worker, loads_w) for the coming
        round — adaptive schedules ask the scheduler, static ones reuse
        the config's matrix."""
        cfg = self.config
        if self.scheduler is None:
            return cfg.to_matrix(), np.arange(cfg.n), cfg.load_vector
        C_eff = self.scheduler.matrix()
        row_of_worker = self.scheduler.row_of_worker()
        loads_w = (self.scheduler.loads() if cfg.rebalance
                   else cfg.load_vector)
        return C_eff, row_of_worker, loads_w

    async def run(self) -> LiveResult:
        cfg = self.config
        n, r, k = cfg.n, cfg.width, cfg.k
        DL = None if cfg.deadline is None else np.float32(cfg.deadline)
        closing = cfg.deadline is not None and cfg.deadline_policy != "wait"

        await self._handshake()
        queue: asyncio.Queue = asyncio.Queue()
        pumps = [asyncio.create_task(_pump(w, c, queue))
                 for w, c in self._comms.items()]
        dead: set = set()
        T1_all = np.full((self.rounds, n, r), np.inf, np.float32)
        T2_all = np.full((self.rounds, n, r), np.inf, np.float32)
        per_round = np.zeros(self.rounds, np.float64)
        realized_a = np.zeros(self.rounds, np.int64)
        missed_a = np.zeros(self.rounds, bool)
        reports: List[RoundReport] = []

        try:
            for t in range(self.rounds):
                C_eff, row_of_worker, loads_w = self._plan_round()
                alive = set(range(n)) - dead
                expect = np.zeros((n, r), bool)     # cells a full round fills
                for w in alive:
                    row = [int(x) for x in C_eff[w] if x >= 0]
                    expect[w, :len(row)] = True
                    await self._comms[w].send(
                        {"type": ROUND, "round": t,
                         "row": int(row_of_worker[w]), "tasks": row,
                         "load": len(row)})
                T1_tab = T1_all[t]
                T2_tab = T2_all[t]
                got_tasks: set = set()
                done: set = set(dead)
                closed = False
                n_results = 0
                n_stalled = 0
                timer: Optional[asyncio.TimerHandle] = None
                if closing and self.time_scale > 0:
                    loop = asyncio.get_running_loop()
                    timer = loop.call_later(
                        float(DL) * self.time_scale,
                        lambda: queue.put_nowait((-1, {"type": "_deadline"})))
                while len(done) < n:
                    w, msg = await queue.get()
                    if msg is None:
                        dead.add(w)
                        done.add(w)
                        continue
                    mt = msg.get("type")
                    if mt == "_deadline":
                        if not closed:
                            closed = True
                            await self._broadcast({"type": CLOSE,
                                                   "round": t}, alive)
                        continue
                    if int(msg.get("round", -1)) != t:
                        continue               # stray late message
                    if mt == RESULT:
                        n_results += 1
                        t1 = np.asarray(msg["t1"], np.float32)
                        T1_tab[w, :t1.size] = t1
                        j1 = int(msg["slots"][1])
                        T2_tab[w, j1] = np.float32(msg["t2"])
                        arr = float(msg["arrival"])
                        if not closing or arr <= float(DL):
                            got_tasks.update(int(x) for x in msg["tasks"])
                        if not closed and len(got_tasks) >= k:
                            closed = True
                            await self._broadcast({"type": CLOSE,
                                                   "round": t}, alive)
                    elif mt == ROUND_DONE:
                        done.add(w)
                        n_stalled += int(bool(msg.get("stalled")))
                if timer is not None:
                    timer.cancel()

                # ---- authoritative stats from the assembled tables ------
                v, tau, arr_w = self._score(T1_tab, T2_tab,
                                            np.asarray(row_of_worker),
                                            np.asarray(loads_w))
                if closing:                    # mirror engine _policy_close
                    v_eff = min(v, DL)
                    by = int((tau <= DL).sum())
                    realized = min(by, k)
                    missed = by < k
                elif DL is not None:           # wait: flag, don't cap
                    v_eff = v
                    realized = min(int(np.isfinite(tau).sum()), k)
                    missed = not (v <= DL)
                else:
                    v_eff = v
                    realized = min(int(np.isfinite(tau).sum()), k)
                    missed = False
                per_round[t] = float(v_eff)
                realized_a[t] = realized
                missed_a[t] = missed
                if self.scheduler is not None:
                    holes = not np.isfinite(T1_tab[expect]).all()
                    if cfg.censored_feedback or holes:
                        # a real master only sees what arrived in time;
                        # +inf holes additionally force censoring (a plain
                        # mean over a holey table would pin the EMA at inf)
                        self.scheduler.observe(T1_tab, arrivals=arr_w,
                                               t_done=float(v_eff))
                    else:
                        self.scheduler.observe(T1_tab)
                    if cfg.deadline_policy == "reissue":
                        delivered = ((tau <= np.float32(v_eff))
                                     & np.isfinite(tau))
                        self.scheduler.set_need(~delivered)
                reports.append(RoundReport(
                    round=t, t_done=float(v_eff), realized=realized,
                    missed=missed, closed_early=closed, results=n_results,
                    stalled=n_stalled, dead=len(dead)))
            await self._broadcast({"type": SHUTDOWN})
        finally:
            for p in pumps:
                p.cancel()
            for comm in self._comms.values():
                await comm.aclose()

        trace = DelayTrace(T1_all, T2_all, meta={
            "source": "live", "config": cfg.to_dict(),
            "rounds": self.rounds, "time_scale": self.time_scale,
            "abort_on_close": self.abort_on_close})
        return LiveResult(config=cfg, per_round=per_round,
                          realized=realized_a, missed=missed_a,
                          trace=trace, reports=reports)


async def _run_live_async(config: RoundConfig, process, rounds: int, *,
                          address: Optional[str] = None,
                          time_scale: float = 0.0,
                          abort_on_close: bool = True,
                          device=None) -> LiveResult:
    device = resolve_device(device)
    if address is None:
        address = f"inproc://live-{next(_INPROC_SEQ)}"
    listener = await listen(address)
    workers: List[asyncio.Task] = []
    try:
        master = Master(config, rounds=rounds, listener=listener,
                        time_scale=time_scale,
                        abort_on_close=abort_on_close, device=device)
        workers = [asyncio.create_task(run_worker(listener.address, process,
                                                  device=device))
                   for _ in range(config.n)]
        result = await master.run()
        await asyncio.gather(*workers)
    finally:
        for wt in workers:
            wt.cancel()
        await asyncio.gather(*workers, return_exceptions=True)
        await listener.aclose()
    return result


def run_live(config: RoundConfig, process, rounds: int, *,
             address: Optional[str] = None, time_scale: float = 0.0,
             abort_on_close: bool = True, device=None) -> LiveResult:
    """One-call live run: listener + ``config.n`` in-process workers + a
    master, all on a private event loop.  ``process`` is any delay source
    accepted by ``cluster.as_process`` (parametric or a replayed trace).
    The workers draw their tables and the master scores and schedules on
    ``device``: the card by default (``RuntimeError`` without one),
    ``"cpu"`` on request.

    With the defaults (``inproc`` transport, ``time_scale=0``) the run is
    deterministic and the recorded trace is dense: ``result.per_round``
    equals ``sweep_rounds(process, trials=1, seed=config.seed,
    record_trace=True)`` on the same device exactly.  Pass
    ``address="tcp://host:0"`` to exercise the TCP transport (workers
    connect to the ephemeral bound port), ``time_scale > 0`` to race real
    wall-clock deadlines."""
    return asyncio.run(_run_live_async(
        config, process, rounds, address=address, time_scale=time_scale,
        abort_on_close=abort_on_close, device=device))
