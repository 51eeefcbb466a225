"""The port's live layer (``repro_torch.live``) against the JAX package's
(``repro.live``) on the CPU.

* Worker tables: ``sample_delay_tables`` is the port's engine recording
  (``sweep_rounds(..., trials=1, record_trace=True).trace``) bit for bit.
* Same tables in both packages: one JAX-recorded trace replayed through
  ``TraceProcess`` in each package (static CS, r <= 17, where the JAX
  package's cumsum is a left fold) gives the reference's ``per_round``,
  ``realized``, ``missed`` and trace tables bit for bit, without a
  deadline and under ``close_partial``.
* Adaptive runs: the per-round ``row_of_worker`` equals the reference's;
  a round where they part is named, with whether its first differing pick
  is an exact tie in real arithmetic (the check of
  tests/test_torch_greedy.py).
* The live run equals the port's engine, the live scorer equals the
  aggregator's ``round_mask``, TCP equals inproc, and mixed clusters (a
  JAX master with port workers, and the other way round) over
  ``tcp://127.0.0.1:0`` give the all-JAX run's ``per_round``.
* Trace files cross both ways; bad addresses raise; the lazy facade is the
  reference's; without a card the defaults raise.

Every cluster runs under ``asyncio.wait_for`` with a limit of its own, so a
hung socket fails its test and does not stall the suite.  The JAX runs are
shared through module fixtures at n <= 8 and 5 rounds."""
import asyncio

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.live as jlive
import repro_torch.core as tcore
import repro_torch.live as tlive
from repro.core import trace as jtrace
from repro.live import master as jmaster
from repro_torch.core import scheduling as tsched
from repro_torch.core import trace as ttrace
from repro_torch.live import master as tmaster

from test_torch_greedy import _exact_argmins

ROUNDS = 5
LIMIT_S = 60.0


def _run(coro):
    """One cluster run under its own time limit."""
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _port_live(cfg, process, **kw):
    return _run(tmaster._run_live_async(tcore.RoundConfig.from_dict(
        cfg.to_dict()), process, ROUNDS, device="cpu", **kw))


def _jax_live(cfg, process, **kw):
    return _run(jmaster._run_live_async(jcore.RoundConfig.from_dict(
        cfg.to_dict()), process, ROUNDS, **kw))


def _cfg(n, **kw):
    return jcore.RoundConfig(n=n, k=n - 2, kind="cs", r=2, seed=42, **kw)


def _port_trace(jt):
    return ttrace.DelayTrace(np.asarray(jt.T1), np.asarray(jt.T2))


@pytest.fixture(scope="module")
def jax_traces():
    """n -> a JAX-recorded trial-0 trace of a persistent-straggler
    cluster, ROUNDS rounds at r = 2."""
    out = {}
    for n in (4, 8):
        cfg = _cfg(n)
        rec = jcore.sweep_rounds(
            [cfg.to_scheme_spec("s")],
            jcore.ec2_cluster(n, spread=3.0, persistence=0.9, seed=1), n,
            rounds=ROUNDS, trials=1, k=cfg.k, seed=cfg.seed,
            record_trace=True)
        out[n] = rec.trace
    return out


@pytest.fixture(scope="module")
def jax_runs(jax_traces):
    """(n, policy) -> the JAX package's live run over its recorded trace;
    ``close_partial`` takes its deadline at the plain run's median."""
    out = {}
    for n, tr in jax_traces.items():
        plain = _jax_live(_cfg(n), jcore.TraceProcess(tr))
        out[n, None] = plain
        dl = float(np.quantile(plain.per_round, 0.5))
        out[n, "close_partial"] = _jax_live(
            _cfg(n, deadline=dl, deadline_policy="close_partial"),
            jcore.TraceProcess(tr))
    return out


def _assert_same_run(got, want):
    np.testing.assert_array_equal(got.per_round, want.per_round)
    np.testing.assert_array_equal(got.realized, want.realized)
    np.testing.assert_array_equal(got.missed, want.missed)
    np.testing.assert_array_equal(got.trace.T1, np.asarray(want.trace.T1))
    np.testing.assert_array_equal(got.trace.T2, np.asarray(want.trace.T2))


# --------------------------------- worker tables -------------------------------

PROCESSES = {
    "iid": lambda n: tcore.scenario1(),
    "markov": lambda n: tcore.ec2_cluster(n, spread=3.0, persistence=0.9,
                                          seed=1),
    "ar1": lambda n: tcore.AR1Process(
        base=tcore.scenario1(),
        worker_scale=tcore.heterogeneous_scales(n, 2.0, seed=3), rho=0.9,
        sigma=0.4),
    "preemption": lambda n: tcore.make_scenario(
        "preemption", tcore.ec2_cluster(n, seed=2), n),
}


@pytest.mark.parametrize("name", sorted(PROCESSES))
def test_worker_tables_are_the_engine_recording(name):
    n, r, seed = 6, 3, 11
    process = PROCESSES[name](n)
    T1, T2 = tlive.sample_delay_tables(process, seed, ROUNDS, n, r,
                                       device="cpu")
    rec = tcore.sweep_rounds(
        [tcore.to_spec("s", tcore.cyclic_to_matrix(n, r))], process, n,
        rounds=ROUNDS, trials=1, k=n - 1, seed=seed, record_trace=True,
        devices="cpu").trace
    assert T1.dtype == T2.dtype == np.float32
    np.testing.assert_array_equal(T1, rec.T1[:, 0])
    np.testing.assert_array_equal(T2, rec.T2[:, 0])


# ---------------------- the reference's tables, both packages -------------------

@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("policy", [None, "close_partial"])
def test_jax_trace_replay_equals_the_reference(n, policy, jax_traces,
                                               jax_runs):
    want = jax_runs[n, policy]
    kw = {}
    if policy is not None:
        kw = dict(deadline=want.config.deadline, deadline_policy=policy)
    got = _port_live(_cfg(n, **kw), ttrace.TraceProcess(
        _port_trace(jax_traces[n])))
    _assert_same_run(got, want)
    assert [r.closed_early for r in got.reports] == [
        r.closed_early for r in want.reports]
    assert [r.results for r in got.reports] == [
        r.results for r in want.reports]
    if policy is not None:
        assert 0 < int(got.missed.sum()) < ROUNDS
    assert got.trace.meta == {**want.trace.meta,
                              "config": got.config.to_dict()}


# ------------------------------------ the engine --------------------------------

@pytest.fixture(scope="module")
def port_process():
    return tcore.ec2_cluster(4, spread=3.0, persistence=0.9, seed=1)


@pytest.fixture(scope="module")
def port_live(port_process):
    return _port_live(_cfg(4), port_process)


def test_live_equals_the_engine_and_its_replay(port_process, port_live):
    cfg = tcore.RoundConfig.from_dict(_cfg(4).to_dict())
    spec = cfg.to_scheme_spec("s")
    kw = dict(rounds=ROUNDS, trials=1, k=cfg.k, seed=cfg.seed,
              devices="cpu")
    eng = tcore.sweep_rounds([spec], port_process, cfg.n,
                             record_trace=True, **kw)
    rep = tcore.sweep_rounds([spec], ttrace.TraceProcess(port_live.trace),
                             cfg.n, **kw)
    live32 = port_live.per_round.astype(np.float32)
    np.testing.assert_array_equal(live32, eng.per_round["s"].astype(
        np.float32))
    np.testing.assert_array_equal(live32, rep.per_round["s"].astype(
        np.float32))
    np.testing.assert_array_equal(port_live.trace.T1, eng.trace.T1)
    assert port_live.realized.tolist() == [cfg.k] * ROUNDS
    assert not port_live.missed.any()
    assert port_live.trace.meta["source"] == "live"
    for rep_ in port_live.reports:
        assert rep_.results >= cfg.k and not rep_.dead and not rep_.stalled
        assert rep_.t_done == port_live.per_round[rep_.round]


SCORER_CONFIGS = {
    "cs": dict(n=6, k=4, kind="cs", r=3),
    "ss_one_message": dict(n=6, k=5, kind="ss", r=3, messages=1),
    "cs_ragged_eps": dict(n=6, k=4, kind="cs", r=3, loads=(3, 1, 2, 3, 2, 1),
                          messages=2, comm_eps=1e-5),
}


@pytest.mark.parametrize("name", sorted(SCORER_CONFIGS))
def test_scorer_equals_round_mask_and_the_engine(name):
    """The master's scorer, the aggregator's ``round_mask`` and the rounds
    engine at trials = 1 read the same tables and give the same bits."""
    cfg = tcore.RoundConfig(**SCORER_CONFIGS[name])
    T1, T2 = tlive.sample_delay_tables(
        tcore.ec2_cluster(cfg.n, seed=4), 3, ROUNDS, cfg.n, cfg.width,
        device="cpu")
    trace = ttrace.DelayTrace(T1[:, None], T2[:, None])
    score = tmaster._make_scorer(cfg, torch.device("cpu"))
    agg = tcore.StragglerAggregator(cfg, ttrace.TraceProcess(trace),
                                    device="cpu")
    eng = tcore.sweep_rounds([cfg.to_scheme_spec("s")],
                             ttrace.TraceProcess(trace), cfg.n,
                             rounds=ROUNDS, trials=1, k=cfg.k,
                             devices="cpu")
    rows = np.arange(cfg.n)
    for t in range(ROUNDS):
        v, tau, arr_w = score(T1[t], T2[t], rows, cfg.load_vector)
        _, t_done = agg.round_mask(t)
        assert v.dtype == np.float32 and tau.shape == (cfg.n,)
        assert v == np.float32(t_done.item()), t
        assert v == np.float32(eng.per_round["s"][t]), t
        assert arr_w.shape == (cfg.n, cfg.width)
        assert np.isfinite(tau).all()


# --------------------------------- adaptive rounds -------------------------------

def _recording(master_cls):
    """``master_cls`` that keeps each round's (estimates, need, row of
    each worker, loads)."""
    class Recording(master_cls):
        def _plan_round(self):
            est = self.scheduler._effective_est()
            need = self.scheduler._need
            plan = super()._plan_round()
            self.log.append((None if est is None else np.array(est),
                             None if need is None else np.array(need),
                             np.array(plan[1]), np.array(plan[2])))
            return plan
    return Recording


async def _cluster(master_cls, listen, worker, cfg, wprocess, address,
                   mkw=None, wkw=None):
    """A master of ``master_cls`` at ``address`` and ``cfg.n`` workers
    (``worker(address, wprocess, **wkw)``) on this event loop."""
    listener = await listen(address)
    workers = []
    try:
        master = master_cls(cfg, rounds=ROUNDS, listener=listener,
                            **(mkw or {}))
        master.log = []
        workers = [asyncio.create_task(worker(listener.address, wprocess,
                                              **(wkw or {})))
                   for _ in range(cfg.n)]
        res = await master.run()
        await asyncio.gather(*workers)
    finally:
        for w in workers:
            w.cancel()
        await asyncio.gather(*workers, return_exceptions=True)
        await listener.aclose()
    return res, master.log


def _first_split_is_exact_tie(C, gamma, est, need, got, want):
    """Replay the port's picks; at the first pick where the two
    assignments part, whether both rows are exact argmins in real
    arithmetic."""
    C_tup = tuple(tuple(int(v) for v in row) for row in np.asarray(C))
    W, A = tsched._greedy_matrices(C_tup, gamma)
    n = W.shape[0]
    e = (np.ones(n, np.float32) if est is None
         else np.asarray(est, np.float32))
    order = np.argsort(e, kind="stable")
    epick = np.maximum(e[order], np.float32(1e-30))
    need_row = None if need is None else (
        (np.asarray(need)[None, :] & (A > 0)).sum(-1).astype(np.float32))
    cov = np.zeros(n, np.float32)
    taken = np.zeros(n, bool)
    for t in range(n):
        p_port = int(np.nonzero(got == order[t])[0][0])
        p_ref = int(np.nonzero(want == order[t])[0][0])
        if p_port != p_ref:
            return {p_port, p_ref} <= _exact_argmins(W, cov, taken,
                                                     need_row)
        taken[p_port] = True
        cov = cov + W[p_port] / epick[t]
    return False


ADAPTIVE = {
    "plain": dict(adaptive=True),
    "censored_reissue": dict(adaptive=True, censored_feedback=True,
                             deadline_policy="reissue"),
    "rebalance": dict(adaptive=True, censored_feedback=True, r=3,
                      loads=(2,) * 8, rebalance=True),
}


@pytest.mark.parametrize("name", sorted(ADAPTIVE))
def test_adaptive_rows_equal_the_reference(name, jax_traces, jax_runs):
    kw = dict(ADAPTIVE[name])
    r = kw.pop("r", 2)
    if kw.get("deadline_policy"):
        kw["deadline"] = float(np.quantile(jax_runs[8, None].per_round, 0.5))
    jt = jax_traces[8]
    if r != 2:                     # the rebalance cap: a wider JAX recording
        cfg0 = jcore.RoundConfig(n=8, k=6, kind="cs", r=r, seed=42)
        jt = jcore.sweep_rounds(
            [cfg0.to_scheme_spec("s")],
            jcore.ec2_cluster(8, spread=3.0, persistence=0.9, seed=1), 8,
            rounds=ROUNDS, trials=1, k=6, seed=42, record_trace=True).trace
    jcfg = jcore.RoundConfig(n=8, k=6, kind="cs", r=r, seed=42, **kw)
    tcfg = tcore.RoundConfig.from_dict(jcfg.to_dict())
    want, jlog = _run(_cluster(_recording(jlive.Master), jlive.listen,
                               jlive.run_worker, jcfg,
                               jcore.TraceProcess(jt), "inproc://jax-adapt"))
    got, tlog = _run(_cluster(
        _recording(tlive.Master), tlive.listen, tlive.run_worker, tcfg,
        ttrace.TraceProcess(_port_trace(jt)), "inproc://port-adapt",
        mkw={"device": "cpu"}, wkw={"device": "cpu"}))
    # the scheduler's inputs a round: delay estimates and reissue needs
    for t, (tl, jl) in enumerate(zip(tlog, jlog)):
        for what, a, b in (("estimates", tl[0], jl[0]),
                           ("need", tl[1], jl[1])):
            assert (a is None) == (b is None), (name, t, what)
            if a is not None:
                np.testing.assert_array_equal(
                    a, b, err_msg=f"{name}: {what} of round {t}")
    C = tcfg.base_matrix() if tcfg.rebalance else tcfg.to_matrix()
    differ, ties = [], []
    for t, ((est, need, rows_t, loads_t), (_, _, rows_j, loads_j)) in \
            enumerate(zip(tlog, jlog)):
        if not (np.array_equal(rows_t, rows_j)
                and np.array_equal(loads_t, loads_j)):
            differ.append(t)
            # worker_of_row = argsort(row_of_worker)
            if _first_split_is_exact_tie(C, tcfg.coverage_gamma, est, need,
                                         np.argsort(rows_t),
                                         np.argsort(rows_j)):
                ties.append(t)
    assert not differ, (f"{name}: row_of_worker differs in rounds {differ}"
                        f" (an exact tie at the first split in rounds "
                        f"{ties})")
    np.testing.assert_array_equal(got.per_round, want.per_round)
    np.testing.assert_array_equal(got.realized, want.realized)
    np.testing.assert_array_equal(got.trace.T1, np.asarray(want.trace.T1))
    assert len({tuple(x[2]) for x in tlog}) > 1 or name == "rebalance", (
        "the assignment never moved")


# ------------------------------------ transports ---------------------------------

def test_tcp_equals_inproc(port_process, port_live):
    res = _port_live(_cfg(4), port_process, address="tcp://127.0.0.1:0")
    np.testing.assert_array_equal(res.per_round, port_live.per_round)
    np.testing.assert_array_equal(res.trace.T1, port_live.trace.T1)
    np.testing.assert_array_equal(res.trace.T2, port_live.trace.T2)


@pytest.mark.parametrize("master_side", ["jax", "port"])
def test_mixed_clusters_over_tcp_equal_the_jax_run(master_side, jax_traces,
                                                   jax_runs):
    """One package's master, the other's workers, over one TCP listener:
    the wire format and the round semantics are shared."""
    jt = jax_traces[4]
    cfg = _cfg(4)
    if master_side == "jax":
        coro = _cluster(jlive.Master, jlive.listen, tlive.run_worker, cfg,
                        ttrace.TraceProcess(_port_trace(jt)),
                        "tcp://127.0.0.1:0", wkw={"device": "cpu"})
    else:
        coro = _cluster(tlive.Master, tlive.listen, jlive.run_worker,
                        tcore.RoundConfig.from_dict(cfg.to_dict()),
                        jcore.TraceProcess(jt), "tcp://127.0.0.1:0",
                        mkw={"device": "cpu"})
    res, _ = _run(coro)
    want = jax_runs[4, None]
    np.testing.assert_array_equal(res.per_round, want.per_round)
    np.testing.assert_array_equal(np.asarray(res.trace.T1),
                                  np.asarray(want.trace.T1))


def test_paced_rounds_close_at_the_deadline(port_process, port_live):
    """``time_scale > 0``: workers sleep their virtual delays and abort on
    ``close``; the master's wall-clock timer closes rounds at the
    deadline.  Whatever arrives, every round closes by the deadline."""
    dl = float(np.quantile(port_live.per_round, 0.5))
    res = _port_live(_cfg(4, deadline=dl, deadline_policy="close_partial"),
                     port_process, time_scale=20.0)
    assert np.isfinite(res.per_round).all()
    assert (res.per_round <= np.float32(dl)).all()
    assert (res.realized <= 2).all()
    assert res.missed.sum() >= 1


def test_bad_addresses_raise(port_process):
    cfg = tcore.RoundConfig.from_dict(_cfg(4).to_dict())
    with pytest.raises(ValueError, match="unknown transport scheme"):
        tlive.run_live(cfg, port_process, 2, address="carrier-pigeon://x",
                       device="cpu")
    with pytest.raises(ValueError, match="needs a scheme"):
        asyncio.run(tlive.connect("localhost:5555"))
    with pytest.raises(ValueError, match="host:port"):
        asyncio.run(tlive.listen("tcp://nohost"))


def test_facade_exports_the_references():
    assert tcore._LIVE_EXPORTS == jcore._LIVE_EXPORTS
    assert sorted(tlive.__all__) == sorted(jlive.__all__)
    for name in jcore._LIVE_EXPORTS:
        assert getattr(tcore, name) is getattr(tlive, name)
        assert name in dir(tcore)
    assert tcore.run_live is tlive.run_live
    with pytest.raises(AttributeError):
        tcore.no_such_name


# ----------------------------------- trace files ---------------------------------

def test_trace_files_cross_both_ways(tmp_path, jax_runs):
    """A censored live trace (preemption: stalled rows leave +inf cells,
    a version-2 header) written by the port loads in the reference, and
    the reference's live trace loads in the port."""
    n = 6
    cfg = tcore.RoundConfig(n=n, k=3, kind="cs", r=2, seed=5)
    proc = tcore.make_scenario("preemption", tcore.ec2_cluster(n, seed=2),
                               n, kill_p=0.3)
    res = _run(tmaster._run_live_async(cfg, proc, ROUNDS, device="cpu"))
    assert res.trace.has_faults and res.trace.header()["version"] == 2
    path = ttrace.save_trace(str(tmp_path / "port.npz"), res.trace)
    back = jtrace.load_trace(path)
    assert back.header()["digest"] == res.trace.header()["digest"]
    assert back.meta == res.trace.meta
    np.testing.assert_array_equal(np.asarray(back.T1), res.trace.T1)
    want = jax_runs[4, "close_partial"].trace
    path = jtrace.save_trace(str(tmp_path / "jax.npz"), want)
    got = ttrace.load_trace(path)
    assert got.header()["digest"] == want.header()["digest"]
    assert got.meta == want.meta
    np.testing.assert_array_equal(got.T2, np.asarray(want.T2))


# ------------------------------------ the card -----------------------------------

def test_runs_on_the_card_unless_asked(port_process):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = tcore.RoundConfig.from_dict(_cfg(4).to_dict())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlive.run_live(cfg, port_process, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlive.Master(cfg, rounds=2, listener=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlive.sample_delay_tables(port_process, 0, 2, 4, 2)
    m = tlive.Master(tcore.RoundConfig(n=4, k=3, adaptive=True), rounds=2,
                     listener=None, device="cpu")
    assert m.device.type == "cpu" and m.scheduler.device.type == "cpu"
