"""Fault tolerance — round deadlines, the fault-scenario zoo and fault
traces — the port against the JAX package.

* Deadline arrival counts of every static kind (TO, ragged, with a message
  budget or overhead; LB; PC; PCMM): bit-equal to the JAX ``_build_eval``.
* On traces the JAX package records with preemption, partition and message
  loss over a tie-exact base (tests/torch_parity.py), every scheme's
  per-trial, per-round close under ``wait`` / ``close_partial`` /
  ``reissue`` is bit-equal (static specs, adaptive and rebalance specs,
  censored and not), and so are the per-trial degradation streams
  (realized k, missed, stale).  Degradation means: rel 1e-12 where every
  per-trial value is a small dyadic number (realized, missed, khist, and
  ``stale`` at k = 4), rel 1e-6 for ``stale`` at k = 6 (its float32
  per-chunk sums are associated by XLA on the reference side).
* Partition and diurnal overlays on a replayed base: partition bit-equal,
  diurnal within rel 1e-6 (its factor's float32 ``cos`` and angle are
  evaluated by XLA on the reference side and by numpy here: they differ in
  the last bits).  Preemption, rack and message loss draw different random
  numbers in the two packages: per-round dead / drop shares agree with the
  reference and with the chain's exact marginal within z-bounds.
* ``kill_p = 0`` / ``p_drop = 0`` overlays are the base process bit for bit
  (the port's own property), and stacked overlays draw disjoint streams.
* Trace files with +inf cells written by either package are read by the
  other, and replay reproduces the recording run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster as jcl
from repro.core import delays as jd
from repro.core import montecarlo as jm
from repro.core import scheduling as js
from repro.core import trace as jt
from repro_torch.core import cluster as tcl
from repro_torch.core import delays as td
from repro_torch.core import montecarlo as tm
from repro_torch.core import trace as tt

from torch_parity import assert_bit_equal, np_of, tie_exact_tables, z_scores
from torch_parity import one_thread  # noqa: F401

N, R, CAP, ROUNDS, TRIALS = 8, 3, 4, 6, 64
LOADS = [3, 1, 2, 3, 1, 3, 2, 2]
DEADLINE = 2.5e-3


# ------------------------------ deadline counts ------------------------------

def _static_specs(M):
    return [M.to_spec("cs", js.cyclic_to_matrix(N, R)),
            M.to_spec("ss_m2", js.staircase_to_matrix(N, R), messages=2),
            M.to_spec("cs_rag", js.cyclic_to_matrix(N, R), loads=LOADS),
            M.to_spec("cs_eps", js.cyclic_to_matrix(N, R), messages=2,
                      comm_eps=3e-5),
            M.lb_spec(R, name="lb"),
            M.lb_spec(name="lb_rag", loads=LOADS),
            M.lb_spec(R, name="lb_m1", messages=1),
            M.pc_spec(R, name="pc"),
            M.pcmm_spec(R, name="pcmm"),
            M.pcmm_spec(R, name="pcmm_m2", messages=2)]


@pytest.mark.parametrize("ks", [5, None])
@pytest.mark.parametrize("deadline", [6e-4, 1.2e-3])
def test_deadline_counts_bit_equal(ks, deadline):
    gen = np.random.default_rng(3)
    s = np.cumsum(1e-4 * (0.5 + gen.random((64, N, R))), -1) + \
        5e-4 * (0.5 + gen.random((64, N, R)))
    s = s.astype(np.float32)
    s[gen.random(s.shape) < 0.1] = np.inf              # lost results
    s[:3] = np.inf                                     # nothing arrives
    want_out, want = jm._build_eval(tuple(_static_specs(jm)), N, R, ks,
                                    deadline)(jnp.asarray(s))
    sig, params, slots = tm._eval_layout(tuple(_static_specs(tm)), N, R, ks)
    got_out, got = tm._build_bucket_eval(sig, deadline)(
        torch.as_tensor(s), tm.params_on(params, "cpu"))
    seen = set()
    for name, (g, i) in slots.items():
        assert_bit_equal(got_out[g][:, i, :], want_out[name])
        assert_bit_equal(got[g][0][:, i], want[name][0])
        assert_bit_equal(got[g][1][:, i], want[name][1])
        seen.update(np_of(got[g][0][:, i]).tolist())
    assert len(seen) > 2                               # counts differ


# ------------------------ recorded fault traces -------------------------------

SCENARIOS = {"preemption": dict(kill_p=0.15, respawn_p=0.3),
             "partition": dict(start=2, length=3),
             "msgloss": dict(p_drop=0.1)}


@pytest.fixture(scope="module")
def fault_traces():
    """{scenario: (JAX DelayTrace, port DelayTrace)}: the JAX package's
    recording of each scenario over a replayed tie-exact base."""
    T1, T2 = tie_exact_tables(5, ROUNDS, N, CAP, trials=TRIALS)
    base = jt.TraceProcess(jt.DelayTrace(T1, T2))
    out = {}
    for name, kw in SCENARIOS.items():
        proc = jcl.make_scenario(name, base, N, **kw)
        tr = jm._record_trace(proc, N, CAP, rounds=ROUNDS, trials=TRIALS,
                              seed=2, chunk=TRIALS, meta={"scenario": name})
        assert tr.has_faults
        out[name] = (tr, tt.DelayTrace(tr.T1, tr.T2, meta=tr.meta))
    return out


def _round_specs(M):
    return [M.to_spec("cs", js.cyclic_to_matrix(N, R)),
            M.to_spec("ss_m2", js.staircase_to_matrix(N, R), messages=2),
            M.to_spec("cs_rag", js.cyclic_to_matrix(N, R), loads=LOADS),
            M.lb_spec(R, name="lb"),
            M.pc_spec(R, name="pc"),
            M.pcmm_spec(R, name="pcmm"),
            M.adaptive_spec("adapt", js.cyclic_to_matrix(N, R)),
            M.adaptive_spec("adapt_ss", js.staircase_to_matrix(N, R),
                            messages=2),
            M.adaptive_spec("rebal", js.cyclic_to_matrix(N, CAP),
                            loads=[2] * N, rebalance=True)]


def _streams(M, trace, policy, censored):
    """Per-trial (times, aux) of every scheme at k = 6 from each package's
    rounds function (one compile on the JAX side)."""
    specs = tuple(_round_specs(M))
    if M is jm:
        fn = jm._build_rounds_fn(specs, jt.TraceProcess(trace), N, CAP, 6,
                                 ROUNDS, 0.5, 0.5, censored, DEADLINE,
                                 policy, "scan")
        return jax.jit(fn)(jm.trial_keys(0, TRIALS),
                           jnp.arange(TRIALS, dtype=jnp.int32))
    fn = tm._build_rounds_fn(specs, tt.TraceProcess(trace), N, CAP, 6,
                             ROUNDS, 0.5, 0.5, censored, None,
                             torch.device("cpu"), DEADLINE, policy)
    return fn(0, torch.arange(TRIALS))


@pytest.fixture(scope="module")
def jax_streams(fault_traces):
    """(scenario, policy, censored) -> the JAX package's streams, computed
    once per key for the tests that share them."""
    cache = {}

    def get(scenario, policy, censored):
        key = (scenario, policy, censored)
        if key not in cache:
            cache[key] = _streams(jm, fault_traces[scenario][0], policy,
                                  censored)
        return cache[key]
    return get


#: preemption under every policy and both feedback modes; partition and
#: message loss under the two closing policies
ROUND_CASES = ([("preemption", pol, cens)
                for pol in ("wait", "close_partial", "reissue")
                for cens in (True, False)]
               + [(sc, pol, cens) for sc in ("partition", "msgloss")
                  for pol, cens in (("close_partial", True),
                                    ("reissue", False))])


@pytest.mark.parametrize("scenario,policy,censored", ROUND_CASES)
def test_fault_rounds_bit_exact(fault_traces, jax_streams, scenario, policy,
                                censored):
    tj, aj = jax_streams(scenario, policy, censored)
    tt_, at = _streams(tm, fault_traces[scenario][1], policy, censored)
    assert sorted(tt_) == sorted(tj)
    for name in tj:
        assert_bit_equal(tt_[name], tj[name])
        for key in ("realized", "missed", "stale"):
            assert_bit_equal(at[name][key], aj[name][key])
    if policy != "wait":
        assert all(float(np_of(tt_[nm]).max()) <= DEADLINE for nm in tt_)
    assert any(float(np_of(at[nm]["missed"]).sum()) > 0 for nm in at)


@pytest.mark.parametrize("policy", ["wait", "close_partial", "reissue"])
def test_public_trajectories_on_a_recorded_trace(fault_traces, jax_streams,
                                                policy):
    """trajectory_samples (the public path, chunked) equals the JAX rounds
    function's per-trial closes, static and adaptive."""
    ttr = fault_traces["preemption"][1]
    times, _ = jax_streams("preemption", policy, True)
    for spec in (_round_specs(tm)[0], _round_specs(tm)[6],
                 _round_specs(tm)[8]):
        got = tm.trajectory_samples(
            spec, ttr, N, rounds=ROUNDS, k=6, trials=TRIALS, chunk=32,
            feedback_beta=0.5, coverage_gamma=0.5, censored_feedback=True,
            deadline=DEADLINE, deadline_policy=policy, devices="cpu")
        assert_bit_equal(got.T, times[spec.name])


@pytest.mark.parametrize("k", [4, 6])
def test_degradation_means(fault_traces, k):
    jtr, ttr = fault_traces["preemption"]
    kw = dict(rounds=ROUNDS, k=k, trials=TRIALS, chunk=32,
              feedback_beta=0.5, coverage_gamma=0.5, censored_feedback=True,
              deadline=DEADLINE, deadline_policy="reissue")
    names = [0, 3, 5, 6, 8]
    rj = jm.sweep_rounds([_round_specs(jm)[i] for i in names],
                         jt.TraceProcess(jtr), N, greedy_impl="scan", **kw)
    rt = tm.sweep_rounds([_round_specs(tm)[i] for i in names],
                         tt.TraceProcess(ttr), N, devices="cpu", **kw)
    assert rt.degradation.keys() == rj.degradation.keys()
    for name, d in rj.degradation.items():
        for key in ("realized_k", "missed", "khist"):
            np.testing.assert_allclose(rt.degradation[name][key], d[key],
                                       rtol=1e-12, atol=0)
        np.testing.assert_allclose(rt.stale_fraction(name), d["stale"],
                                   rtol=1e-12 if k == 4 else 1e-6, atol=0)
        np.testing.assert_allclose(rt.khist(name).sum(-1), 1.0, rtol=1e-12)
        np.testing.assert_allclose(rt.per_round[name], rj.per_round[name],
                                   rtol=1e-6)


def test_degradation_needs_a_deadline():
    for M, kw in ((jm, {}), (tm, {"devices": "cpu"})):
        res = M.sweep_rounds([M.lb_spec(2)], jd.scenario1() if M is jm
                             else td.scenario1(), N, rounds=2, k=2,
                             trials=4, **kw)
        assert res.degradation is None and res.trace is None
        with pytest.raises(ValueError, match="deadline"):
            res.realized_k("lb")


# --------------------------- overlays on a replay ------------------------------

def _ones_trace(M, rounds=12, r=2):
    T = np.ones((rounds, N, r), np.float32)
    return (jt if M is jm else tt).TraceProcess(
        (jt if M is jm else tt).DelayTrace(T, 2 * T))


def _sample(M, proc, trials, rounds, r, seed=0):
    if M is jm:
        T1, T2 = proc.sample_rounds(jax.random.PRNGKey(seed), trials, N, r,
                                    rounds)
    else:
        T1, T2 = proc.sample_rounds(seed, trials, N, r, rounds,
                                    device="cpu")
    return np_of(T1), np_of(T2)


@pytest.mark.parametrize("kw", [dict(), dict(workers=(1, 5), start=0,
                                             length=2)])
def test_partition_overlay_bit_equal(kw):
    T1, T2 = tie_exact_tables(6, 10, N, 3, trials=5)
    jp = jcl.make_scenario("partition", jt.DelayTrace(T1, T2), N, **kw)
    tp = tcl.make_scenario("partition", tt.DelayTrace(T1, T2), N, **kw)
    a, b = _sample(jm, jp, 5, 10, 3), _sample(tm, tp, 5, 10, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    assert np.isinf(b[1]).any() and np.isfinite(b[0]).all()


@pytest.mark.parametrize("kw", [dict(), dict(period=24, amplitude=1.0),
                                dict(period=7, amplitude=1.5, phase=0.3)])
def test_diurnal_overlay_within_rel_1e6(kw):
    T1, T2 = tie_exact_tables(7, 30, N, 3, trials=2)
    jp = jcl.make_scenario("diurnal", jt.DelayTrace(T1, T2), N, **kw)
    tp = tcl.make_scenario("diurnal", tt.DelayTrace(T1, T2), N, **kw)
    for base, x, y in zip((T1, T2), _sample(jm, jp, 2, 30, 3),
                          _sample(tm, tp, 2, 30, 3)):
        np.testing.assert_allclose(y, x, rtol=1e-6, atol=0)
        assert (y / base > 1.5).any()                 # the swell bites


def _dead_share(T1, unit_cols):
    """(rounds,) share of dead units (+inf compute) and their count."""
    dead = np.isinf(T1[..., unit_cols, 0])
    return dead.mean(axis=(1, 2)), dead.shape[1] * dead.shape[2]


def _chain_marginal(kill, respawn, rounds):
    d, out = 0.0, []
    for _ in range(rounds):
        d = d * (1 - respawn) + (1 - d) * kill
        out.append(d)
    return np.asarray(out)


@pytest.mark.parametrize("name,kw,cols", [
    ("preemption", dict(kill_p=0.1, respawn_p=0.25), list(range(N))),
    ("rack", dict(kill_p=0.05, respawn_p=0.3), [0, 2, 4, 6]),
    ("msgloss", dict(p_drop=0.1), None)])
def test_random_overlays_by_distribution(name, kw, cols):
    """Per-round dead (or dropped) shares over 3 000 trials: the port's
    against the JAX package's and against the exact marginal, within 4.5
    binomial standard errors (rack units are racks of two workers)."""
    trials, rounds = 3000, 12
    shares = []
    for M, mod in ((jm, jcl), (tm, tcl)):
        proc = mod.make_scenario(name, _ones_trace(M, rounds), N, **kw)
        T1, T2 = _sample(M, proc, trials, rounds, 2, seed=4)
        if name == "msgloss":
            drop = np.isinf(T2)
            shares.append((drop.mean(axis=(1, 2, 3)), drop[0].size))
            assert np.isfinite(T1).all()
        else:
            shares.append(_dead_share(T1, cols))
            assert np.isfinite(T2).all()
    (pj, nj), (pt, nt) = shares
    want = (np.full(rounds, kw["p_drop"]) if name == "msgloss"
            else _chain_marginal(kw["kill_p"], kw["respawn_p"], rounds))
    se = lambda p, m: np.sqrt(p * (1 - p) / m)        # noqa: E731
    assert z_scores(pt, se(want, nt), pj, se(want, nj)).max() < 4.5
    assert (np.abs(pt - want) / se(want, nt)).max() < 4.5


@pytest.mark.parametrize("base", [
    lambda: tcl.ec2_cluster(N, spread=3.0, p_slow=0.25, persistence=0.9,
                            base=td.scenario1()),
    lambda: tcl.IIDProcess(td.scenario2(N)),
    lambda: tcl.make_scenario("diurnal", td.scenario1(), N)])
@pytest.mark.parametrize("name,kw", [
    ("preemption", dict(kill_p=0.0)), ("rack", dict(kill_p=0.0)),
    ("msgloss", dict(p_drop=0.0)),
    ("msgloss", dict(p_drop=0.0, retry_delay=1e-4))])
def test_zero_fault_overlay_is_the_base(base, name, kw):
    b = base()
    proc = tcl.make_scenario(name, b, N, **kw)
    for x, y in zip(_sample(tm, b, 16, 5, 3, seed=9),
                    _sample(tm, proc, 16, 5, 3, seed=9)):
        np.testing.assert_array_equal(y, x)


def test_stacked_overlays_draw_disjoint_streams():
    """Two preemption layers (kill 0.3, no respawn) over ones: with
    disjoint streams a worker survives round 1 with probability 0.7^2, not
    0.7; a message-loss layer on top draws a third stream."""
    one = tcl.make_scenario("preemption", _ones_trace(tm, 2), N,
                            kill_p=0.3, respawn_p=0.0)
    two = tcl.make_scenario("preemption", one, N, kill_p=0.3,
                            respawn_p=0.0)
    three = tcl.make_scenario("msgloss", two, N, p_drop=0.2)
    assert (one.fault_stream, two.fault_stream, three.fault_stream) == (
        tcl.STREAM_FAULT, tcl.STREAM_FAULT + 1, tcl.STREAM_FAULT + 2)
    assert tcl.STREAM_FAULT > max(tcl.STREAM_MARKOV_INIT,
                                  tcl.STREAM_MARKOV_CHAIN,
                                  tcl.STREAM_AR1_INIT, tcl.STREAM_AR1_EPS)
    T1, T2 = _sample(tm, three, 4000, 1, 2)
    alive = np.isfinite(T1[0, ..., 0]).mean()
    assert abs(alive - 0.49) < 4.5 * np.sqrt(0.49 * 0.51 / (4000 * N))
    # the loss layer's drops are independent of the deaths beneath it
    dead = np.isinf(T1[0, ..., 0])
    drop = np.isinf(T2[0, ..., 0])
    assert abs(drop[dead].mean() - drop[~dead].mean()) < 0.03


def test_message_comm_delays_bit_equal():
    T2 = (1e-4 * (0.5 + np.random.default_rng(8).random((5, N, 6)))
          ).astype(np.float32)
    for m in range(1, 7):
        for eps in (0.0, 2e-5):
            assert_bit_equal(
                tcl.message_comm_delays(torch.as_tensor(T2), m, eps),
                jcl.message_comm_delays(jnp.asarray(T2), m, eps))


@pytest.mark.parametrize("name", jcl.FAULT_SCENARIOS)
@pytest.mark.parametrize("n", [5, 12])
def test_scenario_defaults_equal_the_references(name, n):
    assert tcl.FAULT_SCENARIOS == jcl.FAULT_SCENARIOS
    a = jcl.make_scenario(name, jd.scenario1(), n)
    b = tcl.make_scenario(name, td.scenario1(), n)
    assert type(a).__name__ == type(b).__name__
    fields = [f.name for f in dataclasses.fields(a) if f.name != "base"]
    assert [getattr(b, f) for f in fields] == [getattr(a, f) for f in fields]
    assert isinstance(b.base, tcl.IIDProcess)


@pytest.mark.parametrize("call", [
    lambda m, d: m.make_scenario("volcano", d.scenario1(), 4),
    lambda m, d: m.make_scenario("preemption", d.scenario1(), 4, kill_p=2.0),
    lambda m, d: m.make_scenario("rack", d.scenario1(), 4, racks=()),
    lambda m, d: m.make_scenario("msgloss", d.scenario1(), 4, p_drop=1.0),
    lambda m, d: m.make_scenario("msgloss", d.scenario1(), 4,
                                 retry_delay=0.0),
    lambda m, d: m.make_scenario("diurnal", d.scenario1(), 4, period=0),
    lambda m, d: m.make_scenario("partition", d.scenario1(), 4,
                                 workers=()),
    lambda m, d: m.make_scenario("partition", d.scenario1(), 4, length=0)])
def test_scenario_validation_alike(call):
    with pytest.raises(ValueError):
        call(jcl, jd)
    with pytest.raises(ValueError):
        call(tcl, td)


def test_as_process_takes_every_scenario():
    for name in tcl.FAULT_SCENARIOS:
        p = tcl.make_scenario(name, td.scenario1(), N)
        assert tcl.as_process(p) is p
        assert isinstance(p, tcl.FaultProcess)


# ------------------------------ trace files ----------------------------------

def test_port_fault_trace_read_and_replayed_by_the_reference(tmp_path):
    """The port records a preemption run with a deadline; the file it
    writes validates in the JAX package (version 2, faults), and the JAX
    replay of a static scheme gives the recording run's trajectories; the
    port's own replay gives its recording result exactly."""
    proc = tcl.make_scenario("preemption", tcl.ec2_cluster(
        N, spread=3.0, base=td.scenario1()), N)
    kw = dict(rounds=5, k=6, trials=64, chunk=32, deadline=1e-3,
              deadline_policy="close_partial", censored_feedback=True)
    spec = tm.to_spec("cs", js.cyclic_to_matrix(N, R))
    y, trace = tm.trajectory_samples(spec, proc, N, record_trace=True,
                                     devices="cpu", **kw)
    path = tt.save_trace(str(tmp_path / "port"), trace)
    hdr = jt.validate_trace_file(path)
    assert hdr["version"] == 2 and hdr["faults"] is True
    assert hdr["digest"] == trace.header()["digest"]
    jy = jm.trajectory_samples(jm.to_spec("cs", js.cyclic_to_matrix(N, R)),
                               jt.load_trace(path), N, **kw)
    assert_bit_equal(y, jy)
    specs = [spec, tm.adaptive_spec("a", js.cyclic_to_matrix(N, R))]
    rec = tm.sweep_rounds(specs, proc, N, record_trace=True, devices="cpu",
                          **kw)
    rep = tm.sweep_rounds(specs, tt.TraceProcess(tt.load_trace(
        tt.save_trace(str(tmp_path / "rec"), rec.trace))), N, seed=99,
        devices="cpu", **kw)
    for name in rec.per_round:
        assert_bit_equal(rep.per_round[name], rec.per_round[name])
        for key, v in rec.degradation[name].items():
            assert_bit_equal(rep.degradation[name][key], v)


def test_reference_fault_trace_read_by_the_port(fault_traces, tmp_path):
    jtr, _ = fault_traces["msgloss"]
    path = jt.save_trace(str(tmp_path / "ref"), jtr)
    got = tt.load_trace(path)
    assert got.header()["digest"] == jtr.header()["digest"]
    assert tt.validate_trace_file(path)["faults"] is True
    assert got.meta == {"scenario": "msgloss"}


@pytest.mark.parametrize("fn", ["sweep", "completion_samples",
                                "task_arrival_samples"])
def test_single_round_entry_points_refuse_record_trace_alike(fn):
    C = js.cyclic_to_matrix(N, R)
    for M, d, kw in ((jm, jd, {}), (tm, td, {"devices": "cpu"})):
        call = {"sweep": lambda: M.sweep([M.to_spec("cs", C)], d.scenario1(),
                                         N, trials=4, record_trace=True,
                                         **kw),
                "completion_samples": lambda: M.completion_samples(
                    M.to_spec("cs", C), d.scenario1(), N, trials=4, k=2,
                    record_trace=True, **kw),
                "task_arrival_samples": lambda: M.task_arrival_samples(
                    C, d.scenario1(), trials=4, record_trace=True, **kw)}[fn]
        with pytest.raises(ValueError, match="rounds axis"):
            call()
