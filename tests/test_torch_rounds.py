"""The rounds axis: delay processes, trace files and replay, and the rounds
engine (static and adaptive schemes, censored and not) — the port against
the JAX package.

Levels of parity (ROADMAP.md, "What 'held against' means here"):
* trace files are byte-compatible both ways (same header, same digest) and
  replay is a pure gather: replayed tables are bit-equal;
* on a replayed trace of the tie-exact family (tests/torch_parity.py) the
  per-trial, per-round trajectories are bit-equal, adaptive picks
  included; slot arrivals (eq. 1) are explicit left folds, bit-equal to
  the reference's ``jnp.cumsum`` for r <= 17 (a reference caveat), so every
  case here keeps r <= 17;
* means and standard errors of a sweep on a shared trace agree within
  float32 round-off (per-chunk partial sums are a pairwise tree here and
  XLA reductions there);
* parametric processes draw different random numbers in the two packages
  and are compared by distribution, within stated z-bounds.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import cluster as jcl
from repro.core import delays as jd
from repro.core import montecarlo as jm
from repro.core import scheduling as js
from repro.core import trace as jt
from repro_torch import convert
from repro_torch.core import cluster as tcl
from repro_torch.core import delays as td
from repro_torch.core import montecarlo as tm
from repro_torch.core import trace as tt

from torch_parity import assert_bit_equal, np_of, tie_exact_tables, z_scores
from torch_parity import one_thread  # noqa: F401

N, R, ROUNDS, TRIALS = 8, 3, 5, 192
LOADS = [3, 1, 2, 3, 1, 3, 2, 2]

SPECS = {
    "cs": lambda M, nm: M.to_spec(nm, js.cyclic_to_matrix(N, R)),
    "ss_m2": lambda M, nm: M.to_spec(nm, js.staircase_to_matrix(N, R),
                                     messages=2),
    "cs_rag": lambda M, nm: M.to_spec(nm, js.cyclic_to_matrix(N, R),
                                      loads=LOADS),
    "lb": lambda M, nm: M.lb_spec(R, name=nm),
    "pc": lambda M, nm: M.pc_spec(R, name=nm),
    "pcmm": lambda M, nm: M.pcmm_spec(R, name=nm),
    "adapt": lambda M, nm: M.adaptive_spec(nm, js.cyclic_to_matrix(N, R)),
    "adapt_ss_m2": lambda M, nm: M.adaptive_spec(
        nm, js.staircase_to_matrix(N, R), messages=2),
    "adapt_rag": lambda M, nm: M.adaptive_spec(
        nm, js.cyclic_to_matrix(N, R), loads=LOADS),
    "adapt_ra": lambda M, nm: M.adaptive_spec(
        nm, js.random_assignment_to_matrix(N, seed=4)),
}


@pytest.fixture(scope="module")
def shared_trace():
    """One tie-exact trace, as each package's DelayTrace."""
    T1, T2 = tie_exact_tables(3, ROUNDS, N, N, trials=TRIALS)
    return jt.DelayTrace(T1, T2), tt.DelayTrace(T1, T2)


def _traj(M, trace_cls, trace, spec, **kw):
    kw.setdefault("feedback_beta", 0.5)
    kw.setdefault("coverage_gamma", 0.5)
    if M is tm:
        kw.setdefault("devices", "cpu")
    else:
        kw.setdefault("greedy_impl", "scan")
    return np_of(M.trajectory_samples(spec, trace_cls(trace), N,
                                      rounds=ROUNDS, k=6, trials=TRIALS,
                                      **kw))


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("censored", [False, True])
def test_trajectories_bit_exact_on_tie_exact_trace(shared_trace, name,
                                                   censored):
    jtr, ttr = shared_trace
    want = _traj(jm, jt.TraceProcess, jtr, SPECS[name](jm, name), chunk=96,
                 censored_feedback=censored)
    got = _traj(tm, tt.TraceProcess, ttr, SPECS[name](tm, name), chunk=64,
                censored_feedback=censored)
    assert got.shape == (TRIALS, ROUNDS)
    assert_bit_equal(got, want)


def test_adaptive_differs_from_static_on_the_trace(shared_trace):
    """The tie-exact trace is not degenerate: the adaptive schedule's
    trajectories differ from static CS's."""
    _, ttr = shared_trace
    a = _traj(tm, tt.TraceProcess, ttr, SPECS["adapt"](tm, "a"))
    b = _traj(tm, tt.TraceProcess, ttr, SPECS["cs"](tm, "cs"))
    assert (a != b).any()


@pytest.mark.parametrize("censored", [False, True])
def test_sweep_rounds_on_shared_trace(shared_trace, censored):
    """Every scheme in one sweep (static ones through the bucketed
    evaluator at k, adaptive ones with their own estimates when censored):
    per-round and wall-clock means within rel 1e-6 and standard errors
    within rel 1e-4 of the JAX sweep (float32 per-chunk partials summed in
    another order; the standard error's E[x^2] - mean^2 amplifies that
    round-off by E[x^2] / var)."""
    jtr, ttr = shared_trace
    names = ["cs", "ss_m2", "lb", "pc", "pcmm", "adapt", "adapt_rag"]
    kw = dict(rounds=ROUNDS, k=6, trials=TRIALS, chunk=64,
              feedback_beta=0.5, coverage_gamma=0.5,
              censored_feedback=censored)

    def specs(M):
        return [SPECS[nm](M, nm) for nm in names]

    rj = jm.sweep_rounds(specs(jm), jt.TraceProcess(jtr), N,
                         greedy_impl="scan", **kw)
    rt = tm.sweep_rounds(specs(tm), tt.TraceProcess(ttr), N, devices="cpu",
                         **kw)
    assert sorted(rt.per_round) == sorted(rj.per_round)
    for nm in names:
        for a, b, tol in ((rt.per_round, rj.per_round, 1e-6),
                          (rt.wallclock, rj.wallclock, 1e-6),
                          (rt.stderr, rj.stderr, 1e-4),
                          (rt.wallclock_stderr, rj.wallclock_stderr, 1e-4)):
            np.testing.assert_allclose(a[nm], b[nm], rtol=tol)
        assert np.isclose(rt.mean_round(nm), rj.mean_round(nm), rtol=1e-6)
        assert np.isclose(rt.total(nm), rj.total(nm), rtol=1e-6)
        assert (rt.per_round["lb"] <= rt.per_round[nm] * (1 + 1e-7)).all()


def test_fig8_shaped_sweep_over_shared_trace():
    """The slice as a whole at a small Fig.-8 shape (n=6, r=3, k=4, 4
    rounds; cs/ss/adapt/lb, default feedback_beta 0.7): per trial the same
    trajectories for every scheme, and the sweep's means within rel 1e-6.
    Estimates stay exact because the trace's slot delays are constant per
    worker."""
    n, r, k, rounds, trials = 6, 3, 4, 4, 160
    T1, T2 = tie_exact_tables(11, rounds, n, r, trials=trials)
    cs = js.cyclic_to_matrix(n, r)
    ss = js.staircase_to_matrix(n, r)

    def specs(M):
        return [M.to_spec("cs", cs), M.to_spec("ss", ss),
                M.adaptive_spec("adapt", cs), M.lb_spec(r)]
    pj = jt.TraceProcess(jt.DelayTrace(T1, T2))
    pt = tt.TraceProcess(tt.DelayTrace(T1, T2))
    for sj, st in zip(specs(jm), specs(tm)):
        a = jm.trajectory_samples(sj, pj, n, rounds=rounds, k=k,
                                  trials=trials, chunk=80,
                                  greedy_impl="scan")
        b = tm.trajectory_samples(st, pt, n, rounds=rounds, k=k,
                                  trials=trials, chunk=32, devices="cpu")
        assert_bit_equal(b, a)
    rj = jm.sweep_rounds(specs(jm), pj, n, rounds=rounds, k=k,
                         trials=trials, chunk=80, greedy_impl="scan")
    rt = tm.sweep_rounds(specs(tm), pt, n, rounds=rounds, k=k,
                         trials=trials, chunk=32, devices="cpu")
    for nm in ("cs", "ss", "adapt", "lb"):
        np.testing.assert_allclose(rt.per_round[nm], rj.per_round[nm],
                                   rtol=1e-6)


@pytest.mark.parametrize("censored", [False, True])
def test_trajectories_chunk_invariant(censored):
    """Sampled (Markov) process: per-trial trajectories are the same bits
    for any chunking (streams keyed by round and global trial id), and the
    sweep's means agree to float32 round-off."""
    proc = tcl.ec2_cluster(N, spread=3.0, p_slow=0.25, persistence=0.9,
                           slow=8.0, base=td.scenario1(), seed=1)
    sp = SPECS["adapt"](tm, "adapt")
    kw = dict(rounds=4, k=6, trials=300, devices="cpu",
              censored_feedback=censored)
    a = tm.trajectory_samples(sp, proc, N, chunk=64, **kw)
    b = tm.trajectory_samples(sp, proc, N, chunk=256, **kw)
    c = tm.trajectory_samples(sp, proc, N, **kw)
    assert torch.equal(a, b) and torch.equal(a, c)
    specs = [SPECS["cs"](tm, "cs"), sp, SPECS["lb"](tm, "lb")]
    r1 = tm.sweep_rounds(specs, proc, N, chunk=64, **kw)
    r2 = tm.sweep_rounds(specs, proc, N, chunk=256, **kw)
    for nm in r1.per_round:
        np.testing.assert_allclose(r1.per_round[nm], r2.per_round[nm],
                                   rtol=1e-6)


def test_sweep_rounds_matches_jax_by_distribution():
    """The Fig. 8 persistent heterogeneous cell at n=12 (r=3, k=9, 8
    rounds, 1 200 trials) on each package's own Markov draws: per-round
    means within 4.5 combined standard errors, and adapt beats CS and SS
    on both sides."""
    def specs(M):
        cs = js.cyclic_to_matrix(12, 3)
        return [M.to_spec("cs", cs),
                M.to_spec("ss", js.staircase_to_matrix(12, 3)),
                M.adaptive_spec("adapt", cs), M.lb_spec(3)]
    kw = dict(rounds=8, k=9, trials=1200, chunk=600)
    rj = jm.sweep_rounds(specs(jm), jcl.ec2_cluster(
        12, spread=3.0, p_slow=0.25, persistence=0.98, slow=8.0,
        base=jd.scenario1(), seed=1), 12, greedy_impl="scan", **kw)
    rt = tm.sweep_rounds(specs(tm), tcl.ec2_cluster(
        12, spread=3.0, p_slow=0.25, persistence=0.98, slow=8.0,
        base=td.scenario1(), seed=1), 12, devices="cpu", **kw)
    for nm in rj.per_round:
        z = z_scores(rt.per_round[nm], rt.stderr[nm], rj.per_round[nm],
                     rj.stderr[nm])
        assert z.max() < 4.5, (nm, z)
    for res in (rj, rt):
        assert res.mean_round("adapt") < min(res.mean_round("cs"),
                                             res.mean_round("ss"))


# ------------------------------ processes ---------------------------------------

def _jax_states(proc, trials, n, rounds, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), trials)
    allk = jax.vmap(lambda kk: jax.random.split(kk, rounds + 1))(keys)
    st = proc.init(allk[:, 0], n)
    states, T1s = [], []
    for t in range(rounds):
        st, T1, _ = proc.step(st, allk[:, t + 1], n, 2)
        states.append(np.asarray(st))
        T1s.append(np.asarray(T1))
    return np.stack(states), np.stack(T1s)


def _torch_states(proc, trials, n, rounds, seed=0):
    from repro_torch.core import rng
    tids = torch.arange(trials)
    st = proc.init_trials(rng.round_seed(seed, 0), tids, n)
    states, T1s = [], []
    for t in range(rounds):
        st, T1, _ = proc.step(st, rng.round_seed(seed, t + 1), tids, n, 2)
        states.append(st.numpy())
        T1s.append(T1.numpy())
    return np.stack(states), np.stack(T1s)


def _share_z(a, b):
    """|p_a - p_b| in pooled binomial standard errors."""
    p = (a.sum() + b.sum()) / (a.size + b.size)
    return abs(a.mean() - b.mean()) / np.sqrt(
        p * (1 - p) * (1 / a.size + 1 / b.size))


@pytest.mark.parametrize("persistence", [0.0, 0.9])
def test_markov_process_by_distribution(persistence):
    """Per-round mean T1 within 4.5 combined standard errors; the
    stationary slow share and the lag-1 regime persistence P(slow at t+1 |
    slow at t) within 4.5 binomial standard errors (regimes are correlated
    across rounds, so the bound is loose on purpose); both packages keep
    the chain stationary at p_slow."""
    kw = dict(worker_scale=(0.5, 1.0, 2.0, 1.0, 1.0, 1.5), p_slow=0.25,
              persistence=persistence, slow=8.0)
    trials, n, rounds = 2000, 6, 5
    sj, Tj = _jax_states(jcl.MarkovRegimeProcess(base=jd.scenario1(), **kw),
                         trials, n, rounds)
    st, Tt = _torch_states(tcl.MarkovRegimeProcess(base=td.scenario1(), **kw),
                           trials, n, rounds)
    for t in range(rounds):
        mj, mt = Tj[t].mean(axis=(0, 2)), Tt[t].mean(axis=(0, 2))
        sej = Tj[t].mean(axis=2).std(axis=0) / np.sqrt(trials)
        set_ = Tt[t].mean(axis=2).std(axis=0) / np.sqrt(trials)
        assert z_scores(mt, set_, mj, sej).max() < 4.5
    assert _share_z(st, sj) < 4.5
    assert abs(st.mean() - 0.25) < 0.02
    stay_j = sj[1:][sj[:-1]]
    stay_t = st[1:][st[:-1]]
    assert _share_z(stay_t, stay_j) < 4.5
    want = persistence + (1 - persistence) * 0.25
    assert abs(stay_t.mean() - want) < 0.03


@pytest.mark.parametrize("rho,sigma", [(0.9, 0.3), (0.0, 0.5)])
def test_ar1_process_by_distribution(rho, sigma):
    """The AR(1) latent: mean, variance (stationary sigma^2) and lag-1
    autocorrelation (rho) of the port within stated bounds of the JAX
    process's and of their exact values; per-round mean T1 within 4.5
    combined standard errors."""
    trials, n, rounds = 2000, 4, 5
    sj, Tj = _jax_states(jcl.AR1Process(base=jd.scenario1(), rho=rho,
                                        sigma=sigma), trials, n, rounds)
    st, Tt = _torch_states(tcl.AR1Process(base=td.scenario1(), rho=rho,
                                          sigma=sigma), trials, n, rounds)
    m = st.size
    for x in (sj, st):
        assert abs(x.mean()) < 4.5 * sigma / np.sqrt(m / rounds)
        assert abs(x.var() / sigma ** 2 - 1) < 0.05
        lag = np.corrcoef(x[1:].ravel(), x[:-1].ravel())[0, 1]
        assert abs(lag - rho) < 0.03
    for t in range(rounds):
        mj, mt = Tj[t].mean(axis=(0, 2)), Tt[t].mean(axis=(0, 2))
        sej = Tj[t].mean(axis=2).std(axis=0) / np.sqrt(trials)
        set_ = Tt[t].mean(axis=2).std(axis=0) / np.sqrt(trials)
        assert z_scores(mt, set_, mj, sej).max() < 4.5


def test_process_draws_independent_of_device_chunking():
    """The same trials drawn in one batch or trial by trial give the same
    bits (CPU)."""
    proc = tcl.AR1Process(base=td.scenario1(), worker_scale=2.0)
    T1, T2 = proc.sample_rounds(5, 12, 4, 3, 3, device="cpu")
    from repro_torch.core import rng
    for tid in (0, 7, 11):
        tids = torch.tensor([tid])
        st = proc.init_trials(rng.round_seed(5, 0), tids, 4)
        for t in range(3):
            st, a, b = proc.step(st, rng.round_seed(5, t + 1), tids, 4, 3)
            assert torch.equal(a[0], T1[t, tid])
            assert torch.equal(b[0], T2[t, tid])


@pytest.mark.parametrize("n,spread,seed", [(12, 3.0, 1), (5, 2.0, 0),
                                           (1, 3.0, 0), (7, 1.0, 2)])
def test_heterogeneous_scales_and_cluster_equal(n, spread, seed):
    assert (tcl.heterogeneous_scales(n, spread, seed)
            == jcl.heterogeneous_scales(n, spread, seed))
    cj = jcl.ec2_cluster(n, spread=spread, seed=seed)
    ct = tcl.ec2_cluster(n, spread=spread, seed=seed)
    assert ct.worker_scale == cj.worker_scale
    assert (ct.p_slow, ct.persistence, ct.slow) == (cj.p_slow,
                                                    cj.persistence, cj.slow)
    assert ct.base.mu1 == cj.base.mu1 and ct.base.mu2 == cj.base.mu2


@pytest.mark.parametrize("bad", [
    lambda M: M.MarkovRegimeProcess(p_slow=1.5),
    lambda M: M.MarkovRegimeProcess(persistence=-0.1),
    lambda M: M.AR1Process(rho=1.0),
    lambda M: M.heterogeneous_scales(4, 0.5),
])
def test_process_validation_alike(bad):
    with pytest.raises(ValueError):
        bad(jcl)
    with pytest.raises(ValueError):
        bad(tcl)


@pytest.mark.parametrize("kind", ["MarkovRegimeProcess", "AR1Process"])
def test_convert_processes(kind):
    import dataclasses
    jp = (jcl.ec2_cluster(6, spread=3.0, base=jd.scenario2(6, seed=2))
          if kind == "MarkovRegimeProcess"
          else jcl.AR1Process(base=jd.scenario1(), worker_scale=(1.0, 2.0),
                              rho=0.5, sigma=0.2))
    tp = convert.delay_process(kind, dataclasses.asdict(jp))
    assert type(tp).__name__ == kind
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    with pytest.raises(ValueError):
        convert.delay_process("Nope", {})


# ------------------------------ trace files -------------------------------------

def _trace_tables(faults=False):
    T1, T2 = tie_exact_tables(5, 3, 4, 2, trials=5)
    if faults:
        T2 = T2.copy()
        T2[1, 2, 3, 1] = np.inf
    return T1, T2


@pytest.mark.parametrize("faults", [False, True])
def test_trace_files_readable_both_ways(tmp_path, faults):
    T1, T2 = _trace_tables(faults)
    meta = {"source": "test", "seed": 3}
    tr_t = tt.DelayTrace(T1, T2, meta=meta)
    tr_j = jt.DelayTrace(T1, T2, meta=meta)
    assert tr_t.header() == tr_j.header()
    assert tr_t.header()["version"] == (2 if faults else 1)
    p = tt.save_trace(str(tmp_path / "port"), tr_t)
    back_j = jt.load_trace(p)
    assert back_j == tr_j and back_j.meta == meta
    assert jt.validate_trace_file(p)["digest"] == tr_t._digest
    q = jt.save_trace(str(tmp_path / "jax"), tr_j)
    back_t = tt.load_trace(q)
    assert back_t._digest == tr_j._digest and back_t.meta == meta
    assert_bit_equal(back_t.T1, T1)
    assert_bit_equal(back_t.T2, T2)
    assert tt.validate_trace_file(q) == jt.validate_trace_file(q)
    assert convert.delay_trace(T1, T2, meta)._digest == tr_j._digest


def test_trace_file_errors_alike(tmp_path):
    T1, T2 = _trace_tables()
    p = jt.save_trace(str(tmp_path / "t.npz"), jt.DelayTrace(T1, T2))
    with np.load(p) as z:
        members = {k: z[k] for k in z.files}
    bad = dict(members, T1=members["T1"] * 2)
    np.savez(tmp_path / "bad.npz", **bad)
    np.savez(tmp_path / "nohdr.npz", T1=T1, T2=T2)
    for path in (tmp_path / "bad.npz", tmp_path / "nohdr.npz"):
        with pytest.raises(ValueError) as ej:
            jt.load_trace(str(path))
        with pytest.raises(ValueError) as et:
            tt.load_trace(str(path))
        assert str(et.value) == str(ej.value)
    for bad_tables in ((T1[..., :1], T2), (-T1, T2), (T1 * np.nan, T2)):
        with pytest.raises(ValueError):
            jt.DelayTrace(*bad_tables)
        with pytest.raises(ValueError):
            tt.DelayTrace(*bad_tables)


@pytest.mark.parametrize("kw,n,r,rounds", [
    (dict(), 4, 2, 3), (dict(), 3, 1, 2),
    (dict(pad_rounds="cycle"), 4, 2, 7), (dict(pad_rounds="hold"), 4, 2, 6),
    (dict(pad_workers="cycle", pad_slots="cycle"), 6, 3, 3),
    (dict(start_round=1, pad_rounds="cycle"), 4, 2, 4)])
def test_trace_replay_bit_equal(kw, n, r, rounds):
    """Replay is a gather: the same tables on both sides for every pad
    policy and start_round, with 7 replay trials over 5 recorded ones."""
    T1, T2 = _trace_tables()
    pj = jt.TraceProcess(jt.DelayTrace(T1, T2), **kw)
    pt = tt.TraceProcess(tt.DelayTrace(T1, T2), **kw)
    aj = pj.sample_rounds(jax.random.PRNGKey(0), 7, n, r, rounds)
    at = pt.sample_rounds(0, 7, n, r, rounds, device="cpu")
    for x, y in zip(at, aj):
        assert_bit_equal(x, y)


@pytest.mark.parametrize("kw,n,r,rounds", [
    (dict(), 4, 2, 4), (dict(start_round=2), 4, 2, 2), (dict(), 5, 2, 2),
    (dict(), 4, 3, 2)])
def test_trace_pad_policy_errors_alike(kw, n, r, rounds):
    T1, T2 = _trace_tables()
    pj = jt.TraceProcess(jt.DelayTrace(T1, T2), **kw)
    pt = tt.TraceProcess(tt.DelayTrace(T1, T2), **kw)
    with pytest.raises(ValueError) as ej:
        pj.sample_rounds(jax.random.PRNGKey(0), 2, n, r, rounds)
    with pytest.raises(ValueError) as et:
        pt.sample_rounds(0, 2, n, r, rounds, device="cpu")
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("bad", [dict(pad_rounds="wrap"),
                                 dict(pad_workers="hold"),
                                 dict(start_round=-1)])
def test_trace_process_validation_alike(bad):
    T1, T2 = _trace_tables()
    with pytest.raises(ValueError):
        jt.TraceProcess(jt.DelayTrace(T1, T2), **bad)
    with pytest.raises(ValueError):
        tt.TraceProcess(tt.DelayTrace(T1, T2), **bad)
    with pytest.raises(TypeError):
        tt.TraceProcess(T1)


def test_as_process_takes_a_trace():
    T1, T2 = _trace_tables()
    assert isinstance(tcl.as_process(tt.DelayTrace(T1, T2)), tt.TraceProcess)
    assert isinstance(tcl.as_process(td.scenario1()), tcl.IIDProcess)
    with pytest.raises(TypeError):
        tcl.as_process(3)


# ------------------------------ validation --------------------------------------

@pytest.mark.parametrize("bad", [
    lambda M, p, **kw: M.sweep_rounds(
        [M.tau_spec("t", js.cyclic_to_matrix(N, 2))], p, N, rounds=2, k=2,
        trials=4, **kw),
    lambda M, p, **kw: M.sweep_rounds([M.lb_spec(2)], p, N, rounds=0, k=2,
                                      trials=4, **kw),
    lambda M, p, **kw: M.sweep_rounds([M.lb_spec(2)], p, N, rounds=2,
                                      k=N + 1, trials=4, **kw),
    lambda M, p, **kw: M.sweep_rounds(
        [M.adaptive_spec("a", js.block_to_matrix(N, 2), loads=[1] * N)],
        p, N, rounds=2, k=N, trials=4, **kw),
    lambda M, p, **kw: M.sweep(
        [M.adaptive_spec("a", js.cyclic_to_matrix(N, 2))], p, N, trials=4,
        **kw),
])
def test_rounds_validation_alike(bad):
    with pytest.raises(ValueError):
        bad(jm, jd.scenario1())
    with pytest.raises(ValueError):
        bad(tm, td.scenario1(), devices="cpu")


def _deadline_case(shared):
    """A deadline on a shared trace: per-round means and the degradation
    means (integer-valued counts and a k = 4 stale share, exact in
    float32) as the JAX sweep's."""
    jtr, ttr = shared
    kw = dict(rounds=ROUNDS, k=4, trials=TRIALS, chunk=64, deadline=1.5e-3,
              deadline_policy="close_partial")
    rj = jm.sweep_rounds([jm.lb_spec(2)], jt.TraceProcess(jtr), N, **kw)
    rt = tm.sweep_rounds([tm.lb_spec(2)], tt.TraceProcess(ttr), N,
                         devices="cpu", **kw)
    assert rt.deadline == rj.deadline
    assert rt.deadline_policy == rj.deadline_policy
    np.testing.assert_allclose(rt.per_round["lb"], rj.per_round["lb"],
                               rtol=1e-6)
    for key in ("realized_k", "missed", "stale", "khist"):
        np.testing.assert_allclose(rt.degradation["lb"][key],
                                   rj.degradation["lb"][key], rtol=1e-12)
    assert rt.missed_fraction("lb").max() > 0       # the deadline bites


def _record_case(shared):
    """record_trace=True returns the tables the run drew, and replaying
    them reproduces the run's trajectories (the port alone: a parametric
    process draws other numbers in JAX)."""
    spec = tm.adaptive_spec("a", js.cyclic_to_matrix(N, 2))
    kw = dict(rounds=2, k=2, trials=4, devices="cpu")
    y, trace = tm.trajectory_samples(spec, td.scenario1(), N,
                                     record_trace=True, **kw)
    assert (trace.rounds, trace.trials, trace.n, trace.r) == (2, 4, N, 2)
    assert trace.meta["source"] == "sweep_rounds"
    assert_bit_equal(y, tm.trajectory_samples(spec, td.scenario1(), N,
                                              **kw))
    assert_bit_equal(y, tm.trajectory_samples(spec, trace, N, **kw))


def _rebalance_spec_case(shared):
    """adaptive_spec(rebalance=True) builds the reference's spec: dense
    base, the budget kept as loads."""
    C = js.cyclic_to_matrix(N, 2)
    a = jm.adaptive_spec("a", C, loads=[1] * N, rebalance=True)
    b = tm.adaptive_spec("a", C, loads=[1] * N, rebalance=True)
    assert (b.kind, b.C, b.loads, b.rebalance, b.load) == (
        a.kind, a.C, a.loads, a.rebalance, a.load)


@pytest.mark.parametrize("case", [_deadline_case, _record_case,
                                  _rebalance_spec_case])
def test_fault_slice_features_match_jax(shared_trace, case):
    case(shared_trace)


def test_seed_range_and_greedy_impl_checked():
    with pytest.raises(ValueError, match="2\\*\\*32"):
        tm.sweep_rounds([tm.lb_spec(2)], td.scenario1(), N, rounds=2, k=2,
                        trials=4, seed=2 ** 32, devices="cpu")
    with pytest.raises(ValueError):
        tm.sweep_rounds([tm.lb_spec(2)], td.scenario1(), N, rounds=2, k=2,
                        trials=4, greedy_impl="bogus", devices="cpu")
