"""The aggregator (static and adaptive) and the DGD regression loop: the
port against the JAX package on shared delay tables (a table-replaying
process on each side) and shared regression data (the JAX package's
dataset, converted).  Adaptive rounds use the tie-exact family of tables
(tests/torch_parity.py), on which the greedy picks cannot depend on the
summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregator as jagg
from repro.core import coded as jcoded
from repro.core import completion as jcomp
from repro.core import spec as jspec
from repro.data import regression_dataset, regression_tasks
from repro_torch import convert, dgd
from repro_torch.configs import RegressionConfig
from repro.core import cluster as jcl
from repro.core import delays as jd
from repro_torch.core import StragglerAggregator, scenario1
from repro_torch.core import cluster as tcl
from repro_torch.core import montecarlo as tmc
from repro_torch.core import spec as tspec

from torch_parity import (JaxTableProcess, TorchTableProcess,
                          assert_bit_equal, delay_tables, load_example,
                          rel_err, tie_exact_tables)
from torch_parity import one_thread  # noqa: F401

CONFIGS = [dict(n=6, k=4, kind="cs", r=2),
           dict(n=6, k=6, kind="ss", r=3, messages=2),
           dict(n=6, k=5, kind="ra"),
           dict(n=6, k=4, kind="ss", r=3, loads=(3, 1, 2, 3, 1, 2)),
           dict(n=6, k=3, kind="cs", r=3, messages=2, comm_eps=2e-5)]
ROUNDS = 6


def _pair(kw, seed=0):
    cfg = tspec.RoundConfig(**kw)
    T1, T2 = delay_tables(seed, ROUNDS, cfg.n, cfg.width)
    j = jagg.StragglerAggregator(jspec.RoundConfig(**kw).to_round_spec(),
                                 JaxTableProcess(T1=T1, T2=T2))
    t = StragglerAggregator(cfg, TorchTableProcess(T1=T1, T2=T2),
                            device="cpu")
    return j, t


@pytest.mark.parametrize("kw", CONFIGS)
def test_round_masks_bit_exact(kw):
    j, t = _pair(kw)
    assert_bit_equal(t.current_matrix(), j.current_matrix())
    assert_bit_equal(t.current_loads(), j.current_loads())
    gen = np.random.default_rng(1)
    for rnd in range(ROUNDS):
        w_j, t_j = j.round_mask(jax.random.PRNGKey(rnd))
        w_t, t_t = t.round_mask(rnd)
        assert_bit_equal(w_t, w_j)
        assert_bit_equal(t_t, t_j)
        g = gen.standard_normal(tuple(w_t.shape) + (5,)).astype(np.float32)
        np.testing.assert_allclose(
            t.combine({"g": torch.as_tensor(g)}, w_t)["g"].numpy(),
            np.asarray(j.combine({"g": jnp.asarray(g)}, w_j)["g"]),
            rtol=1e-6, atol=1e-7)
    assert t.realized_k_history == j.realized_k_history


ADAPTIVE = [dict(n=6, k=4, kind="cs", r=2, adaptive=True),
            dict(n=6, k=4, kind="cs", r=3, adaptive=True,
                 censored_feedback=True, feedback_beta=0.5),
            dict(n=6, k=5, kind="ss", r=3, messages=2, adaptive=True,
                 censored_feedback=True),
            dict(n=6, k=4, kind="ss", r=3, loads=(3, 1, 2, 3, 2, 1),
                 adaptive=True, coverage_gamma=0.5),
            dict(n=6, k=3, kind="cs", r=3, adaptive=True, dead_after=2),
            dict(n=6, k=4, kind="ra", adaptive=True, censored_feedback=True,
                 dead_after=1)]


@pytest.mark.parametrize("kw", ADAPTIVE)
def test_adaptive_round_masks_bit_exact(kw):
    """The adaptive aggregator over tie-exact tables (worker 2 silent, +inf,
    from round 2 on): the same schedule, weights, completion times, loads
    and realized counts every round as JAX's
    ``StragglerAggregator(adaptive=True)``."""
    cfg = tspec.RoundConfig(**kw)
    T1, T2 = tie_exact_tables(4, ROUNDS, cfg.n, cfg.width)
    T1 = T1.copy()
    T1[2:, 2] = np.inf
    jc = jspec.RoundConfig(**kw)
    j = jagg.StragglerAggregator(jc.to_round_spec(),
                                 JaxTableProcess(T1=T1, T2=T2),
                                 **jc.aggregator_kwargs())
    t = StragglerAggregator(cfg, TorchTableProcess(T1=T1, T2=T2),
                            device="cpu")
    assert cfg.aggregator_kwargs() == jc.aggregator_kwargs()
    for rnd in range(ROUNDS):
        assert_bit_equal(t.current_matrix(), j.current_matrix())
        assert_bit_equal(t.current_loads(), j.current_loads())
        w_j, t_j = j.round_mask(jax.random.PRNGKey(rnd))
        w_t, t_t = t.round_mask(rnd)
        assert_bit_equal(w_t, w_j)
        assert_bit_equal(t_t, t_j)
        assert_bit_equal(t.scheduler.est, j.scheduler.est)
    assert t.realized_k_history == j.realized_k_history


FAULT_ROUNDS = [
    dict(n=6, k=4, kind="cs", r=4, adaptive=True, rebalance=True,
         loads=(2,) * 6, feedback_beta=0.5),
    dict(n=6, k=4, kind="cs", r=4, adaptive=True, rebalance=True,
         loads=(2,) * 6, messages=2, censored_feedback=True,
         feedback_beta=0.5),
    dict(n=6, k=4, kind="cs", r=2, deadline=8e-4),
    dict(n=6, k=4, kind="ss", r=3, deadline=8e-4,
         deadline_policy="close_partial"),
    dict(n=6, k=4, kind="cs", r=3, deadline=7e-4, deadline_policy="reissue",
         adaptive=True, feedback_beta=0.5),
    dict(n=6, k=4, kind="ss", r=4, loads=(2, 3, 2, 3, 2, 2), deadline=8e-4,
         deadline_policy="reissue", adaptive=True, rebalance=True,
         censored_feedback=True, feedback_beta=0.5, dead_after=2)]


@pytest.mark.parametrize("kw", FAULT_ROUNDS)
def test_fault_round_masks_bit_exact(kw):
    """Re-balancing and deadlines (wait / close_partial / reissue) over
    shared tie-exact tables with faults (worker 2 dead in rounds 2-4, one
    lost message in round 3): the same schedule, loads, weights, completion
    times, realized counts and missed rounds every round as JAX's
    aggregator."""
    cfg = tspec.RoundConfig(**kw)
    T1, T2 = tie_exact_tables(4, 8, cfg.n, cfg.width)
    T1, T2 = T1.copy(), T2.copy()
    T1[2:5, 2] = np.inf
    T2[3, 1, 0] = np.inf
    jc = jspec.RoundConfig(**kw)
    j = jagg.StragglerAggregator(jc.to_round_spec(),
                                 JaxTableProcess(T1=T1, T2=T2),
                                 **jc.aggregator_kwargs())
    t = StragglerAggregator(cfg, TorchTableProcess(T1=T1, T2=T2),
                            device="cpu")
    for rnd in range(8):
        assert_bit_equal(t.current_matrix(), j.current_matrix())
        assert_bit_equal(t.current_loads(), j.current_loads())
        w_j, t_j = j.round_mask(jax.random.PRNGKey(rnd))
        w_t, t_t = t.round_mask(rnd)
        assert_bit_equal(w_t, w_j)
        assert_bit_equal(t_t, t_j)
    assert t.realized_k_history == j.realized_k_history
    assert t.rounds_missed == j.rounds_missed
    if cfg.deadline is not None:
        assert t.rounds_missed > 0             # the deadline bites


@pytest.mark.parametrize("kw", [dict(n=8, k=6, kind="cs", r=3),
                                dict(n=8, k=6, kind="ss", r=3, adaptive=True,
                                     censored_feedback=True)])
def test_expected_completion_matches_jax(kw):
    """``expected_completion`` on each package's own Markov cluster (8
    rounds, 2 048 trials): within 4.5 combined standard errors, the
    standard error read from the port's sweep of the same policy (a bound
    on the run mean's, shared by both sides)."""
    proc = dict(spread=3.0, p_slow=0.25, persistence=0.9, slow=8.0, seed=1)
    cj = jspec.RoundConfig(**kw)
    ct = tspec.RoundConfig(**kw)
    j = jagg.StragglerAggregator(cj.to_round_spec(), jcl.ec2_cluster(
        8, base=jd.scenario1(), **proc), **cj.aggregator_kwargs())
    tproc = tcl.ec2_cluster(8, base=scenario1(), **proc)
    t = StragglerAggregator(ct, tproc, device="cpu")
    a = t.expected_completion(3, trials=2048)
    b = j.expected_completion(3, trials=2048)
    res = tmc.sweep_rounds([ct.to_scheme_spec("s")], tproc, 8, rounds=8,
                           trials=2048, seed=3, devices="cpu",
                           **ct.sweep_rounds_kwargs())
    assert a == res.mean_round("s")
    se = float(res.stderr["s"].max())
    assert abs(a - b) < 4.5 * np.sqrt(2) * se, (a, b, se)


# ------------------------------ DGD loop ---------------------------------------

N_, D, NW = 240, 60, 6                  # benchmarks/table1_e2e.py's size
ITERS, LR = 5, 0.01


@pytest.fixture(scope="module")
def regression():
    """The JAX package's dataset (numpy) and the port's problem built from
    it, plus the JAX-side layouts examples/linear_regression_dgd.py uses."""
    X, y, _ = regression_dataset(jax.random.PRNGKey(0), N_, D)
    X, y = np.asarray(X, np.float32), np.asarray(y, np.float32)
    Xs, ys = regression_tasks(jnp.asarray(X), jnp.asarray(y), NW)
    Xs_cols = np.asarray(Xs).transpose(0, 2, 1)
    Xty_parts = np.stack([np.asarray(Xs[i]).T @ np.asarray(ys[i])
                          for i in range(NW)])
    prob = dgd.regression_problem(*convert.regression_state(X, y,
                                                            device="cpu"), NW)
    return dict(X=X, y=y, Xs_cols=Xs_cols, Xty_parts=Xty_parts, prob=prob)


@pytest.mark.parametrize("kw", [dict(n=NW, k=4, kind="cs", r=2),
                                dict(n=NW, k=NW, kind="ss", r=2),
                                dict(n=NW, k=5, kind="ra")])
def test_dgd_uncoded_matches_jax_example(regression, kw):
    """5 iterations on shared tables: the same tasks every iteration, the
    same virtual clock, and theta within rel 1e-5 of the JAX example's
    run_uncoded (float32 sums in another order)."""
    cfg = tspec.RoundConfig(**kw)
    T1, T2 = delay_tables(3, ITERS, NW, cfg.width)
    ex = load_example("linear_regression_dgd")
    spec = jspec.RoundConfig(**kw).to_round_spec()
    R = regression
    theta_j, clock_j = ex.run_uncoded(
        spec, JaxTableProcess(T1=T1, T2=T2), jnp.asarray(R["Xs_cols"]),
        R["Xty_parts"], N_, R["X"], R["y"], ITERS, LR, label="jax")
    agg = jagg.StragglerAggregator(spec, JaxTableProcess(T1=T1, T2=T2))
    C = agg.current_matrix()
    sel_j = []
    for it in range(ITERS):
        w, _ = agg.round_mask(jax.random.PRNGKey(it))
        sel_j.append(tuple(sorted({int(c) for c in C[np.asarray(w) > 0]})))
    run = dgd.run_uncoded(cfg, TorchTableProcess(T1=T1, T2=T2), R["prob"],
                          ITERS, LR, label="port")
    assert run.used == sel_j
    assert run.clock == clock_j
    assert rel_err(run.theta, theta_j) < 1e-5


def test_dgd_coded_loops_match_jax(regression):
    """PC and PCMM loops of the JAX example (eqs. 51-52, 56-57), replayed
    here in numpy on the same tables: same workers/slots used every
    iteration, theta within rel 1e-9 (float64 decode; both loops take the
    port's float32 X^T y)."""
    R, r = regression, 2
    T1, T2 = delay_tables(5, ITERS, NW, r)
    Xf = R["Xs_cols"].astype(np.float64)
    Xty = R["prob"].Xty.numpy().astype(np.float64)
    pc = dgd.run_pc(TorchTableProcess(T1=T1, T2=T2), R["prob"], r, ITERS, LR)
    pcmm = dgd.run_pcmm(TorchTableProcess(T1=T1, T2=T2), R["prob"], r,
                        ITERS, LR)
    Xt, alphas, _ = jcoded.pc_encode(Xf, r)
    Xh, betas = jcoded.pcmm_encode(Xf, r)
    th_pc = np.zeros(D)
    th_mm = np.zeros(D)
    for it in range(ITERS):
        t_w = (T1[it].sum(-1) + T2[it][:, -1])
        order = np.argsort(t_w, kind="stable")[:jcoded.pc_threshold(NW, r)]
        assert pc.used[it] == tuple(order.tolist())
        res = np.stack([jcoded.pc_worker_compute(Xt[i], th_pc)
                        for i in order])
        xxt = jcoded.pc_decode(res, alphas[order], NW, r)
        th_pc = th_pc - LR * 2 / N_ * (xxt - Xty)
        s = np.asarray(jcomp.slot_arrival_times(
            jnp.asarray(T1[it]), jnp.asarray(T2[it]))).reshape(-1)
        order = np.argsort(s, kind="stable")[:jcoded.pcmm_threshold(NW)]
        assert pcmm.used[it] == tuple(order.tolist())
        res = np.stack([jcoded.pcmm_worker_compute(Xh[o // r, o % r], th_mm)
                        for o in order])
        xxt = jcoded.pcmm_decode(res, betas.reshape(-1)[order], NW)
        th_mm = th_mm - LR * 2 / N_ * (xxt - Xty)
    assert rel_err(pc.theta, th_pc) < 1e-9
    assert rel_err(pcmm.theta, th_mm) < 1e-9


def test_table1_update_equals_full_gradient_at_k_eq_n(regression):
    """benchmarks/table1_e2e.py's check on the port: at k = n the uncoded
    (kernel path), PC and PCMM one-step updates equal the exact
    full-gradient update (bounds 1e-4, 1e-4, 1e-2)."""
    errs = dgd.table1_check(regression["prob"], 2)
    assert errs["uncoded"] < 1e-4
    assert errs["pc"] < 1e-4
    assert errs["pcmm"] < 1e-2


def test_paper_run_on_cpu_lowers_every_loss():
    cfg = RegressionConfig(N=240, d=60, n=6, r=2, k=6)
    runs = dgd.run_paper(cfg, 20, device="cpu")
    prob = dgd.paper_problem(cfg, device="cpu")
    loss0 = dgd.loss_of(torch.zeros(cfg.d), prob.X, prob.y)
    assert sorted(runs) == ["ADAPT", "CS", "PC", "PCMM", "RA", "SS"]
    for run in runs.values():
        assert dgd.loss_of(run.theta, prob.X, prob.y) < loss0
        assert len(run.used) == 20 and run.clock > 0


def test_dgd_adaptive_matches_jax_example(regression):
    """The ADAPT row: 5 iterations on shared tie-exact tables select the
    same tasks every iteration as the JAX example's
    ``run_uncoded(adaptive=True)`` (replayed through its aggregator), with
    the same virtual clock and theta within rel 1e-5 (float32 sums in
    another order)."""
    kw = dict(n=NW, k=4, kind="cs", r=2)
    cfg = tspec.RoundConfig(adaptive=True, **kw)
    T1, T2 = tie_exact_tables(6, ITERS, NW, 2)
    ex = load_example("linear_regression_dgd")
    spec = jspec.RoundConfig(**kw).to_round_spec()
    R = regression
    theta_j, clock_j = ex.run_uncoded(
        spec, JaxTableProcess(T1=T1, T2=T2), jnp.asarray(R["Xs_cols"]),
        R["Xty_parts"], N_, R["X"], R["y"], ITERS, LR, adaptive=True,
        label="jax")
    agg = jagg.StragglerAggregator(spec, JaxTableProcess(T1=T1, T2=T2),
                                   adaptive=True)
    sel_j, mats = [], []
    for it in range(ITERS):
        C = agg.current_matrix()
        mats.append(C)
        w, _ = agg.round_mask(jax.random.PRNGKey(it))
        sel_j.append(tuple(sorted({int(c) for c in C[np.asarray(w) > 0]})))
    assert any(not np.array_equal(m, mats[0]) for m in mats)
    run = dgd.run_uncoded(cfg, TorchTableProcess(T1=T1, T2=T2), R["prob"],
                          ITERS, LR, label="port")
    assert run.used == sel_j
    assert run.clock == clock_j
    assert rel_err(run.theta, theta_j) < 1e-5


def test_paper_run_on_markov_cluster_lowers_every_loss():
    cfg = RegressionConfig(N=240, d=60, n=6, r=2, k=6)
    runs = dgd.run_paper(cfg, 10, device="cpu", cluster="markov")
    prob = dgd.paper_problem(cfg, device="cpu")
    loss0 = dgd.loss_of(torch.zeros(cfg.d), prob.X, prob.y)
    assert list(runs) == ["CS", "SS", "RA", "ADAPT", "PC", "PCMM"]
    for run in runs.values():
        assert dgd.loss_of(run.theta, prob.X, prob.y) < loss0
    with pytest.raises(ValueError):
        dgd.paper_cluster(6, "bogus")
