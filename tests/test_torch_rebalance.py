"""Load re-balancing — the port against the JAX package.

* ``greedy_load_rebalance[_batch]`` is integer-valued, so it is exact: +inf
  estimates, all-inf rows, equal estimates on uneven loads, ``min_load >
  1`` and a bounded number of moves included.
* ``AdaptiveScheduler(rebalance=True)``: ``loads()`` / ``matrix()`` round
  by round on feedback of the tie-exact family (tests/torch_parity.py:
  power-of-two delays constant per worker, feedback_beta = 0.5, so every
  estimate and greedy score is exact and no summation order can change a
  pick), with and without crash detection.
* The rebalance spec's validation, its closing-slot table, and rebalance
  trajectories in the rounds engine on a shared tie-exact trace (censored
  and not, with a message budget, under each deadline policy): per trial,
  bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import montecarlo as jm
from repro.core import scheduling as js
from repro.core import trace as jt
from repro_torch.core import montecarlo as tm
from repro_torch.core import scheduling as ts
from repro_torch.core import trace as tt

from torch_parity import assert_bit_equal, np_of, tie_exact_tables
from torch_parity import one_thread  # noqa: F401

N, CAP = 8, 4


def _estimates(case: str) -> tuple:
    """(est (B, N) float32, initial loads, min_load) for one case."""
    gen = np.random.default_rng(sum(map(ord, case)))
    est = gen.uniform(0.1, 2.0, (64, N)).astype(np.float32)
    loads, min_load = np.full(N, 2), 1
    if case == "inf":
        est[gen.random(est.shape) < 0.2] = np.inf
        est[0] = np.inf                              # an all-inf row
    elif case == "equal_uneven":
        est[:] = 0.5
        loads = np.array([4, 1, 1, 4, 2, 1, 2, 1])
    elif case == "ties":
        est = np.round(est * 4) / 4                  # many equal finishes
        loads = gen.integers(1, CAP + 1, N)
    elif case == "min_load":
        loads, min_load = np.full(N, 3), 2
    return est, loads, min_load


@pytest.mark.parametrize("case", ["random", "inf", "equal_uneven", "ties",
                                  "min_load"])
@pytest.mark.parametrize("steps", [None, 3])
def test_rebalance_batch_exact(case, steps):
    est, loads, min_load = _estimates(case)
    want = js.greedy_load_rebalance_batch(jnp.asarray(est), loads,
                                          r_max=CAP, min_load=min_load,
                                          steps=steps)
    got = ts.greedy_load_rebalance_batch(torch.as_tensor(est), loads,
                                         r_max=CAP, min_load=min_load,
                                         steps=steps)
    assert_bit_equal(got, want)
    assert (np_of(got).sum(-1) == loads.sum()).all()
    if case == "inf":
        assert (np_of(got)[0] == loads).all()        # no feedback: unchanged


def test_rebalance_moves_slots():
    """The random case is not a fixed point: slots move."""
    est, loads, _ = _estimates("random")
    got = np_of(ts.greedy_load_rebalance_batch(torch.as_tensor(est), loads,
                                               r_max=CAP))
    assert (got != loads).any()


@pytest.mark.parametrize("kw", [dict(loads=[2] * N), dict(total=13),
                                dict(loads=[3] * N, min_load=2),
                                dict(loads=[1, 2, 3, 4, 1, 2, 3, 4])])
def test_rebalance_single_exact(kw):
    gen = np.random.default_rng(7)
    est = gen.uniform(0.1, 2.0, N).astype(np.float32)
    est[3] = np.inf
    want = js.greedy_load_rebalance(est, r_max=CAP, **kw)
    got = ts.greedy_load_rebalance(est, r_max=CAP, device="cpu", **kw)
    assert_bit_equal(got, want)


@pytest.mark.parametrize("bad", [
    dict(speed_est=None, loads=None, total=None),
    dict(speed_est=np.ones(N), loads=[2] * N, total=17),
    dict(speed_est=np.ones(N), loads=[2] * N, min_load=3),
    dict(speed_est=np.ones(N), loads=[5] + [2] * (N - 1)),
    dict(speed_est=np.ones(N - 1), loads=[2] * N)])
def test_rebalance_raises_alike(bad):
    with pytest.raises(ValueError):
        js.greedy_load_rebalance(r_max=CAP, **bad)
    with pytest.raises(ValueError):
        ts.greedy_load_rebalance(r_max=CAP, device="cpu", **bad)


@pytest.mark.parametrize("kw", [dict(), dict(dead_after=2, target_k=6),
                                dict(min_load=2)])
def test_scheduler_loads_and_matrix_sequences(kw):
    """Eight rounds of feedback (worker 3 silent in rounds 1-3): the same
    loads, masked matrix, assignment and estimates every round."""
    n, cap = 12, 6
    C = js.cyclic_to_matrix(n, cap)
    loads = [3] * n
    e = np.random.default_rng(1).integers(8, 14, n)
    sj = js.AdaptiveScheduler(C, loads=loads, rebalance=True, beta=0.5, **kw)
    st = ts.AdaptiveScheduler(C, loads=loads, rebalance=True, beta=0.5,
                              device="cpu", **kw)
    moved = False
    for rnd in range(8):
        assert_bit_equal(st.loads(), sj.loads())
        assert_bit_equal(st.matrix(), sj.matrix())
        assert_bit_equal(st.worker_of_row(), sj.worker_of_row())
        moved |= bool((st.loads() != 3).any())
        t1 = np.broadcast_to(2.0 ** -e[:, None], (n, cap)).copy()
        if rnd in (1, 2, 3):
            t1[3] = np.inf
        if rnd % 2:
            arr = np.cumsum(t1, -1) + 1e-4
            sj.observe(t1, arrivals=arr, t_done=float(np.median(arr)))
            st.observe(t1, arrivals=arr, t_done=float(np.median(arr)))
        else:
            sj.observe(t1)
            st.observe(t1)
        np.testing.assert_array_equal(st.est, sj.est)
        np.testing.assert_array_equal(st.dead_workers(), sj.dead_workers())
    assert moved


def test_scheduler_before_feedback_keeps_the_budget():
    C = js.cyclic_to_matrix(N, CAP)
    st = ts.AdaptiveScheduler(C, loads=[2] * N, rebalance=True, device="cpu")
    assert (st.loads() == 2).all()
    assert (st.matrix()[:, 2:] == ts.MASKED).all()


def test_remap_table_equals_the_references():
    for cap in (1, 3, 4, 6):
        for m in range(1, cap + 2):
            want = jm._rebalance_remap_table(cap, m)
            got = tm._rebalance_remap_table(cap, m)
            if want is None:
                assert got is None
            else:
                assert_bit_equal(got, want)


@pytest.mark.parametrize("bad", [
    lambda M: M.adaptive_spec("a", js.cyclic_to_matrix(N, CAP),
                              rebalance=True),            # no budget
    lambda M: M.adaptive_spec("a", js.cyclic_to_matrix(
        N, CAP, loads=[2] * N), loads=[2] * N, rebalance=True),  # masked
    lambda M: M.adaptive_spec("a", js.block_to_matrix(N, CAP),
                              loads=[2] * N, rebalance=True),  # no diagonal
    lambda M: M.SchemeSpec(
        name="a", kind="to", C=tuple(map(tuple, js.cyclic_to_matrix(N, 2))),
        loads=(2,) * N, rebalance=True)])                 # not adaptive
def test_rebalance_specs_refused_alike(bad):
    T = np.ones((2, N, CAP), np.float32)
    for M, trace, kw in ((jm, jt.DelayTrace(T, T), {}),
                         (tm, tt.DelayTrace(T, T), {"devices": "cpu"})):
        with pytest.raises(ValueError):
            M.sweep_rounds([bad(M)], trace, N, rounds=2, k=4, trials=2,
                           **kw)


ROUNDS, TRIALS = 5, 64


@pytest.fixture(scope="module")
def shared_trace():
    T1, T2 = tie_exact_tables(11, ROUNDS, N, CAP, trials=TRIALS)
    T1 = T1.copy()
    T1[3:, :, 5] = np.inf                        # worker 5 dies at round 3
    return jt.DelayTrace(T1, T2), tt.DelayTrace(T1, T2)


def _rebal(M, messages=None):
    return M.adaptive_spec(f"rebal_m{messages}", js.cyclic_to_matrix(N, CAP),
                           loads=[2] * N, rebalance=True, messages=messages)


@pytest.fixture(scope="module")
def jax_rounds(shared_trace):
    """(censored, policy) -> the JAX rounds function's per-trial closes of
    both rebalance specs (one compile per key, shared by the cases)."""
    cache = {}

    def get(censored, policy):
        if (censored, policy) not in cache:
            fn = jm._build_rounds_fn(
                (_rebal(jm), _rebal(jm, 2)), jt.TraceProcess(shared_trace[0]),
                N, CAP, 6, ROUNDS, 0.5, 0.5, censored,
                None if policy is None else 2e-3, policy or "wait", "scan")
            cache[censored, policy] = jax.jit(fn)(
                jm.trial_keys(0, TRIALS),
                jnp.arange(TRIALS, dtype=jnp.int32))[0]
        return cache[censored, policy]
    return get


@pytest.mark.parametrize("messages", [None, 2])
@pytest.mark.parametrize("censored", [False, True])
@pytest.mark.parametrize("policy", [None, "reissue"])
def test_rebalance_trajectories_bit_exact(shared_trace, jax_rounds, messages,
                                          censored, policy):
    """The port's trajectory_samples (chunked) against the JAX rounds
    function's closes of the same spec, trial by trial (close_partial:
    tests/test_torch_faults.py, on recorded fault traces)."""
    kw = dict(rounds=ROUNDS, k=6, trials=TRIALS, feedback_beta=0.5,
              coverage_gamma=0.5, censored_feedback=censored)
    if policy is not None:
        kw.update(deadline=2e-3, deadline_policy=policy)
    spec = _rebal(tm, messages)
    want = jax_rounds(censored, policy)[spec.name].T
    got = tm.trajectory_samples(spec, tt.TraceProcess(shared_trace[1]), N,
                                chunk=32, devices="cpu", **kw)
    assert_bit_equal(got, want)
    assert np.isfinite(np_of(got)).all()


def test_rebalance_with_a_wider_grid_keeps_its_slots():
    """A rebalance spec with a message budget beside a wider spec (r_max =
    6 > cap = 4) scores the slots it scores alone: the load-indexed
    closing-slot table keeps the grid's width (a reference caveat: the JAX
    package gathers a (cap, cap) table there and its plan reads clamped
    indices, ROADMAP.md)."""
    T1, T2 = tie_exact_tables(12, 3, N, 6, trials=16)
    trace = tt.DelayTrace(T1, T2)
    kw = dict(rounds=3, k=6, trials=16, feedback_beta=0.5,
              coverage_gamma=0.5, devices="cpu")
    alone = tm.sweep_rounds([_rebal(tm, 2)], trace, N, **kw)
    wide = tm.sweep_rounds([_rebal(tm, 2), tm.lb_spec(6)], trace, N, **kw)
    assert_bit_equal(wide.per_round["rebal_m2"], alone.per_round["rebal_m2"])
