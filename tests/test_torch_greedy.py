"""The greedy row assignment and the adaptive scheduler: the port against the
JAX package.

Where the numbers can part: the JAX reference leaves the float32
association of ``cov @ W.T`` to XLA, while the port's plain version (and
the CUDA kernel, held to it bit for bit in tests/test_torch_card.py) folds
each score left to right over the task index with separately rounded
products and sums.  So the two are compared bit for bit on tie-exact inputs
(power-of-two estimates with gamma = 0.5: every score exact in float32),
and on random inputs every pick where they differ must be an exact tie in
real arithmetic.  The pickers are a stable argsort on both sides; the
reissue priority ``(need > 0) @ A.T`` is an exact integer count on both.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scheduling as js
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import scheduling as ts
from repro_torch.kernels import ops, ref

from torch_parity import assert_bit_equal, np_of
from torch_parity import one_thread  # noqa: F401

MATRICES = {
    "cs8x3": lambda: js.cyclic_to_matrix(8, 3),
    "ss12x3": lambda: js.staircase_to_matrix(12, 3),
    "cs6_ragged": lambda: js.cyclic_to_matrix(6, loads=[3, 1, 2, 3, 1, 3]),
    "ra5": lambda: js.random_assignment_to_matrix(5, seed=2),
    "n1": lambda: js.cyclic_to_matrix(1, 1),
    "ss7x4": lambda: js.staircase_to_matrix(7, 4),
}


def _tup(C):
    return tuple(tuple(int(v) for v in row) for row in np.asarray(C))


def pick_inputs(C, B, seed, *, exact=True, need=False, infs=False,
                gamma=0.5):
    """(W, order, epick, need_row) as numpy, built as
    ``greedy_row_assignment_batch`` builds them.  ``exact``: estimates are
    powers of two 2**-e, e in [0, 4) (many ties); else uniform in
    [0.01, 1)."""
    gen = np.random.default_rng(seed)
    n = np.asarray(C).shape[0]
    W, A = js._greedy_matrices(_tup(C), gamma)
    if exact:
        est = (2.0 ** -gen.integers(0, 4, (B, n))).astype(np.float32)
    else:
        est = gen.uniform(0.01, 1.0, (B, n)).astype(np.float32)
    if infs:
        est[gen.random((B, n)) < 0.2] = np.inf
    order = np.argsort(est, axis=-1, kind="stable").astype(np.int32)
    epick = np.maximum(np.take_along_axis(est, order, -1),
                       np.float32(1e-30))
    need_row = None
    if need:
        nd = (gen.random((B, n)) < 0.3).astype(np.float32)
        need_row = (nd @ A.T).astype(np.float32)
    return W, order, epick, need_row


def _both(W, order, epick, need_row):
    t = [torch.as_tensor(W), torch.as_tensor(order), torch.as_tensor(epick),
         None if need_row is None else torch.as_tensor(need_row)]
    j = [jnp.asarray(W), jnp.asarray(order), jnp.asarray(epick),
         None if need_row is None else jnp.asarray(need_row)]
    return ref.greedy_assign_ref(*t), jref.greedy_assign_ref(*j)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("B", [1, 37, 300])
@pytest.mark.parametrize("need,infs", [(False, False), (True, False),
                                       (True, True)])
def test_plain_equals_jax_ref_on_tie_exact_inputs(name, B, need, infs):
    C = MATRICES[name]()
    got, want = _both(*pick_inputs(C, B, seed=B, need=need, infs=infs))
    assert_bit_equal(got, want)


def _exact_argmins(W, cov, taken, need_row):
    """Rows achieving the minimum score in exact rational arithmetic, under
    the reference's rules (taken rows excluded, needed untaken rows first
    while any is left)."""
    n = W.shape[0]
    scores = [None if taken[p] else
              sum((Fraction(float(cov[j])) * Fraction(float(W[p, j]))
                   for j in range(n)), Fraction(0)) for p in range(n)]
    rows = [p for p in range(n) if not taken[p]]
    if need_row is not None:
        pref = [p for p in rows if need_row[p] > 0]
        rows = pref or rows
    best = min(scores[p] for p in rows)
    return {p for p in rows if scores[p] == best}


@pytest.mark.parametrize("name", ["cs8x3", "ss12x3", "cs6_ragged"])
@pytest.mark.parametrize("need", [False, True])
def test_random_inputs_part_only_at_exact_ties(name, need):
    """On random float32 inputs the port's fold and XLA's matmul may round
    a score differently; replaying both pick sequences, the first pick
    where they part must be an exact tie in real arithmetic (the check of
    ROADMAP.md section 3)."""
    C = MATRICES[name]()
    W, order, epick, need_row = pick_inputs(C, 1000, seed=7, exact=False,
                                            need=need)
    got, want = (np_of(x) for x in _both(W, order, epick, need_row))
    n = W.shape[0]
    for b in np.nonzero((got != want).any(-1))[0]:
        cov = np.zeros(n, np.float32)
        taken = np.zeros(n, bool)
        row_of = {int(w): p for p, w in enumerate(want[b])}
        for t in range(n):
            p_ref = row_of[int(order[b, t])]
            p_port = int(np.nonzero(got[b] == order[b, t])[0][0])
            if p_ref != p_port:
                ties = _exact_argmins(W, cov, taken,
                                      None if need_row is None
                                      else need_row[b])
                assert {p_ref, p_port} <= ties, (b, t, p_ref, p_port)
                break
            taken[p_ref] = True
            cov = cov + W[p_ref] / epick[b, t]


@pytest.mark.parametrize("need", [False, True])
def test_batch_past_the_warp_route_parts_only_at_exact_ties(need):
    """At n = 130 (past the kernel's warp route; on the card the wide route,
    held to the plain version bit for bit in tests/test_torch_card.py) the
    port's ``greedy_row_assignment_batch`` on the CPU and the JAX package's
    scan give the same picks except where a pick is an exact tie in real
    arithmetic."""
    n, B = 130, 6
    C = js.cyclic_to_matrix(n, 3)
    gen = np.random.default_rng(130 + need)
    est = gen.uniform(0.01, 1.0, (B, n)).astype(np.float32)
    nd = gen.random((B, n)) < 0.3 if need else None
    got = np_of(ts.greedy_row_assignment_batch(
        C, torch.as_tensor(est),
        need=None if nd is None else torch.as_tensor(nd)))
    want = np_of(js.greedy_row_assignment_batch(
        C, jnp.asarray(est), need=None if nd is None else jnp.asarray(nd),
        impl="scan"))
    W, A = js._greedy_matrices(_tup(C), 0.5)
    order = np.argsort(est, axis=-1, kind="stable")
    epick = np.maximum(np.take_along_axis(est, order, -1), np.float32(1e-30))
    need_row = None if nd is None else nd.astype(np.float32) @ A.T
    for b in np.nonzero((got != want).any(-1))[0]:
        cov = np.zeros(n, np.float32)
        taken = np.zeros(n, bool)
        row_of = {int(w): p for p, w in enumerate(want[b])}
        for t in range(n):
            p_ref = row_of[int(order[b, t])]
            p_port = int(np.nonzero(got[b] == order[b, t])[0][0])
            if p_ref != p_port:
                ties = _exact_argmins(W, cov, taken,
                                      None if need_row is None
                                      else need_row[b])
                assert {p_ref, p_port} <= ties, (b, t, p_ref, p_port)
                break
            taken[p_ref] = True
            cov = cov + W[p_ref] / epick[b, t]


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("gamma", [0.5, 0.3, 1.0])
def test_greedy_matrices_bit_equal(name, gamma):
    C = MATRICES[name]()
    Wt, At = ts._greedy_matrices(_tup(C), gamma)
    Wj, Aj = js._greedy_matrices(_tup(C), gamma)
    assert_bit_equal(Wt, Wj)
    assert_bit_equal(At, Aj)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("mode", ["none", "est", "est_need"])
def test_greedy_row_assignment_bit_equal(name, mode):
    C = MATRICES[name]()
    n = C.shape[0]
    gen = np.random.default_rng(n)
    est = None if mode == "none" else 2.0 ** -gen.integers(0, 4, n)
    need = gen.random(n) < 0.4 if mode == "est_need" else None
    got = ts.greedy_row_assignment(C, est, need=need, device="cpu")
    want = js.greedy_row_assignment(C, est, need=need)
    assert_bit_equal(got, want)


def test_batch_keeps_leading_dims_and_impls_agree():
    C = js.random_assignment_to_matrix(8, seed=3)
    gen = np.random.default_rng(2)
    est = torch.as_tensor(gen.uniform(0.01, 1.0, (5, 13, 8)),
                          dtype=torch.float32)
    need = torch.as_tensor(gen.random((5, 13, 8)) < 0.4)
    for nd in (None, need):
        a = ts.greedy_row_assignment_batch(C, est, need=nd, impl="scan")
        b = ts.greedy_row_assignment_batch(C, est, need=nd)
        assert a.shape == est.shape and a.dtype == torch.int32
        assert torch.equal(a, b)


def test_wrapper_cpu_path_is_the_plain_version_and_launches_nothing():
    ops.reset_launch_counts()
    W, order, epick, need_row = (torch.as_tensor(x) for x in pick_inputs(
        js.cyclic_to_matrix(8, 3), 20, seed=1, need=True))
    got = ops.greedy_assign(W, order, epick, need_row)
    assert torch.equal(got, ref.greedy_assign_ref(W, order, epick, need_row))
    assert ops.LAUNCHES["greedy_assign"] == 0


@pytest.mark.parametrize("make", [
    lambda: [torch.zeros(4, 4, device="meta"), torch.zeros(2, 4),
             torch.zeros(2, 4)],
    lambda: [torch.zeros(4, 4, device="meta"),
             torch.zeros(2, 4, device="meta"),
             torch.zeros(2, 4, device="meta")],
])
def test_wrapper_rejects_non_cuda_devices(make):
    with pytest.raises(ValueError):
        ops.greedy_assign(*make())


def test_unknown_impl_rejected_alike():
    C = js.cyclic_to_matrix(4, 2)
    with pytest.raises(ValueError):
        js.greedy_row_assignment_batch(C, jnp.ones((1, 4)), impl="bogus")
    with pytest.raises(ValueError):
        ts.greedy_row_assignment_batch(C, torch.ones(1, 4), impl="bogus")
    assert ts.GREEDY_IMPLS == js.GREEDY_IMPLS


# --------------------------- censored feedback ---------------------------------

def _feedback_inputs(seed, B, n, r, exact):
    gen = np.random.default_rng(seed)
    est = gen.uniform(1e-4, 3e-4, (B, n)).astype(np.float32)
    est[gen.random((B, n)) < 0.3] = np.inf
    if exact:
        t1 = np.broadcast_to(2.0 ** -gen.integers(8, 14, (B, n, 1)),
                             (B, n, r)).astype(np.float32)
        est = np.where(np.isfinite(est), 2.0 ** -gen.integers(8, 14, (B, n)),
                       np.inf).astype(np.float32)
    else:
        t1 = gen.uniform(1e-4, 3e-4, (B, n, r)).astype(np.float32)
    arr = gen.uniform(1e-4, 1e-3, (B, n, r)).astype(np.float32)
    arr[gen.random((B, n, r)) < 0.1] = np.inf
    t1[gen.random((B, n, r)) < 0.05] = np.inf
    t_done = gen.uniform(3e-4, 8e-4, B).astype(np.float32)
    return est, t1, arr, t_done


@pytest.mark.parametrize("r", [1, 3, 7])
@pytest.mark.parametrize("beta", [0.5, 0.7])
def test_censored_feedback_update_matches_jax(r, beta):
    """Random inputs: within rel 1e-6 (the masked slot sum is a left fold
    here and XLA's reduction there, float32); tie-exact inputs (constant
    power-of-two slot delays, power-of-two estimates, beta 0.5): bit for
    bit."""
    for exact in (False, True):
        est, t1, arr, td = _feedback_inputs(r, 64, 6, r, exact)
        got = ts.censored_feedback_update(torch.as_tensor(est),
                                          torch.as_tensor(t1),
                                          torch.as_tensor(arr),
                                          torch.as_tensor(td), beta=beta)
        want = js.censored_feedback_update(jnp.asarray(est), jnp.asarray(t1),
                                           jnp.asarray(arr), jnp.asarray(td),
                                           beta=beta)
        if exact and beta == 0.5:
            assert_bit_equal(got, want)
        else:
            g, w = np_of(got), np.asarray(want)
            assert np.array_equal(np.isinf(g), np.isinf(w))
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-6)


# --------------------------- adaptive scheduler --------------------------------

SCHEDULERS = [
    dict(C=lambda: js.cyclic_to_matrix(8, 3), kw={}, censored=False),
    dict(C=lambda: js.cyclic_to_matrix(8, 3), kw={}, censored=True),
    dict(C=lambda: js.staircase_to_matrix(6, 3, loads=[3, 1, 2, 3, 2, 1]),
         kw=dict(beta=0.5), censored=True),
    dict(C=lambda: js.cyclic_to_matrix(8, 3),
         kw=dict(dead_after=2, target_k=6), censored=False),
    dict(C=lambda: js.staircase_to_matrix(8, 2),
         kw=dict(dead_after=2, target_k=3, beta=0.5), censored=True),
    dict(C=lambda: js.staircase_to_matrix(8, 2),
         kw=dict(dead_after=1, target_k=5, beta=0.5), censored=True),
]


@pytest.mark.parametrize("case", range(len(SCHEDULERS)))
def test_adaptive_scheduler_matrix_sequence(case):
    """Both schedulers fed the same observations over 6 rounds (tie-exact:
    constant power-of-two slot delays per worker, two workers silent
    (+inf) from round 2, a random need vector every other round) give the
    same matrices, loads, estimates and silence counters."""
    cfg = SCHEDULERS[case]
    C = cfg["C"]()
    n, r = C.shape
    kw = dict(cfg["kw"], gamma=0.5)
    sj = js.AdaptiveScheduler(C, **kw)
    st = ts.AdaptiveScheduler(C, device="cpu", **kw)
    gen = np.random.default_rng(case)
    base = 2.0 ** -gen.integers(8, 14, (n, 1))
    for rnd in range(6):
        outcome = []
        for s in (st, sj):
            try:
                outcome.append(s.matrix())
            except ValueError as e:          # the degradation guard
                outcome.append(str(e))
        if isinstance(outcome[1], str):
            assert outcome[0] == outcome[1]
        else:
            assert_bit_equal(outcome[0], outcome[1])
        assert_bit_equal(st.loads(), sj.loads())
        assert_bit_equal(st.row_of_worker(), sj.row_of_worker())
        t1 = np.broadcast_to(base, (n, r)).astype(np.float32).copy()
        if rnd >= 2:
            t1[:2] = np.inf
        if cfg["censored"]:
            arr = (5e-4 * (0.5 + gen.random((n, r)))).astype(np.float32)
            arr[np.isinf(t1)] = np.inf
            td = float(np.float32(np.quantile(arr[np.isfinite(arr)], 0.6)))
            st.observe(t1, arrivals=arr, t_done=td)
            sj.observe(t1, arrivals=arr, t_done=td)
        else:
            st.observe(t1)
            sj.observe(t1)
        assert_bit_equal(st.est, sj.est)
        assert_bit_equal(st.silent, sj.silent)
        assert_bit_equal(st.dead_workers(), sj.dead_workers())
        if rnd % 2:
            need = gen.random(n) < 0.3
            st.set_need(need)
            sj.set_need(need)


def test_scheduler_raises_alike():
    C = js.cyclic_to_matrix(4, 2)
    for bad in (dict(dead_after=0), dict(target_k=5)):
        with pytest.raises(ValueError):
            js.AdaptiveScheduler(C, **bad)
        with pytest.raises(ValueError):
            ts.AdaptiveScheduler(C, device="cpu", **bad)
    st = ts.AdaptiveScheduler(C, device="cpu")
    with pytest.raises(ValueError):
        st.observe(np.ones((4, 2)), arrivals=np.ones((4, 2)))
    with pytest.raises(ValueError):
        st.set_need(np.ones(3, bool))
    # rebalance: a masked base, or no initial budget, is refused alike
    for bad in (dict(C=js.cyclic_to_matrix(4, 2, loads=[2, 1, 2, 1]),
                     loads=[2, 1, 2, 1]), dict(C=C)):
        with pytest.raises(ValueError):
            js.AdaptiveScheduler(rebalance=True, **bad)
        with pytest.raises(ValueError):
            ts.AdaptiveScheduler(rebalance=True, device="cpu", **bad)


def test_degradation_guard_raises_alike():
    """Three of four workers dead: the survivors' rows cannot cover k=3
    tasks, so both schedulers refuse to produce a matrix."""
    C = js.cyclic_to_matrix(4, 1)
    t1 = np.full((4, 1), np.inf)
    t1[0] = 1e-4
    scheds = (js.AdaptiveScheduler(C, dead_after=1, target_k=3),
              ts.AdaptiveScheduler(C, dead_after=1, target_k=3,
                                   device="cpu"))
    for s in scheds:
        s.observe(t1)
        with pytest.raises(ValueError, match="graceful degradation"):
            s.matrix()


def test_convert_carries_scheduler_state():
    """A JAX scheduler's est/silent carried into the port give the same
    next matrix."""
    C = js.staircase_to_matrix(8, 3)
    sj = js.AdaptiveScheduler(C, dead_after=2, target_k=5)
    gen = np.random.default_rng(5)
    for _ in range(3):
        t1 = np.broadcast_to(2.0 ** -gen.integers(8, 14, (8, 1)), (8, 3))
        t1 = t1.copy()
        t1[3] = np.inf
        sj.observe(t1)
    st = convert.adaptive_scheduler(C, sj.est, sj.silent, dead_after=2,
                                    target_k=5, device="cpu")
    assert_bit_equal(st.matrix(), sj.matrix())
    assert_bit_equal(st.dead_workers(), sj.dead_workers())
    with pytest.raises(ValueError):
        convert.adaptive_scheduler(C, np.ones(3), device="cpu")
