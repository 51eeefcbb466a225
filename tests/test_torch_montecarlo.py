"""Completion times and the single-round engine: the port against the JAX
package.  On shared tables (slot arrivals, delays) every result is bit for
bit the JAX one — the computations are gathers, mins, sorts and elementwise
float32 adds; sampled sweeps agree within 4 combined standard errors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import completion as jc
from repro.core import delays as jd
from repro.core import montecarlo as jm
from repro.core import scheduling as js
from repro_torch.core import completion as tc
from repro_torch.core import delays as td
from repro_torch.core import montecarlo as tm

from torch_parity import assert_bit_equal, np_of, z_scores
from torch_parity import one_thread  # noqa: F401

N, R = 8, 4
LOADS = [4, 3, 2, 1, 4, 3, 2, 1]


def spec_set(M, n=N, r=R):
    """Every feature of the evaluator: kinds to/tau/lb/pc/pcmm, ragged
    loads, message budgets and per-message overheads."""
    C, S = js.cyclic_to_matrix(n, r), js.staircase_to_matrix(n, r)
    return [M.to_spec("cs", C), M.to_spec("ss_m2", S, messages=2),
            M.to_spec("cs_rag", C, loads=LOADS),
            M.to_spec("ss_eps", S, messages=3, comm_eps=1e-5),
            M.tau_spec("tau", S, comm_eps=2e-5),
            M.tau_spec("tau_rag", C, loads=LOADS, messages=2),
            M.lb_spec(r), M.lb_spec(r, name="lb_eps", messages=3,
                                    comm_eps=2e-5),
            M.lb_spec(name="lb_rag", loads=LOADS),
            M.pc_spec(r), M.pc_spec(2, name="pc2"),
            M.pcmm_spec(r), M.pcmm_spec(r, name="pcmm_m2", messages=2)]


def slot_table(seed, chunk=48, n=N, r=R):
    """Slot arrivals with +inf slots (censored results)."""
    gen = np.random.default_rng(seed)
    s = (1e-4 * (1 + gen.random((chunk, n, r)))).astype(np.float32)
    s[3, 2, 1] = np.inf
    s[5, :, 0] = np.inf
    s[7] = np.inf
    return s


@pytest.mark.parametrize("ks", [None, 1, 3, N])
@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_evaluator_bit_exact(ks, seed):
    sig_j, par_j, slots_j = jm._eval_layout(tuple(spec_set(jm)), N, R, ks)
    sig_t, par_t, slots_t = tm._eval_layout(tuple(spec_set(tm)), N, R, ks)
    assert sig_t == sig_j and slots_t == slots_j
    assert sorted(par_t) == sorted(par_j)
    for k in par_j:
        assert_bit_equal(par_t[k], par_j[k])
    s = slot_table(seed)
    out_j = jm._build_bucket_eval(sig_j)(
        jnp.asarray(s), {k: jnp.asarray(v) for k, v in par_j.items()})
    out_t = tm._build_bucket_eval(sig_t)(torch.as_tensor(s),
                                         tm.params_on(par_t, "cpu"))
    assert sorted(out_t) == sorted(out_j)
    for g in out_j:
        assert_bit_equal(out_t[g], out_j[g])


@pytest.mark.parametrize("m", [1, 5, 8, 13, 100])
def test_tree_sum_bit_exact(m):
    v = np.random.default_rng(m).random((m, 3, 5)).astype(np.float32)
    assert_bit_equal(tm._tree_sum(torch.as_tensor(v)),
                     jm._tree_sum(jnp.asarray(v)))


@pytest.mark.parametrize("r", [1, 3, 16, 17, 40])
def test_slot_arrivals_bit_exact(r):
    """eq. (1) is a left-to-right running sum: bit-equal to numpy's
    cumsum at every r, and to the JAX package's up to r = 17.  From r = 18
    jnp.cumsum on the CPU (jax 0.9.0) associates differently; there the
    two agree to float32 round-off (a reference caveat)."""
    gen = np.random.default_rng(r)
    T1 = (1e-4 * gen.random((64, 5, r))).astype(np.float32)
    T2 = (5e-4 * gen.random((64, 5, r))).astype(np.float32)
    got = tc.slot_arrival_times(torch.as_tensor(T1), torch.as_tensor(T2))
    assert_bit_equal(got, np.cumsum(T1, axis=-1) + T2)
    want = jc.slot_arrival_times(jnp.asarray(T1), jnp.asarray(T2))
    if r <= 17:
        assert_bit_equal(got, want)
    else:
        np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-6)


@pytest.mark.parametrize("messages,loads,eps", [
    (R, None, 0.0), (2, None, 0.0), (1, None, 0.0), (3, LOADS, 0.0),
    (2, None, 1e-5), (R, LOADS, 2e-5)])
def test_message_arrivals_bit_exact(messages, loads, eps):
    gen = np.random.default_rng(7)
    T1 = (1e-4 * gen.random((32, N, R))).astype(np.float32)
    T2 = (5e-4 * gen.random((32, N, R))).astype(np.float32)
    assert_bit_equal(
        tc.message_arrival_times(torch.as_tensor(T1), torch.as_tensor(T2),
                                 messages, loads=loads, comm_eps=eps),
        jc.message_arrival_times(jnp.asarray(T1), jnp.asarray(T2), messages,
                                 loads=loads, comm_eps=eps))


MATRICES = {
    "cs": lambda: js.cyclic_to_matrix(N, R),
    "ss": lambda: js.staircase_to_matrix(N, R),
    "ra": lambda: js.random_assignment_to_matrix(N, seed=3),
    "cs_rag": lambda: js.cyclic_to_matrix(N, R, loads=LOADS),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("k", [1, 5, N])
@pytest.mark.parametrize("deadline", [None, 1.5e-4])
def test_winner_masks_bit_exact(name, k, deadline):
    C = MATRICES[name]()
    s = slot_table(11, 32, N, C.shape[1])
    plan = jm.task_gather_plan(C, N)
    assert_bit_equal(tm.task_gather_plan(C, N), plan)
    w_j, t_j = jc.winner_mask_gather(C, plan, jnp.asarray(s), N, k,
                                     deadline=deadline)
    w_t, t_t = tc.winner_mask_gather(C, plan, torch.as_tensor(s), N, k,
                                     deadline=deadline)
    assert_bit_equal(w_t, w_j)
    assert_bit_equal(t_t, t_j)
    w_j, t_j = jc.first_k_distinct_mask(C, jnp.asarray(s), N, k,
                                        deadline=deadline)
    w_t, t_t = tc.first_k_distinct_mask(C, torch.as_tensor(s), N, k,
                                        deadline=deadline)
    assert_bit_equal(w_t, w_j)
    assert_bit_equal(t_t, t_j)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_order_statistics_bit_exact(name):
    C = MATRICES[name]()
    s = slot_table(5, 32, N, C.shape[1])
    st, sj = torch.as_tensor(s), jnp.asarray(s)
    tau_t = tc.task_arrival_times(C, st, N)
    tau_j = jc.task_arrival_times(C, sj, N)
    assert_bit_equal(tau_t, tau_j)
    assert_bit_equal(tm.task_arrival_times_gather(tm.task_gather_plan(C, N),
                                                  st), tau_j)
    for k in (1, 4, N):
        assert_bit_equal(tc.completion_time(tau_t, k),
                         jc.completion_time(tau_j, k))
        assert_bit_equal(tc.lower_bound_time(st, k),
                         jc.lower_bound_time(sj, k))


@pytest.mark.parametrize("ks", [None, 5])
def test_sweep_means_match_jax(ks):
    """n=8, r=4, 20 000 trials: every scheme's mean at every k within 4
    combined standard errors of the JAX sweep."""
    trials = 20000
    specs_j = spec_set(jm)[:4] + spec_set(jm)[6:]
    specs_t = spec_set(tm)[:4] + spec_set(tm)[6:]
    res_j = jm.sweep(specs_j, jd.scenario2(N, seed=1), N, trials=trials,
                     seed=0, chunk=5000, ks=ks)
    res_t = tm.sweep(specs_t, td.scenario2(N, seed=1), N, trials=trials,
                     seed=0, chunk=5000, ks=ks, devices="cpu")
    assert sorted(res_t.means) == sorted(res_j.means)
    for name in res_j.means:
        assert res_t.means[name].shape == res_j.means[name].shape
        z = z_scores(res_t.means[name], res_t.stderr[name],
                     res_j.means[name], res_j.stderr[name])
        assert z.max() < 4, (name, z)
    assert res_t.fixed == res_j.fixed
    for name in ("cs", "pc", "pcmm"):
        assert np.isclose(res_t.at_k(name, 5), res_j.at_k(name, 5),
                          rtol=2e-2)


def test_sample_shapes_and_ragged_tau():
    C = js.cyclic_to_matrix(N, R)
    model = td.scenario1()
    cs = tm.to_spec("cs", C)
    assert tm.completion_samples(cs, model, N, trials=10,
                                 devices="cpu").shape == (10, N)
    assert tm.completion_samples(cs, model, N, trials=10, k=3,
                                 devices="cpu").shape == (10,)
    assert tm.completion_samples(tm.pcmm_spec(R), model, N, trials=10,
                                 devices="cpu").shape == (10,)
    block = js.block_to_matrix(N, 2, loads=[2, 1, 2, 1, 2, 1, 2, 1])
    tau = tm.task_arrival_samples(block, model, trials=12, devices="cpu")
    want = np.isinf(np_of(jm.task_arrival_samples(block, jd.scenario1(),
                                                  trials=12)))
    assert_bit_equal(torch.isinf(tau), want)


@pytest.mark.parametrize("bad,err", [
    (lambda M, m: M.sweep([M.to_spec("a", js.cyclic_to_matrix(N, 2))], m, N,
                          trials=5, chunk=6, devices="cpu"), ValueError),
    (lambda M, m: M.sweep([M.lb_spec(2), M.lb_spec(3)], m, N, trials=5,
                          devices="cpu"), ValueError),
    (lambda M, m: M.sweep([M.pcmm_spec(1)], m, N, trials=5,
                          devices="cpu"), ValueError),
    (lambda M, m: M.sweep([M.pc_spec(2)], m, N, trials=5, ks=N + 1,
                          devices="cpu"), ValueError),
    (lambda M, m: M.sweep([M.lb_spec(2)], m, N, trials=5,
                          devices=0), ValueError),
])
def test_sweep_validation(bad, err):
    with pytest.raises(err):
        bad(tm, td.scenario1())
