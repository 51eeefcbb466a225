"""Theorem 1, the lower bound and the multi-message coded expectations: the
port's ``core/theory.py`` and completion drivers against the JAX package.

Parity levels: the closed forms are float64 numpy in both packages, in one
order of summation, so they are compared bit for bit; ``H(S)`` is exact
against the reference's formula on the port's own samples; the Monte-Carlo
wrappers draw different numbers in the two frameworks, so they are compared
by distribution (means within z = 4 combined standard errors); inside the
port, Theorem 1's mean agrees with the direct order statistic as
``tests/test_theory.py`` demands of the reference (3 %, its tolerance).
"""
import math

import numpy as np
import pytest

from repro.core import delays as jd
from repro.core import montecarlo as jmc
from repro.core import theory as jt
from repro.core import (mean_completion_time as j_mean_completion_time,
                        simulate_completion as j_simulate_completion)
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.core import delays as td
from repro_torch.core import theory as tt

from torch_parity import assert_bit_equal, np_of, z_scores
from torch_parity import one_thread  # noqa: F401

CPU = "cpu"


def _grid_H(n, npts, seed):
    """A deterministic H(S) over a grid: the product of per-index survival
    curves, each a random decreasing table (any function of S will do: the
    assembly is the same arithmetic in both packages)."""
    gen = np.random.default_rng(seed)
    curves = np.sort(gen.random((n, npts)), axis=1)[:, ::-1].copy()

    def H(S):
        out = np.ones(npts)
        for j in S:
            out = out * curves[j]
        return out
    return H


@pytest.mark.parametrize("n,k", [(4, 3), (5, 1), (5, 5), (6, 4), (7, 2)])
def test_theorem1_assembly_is_bit_equal(n, k):
    H = _grid_H(n, 64, seed=n * 10 + k)
    assert_bit_equal(tt.theorem1_tail_from_H(H, n, k),
                     jt.theorem1_tail_from_H(H, n, k))
    for i in range(n - k + 1, n + 1):
        assert tt._coef(n, k, i) == jt._coef(n, k, i)


def test_survival_grid_and_r1_case_are_bit_equal():
    m = td.scenario1()
    pdf1 = tt.truncated_gaussian_pdf(m.mu1, m.sigma1, m.a1)
    pdf2 = tt.truncated_gaussian_pdf(m.mu2, m.sigma2, m.a2)
    jpdf1 = jt.truncated_gaussian_pdf(m.mu1, m.sigma1, m.a1)
    jpdf2 = jt.truncated_gaussian_pdf(m.mu2, m.sigma2, m.a2)
    t = np.linspace(0.0, 2e-3, 777)
    assert_bit_equal(pdf1(t), jpdf1(t))
    assert_bit_equal(pdf2(t), jpdf2(t))
    tg, surv = tt.sum_survival_grid(pdf1, pdf2, 2e-3, npts=1024)
    jtg, jsurv = jt.sum_survival_grid(jpdf1, jpdf2, 2e-3, npts=1024)
    assert_bit_equal(tg, jtg)
    assert_bit_equal(surv, jsurv)
    survs = [surv, surv ** 1.1, surv ** 0.9, surv]
    assert_bit_equal(tt.theorem1_tail_r1_independent(survs, 3),
                     jt.theorem1_tail_r1_independent(survs, 3))


def test_truncated_gaussian_pdf_asymmetric_is_bit_equal():
    t = np.linspace(-1e-4, 8e-4, 501)
    assert_bit_equal(tt.truncated_gaussian_pdf(3e-4, 1e-4, 5e-5, 2e-4)(t),
                     jt.truncated_gaussian_pdf(3e-4, 1e-4, 5e-5, 2e-4)(t))


def _sexp_pdf(shift, mean):
    return lambda t: np.where(
        t >= shift, np.exp(-np.minimum((t - shift) / mean, 700.0)) / mean,
        0.0)


@pytest.mark.parametrize("r,messages", [(1, 1), (4, 1), (4, 2), (4, 4),
                                        (5, 3)])
def test_multimessage_marginal_cdfs_are_bit_equal(r, messages):
    pdf1, pdf2 = _sexp_pdf(1e-4, 5e-5), _sexp_pdf(2e-4, 1e-4)
    got = tt.multimessage_marginal_cdfs(pdf1, pdf2, r, messages, 4e-3, 512)
    want = jt.multimessage_marginal_cdfs(pdf1, pdf2, r, messages, 4e-3, 512)
    assert_bit_equal(got[0], want[0])
    assert_bit_equal(got[1], want[1])


@pytest.mark.parametrize("n,r,messages,threshold,comm_eps", [
    (8, 4, 1, None, 0.0), (8, 4, 2, None, 0.0), (8, 4, 4, None, 0.0),
    (8, 4, 1, "pc", 0.0), (6, 3, 3, None, 1e-4), (5, 5, 2, 7, 3e-4)])
def test_multimessage_coded_tail_and_mean_are_bit_equal(n, r, messages,
                                                        threshold, comm_eps):
    pdf1, pdf2 = _sexp_pdf(1e-4, 5e-5), _sexp_pdf(2e-4, 1e-4)
    if threshold == "pc":              # eqs. 51-52: PC at full workers
        threshold = (2 * math.ceil(n / r) - 2) * r + 1
    kw = dict(tmax=6e-3, npts=1024, threshold=threshold, comm_eps=comm_eps)
    assert (tt.multimessage_coded_mean(n, r, messages, pdf1, pdf2, **kw)
            == jt.multimessage_coded_mean(n, r, messages, pdf1, pdf2, **kw))
    t, F = jt.multimessage_marginal_cdfs(pdf1, pdf2, r, messages, 6e-3, 1024)
    assert_bit_equal(tt._shift_message_cdfs(t, F, comm_eps),
                     jt._shift_message_cdfs(t, F, comm_eps))
    gs = jmc.message_group_sizes(r, messages)
    assert_bit_equal(tcore.message_group_sizes(r, messages), gs)
    th = 2 * n - 1 if threshold is None else threshold
    assert_bit_equal(tt.multimessage_coded_tail(F, gs, n, th),
                     jt.multimessage_coded_tail(F, gs, n, th))


def test_multimessage_coded_tail_raises_alike():
    F = np.ones((2, 4))
    for gs, th in (([1], 3), ([2, 0], 3), ([2, 2], 0), ([2, 2], 100)):
        with pytest.raises(ValueError):
            jt.multimessage_coded_tail(F, gs, 4, th)
        with pytest.raises(ValueError):
            tt.multimessage_coded_tail(F, gs, 4, th)


@pytest.mark.parametrize("n,r,k,messages,comm_eps", [
    (6, 3, 4, None, 0.0), (8, 4, 8, 2, 0.0), (8, 4, 5, 1, 2e-4),
    (5, 2, 10, 9, 1e-4)])
def test_operating_point_mean_lb_is_bit_equal(n, r, k, messages, comm_eps):
    m = td.scenario1()
    args = (tt.truncated_gaussian_pdf(m.mu1, m.sigma1, m.a1),
            tt.truncated_gaussian_pdf(m.mu2, m.sigma2, m.a2))
    kw = dict(messages=messages, comm_eps=comm_eps, tmax=5e-3, npts=512)
    assert (tt.operating_point_mean_lb(n, r, k, *args, **kw)
            == jt.operating_point_mean_lb(n, r, k, *args, **kw))


DELAY_MODELS = {
    "scenario1": lambda m: m.scenario1(),
    "scenario2": lambda m: m.scenario2(5, seed=3),
    "ec2_like": lambda m: m.ec2_like(5),
    "truncgauss_asym": lambda m: m.TruncatedGaussianDelays(b1=5e-5,
                                                           b2=3e-4),
    "truncgauss_rho": lambda m: m.TruncatedGaussianDelays(rho=0.3),
    "shifted_exp": lambda m: m.ShiftedExponentialDelays(mean1=1e-5),
    "bimodal": lambda m: m.BimodalStragglerDelays(slow=3.0),
    "empirical": lambda m: m.EmpiricalDelays(samples1=((1e-4, 2e-4),),
                                             samples2=((3e-4, 4e-4),)),
}


@pytest.mark.parametrize("name", sorted(DELAY_MODELS))
def test_delay_model_pdfs_on_every_port_model(name):
    got = tt.delay_model_pdfs(DELAY_MODELS[name](td))
    want = jt.delay_model_pdfs(DELAY_MODELS[name](jd))
    assert (got is None) == (want is None)
    if got is None:
        return
    t = np.linspace(0.0, 2e-3, 301)
    for g, w in zip(got[:2], want[:2]):
        assert_bit_equal(g(t), w(t))
    assert got[2:] == want[2:]


def test_delay_model_pdfs_reads_the_ports_class():
    """A model carried over by ``convert`` is the port's own class, which
    ``delay_model_pdfs`` recognizes (the reference's class is not it)."""
    jm = jd.scenario1()
    m = convert.delay_model("TruncatedGaussianDelays", jm.__dict__)
    assert tt.delay_model_pdfs(m) is not None
    assert tt.delay_model_pdfs(jm) is None


@pytest.mark.parametrize("sched,messages", [("cs", None), ("ss", 2),
                                            ("ragged", None)])
def test_H_is_the_reference_formula_on_the_ports_samples(sched, messages):
    n, r = 6, 3
    if sched == "ragged":
        C = tcore.cyclic_to_matrix(n, loads=[3, 1, 2, 3, 1, 2])
    elif sched == "cs":
        C = tcore.cyclic_to_matrix(n, r)
    else:
        C = tcore.staircase_to_matrix(n, r)
    model = td.scenario1()
    tg = np.linspace(0.0, 3e-3, 200)
    kw = dict(trials=3000, seed=4, messages=messages)
    H = tt.joint_survival_mc(C, model, tg, devices=CPU, **kw)
    tau = np_of(tcore.task_arrival_samples(C, model, devices=CPU, **kw))
    for S in [(0,), (2, 5), (0, 1, 3), tuple(range(n))]:
        m = tau[:, list(S)].min(axis=1)
        assert_bit_equal(H(S), (m[:, None] > tg[None, :]).mean(axis=0))


@pytest.mark.parametrize("n,r,k,sched", [
    (4, 2, 3, "cs"), (4, 2, 4, "cs"), (5, 2, 4, "ss"),
    (6, 3, 4, "cs"), (6, 3, 6, "ss"), (5, 5, 2, "cs"),
])
def test_theorem1_identity_vs_direct_mc(n, r, k, sched):
    C = (tcore.cyclic_to_matrix(n, r) if sched == "cs"
         else tcore.staircase_to_matrix(n, r))
    m = td.scenario1()
    t_thm = tt.theorem1_mean_mc(C, m, k=k, tmax=4e-3, trials=6000,
                                devices=CPU)
    t_mc = tcore.mean_completion_time(C, m, k=k, trials=6000, devices=CPU)
    assert abs(t_thm - t_mc) / t_mc < 0.03


def test_theorem1_tail_is_valid_survival():
    n, r, k = 5, 2, 4
    tg = np.linspace(0, 4e-3, 128)
    tail = tt.theorem1_tail_mc(tcore.cyclic_to_matrix(n, r), td.scenario1(),
                               tg, trials=6000, k=k, devices=CPU)
    assert tail[0] > 0.999
    assert tail[-1] < 1e-3
    assert (np.diff(tail) <= 1e-6).all()
    with pytest.raises(ValueError):
        tt.theorem1_tail_mc(tcore.cyclic_to_matrix(n, r), td.scenario1(),
                            tg, k=0, devices=CPU)


def test_theorem1_analytic_r1_independent():
    n, k = 6, 4
    m = td.scenario1()
    pdf1 = tt.truncated_gaussian_pdf(m.mu1, m.sigma1, m.a1)
    pdf2 = tt.truncated_gaussian_pdf(m.mu2, m.sigma2, m.a2)
    tg, surv = tt.sum_survival_grid(pdf1, pdf2, 2e-3)
    tail = tt.theorem1_tail_r1_independent([surv] * n, k)
    t_analytic = float(np.trapezoid(np.clip(tail, 0, 1), tg))
    t_mc = tcore.mean_completion_time(tcore.cyclic_to_matrix(n, 1), m, k,
                                      trials=20000, devices=CPU)
    assert abs(t_analytic - t_mc) / t_mc < 0.02


def test_lower_bound_tight_for_r_equal_n_small_k():
    n = 8
    m = td.scenario1()
    C = tcore.staircase_to_matrix(n, n)
    for k in (2, 4):
        ub = tcore.mean_completion_time(C, m, k, trials=6000, devices=CPU)
        lb = float(tcore.simulate_lower_bound(m, n, n, k, trials=6000,
                                              devices=CPU).mean())
        assert (ub - lb) / lb < 0.08, (k, ub, lb)


def test_lower_bound_increases_with_k():
    m = td.scenario1()
    lbs = [tt.lower_bound_mean_mc(m, 6, k, r=3, trials=3000, devices=CPU)
           for k in range(1, 7)]
    assert all(a < b for a, b in zip(lbs, lbs[1:]))
    tg = np.linspace(0.0, 3e-3, 64)
    tails = [tt.lower_bound_tail_mc(m, 6, k, tg, r=3, trials=3000,
                                    devices=CPU) for k in (2, 5)]
    assert (tails[0] <= tails[1]).all() and tails[0][0] == 1.0


Z = 4.0


def test_mc_wrappers_agree_with_the_reference_by_distribution():
    """Theorem 1's mean and the lower bound's, port against reference at
    (6, 3, 4) CS on scenario 1, within Z combined standard errors (the
    direct samples' standard error stands for each mean's)."""
    n, r, k, trials = 6, 3, 4, 6000
    C = tcore.cyclic_to_matrix(n, r)
    tm, jm = td.scenario1(), jd.scenario1()
    t_thm = tt.theorem1_mean_mc(C, tm, k, tmax=4e-3, trials=trials,
                                devices=CPU)
    j_thm = jt.theorem1_mean_mc(C, jm, k, tmax=4e-3, trials=trials)
    t_s = np_of(tcore.simulate_completion(C, tm, k, trials=trials,
                                          devices=CPU))
    j_s = np_of(j_simulate_completion(C, jm, k, trials=trials))
    se_t, se_j = (s.std() / math.sqrt(trials) for s in (t_s, j_s))
    assert z_scores(t_thm, se_t, j_thm, se_j) < Z
    t_lb = tt.lower_bound_mean_mc(tm, n, k, r=r, trials=trials, devices=CPU)
    j_lb = jt.lower_bound_mean_mc(jm, n, k, r=r, trials=trials)
    lb_s = np_of(tcore.simulate_lower_bound(tm, n, r, k, trials=trials,
                                            devices=CPU))
    se_lb = lb_s.std() / math.sqrt(trials)
    assert z_scores(t_lb, se_lb, j_lb, se_lb) < Z
    assert t_lb <= t_thm


def test_completion_drivers_are_the_engines_calls():
    n, r, k = 6, 3, 4
    C = tcore.staircase_to_matrix(n, r)
    m = td.scenario2(n, seed=1)
    kw = dict(trials=700, seed=3, chunk=300, devices=CPU)
    assert_bit_equal(
        tcore.simulate_completion(C, m, k, **kw),
        tcore.completion_samples(tcore.to_spec("to", C), m, n, k=k, **kw))
    assert_bit_equal(
        tcore.simulate_lower_bound(m, n, r, k, **kw),
        tcore.completion_samples(tcore.lb_spec(r), m, n, k=k, **kw))
    loads = [3, 1, 2, 3, 2, 1]
    assert_bit_equal(
        tcore.simulate_lower_bound(m, n, k=k, loads=loads, **kw),
        tcore.completion_samples(tcore.lb_spec(None, loads=loads), m, n,
                                 k=k, **kw))
    assert (tcore.mean_completion_time(C, m, k, **kw)
            == tcore.sweep([tcore.to_spec("to", C)], m, n, ks=k,
                           **kw).at_k("to", k))
    # and the reference's driver by distribution
    jC = np.asarray(C)
    want = j_mean_completion_time(jC, jd.scenario2(n, seed=1), k,
                                  trials=4000)
    got = tcore.sweep([tcore.to_spec("to", C)], m, n, ks=k, trials=4000,
                      devices=CPU)
    assert z_scores(got.at_k("to", k), got.stderr["to"][0], want,
                    got.stderr["to"][0]) < Z


def test_core_exports_the_references_theory():
    for name in jt.__all__ + ["simulate_completion", "simulate_lower_bound",
                              "mean_completion_time"]:
        assert name in tcore.__all__ and hasattr(tcore, name), name
