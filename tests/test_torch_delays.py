"""Delay models: the port against the JAX package.  Means of the scenario
constructors are exact (numpy on both sides); samples are compared by
distribution, since the two frameworks draw different random numbers: per
worker, means within 4 combined standard errors and the 10/50/90 %
quantiles within 4 combined binomial standard errors, at 20 000 trials.
Slots of one trial may share a worker effect or a straggler mask, so the
statistics use independent trials: the per-trial slot mean, and slot 0."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import delays as jd
from repro_torch import convert
from repro_torch.core import delays as td

from torch_parity import np_of, quantile_z, z_scores
from torch_parity import one_thread  # noqa: F401

TRIALS, N, R = 20000, 6, 2


def _empirical(mod):
    gen = np.random.default_rng(3)
    s1 = 1e-4 * (1 + gen.random((50, N)))
    s2 = 5e-4 * (1 + gen.random((40, N)))
    return mod.EmpiricalDelays(samples1=tuple(map(tuple, s1.tolist())),
                               samples2=tuple(map(tuple, s2.tolist())))


MODELS = {
    "scenario1": lambda m: m.scenario1(),
    "scenario2": lambda m: m.scenario2(N, seed=2),
    "ec2_like": lambda m: m.ec2_like(N, seed=1),
    "rho": lambda m: m.TruncatedGaussianDelays(rho=0.5, mu1=2e-4, b2=3e-4),
    "shifted_exp": lambda m: m.ShiftedExponentialDelays(),
    "bimodal": lambda m: m.BimodalStragglerDelays(p_straggle=0.3),
    "empirical": _empirical,
}


def _port_model(jax_model):
    """The port's model built from the JAX model's fields (the converter
    the parity tests use to hand state across)."""
    return convert.delay_model(type(jax_model).__name__,
                               dataclasses.asdict(jax_model))


@pytest.mark.parametrize("name", ["scenario2", "ec2_like"])
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_scenario_means_exact(name, seed):
    j = getattr(jd, name)(N, seed=seed)
    t = getattr(td, name)(N, seed=seed)
    assert t.mu1 == j.mu1 and t.mu2 == j.mu2
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_converted_model_equals_port_model(name):
    assert _port_model(MODELS[name](jd)) == MODELS[name](td)


@pytest.mark.parametrize("name", ["scenario1", "scenario2", "ec2_like", "rho"])
def test_samples_inside_support(name):
    m = MODELS[name](td)
    T1, T2 = m.sample(0, torch.arange(TRIALS), N, R)
    for T, mu, a, b in ((T1, m.mu1, m.a1, m.b1), (T2, m.mu2, m.a2, m.b2)):
        mu = torch.broadcast_to(torch.as_tensor(np.asarray(mu, np.float32)),
                                (N,)).reshape(1, N, 1)
        b = a if b is None else b
        assert bool((T >= mu - a).all()) and bool((T <= mu + b).all())
        assert T.dtype == torch.float32 and bool(torch.isfinite(T).all())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_distribution_matches_jax(name):
    jm, tm = MODELS[name](jd), MODELS[name](td)
    J1, J2 = (np.asarray(a, np.float64)
              for a in jm.sample(jax.random.PRNGKey(1), TRIALS, N, R))
    T1, T2 = (np_of(a).astype(np.float64)
              for a in tm.sample(1, torch.arange(TRIALS), N, R))
    for J, T in ((J1, T1), (J2, T2)):
        a, b = J.mean(-1), T.mean(-1)              # (trials, n) slot means
        z = z_scores(a.mean(0), a.std(0) / np.sqrt(TRIALS),
                     b.mean(0), b.std(0) / np.sqrt(TRIALS))
        assert z.max() < 4, z
        for w in range(N):
            for q in (0.1, 0.5, 0.9):
                assert quantile_z(J[:, w, 0], T[:, w, 0], q) < 4, (w, q)
