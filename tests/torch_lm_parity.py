"""Shared checks of the port's LM families against the JAX package
(``tests/test_torch_moe.py``, ``test_torch_mla.py``, ``test_torch_vlm.py``,
``test_torch_mamba.py``):
a JAX parameter tree and the port's model holding the same weights, the
straggler train step on one round of a JAX-drawn trace, and the parameter
tree at full size through ``jax.eval_shape`` (nothing allocated).  Inputs
are made with numpy from fixed seeds; nothing here changes global state.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro import optim as jopt
from repro import train as jtrain
from repro.core import DelayTrace as JDelayTrace
from repro.core import RoundConfig as JRoundConfig
from repro.core import TraceProcess as JTraceProcess
from repro.core import ec2_cluster as j_ec2
from repro.models import init_params as j_init_params
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.core import DelayTrace, RoundConfig, TraceProcess
from repro_torch.models import config as tcfgmod
from repro_torch.models import model as tmodel
from repro_torch.train import TrainState, make_straggler_train_step
from torch_parity import rel_err

#: tests/test_torch_models.py's logits bound (float32, smoke width)
LOGITS_ATOL = 2e-4
#: tests/test_models.py's decode-against-full bound
DECODE_ATOL = 2e-3
#: the straggler step's bounds (tests/test_torch_train.py): loss, grad norm
#: and aux rel 1e-5, weights after momentum SGD within 1e-6
STEP_REL = 1e-5
STEP_W_ATOL = 1e-6
N, R, K, BW, S = 4, 2, 3, 2, 12


def tcfg(jcfg):
    """The port's ModelConfig with the same fields as a JAX one."""
    return tcfgmod.ModelConfig(**dataclasses.asdict(jcfg))


def port_model(cfg, state, *, trainable=False):
    """The port's model of ``cfg`` holding the weights ``state`` (a state
    dict of CPU tensors), none drawn: built on the ``meta`` device, the
    state's tensors assigned."""
    model = tmodel.init_params(cfg, device="meta", trainable=trainable)
    model.load_state_dict(state, assign=True)
    return model


def lm_pair(jcfg, seed=0, *, trainable=False):
    """The JAX parameters of ``jcfg`` (numpy leaves) and the port's model
    holding the same weights (``convert.lm_params``)."""
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        j_init_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg))
    return params, port_model(tcfg(jcfg), convert.lm_params(
        params, tcfg(jcfg)), trainable=trainable)


def assert_config_is_the_references(arch):
    j = jconfigs.get_config(arch)
    assert dataclasses.asdict(tconfigs.get_config(arch)) == \
        dataclasses.asdict(j)
    assert dataclasses.asdict(tcfg(j).smoke()) == dataclasses.asdict(
        j.smoke())
    # the whole registry, in the reference's order
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS


def straggler_step_parity(jcfg, params, extras_np=None):
    """One straggler round (n 4, r 2, k 3, SS, momentum SGD 0.1) on a
    JAX-drawn trace through both packages from the same weights: rounds
    exact; loss, grad norm and aux rel 1e-5; every weight after the step
    within 1e-6.  ``extras_np`` maps an extras key to a function of (r, n,
    b, rng) giving its slot-major numpy array.  Returns the port's
    metrics."""
    cfg = tcfg(jcfg)
    base = j_ec2(N, spread=3.0, persistence=0.9, seed=1)
    T1, T2 = base.sample_rounds(jax.random.PRNGKey(5), 1, N, R, 1)
    T1, T2 = np.asarray(T1), np.asarray(T2)
    rc = dict(n=N, k=K, kind="ss", r=R)
    jo, to = jopt.momentum(0.1), topt.momentum(0.1)
    jstep = jax.jit(jtrain.make_straggler_train_step(
        jcfg, jo, JRoundConfig(**rc).to_round_spec(),
        JTraceProcess(JDelayTrace(T1, T2))))
    model = port_model(cfg, convert.lm_params(params, cfg), trainable=True)
    tstate = TrainState(model, to.init(dict(model.named_parameters())), 0)
    tstep = make_straggler_train_step(cfg, to, RoundConfig(**rc),
                                      TraceProcess(DelayTrace(T1, T2)))
    gen = np.random.default_rng(11)
    toks = gen.integers(0, jcfg.vocab_size, (R, N, BW, S))
    labs = gen.integers(0, jcfg.vocab_size, (R, N, BW, S))
    extras = {k: f(R, N, BW, gen) for k, f in (extras_np or {}).items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtrain.TrainState(jparams, jo.init(jparams),
                               jnp.zeros((), jnp.int32))
    jstate, jm, _ = jstep(jstate, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(labs, jnp.int32),
                          jax.random.PRNGKey(0), None, None,
                          {k: jnp.asarray(v) for k, v in extras.items()})
    tstate, tm, _ = tstep(tstate, torch.as_tensor(toks),
                          torch.as_tensor(labs), 123,
                          extras={k: torch.as_tensor(v)
                                  for k, v in extras.items()})
    for key in ("completion_time", "winners", "realized_k"):
        np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]))
    for key in ("loss", "grad_norm", "aux"):
        if float(jm[key]) == 0.0:
            assert float(tm[key]) == 0.0, key
        else:
            assert rel_err(tm[key], jm[key]) <= STEP_REL, key
    want = convert._unstack(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params), cfg)
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst <= STEP_W_ATOL, worst
    return tm


def assert_full_size_like_the_reference(arch):
    """The port's ``meta``-device model of ``arch`` at full size against
    ``jax.eval_shape`` of the reference's ``init_params``: the same names,
    shapes and dtypes, the same count, and ``active_params`` equal to the
    reference's.  Returns the port's model (shapes only)."""
    jcfg = jconfigs.get_config(arch)
    cfg = tcfg(jcfg)
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    want = {n: (a.shape, str(a.dtype))
            for n, a in convert._unstack(zeros, cfg).items()}
    model = tmodel.init_params(cfg, device="meta")
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in model.named_parameters()}
    assert got == want
    assert tmodel.num_params(model) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert tmodel.active_params(cfg) == jmodel.active_params(jcfg)
    return model
