"""jamba's router aux loss over ten training steps, the port against the
JAX package, in float32 at the CLIs' smoke cut (a Mamba and an MoE layer,
d 256): both from the same weights (``convert.lm_params``), on the same
tokens and the same JAX-drawn delay trace, ten straggler rounds (n 4, r 2,
k 3, SS) of AdamW at lr 3e-4, the trainer's rate.  The loss and the aux
loss are held step by step within the one-step bound (rel 1e-5,
``torch_lm_parity.STEP_REL``) times the step's number: each step adds the
rounding of one more update.  On the card the CLIs' cut at published
widths read aux 1.03 -> 3.97 over such ten steps while the loss fell; both
curves here are the reference's own behaviour if they agree.  The port's
ten steps run on one CPU thread: on a shared machine its small ops take
50x as long on eight.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as jopt
from repro import train as jtrain
from repro.core import DelayTrace as JDelayTrace
from repro.core import RoundConfig as JRoundConfig
from repro.core import TraceProcess as JTraceProcess
from repro.core import ec2_cluster as j_ec2
from repro_torch import optim as topt
from repro_torch.core import DelayTrace, RoundConfig, TraceProcess
from repro_torch.train import TrainState, make_straggler_train_step
from torch_lm_parity import BW, K, N, R, S, STEP_REL, lm_pair, tcfg
from torch_parity import rel_err

STEPS = 10
LR = 3e-4
#: jamba's smoke config with the reference CLIs' cut, as
#: tests/test_torch_mamba.py's JCUT
JCUT = dataclasses.replace(jconfigs.get_config("jamba-v0.1-52b").smoke(),
                           ssm_period=2, ssm_attn_offset=1)


def _curves():
    """(loss, aux) a step of the reference and of the port, ten steps."""
    params, model = lm_pair(JCUT, trainable=True)
    cfg = tcfg(JCUT)
    base = j_ec2(N, spread=3.0, persistence=0.9, seed=1)
    T1, T2 = base.sample_rounds(jax.random.PRNGKey(5), 1, N, R, STEPS)
    T1, T2 = np.asarray(T1), np.asarray(T2)
    rc = dict(n=N, k=K, kind="ss", r=R)
    jo, to = jopt.adamw(LR), topt.adamw(LR)
    jstep = jax.jit(jtrain.make_straggler_train_step(
        JCUT, jo, JRoundConfig(**rc).to_round_spec(),
        JTraceProcess(JDelayTrace(T1, T2))))
    tstep = make_straggler_train_step(cfg, to, RoundConfig(**rc),
                                      TraceProcess(DelayTrace(T1, T2)))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtrain.TrainState(jparams, jo.init(jparams),
                               jnp.zeros((), jnp.int32))
    tstate = TrainState(model, to.init(dict(model.named_parameters())), 0)
    gen = np.random.default_rng(31)
    # the reference's fresh cluster of its step 0 (cluster None), made
    # here, so that its step compiles once for all ten rounds
    jcl = JTraceProcess(JDelayTrace(T1, T2)).init_trials(
        jax.random.fold_in(jax.random.PRNGKey(0), 0x0c10)[None],
        jnp.zeros((1,), jnp.int32), N)
    tcl = None
    ref, port = [], []
    for t in range(STEPS):
        toks = gen.integers(0, JCUT.vocab_size, (R, N, BW, S))
        labs = gen.integers(0, JCUT.vocab_size, (R, N, BW, S))
        jstate, jm, jcl = jstep(jstate, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(labs, jnp.int32),
                                jax.random.PRNGKey(t), jcl)
        tstate, tm, tcl = tstep(tstate, torch.as_tensor(toks),
                                torch.as_tensor(labs), 123, tcl)
        np.testing.assert_array_equal(tm["winners"].numpy(),
                                      np.asarray(jm["winners"]))
        ref.append((float(jm["loss"]), float(jm["aux"])))
        port.append((float(tm["loss"]), float(tm["aux"])))
    return ref, port


@pytest.fixture(scope="module")
def curves():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref, port = _curves()
    finally:
        torch.set_num_threads(threads)
    return np.array(ref), np.array(port)


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_and_aux_follow_the_reference(curves, step):
    ref, port = curves
    bound = STEP_REL * (step + 1)
    assert rel_err(port[step, 0], ref[step, 0]) <= bound, (step, "loss")
    assert rel_err(port[step, 1], ref[step, 1]) <= bound, (step, "aux")


def test_the_curves_move_alike(curves):
    """The loss falls in both; the aux moves the same way in both."""
    ref, port = curves
    assert port[-1, 0] < port[0, 0] and ref[-1, 0] < ref[0, 0]
    assert np.sign(port[-1, 1] - port[0, 1]) == \
        np.sign(ref[-1, 1] - ref[0, 1])
