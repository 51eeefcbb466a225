"""rwkv6-1.6b in the port against the JAX package, at the reference's smoke
config in float32 (2 layers of the RWKV-6 time-mix with SwiGLU, d 256, 4
heads of 64): the token shift, ``rwkv6_apply`` without and with a state
(outputs atol 1e-5, the state ``S`` rel 1e-5, ``x_prev`` exact), the
channel-mix ``cmix_apply`` with and without ``prev`` and through
``block_apply`` in a hand-built (rwkv6, cmix) layer, which no config
reaches; ``forward`` and prefill then decode against the JAX decode (atol
2e-4, tests/test_torch_models.py's logits bound, and each layer's ``S`` rel
1e-5); decode against the port's own full forward (2e-3); the straggler
train step on one round of a JAX-drawn trace (rounds exact, loss rel
1e-5, weights after momentum SGD within 1e-6, tests/test_torch_train.py's
bounds; the grad norm within those or twice the reference's own float32
error, measured against the step in float64); the initialisation's constants and
scales; the parameter shapes, dtypes (``w0``, ``u`` and ``ln_out`` float32
in a bfloat16 model) and count at full size; serving and the trainer CLI
on the CPU.
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
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.core import DelayTrace, RoundConfig, TraceProcess
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import config as tcfgmod
from repro_torch.models import layers as TL
from repro_torch.models import model as tmodel
from repro_torch.train import TrainState, make_straggler_train_step
from test_torch_models import _assert_init_like_the_reference
from torch_parity import rel_err
from torch_parity import one_thread  # noqa: F401

JCFG = jconfigs.get_config("rwkv6-1.6b").smoke()
TCFG = tcfgmod.ModelConfig(**dataclasses.asdict(JCFG))
JFWD = jax.jit(j_forward, static_argnums=1)
B, T, D = 2, 12, 256


@pytest.fixture(scope="module")
def pair():
    """The JAX parameters and the port's model holding the same weights."""
    params = jax.jit(j_init_params, static_argnums=1)(
        jax.random.PRNGKey(0), JCFG)
    model = tmodel.init_params(TCFG, device="cpu")
    model.load_state_dict(convert.lm_params(
        jax.tree_util.tree_map(np.asarray, params), TCFG))
    return params, model


@pytest.fixture(scope="module")
def mixer():
    """One RWKV-6 time-mix, with ``u`` and the group norm's leaves drawn
    away from their constant initial values."""
    p = JL.rwkv6_init(jax.random.PRNGKey(7), JCFG)
    gen = np.random.default_rng(7)
    p["ln_out"] = {k: jnp.asarray(gen.standard_normal((4, 64)).astype(
        np.float32) * 0.5 + (1.0 if k == "scale" else 0.0))
        for k in ("scale", "bias")}
    p["w0"] = jnp.asarray(gen.uniform(-7, -1, D).astype(np.float32))
    return p, _load(TL.RWKV6(TCFG), p)


def _load(module, jax_tree):
    module.load_state_dict({n: torch.tensor(np.asarray(a)) for n, a in
                            convert._flatten(jax_tree, "")})
    return module


def _x(T_, seed):
    return np.random.default_rng(seed).standard_normal((B, T_, D)).astype(
        np.float32)


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (B, T))


def test_config_is_the_references_and_takes_swiglu():
    jc = jconfigs.get_config("rwkv6-1.6b")
    assert dataclasses.asdict(tcfgmod.ModelConfig(**dataclasses.asdict(
        jc))) == dataclasses.asdict(jc)
    specs = tcfgmod.layer_specs(TCFG)
    assert {(s.mixer, s.ffn) for s in specs} == {("rwkv6", "swiglu")}


@pytest.mark.parametrize("with_prev", [False, True])
def test_token_shift_matches_jax(with_prev):
    x = _x(5, 1)
    prev = np.random.default_rng(2).standard_normal((B, D)).astype(
        np.float32) if with_prev else None
    want = np.asarray(JL._token_shift(jnp.asarray(x), None if prev is None
                                      else jnp.asarray(prev)))
    got = TL.token_shift(torch.as_tensor(x), None if prev is None
                         else torch.as_tensor(prev))
    np.testing.assert_array_equal(got.numpy(), want)


def test_rwkv6_apply_without_state_matches_jax(mixer):
    p, mod = mixer
    x = _x(9, 3)
    want, st = JL.rwkv6_apply(p, JCFG, jnp.asarray(x))
    got, tst = TL.rwkv6_apply(mod, TCFG, torch.as_tensor(x))
    assert st is None and tst is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_rwkv6_apply_with_state_matches_jax(mixer):
    """Two chunks (7 tokens, then 1) from the zero state: each output, the
    state's ``S`` after each (rel 1e-5) and ``x_prev`` (exact)."""
    p, mod = mixer
    x = _x(8, 4)
    js = JL.rwkv6_state_init(JCFG, B)
    ts = TL.rwkv6_state_init(TCFG, B)
    assert ts["S"].dtype == torch.float32 and ts["S"].shape == (B, 4, 64, 64)
    for t0, t1 in ((0, 7), (7, 8)):
        want, js = JL.rwkv6_apply(p, JCFG, jnp.asarray(x[:, t0:t1]), js)
        got, ts = TL.rwkv6_apply(mod, TCFG, torch.as_tensor(x[:, t0:t1]), ts)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
        assert rel_err(ts["S"].detach(), js["S"]) <= 1e-5
        np.testing.assert_array_equal(ts["x_prev"].detach().numpy(),
                                      np.asarray(js["x_prev"]))
    assert float(ts["S"].abs().max()) > 0.1


@pytest.mark.parametrize("with_prev", [False, True])
def test_cmix_apply_matches_jax(with_prev):
    p = JL.cmix_init(jax.random.PRNGKey(8), JCFG)
    mod = _load(TL.CMix(TCFG), p)
    x = _x(6, 5)
    prev = _x(1, 6)[:, 0] if with_prev else None
    want, wl = JL.cmix_apply(p, jnp.asarray(x), None if prev is None
                             else jnp.asarray(prev))
    got, gl = TL.cmix_apply(mod, torch.as_tensor(x), None if prev is None
                            else torch.as_tensor(prev))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_cmix_layer_through_block_apply_matches_jax():
    """A hand-built (rwkv6, cmix) layer, which the reference's
    ``block_apply`` runs but no config reaches: without a cache, then a
    prefill and a decode step carrying ``S``, ``x_prev`` and
    ``cmix_prev``."""
    spec = tcfgmod.LayerSpec(mixer="rwkv6", ffn="cmix")
    p = jmodel.block_init(jax.random.PRNGKey(9), JCFG, spec)
    block = _load(tmodel.Block(TCFG, spec), p)
    japply = jax.jit(jmodel.block_apply, static_argnums=(1, 2))
    x = _x(6, 7)
    pos = np.arange(6)[None]
    want, _, _ = japply(p, JCFG, spec, jnp.asarray(x),
                        positions=jnp.asarray(pos))
    got, _, _ = tmodel.block_apply(block, TCFG, spec, torch.as_tensor(x),
                                   positions=torch.as_tensor(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    jc = jmodel.block_cache_init(JCFG, spec, B, 16)
    tc = tmodel.block_cache_init(TCFG, spec, B, 16)
    assert sorted(tc) == sorted(jc) == ["cmix_prev", "ssm"]
    for t0, t1 in ((0, 5), (5, 6)):
        pos = np.arange(t0, t1)[None]
        want, jc, _ = japply(p, JCFG, spec, jnp.asarray(x[:, t0:t1]),
                             positions=jnp.asarray(pos), cache=jc)
        got, tc, _ = tmodel.block_apply(block, TCFG, spec,
                                        torch.as_tensor(x[:, t0:t1]),
                                        positions=torch.as_tensor(pos),
                                        cache=tc)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
        assert rel_err(tc["ssm"]["S"].detach(), jc["ssm"]["S"]) <= 1e-5
        # the last inputs of the mixer and the channel-mix: norm outputs
        for a, b in ((tc["cmix_prev"], jc["cmix_prev"]),
                     (tc["ssm"]["x_prev"], jc["ssm"]["x_prev"])):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-5, rtol=0)


def test_forward_matches_jax(pair):
    params, model = pair
    toks = _tokens()
    want, _, _ = JFWD(params, JCFG, jnp.asarray(toks))
    got, aux, _ = tmodel.forward(model, TCFG, torch.as_tensor(toks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=0)
    assert float(aux) == 0.0


def test_prefill_then_decode_matches_jax(pair):
    params, model = pair
    toks = _tokens(3)
    jc = j_init_cache(JCFG, B, 16)
    tc = tmodel.init_cache(TCFG, B, 16, device="cpu")
    for t0, t1 in ((0, 8), (8, 9), (9, 10), (10, 12)):
        want, _, jc = JFWD(params, JCFG, jnp.asarray(toks[:, t0:t1]),
                           cache=jc)
        got, _, tc = tmodel.forward(model, TCFG,
                                    torch.as_tensor(toks[:, t0:t1]),
                                    cache=tc)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-4, rtol=0)
        (jS,) = [np.asarray(seg[0]["ssm"]["S"]) for seg in jc["segments"]]
        for layer, c in enumerate(tc["layers"]):          # (reps, B, H, dh, dh)
            assert rel_err(c["ssm"]["S"].detach(), jS[layer]) <= 1e-5
    assert tc["pos"] == int(jc["pos"]) == 12


def test_decode_matches_full_forward(pair):
    _, model = pair
    toks = torch.as_tensor(_tokens(4))
    full, _, _ = tmodel.forward(model, TCFG, toks)
    cache = tmodel.init_cache(TCFG, B, 32, device="cpu")
    _, _, cache = tmodel.forward(model, TCFG, toks[:, :5], cache=cache)
    for t in range(5, T):
        lg, _, cache = tmodel.forward(model, TCFG, toks[:, t:t + 1],
                                      cache=cache)
        err = (lg[:, 0] - full[:, t]).abs().max().item()
        assert err < 2e-3, (t, err)


N, R, K, BW, S = 4, 2, 3, 2, 12


def test_straggler_step_matches_jax(pair):
    """Rounds exact, loss rel 1e-5, weights 1e-6.  The grad norm rel 1e-5,
    or within twice the reference's own float32 error where that is
    larger: the same step in float64 in the port gives the exact norm, and
    at this seed both float32 norms are about 2e-4 from it (the group norm
    of the early tokens' small outputs amplifies rounding), 1.9e-5 from
    each other."""
    params, _ = pair
    base = j_ec2(N, spread=3.0, persistence=0.9, seed=1)
    T1, T2 = base.sample_rounds(jax.random.PRNGKey(6), 1, N, R, 1)
    T1, T2 = np.asarray(T1), np.asarray(T2)
    rc = dict(n=N, k=K, kind="cs", r=R)
    jo, to = jopt.momentum(0.1), topt.momentum(0.1)
    jstep = jax.jit(jtrain.make_straggler_train_step(
        JCFG, jo, JRoundConfig(**rc).to_round_spec(),
        JTraceProcess(JDelayTrace(T1, T2))))
    model = tmodel.init_params(TCFG, device="cpu", trainable=True)
    model.load_state_dict(convert.lm_params(
        jax.tree_util.tree_map(np.asarray, params), TCFG))
    tstate = TrainState(model, to.init(dict(model.named_parameters())), 0)
    tstep = make_straggler_train_step(TCFG, to, RoundConfig(**rc),
                                      TraceProcess(DelayTrace(T1, T2)))
    gen = np.random.default_rng(12)
    toks = gen.integers(0, JCFG.vocab_size, (R, N, BW, S))
    labs = gen.integers(0, JCFG.vocab_size, (R, N, BW, S))
    jstate = jtrain.TrainState(params, jo.init(params),
                               jnp.zeros((), jnp.int32))
    jstate, jm, _ = jstep(jstate, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(labs, jnp.int32),
                          jax.random.PRNGKey(0))
    init = convert.lm_params(jax.tree_util.tree_map(np.asarray, params),
                             TCFG)
    tstate, tm, _ = tstep(tstate, torch.as_tensor(toks),
                          torch.as_tensor(labs), 123)
    for key in ("completion_time", "winners", "realized_k"):
        np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]))
    assert rel_err(tm["loss"], jm["loss"]) <= 1e-5
    c64 = dataclasses.replace(TCFG, param_dtype="float64", dtype="float64")
    m64 = tmodel.init_params(c64, device="cpu", trainable=True)
    m64.load_state_dict({k: v.double() for k, v in init.items()})
    _, m, _ = make_straggler_train_step(
        c64, to, RoundConfig(**rc), TraceProcess(DelayTrace(T1, T2)))(
            TrainState(m64, to.init(dict(m64.named_parameters())), 0),
            torch.as_tensor(toks), torch.as_tensor(labs), 123)
    ref_err = rel_err(jm["grad_norm"], m["grad_norm"])
    assert rel_err(tm["grad_norm"], jm["grad_norm"]) <= max(1e-5,
                                                            2 * ref_err)
    want = convert._unstack(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params), TCFG)
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst <= 1e-6, worst


def test_init_params_like_the_reference():
    _assert_init_like_the_reference(
        TCFG, tmodel.init_params(TCFG, seed=3, device="cpu"))


def test_parameter_shapes_and_dtypes_at_full_size():
    jcfg = jconfigs.get_config("rwkv6-1.6b")
    cfg = tcfgmod.ModelConfig(**dataclasses.asdict(jcfg))
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    # float32 leaves as float32, bfloat16 ones as float16 (numpy has no
    # bfloat16); broadcast views, nothing allocated
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(
        np.zeros((), np.float32 if s.dtype == jnp.float32 else np.float16),
        s.shape), shapes)
    leaves = convert._unstack(zeros, cfg)
    want = {n: a.shape for n, a in leaves.items()}
    model = tmodel.init_params(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    f32 = {n for n, p in model.named_parameters() if p.dtype == torch.float32}
    assert f32 == {n for n, a in leaves.items() if a.dtype == np.float32}
    assert {n.split(".", 3)[-1] for n in f32} == {
        "w0", "u", "ln_out.scale", "ln_out.bias"}
    assert tmodel.num_params(model) == 1_835_550_720


def test_serve_and_the_trainer_run_rwkv6_on_the_cpu():
    res = serve.run(TCFG, batch=2, prompt_len=6, gen=3, device="cpu")
    assert res.finite and tuple(res.tokens.shape) == (2, 3)
    out = train_cli.main(["--arch", "rwkv6-1.6b", "--smoke", "--device",
                          "cpu", "--steps", "2", "--n", "2", "--r", "1",
                          "--k", "2", "--batch", "2", "--seq", "8"])
    assert out.state.step == 2
    assert all(np.isfinite(h["loss"]) for h in out.history)
