"""whisper-base in the port against the JAX package, at the reference's
smoke config in float32 (2 decoder and 2 encoder layers, d 256, 4 heads of
64 over 2 KV heads, 64 encoder frames of width 128): the layer norm and
the norm dispatch, the GELU feed-forward (tanh form) and the encoder's
interleaved sinusoid (atol 1e-5); ``encode``, the cross-attention block
with and without a cache, ``forward`` with ``enc_frames`` and prefill then
decode against the JAX decode (atol 2e-4, tests/test_torch_models.py's
logits bound); decode against the port's own full forward (2e-3); the
straggler train step with ``extras={"enc_frames": ...}`` on one round of
a JAX-drawn trace (rounds exact, loss and grad norm rel 1e-5, weights after
momentum SGD within 1e-6, tests/test_torch_train.py's bounds); the
initialisation's constants and scales; the parameter shapes at full size.
The port's own: encoder and cross-attention never reach the swa kernel
wrapper, the two raises where the reference reads stale or clamped values,
the serve CLI with encoder frames, the trainer CLI's refusal.
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

JCFG = jconfigs.get_config("whisper-base").smoke()
TCFG = tcfgmod.ModelConfig(**dataclasses.asdict(JCFG))
JFWD = jax.jit(j_forward, static_argnums=1)
B, T = 2, 12


@pytest.fixture(scope="module")
def pair():
    """The JAX parameters and the port's model holding the same weights."""
    params = jax.jit(j_init_params, static_argnums=1)(
        jax.random.PRNGKey(0), JCFG)
    model = tmodel.init_params(TCFG, device="cpu")
    model.load_state_dict(convert.lm_params(
        jax.tree_util.tree_map(np.asarray, params), TCFG))
    return params, model


def _frames(seed=0, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, JCFG.encoder_seq, JCFG.frontend_dim)).astype(np.float32)


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (B, T))


def _load(module, jax_tree):
    module.load_state_dict({n: torch.tensor(np.asarray(a)) for n, a in
                            convert._flatten(jax_tree, "")})
    return module


def test_config_is_the_references():
    assert dataclasses.asdict(tcfgmod.ModelConfig(**dataclasses.asdict(
        jconfigs.get_config("whisper-base")))) == dataclasses.asdict(
            jconfigs.get_config("whisper-base"))
    assert JCFG.encoder_layers == 2 and JCFG.arch_type == "audio"


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_layer_norm_and_the_norm_dispatch(dtype):
    gen = np.random.default_rng(2)
    x = gen.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale = gen.standard_normal(64).astype(np.float32)
    bias = gen.standard_normal(64).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(JL.layer_norm({"scale": jnp.asarray(scale),
                                     "bias": jnp.asarray(bias)}, xj, 1e-5),
                      np.float32)
    xt = torch.as_tensor(np.asarray(xj, np.float32)).to(
        torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    got = TL.layer_norm(xt, torch.as_tensor(scale), torch.as_tensor(bias),
                        1e-5)
    assert got.dtype == xt.dtype
    # bf16 outputs: roundings of float32 values that may part in their
    # last bits, so at most one bfloat16 unit in the last place apart
    atol = 1e-5 if dtype is np.float32 else 0.0
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=0 if dtype is np.float32 else 2 ** -7)
    assert isinstance(TL.make_norm(TCFG), TL.LayerNorm)
    dense = jconfigs.get_config("gemma3-4b").smoke()
    assert isinstance(TL.make_norm(tcfgmod.ModelConfig(
        **dataclasses.asdict(dense))), TL.RMSNorm)


def test_gelu_mlp_is_the_tanh_form():
    p = JL.gelu_mlp_init(jax.random.PRNGKey(3), JCFG)
    mlp = _load(TL.GeluMLP(TCFG), p)
    x = np.random.default_rng(3).standard_normal((2, 7, 256)).astype(
        np.float32)
    want = np.asarray(JL.gelu_mlp_apply(p, jnp.asarray(x)))
    got = TL.gelu_mlp(mlp, torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the erf form parts from the reference well past that
    erf = mlp.w_down(torch.nn.functional.gelu(mlp.w_up(torch.as_tensor(x))))
    assert np.abs(erf.detach().numpy() - want).max() > 1e-4


@pytest.mark.parametrize("seq,d", [(64, 256), (1500, 512)])
def test_sinusoid_interleaves_like_the_reference(seq, d):
    """sin in the even columns, cos in the odd ones.  The port's values are
    the float64 sin / cos of its float32 arguments within 1e-6; XLA's
    float32 sin on the CPU parts from those by up to half a unit in the
    last place of the argument (6.1e-5 at 1499 rad), so the reference is
    held within one such unit of the largest argument."""
    want = np.asarray(jmodel._sinusoid(seq, d))
    got = tmodel.sinusoid(seq, d).numpy()
    assert got.dtype == np.float32
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                    * (-np.log(1e4) / d))
    arg = (torch.arange(seq, dtype=torch.float32)[:, None] * div).double()
    exact = torch.stack([arg.sin(), arg.cos()], dim=-1).reshape(seq, d)
    np.testing.assert_allclose(got, exact.numpy(), atol=1e-6, rtol=0)
    ulp = float(np.spacing(np.float32(arg.max())))
    np.testing.assert_allclose(got, want, atol=max(ulp, 1e-6), rtol=0)
    np.testing.assert_array_equal(got[0, 1::2], 1.0)     # cos(0), odd cols


def test_encode_matches_jax(pair):
    params, model = pair
    fr = _frames(4)
    want = np.asarray(jax.jit(jmodel.encode, static_argnums=1)(
        params, JCFG, jnp.asarray(fr)))
    got = tmodel.encode(model, TCFG, torch.as_tensor(fr)).detach().numpy()
    assert got.shape == (B, JCFG.encoder_seq, JCFG.d_model)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_cross_attention_block_matches_jax():
    """A decoder block (gqa, gelu, cross-attention) on its own: without a
    cache, and with one (the keys and values stored at the prefill, read
    at the next call, which takes no encoder output)."""
    spec = tcfgmod.layer_specs(TCFG)[0]
    assert spec.cross_attn and spec.ffn == "gelu"
    p = jmodel.block_init(jax.random.PRNGKey(5), JCFG, spec)
    block = _load(tmodel.Block(TCFG, spec), p)
    japply = jax.jit(jmodel.block_apply, static_argnums=(1, 2),
                     static_argnames=("use_rope",))
    gen = np.random.default_rng(5)
    x = gen.standard_normal((B, 6, 256)).astype(np.float32)
    enc = gen.standard_normal((B, 64, 256)).astype(np.float32)
    pos = np.arange(6)[None]
    want, _, _ = japply(p, JCFG, spec, jnp.asarray(x),
                        positions=jnp.asarray(pos), use_rope=False,
                        enc_out=jnp.asarray(enc))
    got, _, _ = tmodel.block_apply(block, TCFG, spec, torch.as_tensor(x),
                                   positions=torch.as_tensor(pos),
                                   use_rope=False,
                                   enc_out=torch.as_tensor(enc))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    jc = jmodel.block_cache_init(JCFG, spec, B, 16)
    tc = tmodel.block_cache_init(TCFG, spec, B, 16)
    assert tc["xk"] is None and tc["xv"] is None
    for t0, t1, e in ((0, 5, enc), (5, 6, None)):
        pos = np.arange(t0, t1)[None]
        want, jc, _ = japply(
            p, JCFG, spec, jnp.asarray(x[:, t0:t1]),
            positions=jnp.asarray(pos), cache=jc, use_rope=False,
            enc_out=None if e is None else jnp.asarray(e))
        got, tc, _ = tmodel.block_apply(
            block, TCFG, spec, torch.as_tensor(x[:, t0:t1]),
            positions=torch.as_tensor(pos), cache=tc, use_rope=False,
            enc_out=None if e is None else torch.as_tensor(e))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
        for key in ("xk", "xv"):
            assert tuple(tc[key].shape) == (B, 4, 64, 64)
            np.testing.assert_allclose(tc[key].detach().numpy(),
                                       np.asarray(jc[key]), atol=1e-5,
                                       rtol=0)


def test_forward_with_enc_frames_matches_jax(pair):
    params, model = pair
    toks, fr = _tokens(), _frames()
    want, _, _ = JFWD(params, JCFG, jnp.asarray(toks),
                      enc_frames=jnp.asarray(fr))
    got, aux, _ = tmodel.forward(model, TCFG, torch.as_tensor(toks),
                                 enc_frames=torch.as_tensor(fr))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=0)
    assert float(aux) == 0.0
    # the frames matter
    other, _, _ = tmodel.forward(model, TCFG, torch.as_tensor(toks),
                                 enc_frames=torch.as_tensor(_frames(9)))
    assert (other - got).abs().max() > 1e-3


def test_prefill_then_decode_matches_jax(pair):
    params, model = pair
    toks, fr = _tokens(3), _frames(3)
    jc = j_init_cache(JCFG, B, 16)
    tc = tmodel.init_cache(TCFG, B, 16, device="cpu")
    for t0, t1 in ((0, 8), (8, 9), (9, 10), (10, 12)):
        first = t0 == 0
        want, _, jc = JFWD(params, JCFG, jnp.asarray(toks[:, t0:t1]),
                           cache=jc, enc_frames=jnp.asarray(fr) if first
                           else None)
        got, _, tc = tmodel.forward(
            model, TCFG, torch.as_tensor(toks[:, t0:t1]), cache=tc,
            enc_frames=torch.as_tensor(fr) if first else None)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-4, rtol=0)
    assert tc["pos"] == int(jc["pos"]) == 12


def test_decode_matches_full_forward(pair):
    _, model = pair
    toks, fr = torch.as_tensor(_tokens(4)), torch.as_tensor(_frames(4))
    full, _, _ = tmodel.forward(model, TCFG, toks, enc_frames=fr)
    cache = tmodel.init_cache(TCFG, B, 32, device="cpu")
    _, _, cache = tmodel.forward(model, TCFG, toks[:, :5], cache=cache,
                                 enc_frames=fr)
    for t in range(5, T):
        lg, _, cache = tmodel.forward(model, TCFG, toks[:, t:t + 1],
                                      cache=cache)
        err = (lg[:, 0] - full[:, t]).abs().max().item()
        assert err < 2e-3, (t, err)


def test_encoder_and_cross_attention_never_reach_the_swa_kernel(monkeypatch):
    """With sliding-window decoder layers, the kernel wrapper sees exactly
    one call a decoder layer, at the decoder's tokens: the encoder (not
    causal) and the cross-attention take ``attention_core``."""
    cfg = dataclasses.replace(TCFG, sliding_window=8)
    assert [s.mixer for s in tcfgmod.layer_specs(cfg)] == ["swa", "swa"]
    calls = []
    real = TL.ops.swa_attention

    def counted(q, k, v, *, window):
        calls.append((tuple(q.shape), window))
        return real(q, k, v, window=window)

    monkeypatch.setattr(TL.ops, "swa_attention", counted)
    model = tmodel.init_params(cfg, device="cpu")
    toks, fr = torch.as_tensor(_tokens()), torch.as_tensor(_frames())
    with torch.no_grad():
        tmodel.forward(model, cfg, toks, enc_frames=fr)
        assert calls == [((B, T, 4, 64), 8)] * 2
        tmodel.encode(model, cfg, fr)
        assert len(calls) == 2


def test_the_ports_raises_where_the_reference_reads_stale_values(pair):
    """A cache whose prefill had no frames: the reference attends to its
    zero-initialised cross keys; past max_seq_len its learned positions
    are clamped.  The port raises for both."""
    _, model = pair
    toks = torch.as_tensor(_tokens())
    cache = tmodel.init_cache(TCFG, B, 16, device="cpu")
    with pytest.raises(ValueError, match="enc_frames"):
        tmodel.forward(model, TCFG, toks, cache=cache)
    with pytest.raises(ValueError, match="enc_frames"):
        tmodel.forward(model, TCFG, toks)
    cache = tmodel.init_cache(TCFG, B, 16, device="cpu")
    cache["pos"] = TCFG.max_seq_len - 4
    with pytest.raises(ValueError, match="max_seq_len"):
        tmodel.forward(model, TCFG, toks[:, :5], cache=cache,
                       enc_frames=torch.as_tensor(_frames()))


N, R, K, BW, S = 4, 2, 3, 2, 12


def test_straggler_step_with_enc_frames_matches_jax(pair):
    params, _ = pair
    base = j_ec2(N, spread=3.0, persistence=0.9, seed=1)
    T1, T2 = base.sample_rounds(jax.random.PRNGKey(5), 1, N, R, 1)
    T1, T2 = np.asarray(T1), np.asarray(T2)
    rc = dict(n=N, k=K, kind="ss", r=R)
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
    gen = np.random.default_rng(11)
    toks = gen.integers(0, JCFG.vocab_size, (R, N, BW, S))
    labs = gen.integers(0, JCFG.vocab_size, (R, N, BW, S))
    fr = gen.standard_normal((R, N, BW, JCFG.encoder_seq,
                              JCFG.frontend_dim)).astype(np.float32)
    jstate = jtrain.TrainState(params, jo.init(params),
                               jnp.zeros((), jnp.int32))
    jstate, jm, _ = jstep(jstate, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(labs, jnp.int32),
                          jax.random.PRNGKey(0), None, None,
                          {"enc_frames": jnp.asarray(fr)})
    tstate, tm, _ = tstep(tstate, torch.as_tensor(toks),
                          torch.as_tensor(labs), 123,
                          extras={"enc_frames": torch.as_tensor(fr)})
    for key in ("completion_time", "winners", "realized_k"):
        np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]))
    assert rel_err(tm["loss"], jm["loss"]) <= 1e-5
    assert rel_err(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
    want = convert._unstack(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params), TCFG)
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    assert any(k.startswith("encoder.") for k in got)
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst <= 1e-6, worst


def test_init_params_like_the_reference():
    _assert_init_like_the_reference(
        TCFG, tmodel.init_params(TCFG, seed=3, device="cpu"))


def test_parameter_shapes_at_full_size():
    jcfg = jconfigs.get_config("whisper-base")
    cfg = tcfgmod.ModelConfig(**dataclasses.asdict(jcfg))
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {n: a.shape for n, a in convert._unstack(zeros, cfg).items()}
    model = tmodel.init_params(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert tmodel.num_params(model) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_serve_draws_encoder_frames_on_the_cpu():
    res = serve.run(TCFG, batch=2, prompt_len=4, gen=3, device="cpu")
    assert res.finite and tuple(res.tokens.shape) == (2, 3)
    assert bool(((res.tokens >= 0) & (res.tokens < TCFG.vocab_size)).all())
    again = serve.run(TCFG, batch=2, prompt_len=4, gen=3, device="cpu")
    assert torch.equal(again.tokens, res.tokens)          # seeded


def test_trainer_cli_refuses_encoder_configs():
    with pytest.raises(SystemExit, match="text archs"):
        train_cli.main(["--arch", "whisper-base", "--smoke", "--device",
                        "cpu", "--steps", "1"])
