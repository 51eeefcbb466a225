"""The port's multi-head latent attention (MLA) and deepseek-v3 against the
JAX package, in float32 at the reference's smoke config (2 layers: a dense
prefix layer and an MoE layer, both MLA; d 256, 4 heads, q_lora 64,
kv_lora 32, nope 32 + rope 16 query/key heads, value heads of 32).
``mla_apply`` on the naive and the absorbed path, with and without a
query low-rank pair, without and with a cache (outputs within 1e-5, the
latent cache equal); ``forward`` and prefill then decode against the JAX
decode on both paths (atol 2e-4, tests/test_torch_models.py's logits
bound; aux rel 1e-6); the absorbed decode against the naive one and decode
against the port's own full forward at capacity_factor E/K (2e-3); in
bfloat16, the absorbed path's gap from the naive one within twice the
reference's own; the straggler train step on one round of a JAX-drawn
trace (tests/test_torch_train.py's bounds); the initialisation's scales; a
bf16 model's weights through ``convert.train_state`` (the router float32);
the parameter tree at full size against ``jax.eval_shape`` and
``active_params``; the cache overflow the reference would clamp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as jopt
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.models import config as tcfgmod
from repro_torch.models import layers as TL
from repro_torch.models import model as tmodel
from test_torch_models import _assert_init_like_the_reference
from torch_lm_parity import (DECODE_ATOL, LOGITS_ATOL,
                             assert_config_is_the_references,
                             assert_full_size_like_the_reference, lm_pair,
                             straggler_step_parity, tcfg)
from torch_parity import rel_err
from torch_parity import one_thread  # noqa: F401

ARCH = "deepseek-v3-671b"
JCFG = jconfigs.get_config(ARCH).smoke()
TCFG = tcfg(JCFG)
JFWD = jax.jit(j_forward, static_argnums=1)
B, T = 2, 12


@pytest.fixture(scope="module")
def pair():
    return lm_pair(JCFG)


def _absorb(cfg, on=True):
    return dataclasses.replace(cfg, mla_absorb=on)


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (B, T))


def test_config_is_the_references():
    assert_config_is_the_references(ARCH)
    assert [(s.mixer, s.ffn) for s in tcfgmod.layer_specs(TCFG)] == [
        ("mla", "swiglu"), ("mla", "moe")]


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
@pytest.mark.parametrize("q_lora", [64, 0], ids=["q_lora", "no_q_lora"])
def test_mla_apply_matches_jax(absorb, q_lora):
    """Without a cache (both paths are the naive one there), then a
    5-token prefill and two decode steps into a cache of 16."""
    jcfg = dataclasses.replace(JCFG, mla_absorb=absorb, q_lora_rank=q_lora)
    cfg = tcfg(jcfg)
    p = JL.mla_init(jax.random.PRNGKey(7), jcfg)
    mla = TL.MLA(cfg)
    mla.load_state_dict({n: torch.tensor(np.asarray(a)) for n, a in
                         convert._flatten(p, "")})
    assert (mla.w_dq is None) == (q_lora == 0)
    japply = jax.jit(JL.mla_apply, static_argnums=1)
    x = np.random.default_rng(7).standard_normal((B, 8, 256)).astype(
        np.float32)
    want, _ = japply(p, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, _ = TL.mla_apply(mla, cfg, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    jc = JL.mla_cache_init(jcfg, B, 16)
    tc = TL.mla_cache_init(cfg, B, 16)
    assert {k: tuple(v.shape) for k, v in tc.items() if k != "pos"} == {
        "c_kv": (B, 16, 32), "k_rope": (B, 16, 16)}
    for t0, t1 in ((0, 5), (5, 6), (6, 7)):
        pos = np.arange(t0, t1)[None]
        want, jc = japply(p, jcfg, jnp.asarray(x[:, t0:t1]),
                          positions=jnp.asarray(pos), cache=jc)
        with torch.no_grad():
            got, tc = TL.mla_apply(mla, cfg, torch.as_tensor(x[:, t0:t1]),
                                   positions=torch.as_tensor(pos), cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
        assert tc["pos"] == int(jc["pos"]) == t1
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       atol=1e-5, rtol=0)


def test_forward_matches_jax(pair):
    params, model = pair
    toks = _tokens()
    want, jaux, _ = JFWD(params, JCFG, jnp.asarray(toks))
    with torch.no_grad():
        got, aux, _ = tmodel.forward(model, TCFG, torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    assert float(aux) > 0 and rel_err(aux, jaux) <= 1e-6


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
def test_prefill_then_decode_matches_jax(pair, absorb):
    params, model = pair
    jcfg, cfg = _absorb(JCFG, absorb), _absorb(TCFG, absorb)
    m = tmodel.init_params(cfg, device="cpu")
    m.load_state_dict(model.state_dict())
    toks = _tokens(3)
    jc = j_init_cache(jcfg, B, 16)
    tc = tmodel.init_cache(cfg, B, 16, device="cpu")
    for t0, t1 in ((0, 8), (8, 9), (9, 10), (10, 12)):
        want, jaux, jc = JFWD(params, jcfg, jnp.asarray(toks[:, t0:t1]),
                              cache=jc)
        with torch.no_grad():
            got, aux, tc = tmodel.forward(
                m, cfg, torch.as_tensor(toks[:, t0:t1]), cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_ATOL, rtol=0)
        assert rel_err(aux, jaux) <= 1e-6
    assert tc["pos"] == int(jc["pos"]) == 12
    assert set(tc["layers"][0]["attn"]) == {"c_kv", "k_rope", "pos"}


def test_decode_against_full_forward_and_absorbed_against_naive(pair):
    """At capacity_factor E/K no call drops a pair: each decode step of
    the naive and of the absorbed path against the full forward, and the
    two paths' steps against each other."""
    _, model = pair
    cf = TCFG.n_experts / TCFG.experts_per_token
    toks = torch.as_tensor(_tokens(4))
    steps = {}
    with torch.no_grad():
        for absorb in (False, True):
            cfg = dataclasses.replace(TCFG, capacity_factor=cf,
                                      mla_absorb=absorb)
            m = tmodel.init_params(cfg, device="cpu")
            m.load_state_dict(model.state_dict())
            full, _, _ = tmodel.forward(m, cfg, toks)
            cache = tmodel.init_cache(cfg, B, 32, device="cpu")
            _, _, cache = tmodel.forward(m, cfg, toks[:, :5], cache=cache)
            out = []
            for t in range(5, T):
                lg, _, cache = tmodel.forward(m, cfg, toks[:, t:t + 1],
                                              cache=cache)
                err = (lg[:, 0] - full[:, t]).abs().max().item()
                assert err < DECODE_ATOL, (absorb, t, err)
                out.append(lg[:, 0])
            steps[absorb] = torch.stack(out)
    assert (steps[True] - steps[False]).abs().max().item() < DECODE_ATOL


def test_absorbed_bf16_gap_is_the_references():
    """In bfloat16 the absorbed path rounds the latent query and context
    where the naive path rounds the decompressed keys and values, so their
    decodes part by about a bf16 logit error.  The port's gap between the
    two, and its absorbed decode's distance from the float32-activation
    forward of the same bf16 weights, are each within twice the
    reference's own (capacity_factor E/K: no dropped pair)."""
    jcfg = dataclasses.replace(JCFG, param_dtype="bfloat16",
                               dtype="bfloat16", capacity_factor=2.0)
    params = jax.tree_util.tree_map(np.asarray, j_init_params(
        jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(8).integers(0, JCFG.vocab_size, (B, T))
    truth = np.asarray(JFWD(params, dataclasses.replace(
        jcfg, dtype="float32"), jnp.asarray(toks))[0][:, 8:], np.float32)

    def decode(absorb, port):
        cfg = _absorb(jcfg, absorb)
        if port:
            cfg = tcfg(cfg)
            m = tmodel.init_params(cfg, device="cpu")
            m.load_state_dict(convert.lm_params(params, cfg))
            cache = tmodel.init_cache(cfg, B, 16, device="cpu")
        else:
            cache = j_init_cache(cfg, B, 16)
        out = []
        for t0, t1 in ((0, 8),) + tuple((t, t + 1) for t in range(8, T)):
            if port:
                with torch.no_grad():
                    lg, _, cache = tmodel.forward(
                        m, cfg, torch.as_tensor(toks[:, t0:t1]), cache=cache)
                lg = lg.float().numpy()
            else:
                lg, _, cache = JFWD(params, cfg, jnp.asarray(toks[:, t0:t1]),
                                    cache=cache)
                lg = np.asarray(lg, np.float32)
            out.append(lg[:, -1])
        return np.stack(out[:-1], axis=1)      # positions 8 .. T - 1

    def gap(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    jn, ja = decode(False, False), decode(True, False)
    tn, ta = decode(False, True), decode(True, True)
    assert gap(ta, tn) <= 2 * gap(ja, jn)
    assert gap(ta, truth) <= 2 * gap(ja, truth)
    assert gap(ja, jn) > 1e-3            # a bf16 gap, not a float32 one


def test_straggler_step_matches_jax(pair):
    params, _ = pair
    tm = straggler_step_parity(JCFG, params)
    assert float(tm["aux"]) > 0


def test_init_params_like_the_reference():
    model = tmodel.init_params(TCFG, seed=3, device="cpu")
    _assert_init_like_the_reference(TCFG, model)


def test_train_state_of_a_bf16_model():
    """The reference's bf16 state (its router float32) through
    ``convert.train_state``: every leaf bit for bit, in its dtype, the
    momentum tree beside it in float32."""
    jcfg = dataclasses.replace(JCFG, param_dtype="bfloat16")
    params = jax.tree_util.tree_map(np.asarray, j_init_params(
        jax.random.PRNGKey(2), jcfg))
    opt = jax.tree_util.tree_map(np.asarray, jopt.momentum(0.1).init(
        params))
    st = convert.train_state(params, opt, 3, tcfg(jcfg), device="cpu")
    want = convert._unstack(params, tcfg(jcfg))
    got = dict(st.params.named_parameters())
    assert got.keys() == want.keys()
    for name, p in got.items():
        assert str(p.dtype).removeprefix("torch.") == str(want[name].dtype)
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      want[name].astype(np.float32))
    assert got["blocks.1.ffn.router"].dtype == torch.float32
    assert got["blocks.1.ffn.w_gate"].dtype == torch.bfloat16
    assert tuple(got["blocks.1.ffn.w_gate"].shape) == (4, 256, 256)
    assert {"blocks.0.mixer.w_uk.w", "blocks.0.mixer.kv_norm.scale",
            "blocks.0.mixer.w_dq.w", "blocks.0.mixer.q_norm.scale"} <= \
        got.keys()
    assert st.step == 3 and all(v.dtype == torch.float32
                                for v in st.opt_state["mu"].values())


def test_parameter_tree_at_full_size():
    model = assert_full_size_like_the_reference(ARCH)
    mla, moe = model.blocks[3].mixer, model.blocks[3].ffn
    assert tuple(mla.w_uk.w.shape) == (512, 128 * 256)
    assert tuple(mla.w_uq.w.shape) == (1536, 128 * 192)
    assert tuple(moe.w_gate.shape) == (256, 7168, 2048)
    assert moe.router.dtype == torch.float32
    assert model.blocks[0].ffn.w_gate.w.shape == (7168, 18432)
    # the cuts the card runs: 3 dense and 1 MoE layer (serve), and that
    # with 16 experts (train)
    cut = dataclasses.replace(model.cfg, n_layers=4)
    n = tmodel.num_params(tmodel.init_params(cut, device="meta"))
    assert 15.0e9 < n < 15.2e9
    n = tmodel.num_params(tmodel.init_params(
        dataclasses.replace(cut, n_experts=16), device="meta"))
    assert 4.4e9 < n < 4.6e9


def test_mla_cache_overflow_raises(pair):
    _, model = pair
    cache = tmodel.init_cache(TCFG, B, 8, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="overflow"):
        tmodel.forward(model, TCFG, torch.as_tensor(_tokens()), cache=cache)
