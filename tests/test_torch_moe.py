"""The port's mixture of experts and llama4-maverick against the JAX
package, in float32.  The MoE layer at the smoke widths of llama4-maverick
(4 experts, top-1, one shared) and deepseek-v3 (4 experts, top-2):
``moe_local`` against ``_moe_local`` on the same tokens and router, with
the top-K experts, the buffer slots and the kept mask exactly equal,
outputs within 1e-5 and the aux loss within rel 1e-6; a router that sends
every token to one expert, past its capacity, drops the same pairs;
``moe_apply`` with the shared expert; an MoE block's output and aux
through ``block_apply``; ``active_params`` for every architecture of the
reference.  Every routed input holds a gap of
at least 1e-5 between its K-th and (K+1)-th probability, so an
exact-routing failure is the port's, never a near-tie.  llama4-maverick
at its smoke config (a dense and an MoE layer, the vision-stub frontend's
projection): ``forward`` and prefill then decode against the JAX decode
(atol 2e-4, tests/test_torch_models.py's logits bound, aux rel 1e-6);
decode against the port's own full forward at capacity_factor E/K, where
no call drops a pair; the straggler train step on one round of a
JAX-drawn trace (tests/test_torch_train.py's bounds); ``remat`` giving the
same loss, aux and gradients; the initialisation's scales; the parameter
tree at full size against ``jax.eval_shape`` and ``active_params``; the
trainer CLI at the smoke config.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import layers as JL
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.launch import train as train_cli
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

ARCH = "llama4-maverick-400b-a17b"
JCFG = jconfigs.get_config(ARCH).smoke()
TCFG = tcfg(JCFG)
#: deepseek-v3's smoke MoE: top-2 of 4 experts, one shared
JDS = jconfigs.get_config("deepseek-v3-671b").smoke()
JFWD = jax.jit(j_forward, static_argnums=1)
#: the routing precondition: the K-th and (K+1)-th probability of every
#: token at least this far apart
GAP = 1e-5
B, T = 2, 12


@pytest.fixture(scope="module")
def pair():
    return lm_pair(JCFG)


def _moe_pair(jcfg, seed):
    p = JL.moe_init(jax.random.PRNGKey(seed), jcfg)
    moe = TL.MoE(tcfg(jcfg))
    moe.load_state_dict({n: torch.tensor(np.asarray(a)) for n, a in
                         convert._flatten(p, "")})
    return p, moe


def _ref_routing(x2d, router_w, cfg):
    """The reference's routing, lines 648-668 of _moe_local
    (repro/models/layers.py) with e_start 0 and every expert local: its
    probabilities, top-K experts, sorted order, slots and kept mask."""
    T_, E, K_ = x2d.shape[0], cfg.n_experts, cfg.experts_per_token
    C = max(1, math.ceil(T_ * K_ / E * cfg.capacity_factor))
    probs = jax.nn.softmax(x2d.astype(jnp.float32) @ router_w, axis=-1)
    _, top_i = jax.lax.top_k(probs, K_)
    key_ = top_i.reshape(-1)
    order = jnp.argsort(key_, stable=True)
    skey = key_[order]
    counts = jnp.zeros((E + 1,), jnp.int32).at[skey].add(1)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(T_ * K_) - starts[skey]
    ok = (skey < E) & (pos < C)
    slot = jnp.where(ok, skey * C + pos, E * C)
    return [np.asarray(a) for a in (probs, top_i, order, slot, ok)]


def _assert_gap(probs, K_):
    """The routing precondition on the reference's probabilities."""
    srt = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    gap = (srt[:, K_ - 1] - srt[:, K_]).min()
    assert gap >= GAP, gap


def _check_moe_local(jcfg, p, moe, x):
    cfg = tcfg(jcfg)
    probs, top_i, order, slot, ok = _ref_routing(jnp.asarray(x),
                                                 p["router"], jcfg)
    _assert_gap(probs, jcfg.experts_per_token)
    rt = TL.moe_route(torch.as_tensor(x), moe.router, cfg)
    np.testing.assert_array_equal(rt.top_i.numpy(), top_i)
    np.testing.assert_array_equal(rt.order.numpy(), order)
    np.testing.assert_array_equal(rt.slot.numpy(), slot)
    np.testing.assert_array_equal(rt.ok.numpy(), ok)
    want, jaux = JL._moe_local(jnp.asarray(x), p["router"], p["w_gate"],
                               p["w_up"], p["w_down"], cfg=jcfg, e_start=0,
                               n_local=jcfg.n_experts)
    with torch.no_grad():
        got, aux = TL.moe_local(torch.as_tensor(x), moe.router, moe.w_gate,
                                moe.w_up, moe.w_down, cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert aux.dtype == torch.float32
    assert rel_err(aux, jaux) <= 1e-6
    return rt


@pytest.mark.parametrize("which,seed", [("llama4", 1), ("deepseek", 2),
                                        ("deepseek", 3)])
def test_moe_local_routes_like_the_reference(which, seed):
    jcfg = JCFG if which == "llama4" else JDS
    p, moe = _moe_pair(jcfg, seed)
    x = np.random.default_rng(seed).standard_normal(
        (24, jcfg.d_model)).astype(np.float32)
    rt = _check_moe_local(jcfg, p, moe, x)
    assert rt.capacity == math.ceil(24 * jcfg.experts_per_token / 4 * 1.25)


@pytest.mark.parametrize("which", ["llama4", "deepseek"])
def test_forced_overflow_drops_the_same_pairs(which):
    """A router whose logits put expert 0 about 8 and expert 1 about 4
    above the rest for every token: 24 pairs each for a capacity of 8
    (top-1: expert 0 alone) or 15 (top-2: experts 0 and 1), so the pairs
    past it are dropped, the same ones as the reference drops (the first C
    in (token, k) order)."""
    jcfg = JCFG if which == "llama4" else JDS
    K_ = jcfg.experts_per_token
    p, moe = _moe_pair(jcfg, 4)
    gen = np.random.default_rng(4)
    x = gen.standard_normal((24, jcfg.d_model)).astype(np.float32)
    x[:, 0] = 8.0 + gen.random(24).astype(np.float32)
    x[:, 1] = 4.0
    router = np.array(p["router"])
    router[:2] = 0.0
    router[0, 0] = router[1, 1] = 1.0
    p = {**p, "router": jnp.asarray(router)}
    with torch.no_grad():
        moe.router.copy_(torch.as_tensor(router))
    rt = _check_moe_local(jcfg, p, moe, x)
    C = rt.capacity
    assert C == math.ceil(24 * K_ / 4 * 1.25) < 24
    for e in range(K_):
        assert bool((rt.top_i[:, e] == e).all())
        assert int(rt.counts[e]) == 24
        pairs = slice(24 * e, 24 * (e + 1))       # expert e's, sorted
        assert int(rt.ok[pairs].sum()) == C
        # expert e keeps the first C tokens, in token order
        kept = rt.order[pairs][rt.ok[pairs]] // K_
        assert kept.tolist() == list(range(C))
    assert int((~rt.ok).sum()) == K_ * (24 - C)


def test_moe_apply_with_the_shared_expert():
    p, moe = _moe_pair(JDS, 5)
    x = np.random.default_rng(5).standard_normal(
        (2, 9, JDS.d_model)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x.reshape(18, -1)) @ p["router"], axis=-1))
    _assert_gap(probs, JDS.experts_per_token)
    want, jaux = JL.moe_apply(p, JDS, jnp.asarray(x))
    with torch.no_grad():
        got, aux = moe(torch.as_tensor(x))
    assert moe.shared is not None and moe.shared.w_gate.w.shape == (256, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert rel_err(aux, jaux) <= 1e-6


@pytest.mark.parametrize("T_,want", [(2, 1), (4096, 160), (1024, 640)])
def test_capacity_is_per_call(T_, want):
    """deepseek-v3's decode step at batch 2 (one slot per expert, so the
    reference itself drops pairs there), its 2 x 2048-token prefill, and
    16 experts over a 1 024-token training slot."""
    cfg = tcfg(jconfigs.get_config("deepseek-v3-671b"))
    if T_ == 1024:
        cfg = dataclasses.replace(cfg, n_experts=16)
    assert TL.moe_capacity(cfg, T_) == want == max(1, math.ceil(
        T_ * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor))


def test_moe_block_matches_jax():
    """An MoE block through ``block_apply``: its output and its aux loss
    (the reference's third return); a dense block returns no aux."""
    spec = tcfgmod.layer_specs(TCFG)[1]
    assert spec.ffn == "moe"
    p = jmodel.block_init(jax.random.PRNGKey(6), JCFG, spec)
    block = tmodel.Block(TCFG, spec)
    block.load_state_dict({n: torch.tensor(np.asarray(a)) for n, a in
                           convert._flatten(p, "")})
    x = np.random.default_rng(6).standard_normal((B, 7, 256)).astype(
        np.float32)
    pos = np.arange(7)[None]
    want, _, jaux = jax.jit(jmodel.block_apply, static_argnums=(1, 2))(
        p, JCFG, spec, jnp.asarray(x), positions=jnp.asarray(pos))
    with torch.no_grad():
        got, _, aux = tmodel.block_apply(block, TCFG, spec,
                                         torch.as_tensor(x),
                                         positions=torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert rel_err(aux, jaux) <= 1e-6
    dense = tcfgmod.layer_specs(TCFG)[0]
    with torch.no_grad():
        _, _, none = tmodel.block_apply(tmodel.Block(TCFG, dense), TCFG,
                                        dense, torch.as_tensor(x),
                                        positions=torch.as_tensor(pos))
    assert none is None


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_active_params_match_the_reference(arch):
    """Every architecture of the reference, jamba's Mamba layers among
    them, at full size and at its smoke size."""
    for jcfg in (jconfigs.get_config(arch), jconfigs.get_config(arch).smoke()):
        assert tmodel.active_params(tcfg(jcfg)) == jmodel.active_params(jcfg)


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (B, T))


def test_config_is_the_references():
    assert_config_is_the_references(ARCH)
    assert [(s.mixer, s.ffn) for s in tcfgmod.layer_specs(TCFG)] == [
        ("gqa", "swiglu"), ("gqa", "moe")]
    assert TCFG.frontend == "vision_stub" and TCFG.frontend_seq == 0


def test_forward_matches_jax(pair):
    params, model = pair
    toks = _tokens()
    want, jaux, _ = JFWD(params, JCFG, jnp.asarray(toks))
    with torch.no_grad():
        got, aux, _ = tmodel.forward(model, TCFG, torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    assert float(aux) > 0 and rel_err(aux, jaux) <= 1e-6
    assert model.frontend_proj is not None          # text-only, projected


def test_prefill_then_decode_matches_jax(pair):
    params, model = pair
    toks = _tokens(3)
    jc = j_init_cache(JCFG, B, 16)
    tc = tmodel.init_cache(TCFG, B, 16, device="cpu")
    for t0, t1 in ((0, 8), (8, 9), (9, 10), (10, 12)):
        want, jaux, jc = JFWD(params, JCFG, jnp.asarray(toks[:, t0:t1]),
                              cache=jc)
        with torch.no_grad():
            got, aux, tc = tmodel.forward(
                model, TCFG, torch.as_tensor(toks[:, t0:t1]), cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_ATOL, rtol=0)
        assert rel_err(aux, jaux) <= 1e-6
    assert tc["pos"] == int(jc["pos"]) == 12


def test_decode_matches_full_forward_without_drops(pair):
    """At capacity_factor E/K the capacity is at least the call's tokens,
    so neither the full forward nor a decode step drops a pair."""
    _, model = pair
    cfg = dataclasses.replace(TCFG, capacity_factor=TCFG.n_experts
                              / TCFG.experts_per_token)
    m = tmodel.init_params(cfg, device="cpu")
    m.load_state_dict(model.state_dict())
    toks = torch.as_tensor(_tokens(4))
    with torch.no_grad():
        full, _, _ = tmodel.forward(m, cfg, toks)
        cache = tmodel.init_cache(cfg, B, 32, device="cpu")
        _, _, cache = tmodel.forward(m, cfg, toks[:, :5], cache=cache)
        for t in range(5, T):
            lg, _, cache = tmodel.forward(m, cfg, toks[:, t:t + 1],
                                          cache=cache)
            err = (lg[:, 0] - full[:, t]).abs().max().item()
            assert err < DECODE_ATOL, (t, err)


def test_straggler_step_matches_jax(pair):
    params, _ = pair
    tm = straggler_step_parity(JCFG, params)
    assert float(tm["aux"]) > 0


def test_remat_gives_the_same_loss_aux_and_gradients(pair):
    """Each block recomputed in backward (``torch.utils.checkpoint`` of a
    block that returns (x, cache, aux)): the MoE dispatch and combine are
    gathers, so the recomputation gives the first pass's numbers."""
    _, model = pair
    toks = torch.as_tensor(_tokens(6))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(TCFG, remat=remat)
        m = tmodel.init_params(cfg, device="cpu", trainable=True)
        m.load_state_dict(model.state_dict())
        logits, aux, _ = tmodel.forward(m, cfg, toks)
        (logits.float().logsumexp(-1).mean() + aux).backward()
        out.append((logits.detach(), aux.detach(),
                    {k: p.grad for k, p in m.named_parameters()}))
    (la, aa, ga), (lb, ab, gb) = out
    assert torch.equal(la, lb) and torch.equal(aa, ab) and float(aa) > 0
    assert ga.keys() == gb.keys()
    # the frontend's projection takes no part in a text-only forward
    assert {k for k, g in ga.items() if g is None} == {
        k for k, g in gb.items() if g is None} == {
            "frontend_proj.w", "frontend_proj.b"}
    for k in ga:
        assert ga[k] is None or torch.equal(ga[k], gb[k]), k
    assert ga["blocks.1.ffn.router"].abs().max() > 0


def test_init_params_like_the_reference():
    model = tmodel.init_params(TCFG, seed=3, device="cpu")
    _assert_init_like_the_reference(TCFG, model)
    assert model.blocks[1].ffn.router.dtype == torch.float32


def test_parameter_tree_at_full_size():
    model = assert_full_size_like_the_reference(ARCH)
    moe = model.blocks[1].ffn
    assert tuple(moe.w_gate.shape) == (128, 5120, 8192)
    assert tuple(moe.w_down.shape) == (128, 8192, 5120)
    assert moe.router.dtype == torch.float32
    assert moe.w_gate.dtype == torch.bfloat16
    # the cut the card runs: one dense and one MoE layer
    cut = tmodel.init_params(dataclasses.replace(model.cfg, n_layers=2),
                             device="meta")
    assert 18.4e9 < tmodel.num_params(cut) < 18.6e9


def test_trainer_cli_trains_the_smoke_config():
    res = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "2", "--n", "4", "--r", "2", "--k", "3",
                          "--batch", "4", "--seq", "16"])
    assert len(res.history) == 2
    assert all(np.isfinite(h["loss"]) and h["aux"] > 0 for h in res.history)
