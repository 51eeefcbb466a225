"""Grouped-GQA decode and the mesh-only attention flags, the port against
the JAX package in float32 at smoke width:

* ``grouped_attention`` against the reference's on the same queries and
  cache (one and three new tokens, a partly filled cache), atol 1e-5;
* mistral-nemo-12b's smoke config (every layer full attention) with
  ``grouped_gqa``: a prefill and four decode steps through both packages
  from the same weights (``convert.lm_params``) within
  tests/test_torch_models.py's logits bound (2e-4), the port's grouped
  decode against its own ``repeat_kv`` decode (1e-5) and its full forward
  (2e-3, tests/test_models.py's bound);
* ``seq_shard_decode`` and ``attn_batch_shard_fallback``, which act only
  under a mesh with a model axis wider than 1, bit-equal to the plain
  path without one (logits and caches), and ``grouped_gqa`` leaving a
  windowed layer's ring route alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as tmodel
from torch_lm_parity import DECODE_ATOL, LOGITS_ATOL, tcfg
from torch_parity import one_thread  # noqa: F401

ARCH = "mistral-nemo-12b"
JFWD = jax.jit(j_forward, static_argnums=1)
B, T, PREFILL, SMAX = 2, 9, 5, 16


@pytest.mark.parametrize("T_new,pos", [(1, 0), (1, 10), (3, 6)])
def test_grouped_attention_matches_the_reference(T_new, pos):
    gen = np.random.default_rng(T_new + pos)
    H, K, dh, S = 8, 2, 16, 16
    q = gen.standard_normal((2, H, T_new, dh)).astype(np.float32)
    k = gen.standard_normal((2, K, S, dh)).astype(np.float32)
    v = gen.standard_normal((2, K, S, dh)).astype(np.float32)
    want = JL.grouped_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), kv_len=pos + T_new,
                                scale=1.0 / np.sqrt(dh), q_offset=pos)
    got = TL.grouped_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), kv_len=pos + T_new,
                               q_offset=pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    rep = TL.attention_core(torch.as_tensor(q),
                            TL.repeat_kv(torch.as_tensor(k), H // K),
                            TL.repeat_kv(torch.as_tensor(v), H // K),
                            causal=True, q_offset=pos, kv_len=pos + T_new)
    np.testing.assert_allclose(got.numpy(), rep.numpy(), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH).smoke(),
                               grouped_gqa=True)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        j_init_params, static_argnums=1)(jax.random.PRNGKey(4), jcfg))
    cfg = tcfg(jcfg)
    model = tmodel.init_params(cfg, device="cpu")
    model.load_state_dict(convert.lm_params(params, cfg))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, T))
    return jcfg, params, cfg, model, toks


def _port_decode(model, cfg, toks):
    """Logits of the prefill's last position and of each decode step, and
    the cache after them."""
    cache = tmodel.init_cache(cfg, B, SMAX, device="cpu")
    lg, _, cache = tmodel.forward(model, cfg, toks[:, :PREFILL], cache=cache)
    out = [lg[:, -1]]
    for t in range(PREFILL, T):
        lg, _, cache = tmodel.forward(model, cfg, toks[:, t:t + 1],
                                      cache=cache)
        out.append(lg[:, 0])
    return torch.stack(out, 1), cache


def test_grouped_decode_matches_the_reference(pair):
    jcfg, params, cfg, model, toks = pair
    assert {s.mixer for s in tmodel.layer_specs(cfg)} == {"gqa"}
    got, cache = _port_decode(model, cfg, torch.as_tensor(toks))
    jc = j_init_cache(jcfg, B, SMAX)
    lg, _, jc = JFWD(params, jcfg, jnp.asarray(toks[:, :PREFILL]), cache=jc)
    want = [np.asarray(lg[:, -1])]
    for t in range(PREFILL, T):
        lg, _, jc = JFWD(params, jcfg, jnp.asarray(toks[:, t:t + 1]),
                         cache=jc)
        want.append(np.asarray(lg[:, 0]))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1),
                               atol=LOGITS_ATOL, rtol=0)
    assert cache["pos"] == int(jc["pos"]) == T


def test_grouped_decode_matches_repeat_kv_and_the_full_forward(pair):
    _, _, cfg, model, toks = pair
    toks = torch.as_tensor(toks)
    grouped, _ = _port_decode(model, cfg, toks)
    plain_cfg = dataclasses.replace(cfg, grouped_gqa=False)
    plain = tmodel.init_params(plain_cfg, device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    rep, _ = _port_decode(plain, plain_cfg, toks)
    np.testing.assert_allclose(grouped.numpy(), rep.numpy(), atol=1e-5,
                               rtol=0)
    full, _, _ = tmodel.forward(model, cfg, toks)
    np.testing.assert_allclose(grouped.numpy(),
                               full[:, PREFILL - 1:].numpy(),
                               atol=DECODE_ATOL, rtol=0)


@pytest.mark.parametrize("arch", [ARCH, "gemma3-4b"])
@pytest.mark.parametrize("flag", ["seq_shard_decode",
                                  "attn_batch_shard_fallback",
                                  "grouped_gqa"])
def test_flags_without_a_mesh_take_the_plain_path(arch, flag):
    """Bit for bit: the mesh-only flags, forward and decode; ``grouped_gqa``
    in the forward and the prefill (it changes a decode step's full-cache
    attention alone, held to 1e-5 here and above)."""
    base = tconfigs.get_config(arch).smoke()
    cfg = dataclasses.replace(base, **{flag: True})
    model = tmodel.init_params(cfg, seed=2, device="cpu")
    plain = tmodel.init_params(base, device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, 40)))
    a, _, _ = tmodel.forward(model, cfg, toks)
    b, _, _ = tmodel.forward(plain, base, toks)
    assert torch.equal(a, b)
    ca = tmodel.init_cache(cfg, B, 48, device="cpu")
    cb = tmodel.init_cache(base, B, 48, device="cpu")
    for t0, t1 in ((0, 36), (36, 37), (37, 38)):
        a, _, ca = tmodel.forward(model, cfg, toks[:, t0:t1], cache=ca)
        b, _, cb = tmodel.forward(plain, base, toks[:, t0:t1], cache=cb)
        if flag == "grouped_gqa" and t1 - t0 == 1:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
            continue
        assert torch.equal(a, b), (flag, t0)
    for la, lb in zip(ca["layers"], cb["layers"]):
        for name in ("k", "v"):
            if flag == "grouped_gqa":   # a later layer's input moved
                np.testing.assert_allclose(la["attn"][name].numpy(),
                                           lb["attn"][name].numpy(),
                                           atol=1e-5)
            else:
                assert torch.equal(la["attn"][name], lb["attn"][name])
