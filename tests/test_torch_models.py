"""The port's LM stack against the JAX package: configurations and layer
plans for every architecture, parameter shapes of gemma3-4b at full size,
the dense layers (atol 1e-5 in float32), full ``forward`` logits through
``convert.lm_params`` (atol 2e-4) on gemma3-4b's smoke width with a
run-length and a periodic segment plan, the port's own decode-vs-full
consistency (tests/test_models.py's 2e-3 bound), bfloat16 logits within
twice the reference's own bfloat16-vs-float32 gap (measured in the test),
the swa route through the kernel wrapper, and the variants (only swa
with a softcap outside the stack)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import config as jcfgmod
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import forward as j_forward
from repro.models import layers as JL
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch import configs as tconfigs
from repro_torch.core import rng
from repro_torch.models import config as tcfgmod
from repro_torch.models import layers as TL
from repro_torch.models import model as tmodel

from torch_parity import one_thread  # noqa: F401

F32 = dict(param_dtype="float32", dtype="float32", remat=False)


def _tcfg(jcfg):
    """The port's ModelConfig with the same fields as a JAX one."""
    return tcfgmod.ModelConfig(**dataclasses.asdict(jcfg))


def _mk(name="m", **kw):
    base = dict(name=name, arch_type="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97, **F32)
    base.update(kw)
    return tcfgmod.ModelConfig(**base)


def _plan(segs):
    return [(tuple(dataclasses.asdict(s) for s in g.specs), g.reps)
            for g in segs]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_and_layer_plans_match(arch):
    jcfg = jconfigs.get_config(arch)
    for jc in (jcfg, jcfg.smoke()):
        tc = _tcfg(jc)
        assert [dataclasses.asdict(s) for s in tcfgmod.layer_specs(tc)] == \
            [dataclasses.asdict(s) for s in jcfgmod.layer_specs(jc)]
        assert tcfgmod.find_period(tcfgmod.layer_specs(tc)) == \
            jcfgmod.find_period(jcfgmod.layer_specs(jc))
        assert _plan(tmodel.plan_segments(tc)) == \
            _plan(jmodel.plan_segments(jc))
        assert tc.padded_vocab == jc.padded_vocab
    assert dataclasses.asdict(_tcfg(jcfg).smoke()) == \
        dataclasses.asdict(jcfg.smoke())
    if arch in tconfigs.ARCH_IDS:
        assert dataclasses.asdict(tconfigs.get_config(arch)) == \
            dataclasses.asdict(jcfg)


def test_port_archs_and_unknown_arch():
    assert set(tconfigs.ARCH_IDS) == {"jamba-v0.1-52b", "gemma3-4b",
                                      "mistral-nemo-12b", "qwen2-72b",
                                      "phi4-mini-3.8b", "whisper-base",
                                      "rwkv6-1.6b", "deepseek-v3-671b",
                                      "llama4-maverick-400b-a17b",
                                      "llava-next-34b"}
    assert "no-such-arch" not in jconfigs.ARCH_IDS
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")


def test_gemma3_4b_parameter_shapes_at_full_size():
    cfg = tconfigs.get_config("gemma3-4b")
    model = tmodel.init_params(cfg, device="meta")
    shapes = jax.eval_shape(
        lambda: j_init_params(jax.random.PRNGKey(0),
                              jconfigs.get_config("gemma3-4b")))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {n: a.shape for n, a in convert._unstack(zeros, cfg).items()}
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert tmodel.num_params(model) == 4_550_996_480
    assert sum(b.spec.mixer == "swa" for b in model.blocks) == 29


def _attn_pair(cfg, seed=0):
    """JAX gqa params and the port's Attention holding the same weights."""
    p = JL.gqa_init(jax.random.PRNGKey(seed), jcfgmod.ModelConfig(
        **dataclasses.asdict(cfg)))
    attn = TL.gqa_init(cfg, device="cpu")
    attn.load_state_dict({n: torch.tensor(np.asarray(a))
                          for n, a in convert._flatten(p, "")})
    return p, attn


def _x(B, T, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, T, d)).astype(np.float32)


def test_rms_norm_and_rope():
    x = _x(2, 5, 64)
    scale = np.random.default_rng(2).standard_normal(64).astype(np.float32)
    want = np.asarray(JL.rms_norm({"scale": jnp.asarray(scale)},
                                  jnp.asarray(x), 1e-5))
    got = TL.rms_norm(torch.as_tensor(x), torch.as_tensor(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    pos = np.arange(3, 8)[None, :]
    xh = x.reshape(2, 5, 4, 16)
    for xx in (xh, x):                              # with and without heads
        want = np.asarray(JL.apply_rope(jnp.asarray(xx), jnp.asarray(pos),
                                        1e4))
        got = TL.apply_rope(torch.as_tensor(xx), torch.as_tensor(pos), 1e4)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(causal=True, q_offset=0),
    dict(causal=True, q_offset=0, window=5),
    dict(causal=True, q_offset=3, kv_len=9, softcap=20.0),
    dict(causal=False, q_offset=0)], ids=["causal", "window", "kvlen", "full"])
def test_attention_core_dense_path(kw):
    gen = np.random.default_rng(3)
    q = gen.standard_normal((2, 4, 6, 16)).astype(np.float32)
    k = gen.standard_normal((2, 4, 12, 16)).astype(np.float32)
    v = gen.standard_normal((2, 4, 12, 16)).astype(np.float32)
    want = np.asarray(JL.attention_core(*map(jnp.asarray, (q, k, v)), **kw))
    got = TL.attention_core(*map(torch.as_tensor, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [dict(causal=True, q_offset=0, window=700),
                                dict(causal=True, q_offset=8, kv_len=4105)],
                         ids=["window", "kvlen"])
def test_attention_core_chunked_path(kw):
    """Past 4096 query rows both packages take the online-softmax path;
    small chunks make several tiles per row."""
    gen = np.random.default_rng(4)
    q = gen.standard_normal((1, 1, 4104, 16)).astype(np.float32)
    k = gen.standard_normal((1, 1, 4120, 16)).astype(np.float32)
    v = gen.standard_normal((1, 1, 4120, 16)).astype(np.float32)
    want = np.asarray(JL.attention_core(*map(jnp.asarray, (q, k, v)),
                                        chunk_q=1024, chunk_k=1000, **kw))
    got = TL.attention_core(*map(torch.as_tensor, (q, k, v)), chunk_q=1024,
                            chunk_k=1000, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("window", [None, 5])
def test_gqa_apply_without_cache(window):
    cfg = _mk(qkv_bias=True)
    p, attn = _attn_pair(cfg)
    x = _x(2, 11, 64)
    want, _ = JL.gqa_apply(p, jcfgmod.ModelConfig(**dataclasses.asdict(cfg)),
                           jnp.asarray(x), window=window)
    got, _ = TL.gqa_apply(attn, cfg, torch.as_tensor(x), window=window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("window,max_len,chunks", [
    (None, 16, (6, 1, 1, 3)),       # full cache with kv_len mask
    (4, 16, (6, 1, 1, 3)),          # ring of 4: first chunk wider than it
    (4, 16, (3, 1, 2, 1)),          # ring: first chunk narrower
    (6, 16, (9, 1, 4))],            # ring: later chunk wider than the ring
    ids=["full", "ring-wide", "ring-narrow", "ring-chunked"])
def test_gqa_apply_with_cache(window, max_len, chunks):
    cfg = _mk()
    jc = jcfgmod.ModelConfig(**dataclasses.asdict(cfg))
    p, attn = _attn_pair(cfg, seed=2)
    x = _x(2, sum(chunks), 64, seed=5)
    jcache = JL.gqa_cache_init(jc, 2, max_len, window=window)
    tcache = TL.gqa_cache_init(cfg, 2, max_len, window=window, device="cpu")
    t = 0
    for T in chunks:
        pos = jnp.arange(t, t + T)[None]
        want, jcache = JL.gqa_apply(p, jc, jnp.asarray(x[:, t:t + T]),
                                    window=window, positions=pos,
                                    cache=jcache)
        got, tcache = TL.gqa_apply(attn, cfg, torch.as_tensor(x[:, t:t + T]),
                                   window=window, positions=torch.as_tensor(
                                       np.array(pos)), cache=tcache)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), atol=1e-5,
                                       rtol=0)
        t += T
        assert tcache["pos"] == int(jcache["pos"]) == t


def test_full_cache_overflow_raises():
    cfg = _mk()
    _, attn = _attn_pair(cfg)
    cache = TL.gqa_cache_init(cfg, 1, 8, device="cpu")
    _, cache = TL.gqa_apply(attn, cfg, torch.zeros(1, 6, 64), cache=cache)
    with pytest.raises(ValueError, match="overflow"):
        TL.gqa_apply(attn, cfg, torch.zeros(1, 3, 64), cache=cache,
                     positions=torch.arange(6, 9)[None])


def _gemma_pair(n_layers):
    jcfg = dataclasses.replace(jconfigs.get_config("gemma3-4b").smoke(),
                               n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.get_config("gemma3-4b").smoke(),
                               n_layers=n_layers)
    params = jax.jit(j_init_params, static_argnums=1)(
        jax.random.PRNGKey(n_layers), jcfg)
    model = tmodel.init_params(tcfg, device="cpu")
    model.load_state_dict(convert.lm_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("n_layers,plan", [(7, "runs"), (19, "periodic")])
def test_forward_matches_jax_through_lm_params(n_layers, plan):
    jcfg, params, tcfg, model = _gemma_pair(n_layers)
    segs = jmodel.plan_segments(jcfg)
    assert (plan == "periodic") == (len(segs[0].specs) > 1
                                    and segs[0].reps > 1)
    toks = np.random.default_rng(n_layers).integers(0, jcfg.vocab_size,
                                                    (2, 48))
    jfwd = jax.jit(j_forward, static_argnums=1)
    want, _, _ = jfwd(params, jcfg, jnp.asarray(toks))
    got, _, _ = tmodel.forward(model, tcfg, torch.as_tensor(toks))
    assert 48 > tcfg.sliding_window
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    # prefill past the window, then decode: ring caches on both sides
    jc = j_init_cache(jcfg, 2, 64)
    tc = tmodel.init_cache(tcfg, 2, 64, device="cpu")
    for t0, t1 in ((0, 40), (40, 41), (41, 42), (42, 45)):
        want, _, jc = jfwd(params, jcfg, jnp.asarray(toks[:, t0:t1]),
                           cache=jc)
        got, _, tc = tmodel.forward(model, tcfg, torch.as_tensor(
            toks[:, t0:t1]), cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=0)
    assert tc["pos"] == int(jc["pos"]) == 45


def test_bf16_logits_within_the_references_own_bf16_gap():
    """The port in bfloat16 against the JAX package: the same bfloat16
    weights (the float32 ones rounded) through both packages; the port's
    logits may be no further from the reference's float32 logits than
    twice the reference's own bfloat16 logits are (the bound measured
    here, each run, not chosen)."""
    jcfg, params, tcfg, _ = _gemma_pair(7)
    bf = dict(param_dtype="bfloat16", dtype="bfloat16")
    jcfg16 = dataclasses.replace(jcfg, **bf)
    tcfg16 = dataclasses.replace(tcfg, **bf)
    params16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                      params)
    model16 = tmodel.init_params(tcfg16, device="cpu")
    model16.load_state_dict(convert.lm_params(
        jax.tree_util.tree_map(np.asarray, params16), tcfg16))
    assert all(p.dtype == torch.bfloat16 for p in model16.parameters())
    toks = np.random.default_rng(16).integers(0, jcfg.vocab_size, (2, 48))
    jfwd = jax.jit(j_forward, static_argnums=1)
    ref32 = np.asarray(jfwd(params, jcfg, jnp.asarray(toks))[0])
    ref16 = np.asarray(jfwd(params16, jcfg16, jnp.asarray(toks))[0],
                       np.float32)
    got, _, _ = tmodel.forward(model16, tcfg16, torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    real = slice(0, jcfg.vocab_size)           # the padded tail is -1e9
    gap_ref = np.abs(ref16 - ref32)[..., real].max()
    gap_port = np.abs(got - ref32)[..., real].max()
    assert 0 < gap_ref and np.isfinite(got).all()
    assert gap_port <= 2 * gap_ref, (gap_port, gap_ref)


def _decode_vs_full(cfg, T=9, prefill=5, atol=2e-3):
    model = tmodel.init_params(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, T)))
    full, _, _ = tmodel.forward(model, cfg, toks)
    cache = tmodel.init_cache(cfg, 2, 32, device="cpu")
    _, _, cache = tmodel.forward(model, cfg, toks[:, :prefill], cache=cache)
    for t in range(prefill, T):
        lg, _, cache = tmodel.forward(model, cfg, toks[:, t:t + 1],
                                      cache=cache)
        err = (lg[:, 0] - full[:, t]).abs().max().item()
        assert err < atol, f"{cfg.name} step {t}: err {err}"


@pytest.mark.parametrize("cfg,T,prefill", [
    (_mk("gqa"), 9, 5),
    (_mk("gqa-b", qkv_bias=True, attn_logit_softcap=30.0), 9, 5),
    (_mk("swa", sliding_window=4, local_global_pattern=(1, 1), n_layers=4),
     12, 6),
    (_mk("swa-only", sliding_window=3, n_layers=2, tie_embeddings=True,
         vocab_size=300), 10, 2)], ids=lambda c: getattr(c, "name", None))
def test_decode_matches_full_forward(cfg, T, prefill):
    _decode_vs_full(cfg, T=T, prefill=prefill)


def test_swa_route_goes_through_the_kernel_wrapper(monkeypatch):
    """Each sliding-window layer calls ``ops.swa_attention`` once per
    forward without a cache and once per prefill into an empty ring; decode
    steps attend over the ring in torch ops and never call it."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma3-4b").smoke(),
                              n_layers=7)
    calls = []
    real = TL.ops.swa_attention

    def counted(q, k, v, *, window):
        calls.append((tuple(q.shape), window))
        return real(q, k, v, window=window)

    monkeypatch.setattr(TL.ops, "swa_attention", counted)
    model = tmodel.init_params(cfg, device="cpu")
    toks = torch.zeros((2, 40), dtype=torch.long)
    tmodel.forward(model, cfg, toks)
    assert calls == [((2, 40, 4, 64), 32)] * 6
    calls.clear()
    cache = tmodel.init_cache(cfg, 2, 50, device="cpu")
    _, _, cache = tmodel.forward(model, cfg, toks, cache=cache)
    assert len(calls) == 6
    tmodel.forward(model, cfg, toks[:, :1], cache=cache)
    assert len(calls) == 6


@pytest.mark.parametrize("change", [
    dict(seq_shard_decode=True), dict(grouped_gqa=True),
    dict(attn_batch_shard_fallback=True),
    dict(attn_logit_softcap=50.0)])
def test_variants_outside_the_slice_raise(change):
    """Only swa layers with a softcap raise; the variant flags build
    (``grouped_gqa``, and ``seq_shard_decode`` / ``attn_batch_shard_fallback``
    that act under a mesh alone: tests/test_torch_grouped.py), and so does
    ``mla_absorb``, a single-device variant of MLA (tests/test_torch_mla.py)."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma3-4b").smoke(),
                              **change)
    if "attn_logit_softcap" in change:
        with pytest.raises(NotImplementedError):
            tmodel.init_params(cfg, device="meta")
    else:
        assert getattr(tmodel.init_params(cfg, device="meta").cfg,
                       next(iter(change)))
    absorbed = dataclasses.replace(tconfigs.get_config("gemma3-4b").smoke(),
                                   mla_absorb=True)
    tmodel.init_params(absorbed, device="meta")


#: sampling standard errors within which a leaf's std matches the
#: reference's
INIT_STD_Z = 5.0


def _assert_init_like_the_reference(cfg, model, ref=None):
    """Every parameter of the port's ``init_params`` model against the
    matching leaf of the reference's ``init_params`` on the same config
    (carried over by ``convert.lm_params``; ``ref``, a state dict of such
    weights, where the caller has one): the same constant leaves (all
    zeros, all ones) exactly, and for a drawn leaf of N elements the same
    std within ``INIT_STD_Z`` standard errors of the difference of two
    sample stds of N normals (sigma / sqrt(N)), and a mean within
    ``INIT_STD_Z`` sigma / sqrt(N / 2)."""
    if ref is None:
        jcfg = jcfgmod.ModelConfig(**dataclasses.asdict(cfg))
        ref = convert.lm_params(jax.tree_util.tree_map(
            np.asarray, j_init_params(jax.random.PRNGKey(11), jcfg)), cfg)
    got = dict(model.named_parameters())
    assert got.keys() == ref.keys()
    for name, p in got.items():
        p, q = p.detach().double().flatten(), ref[name].double().flatten()
        assert p.shape == q.shape, name
        for const in (0.0, 1.0):
            assert bool((p == const).all()) == bool((q == const).all()), name
        if bool((q == q[0]).all()):
            assert torch.equal(p, q), name
            continue
        sigma, m = q.std().item(), p.numel()
        assert abs(p.std().item() - sigma) <= INIT_STD_Z * sigma / m ** 0.5, \
            (name, p.std().item(), sigma)
        assert abs(p.mean().item() - q.mean().item()) <= \
            INIT_STD_Z * sigma * (2 / m) ** 0.5, name


def test_init_params_scales_match_the_reference_gemma3_smoke():
    """gemma3-4b's smoke width at two layers (qk norms, a sliding-window
    and a global layer, tied embeddings as the config has them): each
    leaf's scale and constants as the reference draws them."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma3-4b").smoke(),
                              n_layers=2)
    _assert_init_like_the_reference(
        cfg, tmodel.init_params(cfg, seed=3, device="cpu"))


def test_init_params_is_a_function_of_cfg_and_seed(monkeypatch):
    """``init_params`` draws parameter i of ``named_parameters()`` from
    Philox keyed by (seed, i) (``core/rng.py``, the same integers on every
    device), slab by slab with the same bits for any slab size: the same
    weights whatever was drawn before and whatever torch's global
    generator holds, other weights under another seed, the reference's
    scales and constants (embeddings N(0, 1/d), projections N(0, 1/d_in),
    biases zero, norm scales one), held to the reference's own draw;
    ``gqa_init`` under a seed draws the same way."""
    cfg = _mk("init", qkv_bias=True)
    a = tmodel.init_params(cfg, seed=5, device="cpu")
    tmodel.init_params(cfg, seed=9, device="cpu")
    torch.manual_seed(123)
    torch.randn(7)
    b = tmodel.init_params(cfg, seed=5, device="cpu")
    c = tmodel.init_params(cfg, seed=6, device="cpu")
    d = cfg.d_model
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q), name
        if name.endswith(".b"):
            assert not p.any(), name
        elif name.endswith("scale"):
            assert bool((p == 1).all()), name
        else:
            assert not torch.equal(p, r), name
    _assert_init_like_the_reference(cfg, a)
    z = rng.normal(5, torch.tensor([0]), TL.INIT_STREAM,
                   (a.embed.numel(),))[0]
    assert torch.equal(a.embed.flatten(), (z * d ** -0.5).to(a.embed.dtype))
    monkeypatch.setattr(TL, "INIT_SLAB", 1 << 10)
    for p, q in zip(a.parameters(),
                    tmodel.init_params(cfg, seed=5, device="cpu").parameters()):
        assert torch.equal(p, q)
    attn = TL.gqa_init(cfg, seed=5, device="cpu")
    again = TL.gqa_init(cfg, seed=5, device="cpu")
    for (name, p), q in zip(attn.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
