"""Jamba's Mamba mixer and jamba-v0.1-52b in the port against the JAX
package, in float32 at smoke width (d 256, d_inner 512, d_state 8; the
hybrid config of tests/test_models.py at d 64).  ``mamba_conv`` against
``_mamba_conv`` with and without ``prev`` (the output and the next
``prev`` exactly); ``mamba_apply`` without and with a state (out, ``h``
and ``conv`` rel 1e-5); the mixer in bfloat16 within twice the reference's
own bfloat16-vs-float32 gap (measured here), and one mixer at jamba's
published widths (d 4096, d_inner 8192) with its bfloat16-vs-float32 gap
within a factor 2 of the reference's; ``forward`` and prefill then
decode against the JAX decode (atol 2e-4, tests/test_torch_models.py's
logits bound; each Mamba layer's state rel 1e-5), and decode against the
port's own full forward (2e-3, tests/test_models.py's bound; at
capacity_factor E/K, where no call drops a pair) for the hybrid config and
jamba's smoke config with the CLIs' cut (attention every second layer);
jamba's own period-8 plan at narrow width through ``convert.lm_params``;
the straggler train step with the MoE aux loss; the parameter tree at full
size against ``jax.eval_shape`` and ``active_params``; the
initialisation's fixed leaves exactly and its drawn ones by distribution;
the serve and train CLIs at ``--smoke`` on the CPU, and the full depth
refused by both launchers' memory checks before a weight is drawn.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import config as jcfgmod
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import config as tcfgmod
from repro_torch.models import layers as TL
from repro_torch.models import model as tmodel
from test_torch_models import _assert_init_like_the_reference
from torch_lm_parity import (DECODE_ATOL, LOGITS_ATOL,
                             assert_config_is_the_references,
                             assert_full_size_like_the_reference, lm_pair,
                             port_model, straggler_step_parity, tcfg)
from torch_parity import rel_err
from torch_parity import one_thread  # noqa: F401

ARCH = "jamba-v0.1-52b"
#: jamba's smoke config with the reference CLIs' hybrid cut: layer 0
#: (mamba, swiglu), layer 1 (gqa, moe)
JCUT = dataclasses.replace(jconfigs.get_config(ARCH).smoke(), ssm_period=2,
                           ssm_attn_offset=1)
#: tests/test_models.py's hybrid config: 8 layers, attention at 2 and 6,
#: MoE on the odd layers, capacity 8 (no drops)
JHYB = jcfgmod.ModelConfig(
    name="hyb", arch_type="hybrid", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=97, param_dtype="float32",
    dtype="float32", remat=False, ssm_kind="mamba", ssm_period=4,
    ssm_attn_offset=2, n_experts=4, experts_per_token=2, d_ff_expert=96,
    moe_period=2, moe_offset=1, d_state=8, capacity_factor=8.0)
CONFIGS = {"hyb": JHYB, "jamba-cut": JCUT}
JFWD = jax.jit(j_forward, static_argnums=1)
JMAMBA = jax.jit(JL.mamba_apply, static_argnums=1)
B, T = 2, 12
D = JCUT.d_model


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX config, JAX parameters, the port's model on the same
    weights) of ``CONFIGS[name]``, made once."""
    jcfg = CONFIGS[name]
    return (jcfg,) + lm_pair(jcfg)


@pytest.fixture(params=list(CONFIGS))
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def mixer():
    """One Mamba mixer of jamba's smoke width, with ``D``, ``conv_b`` and
    the ``dt_proj`` bias drawn away from their constant initial values."""
    p = jax.jit(JL.mamba_init, static_argnums=1)(jax.random.PRNGKey(7),
                                                 JCUT)
    gen = np.random.default_rng(7)
    di = JCUT.d_inner
    p["D"] = jnp.asarray(gen.uniform(0.5, 1.5, di).astype(np.float32))
    p["conv_b"] = jnp.asarray(gen.standard_normal(di).astype(np.float32)
                              * 0.1)
    p["dt_proj"]["b"] = jnp.asarray(gen.uniform(-3, 1, di).astype(
        np.float32))
    return p, _load(TL.Mamba(tcfg(JCUT)), p)


def _load(module, jax_tree):
    module.load_state_dict({n: torch.tensor(np.asarray(a)) for n, a in
                            convert._flatten(jax_tree, "")})
    return module


def _x(T_, seed, d=D):
    return np.random.default_rng(seed).standard_normal((B, T_, d)).astype(
        np.float32)


def _tokens(jcfg, seed, T_=T):
    return np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, T_))


def _specs(jcfg):
    return [(s.mixer, s.ffn) for s in jcfgmod.layer_specs(jcfg)]


def test_config_and_layer_plans_are_the_references():
    """The config field for field, and jamba's layer pattern: a Jamba
    block of 8 layers (attention at 4, MoE on the odd layers) four times,
    planned as one periodic segment; the smoke config all Mamba, the
    CLIs' cut Mamba then attention."""
    assert_config_is_the_references(ARCH)
    full = tconfigs.get_config(ARCH)
    block = [("gqa" if i == 4 else "mamba", "moe" if i % 2 else "swiglu")
             for i in range(8)]
    assert [(s.mixer, s.ffn) for s in tcfgmod.layer_specs(full)] == block * 4
    segs = tmodel.plan_segments(full)
    assert [(len(s.specs), s.reps) for s in segs] == [(8, 4)]
    assert _specs(jconfigs.get_config(ARCH).smoke()) == [
        ("mamba", "swiglu"), ("mamba", "moe")]
    assert _specs(JCUT) == [("mamba", "swiglu"), ("gqa", "moe")]
    assert dataclasses.asdict(tconfigs.cli_config(ARCH, smoke=True)) == \
        dataclasses.asdict(JCUT)
    assert tconfigs.cli_config(ARCH) == full


@pytest.mark.parametrize("with_prev", [False, True])
def test_mamba_conv_matches_jax_exactly(with_prev):
    gen = np.random.default_rng(3)
    di = JCUT.d_inner
    x = gen.standard_normal((B, 6, di)).astype(np.float32)
    w = gen.standard_normal((JCUT.d_conv, di)).astype(np.float32)
    b = gen.standard_normal(di).astype(np.float32)
    prev = (gen.standard_normal((B, JCUT.d_conv - 1, di)).astype(np.float32)
            if with_prev else None)
    want, wprev = JL._mamba_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), None if prev is None
                                 else jnp.asarray(prev))
    got, gprev = TL.mamba_conv(torch.as_tensor(x), torch.as_tensor(w),
                               torch.as_tensor(b), None if prev is None
                               else torch.as_tensor(prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gprev.numpy(), np.asarray(wprev))


def test_mamba_apply_without_state_matches_jax(mixer):
    p, mod = mixer
    x = _x(9, 3)
    want, st = JMAMBA(p, JCUT, jnp.asarray(x))
    with torch.no_grad():
        got, tst = TL.mamba_apply(mod, tcfg(JCUT), torch.as_tensor(x))
    assert st is None and tst is None
    assert rel_err(got, want) <= 1e-5


def test_mamba_apply_with_state_matches_jax(mixer):
    """Three chunks (7 tokens, 1, then 3) from the zero state: each
    output and the state's ``h`` and ``conv`` after each, rel 1e-5."""
    p, mod = mixer
    x = _x(11, 4)
    js = JL.mamba_state_init(JCUT, B)
    ts = TL.mamba_state_init(tcfg(JCUT), B)
    assert ts["h"].dtype == torch.float32
    assert ts["h"].shape == (B, JCUT.d_inner, JCUT.d_state)
    assert ts["conv"].shape == (B, JCUT.d_conv - 1, JCUT.d_inner)
    for t0, t1 in ((0, 7), (7, 8), (8, 11)):
        want, js = JMAMBA(p, JCUT, jnp.asarray(x[:, t0:t1]), js)
        with torch.no_grad():
            got, ts = TL.mamba_apply(mod, tcfg(JCUT),
                                     torch.as_tensor(x[:, t0:t1]), ts)
        assert rel_err(got, want) <= 1e-5
        assert rel_err(ts["h"], js["h"]) <= 1e-5
        assert rel_err(ts["conv"], js["conv"]) <= 1e-5
    assert float(ts["h"].abs().max()) > 0.1


def test_mamba_bf16_within_the_references_own_bf16_gap(mixer):
    """The mixer's bfloat16 weights (its float32 ones rounded; ``A_log``
    and ``D`` stay float32, as in a bfloat16 model) on bfloat16 inputs,
    through both packages: the port's output is no further from the
    reference's float32 output than twice the reference's own bfloat16
    output is."""
    p, _ = mixer
    c16 = dataclasses.replace(JCUT, param_dtype="bfloat16", dtype="bfloat16")
    p16 = {k: v if k in ("A_log", "D") else jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), v) for k, v in p.items()}
    mod16 = TL.Mamba(tcfg(c16))
    mod16.load_state_dict({n: torch.tensor(np.asarray(a, np.float32)) for
                           n, a in convert._flatten(p16, "")})
    assert mod16.A_log.dtype == mod16.D.dtype == torch.float32
    assert mod16.in_proj.w.dtype == torch.bfloat16
    x = _x(16, 5)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    ref32 = np.asarray(JMAMBA(p, JCUT, jnp.asarray(x16, jnp.float32))[0])
    ref16 = np.asarray(JMAMBA(p16, c16, x16)[0], np.float32)
    with torch.no_grad():
        got, _ = TL.mamba_apply(mod16, tcfg(c16), torch.as_tensor(
            np.asarray(x16, np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    gap_ref = np.abs(ref16 - ref32).max()
    gap_port = np.abs(got - ref32).max()
    assert 0 < gap_ref and np.isfinite(got).all()
    assert gap_port <= 2 * gap_ref, (gap_port, gap_ref)


def test_mamba_bf16_gap_at_published_width_is_the_references():
    """One Mamba mixer at jamba's published widths (d 4096, d_inner 8192,
    d_state 16) on its bfloat16 initial weights, 2 x 8 tokens: each
    package's bfloat16 output against its own float32-activation output on
    the same weights (the distance the card's consistency check reads for
    a whole Jamba block), rel to the largest float32 output.  The port's
    gap is within a factor 2 of the reference's either way, and its
    bfloat16 output is as close to the reference's float32 one as twice
    the reference's own gap: the bfloat16 error is the reference's
    arithmetic, not the port's."""
    c16 = jconfigs.get_config(ARCH)
    c32 = dataclasses.replace(c16, dtype="float32")
    p16 = jax.jit(JL.mamba_init, static_argnums=1)(jax.random.PRNGKey(3),
                                                   c16)
    mod = TL.Mamba(tcfg(c16)).requires_grad_(False)
    mod.load_state_dict({n: torch.from_numpy(np.array(a, np.float32))
                         for n, a in convert._flatten(p16, "")})
    x16 = jnp.asarray(np.random.default_rng(3).standard_normal(
        (B, 8, c16.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    x32 = jnp.asarray(x16, jnp.float32)
    ref16 = np.asarray(JMAMBA(p16, c16, x16)[0], np.float32)
    ref32 = np.asarray(JMAMBA(p16, c32, x32)[0])
    tx = torch.from_numpy(np.asarray(x32))
    port16 = TL.mamba_apply(mod, tcfg(c16), tx.bfloat16())[0].float().numpy()
    port32 = TL.mamba_apply(mod, tcfg(c32), tx)[0].numpy()
    scale = np.abs(ref32).max()
    gap_ref = np.abs(ref16 - ref32).max() / scale
    gap_port = np.abs(port16 - port32).max() / scale
    cross = np.abs(port16 - ref32).max() / scale
    print(f"published-width Mamba bf16 vs float32-activation rel: "
          f"reference {gap_ref:.4e}, port {gap_port:.4e}, port bf16 vs "
          f"reference float32 {cross:.4e}; port float32 vs reference "
          f"float32 {np.abs(port32 - ref32).max() / scale:.4e}")
    assert np.isfinite(port16).all() and 0 < gap_ref
    assert gap_ref / 2 <= gap_port <= 2 * gap_ref, (gap_port, gap_ref)
    assert cross <= 2 * gap_ref, (cross, gap_ref)


def test_mamba_block_cache_is_the_references():
    spec = tcfgmod.LayerSpec(mixer="mamba", ffn="swiglu")
    jc = jmodel.block_cache_init(JCUT, spec, B, 16)
    tc = tmodel.block_cache_init(tcfg(JCUT), spec, B, 16, device="cpu")
    assert sorted(tc) == sorted(jc) == ["ssm"]
    for k in ("h", "conv"):
        assert tuple(tc["ssm"][k].shape) == jc["ssm"][k].shape
        assert str(tc["ssm"][k].dtype).removeprefix("torch.") == \
            str(jc["ssm"][k].dtype)
        assert not tc["ssm"][k].any()


def test_forward_matches_jax(pair):
    jcfg, params, model = pair
    toks = _tokens(jcfg, 1)
    want, jaux, _ = JFWD(params, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got, aux, _ = tmodel.forward(model, tcfg(jcfg), torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    assert float(aux) > 0 and rel_err(aux, jaux) <= 1e-6


def _mamba_states(jc):
    """The JAX cache's Mamba states, one per layer in layer order."""
    out = []
    for seg in jc["segments"]:
        reps = jax.tree_util.tree_leaves(seg)[0].shape[0]
        for rep in range(reps):
            for layer in seg:
                if "ssm" in layer:
                    out.append({k: np.asarray(v)[rep]
                                for k, v in layer["ssm"].items()})
                else:
                    out.append(None)
    return out


def test_prefill_then_decode_matches_jax(pair):
    """A prefill of 10 tokens and two decode steps: the logits (atol
    2e-4) and every Mamba layer's ``h`` and ``conv`` (rel 1e-5), the
    attention layers' position."""
    jcfg, params, model = pair
    cfg = tcfg(jcfg)
    toks = _tokens(jcfg, 3)
    jc = j_init_cache(jcfg, B, 16)
    tc = tmodel.init_cache(cfg, B, 16, device="cpu")
    for t0, t1 in ((0, 10), (10, 11), (11, 12)):
        want, _, jc = JFWD(params, jcfg, jnp.asarray(toks[:, t0:t1]),
                           cache=jc)
        with torch.no_grad():
            got, _, tc = tmodel.forward(model, cfg,
                                        torch.as_tensor(toks[:, t0:t1]),
                                        cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_ATOL, rtol=0)
        states = _mamba_states(jc)
        assert len(states) == len(tc["layers"])
        for c, js in zip(tc["layers"], states):
            assert ("ssm" in c) == (js is not None)
            if js is not None:
                assert rel_err(c["ssm"]["h"], js["h"]) <= 1e-5
                assert rel_err(c["ssm"]["conv"], js["conv"]) <= 1e-5
            else:
                assert c["attn"]["pos"] == t1
    assert tc["pos"] == int(jc["pos"]) == 12


def test_decode_matches_full_forward(pair):
    jcfg, _, model = pair
    cfg = dataclasses.replace(tcfg(jcfg), capacity_factor=jcfg.n_experts
                              / jcfg.experts_per_token)
    m = port_model(cfg, model.state_dict())
    toks = torch.as_tensor(_tokens(jcfg, 4))
    with torch.no_grad():
        full, _, _ = tmodel.forward(m, cfg, toks)
        cache = tmodel.init_cache(cfg, B, 32, device="cpu")
        _, _, cache = tmodel.forward(m, cfg, toks[:, :5], cache=cache)
        for t in range(5, T):
            lg, _, cache = tmodel.forward(m, cfg, toks[:, t:t + 1],
                                          cache=cache)
            err = (lg[:, 0] - full[:, t]).abs().max().item()
            assert err < DECODE_ATOL, (t, err)


def test_period_8_plan_through_lm_params():
    """jamba's own pattern (ssm_period 8, attention at 4, MoE on the odd
    layers) over one Jamba block of 8 layers at a narrow width, unstacked
    into the port's layers: the reference plans a 5-spec segment and a
    run-length tail of three (the hybrid config's plan is one segment of 4
    specs stacked twice); the logits against the reference's."""
    jcfg = dataclasses.replace(JHYB, name="p8", ssm_period=8,
                               ssm_attn_offset=4)
    plan = [(len(s.specs), s.reps) for s in jmodel.plan_segments(jcfg)]
    assert plan == [(5, 1), (1, 1), (1, 1), (1, 1)]
    assert [(len(s.specs), s.reps) for s in
            tmodel.plan_segments(tcfg(jcfg))] == plan
    assert [(len(s.specs), s.reps) for s in
            jmodel.plan_segments(JHYB)] == [(4, 2)]
    params, model = lm_pair(jcfg, seed=8)
    assert [b.spec.mixer for b in model.blocks] == [
        "gqa" if i == 4 else "mamba" for i in range(8)]
    toks = _tokens(jcfg, 8)
    want, jaux, _ = JFWD(params, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got, aux, _ = tmodel.forward(model, tcfg(jcfg), torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    assert rel_err(aux, jaux) <= 1e-6


@pytest.mark.parametrize("cut", ["smoke", "cli-cut", "one-block"])
def test_each_plan_unstacks_into_the_ports_layers(cut):
    """jamba's smoke config (two Mamba layers, its period 8 kept), the
    CLIs' cut and one Jamba block at published widths: the reference's
    plan for each, and its parameter tree (``jax.eval_shape``, nothing
    allocated) through ``convert._unstack`` onto the port's layers, names,
    shapes and dtypes."""
    full = jconfigs.get_config(ARCH)
    jcfg = {"smoke": full.smoke(), "cli-cut": JCUT,
            "one-block": dataclasses.replace(full, n_layers=8)}[cut]
    cfg = tcfg(jcfg)
    assert [(len(s.specs), s.reps) for s in tmodel.plan_segments(cfg)] == \
        [(len(s.specs), s.reps) for s in jmodel.plan_segments(jcfg)]
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    want = {n: (a.shape, str(a.dtype))
            for n, a in convert._unstack(zeros, cfg).items()}
    model = tmodel.init_params(cfg, device="meta")
    assert {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
            for n, p in model.named_parameters()} == want
    assert [b.spec for b in model.blocks] == list(
        tcfgmod.layer_specs(cfg))


def test_straggler_step_matches_jax():
    """The CLIs' cut through one straggler round: a Mamba and an MoE
    layer, the aux loss within rel 1e-5 and non-zero."""
    _, params, _ = _pair("jamba-cut")
    tm = straggler_step_parity(JCUT, params)
    assert float(tm["aux"]) > 0


def test_parameter_tree_at_full_size():
    """51.57 B parameters at full size; ``A_log`` and ``D`` float32 in the
    bfloat16 model; one Jamba block (8 layers, the smoke's serve cut) holds
    13.30 B, the CLIs' cut at published widths (the smoke's training cut)
    3.68 B."""
    model = assert_full_size_like_the_reference(ARCH)
    assert tmodel.num_params(model) == 51_570_315_264
    f32 = {n.split(".", 2)[-1] for n, p in model.named_parameters()
           if p.dtype == torch.float32}
    assert f32 == {"mixer.A_log", "mixer.D", "ffn.router"}
    mix = model.blocks[0].mixer
    assert tuple(mix.A_log.shape) == (8192, 16)
    assert tuple(mix.x_proj.w.shape) == (8192, 256 + 32)
    assert tuple(mix.dt_proj.w.shape) == (256, 8192)
    block = tmodel.init_params(dataclasses.replace(model.cfg, n_layers=8),
                               device="meta")
    assert tmodel.num_params(block) == 13_295_235_072
    cut = tmodel.init_params(dataclasses.replace(
        model.cfg, n_layers=2, ssm_period=2, ssm_attn_offset=1),
        device="meta")
    assert tmodel.num_params(cut) == 3_678_941_184


def test_init_params_like_the_reference():
    """The hybrid config's every leaf against the reference's jitted
    ``init_params`` (the weights of its pair) by
    ``_assert_init_like_the_reference``: ``conv_w`` N(0, 1/d_conv) by
    distribution, ``A_log`` (log 1..N on every row) and ``D`` exactly."""
    cfg = tcfg(JHYB)
    model = tmodel.init_params(cfg, seed=3, device="cpu")
    _, _, ref = _pair("hyb")
    _assert_init_like_the_reference(cfg, model, ref.state_dict())
    for name in ("A_log", "D"):
        got = getattr(model.blocks[0].mixer, name)
        assert torch.equal(got, getattr(ref.blocks[0].mixer, name)), name


def test_serve_and_the_trainer_run_jamba_on_the_cpu():
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert res.finite and tuple(res.tokens.shape) == (2, 3)
    out = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "2", "--n", "2", "--r", "1", "--k", "2",
                          "--batch", "2", "--seq", "8"])
    assert out.state.params.cfg == tcfg(JCUT)
    assert out.state.step == 2
    assert all(np.isfinite(h["loss"]) and h["aux"] > 0 for h in out.history)


def test_full_depth_is_refused_by_the_memory_checks(monkeypatch):
    """On an 80 GB card, the full 32 layers (103 GB of bfloat16 weights)
    are refused by ``serve.run``'s weight check and the trainer's
    ``state_bytes`` check before any weight is drawn."""
    card = torch.device("cuda")
    monkeypatch.setattr(serve, "resolve_device", lambda d: card)
    monkeypatch.setattr(train_cli, "resolve_device", lambda d: card)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(total_memory=80e9))

    def no_draw(*a, **k):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(TL, "init_weights_", no_draw)
    full = tconfigs.get_config(ARCH)
    with pytest.raises(ValueError, match="exceed"):
        serve.run(full, batch=1, prompt_len=4, gen=2)
    with pytest.raises(SystemExit, match="exceed"):
        train_cli.main(["--arch", ARCH, "--steps", "1"])
    assert train_cli.state_bytes(full) > 6 * 10 ** 11
