"""The port's input shapes and long-context variant against the reference
(``repro.configs``): ``SHAPES`` and ``LONG_WINDOW``, ``shape_supported``
(39 of the 10 x 4 combos), ``resolve`` field by field for every combo
(jamba's long variant keeps full attention at its attention layers, as the
reference's does), ``input_specs``' keys, shapes and dtypes for (n, r) in
{(16, 1), (8, 2)}, ``model_flops_global``; and the long variant's smoke
config of gemma3-4b and mistral-nemo-12b (every layer sliding-window) in
float32 against the reference: the forward, and a prefill past the window
then decode steps on ring caches (atol 2e-4, tests/test_torch_models.py's
logits bound)."""
import dataclasses
import os

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
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import dryrun
from repro_torch.models import config as tcfgmod
from repro_torch.models import model as tmodel

COMBOS = [(a, s) for a in jconfigs.ARCH_IDS for s in jconfigs.SHAPES]
LOGITS_ATOL = 2e-4


def _jdryrun():
    """The reference's dry-run module, imported with JAX's backend already
    up and ``XLA_FLAGS`` put back: importing it sets 512 host devices for
    any process started later."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


def test_shapes_and_window_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.LONG_WINDOW == jconfigs.LONG_WINDOW == 8192


def test_shape_supported_is_the_references():
    got = [tconfigs.shape_supported(tconfigs.get_config(a), s)
           for a, s in COMBOS]
    want = [jconfigs.shape_supported(jconfigs.get_config(a), s)
            for a, s in COMBOS]
    assert got == want and sum(got) == 39
    assert [c for c, ok in zip(COMBOS, got) if not ok] == [
        ("whisper-base", "long_500k")]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_resolve_is_the_references_field_by_field(arch):
    for shape in jconfigs.SHAPES:
        got = tconfigs.resolve(tconfigs.get_config(arch), shape)
        want = jconfigs.resolve(jconfigs.get_config(arch), shape)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), shape
        assert [dataclasses.asdict(s) for s in tcfgmod.layer_specs(got)] == \
            [dataclasses.asdict(s) for s in jcfgmod.layer_specs(want)]


def test_long_variants_mixers():
    """Dense long variants are all sliding-window at W 8192; rwkv6 and
    deepseek keep their mixers; jamba's attention layers stay full
    attention (``layer_specs`` gives a hybrid's attention layers ``gqa``
    before it reads the pattern), as in the reference."""
    for arch in ("gemma3-4b", "mistral-nemo-12b", "qwen2-72b",
                 "phi4-mini-3.8b", "llava-next-34b",
                 "llama4-maverick-400b-a17b"):
        cfg = tconfigs.resolve(tconfigs.get_config(arch), "long_500k")
        assert cfg.name.endswith("+swa") and cfg.sliding_window == 8192
        assert {s.mixer for s in tcfgmod.layer_specs(cfg)} == {"swa"}
    jamba = tconfigs.resolve(tconfigs.get_config("jamba-v0.1-52b"),
                             "long_500k")
    assert jamba.sliding_window == 8192
    assert {s.mixer for s in tcfgmod.layer_specs(jamba)} == {"mamba", "gqa"}
    for arch, mixer in (("rwkv6-1.6b", "rwkv6"), ("deepseek-v3-671b", "mla")):
        cfg = tconfigs.resolve(tconfigs.get_config(arch), "long_500k")
        assert cfg.max_seq_len >= 524_296
        assert mixer in {s.mixer for s in tcfgmod.layer_specs(cfg)}


@pytest.mark.parametrize("n,r", [(16, 1), (8, 2)])
def test_input_specs_are_the_references(n, r):
    for arch, shape in COMBOS:
        jc = jconfigs.get_config(arch)
        if not jconfigs.shape_supported(jc, shape):
            continue
        want = jconfigs.input_specs(jconfigs.resolve(jc, shape), shape,
                                    n=n, r=r)
        got = tconfigs.input_specs(
            tconfigs.resolve(tconfigs.get_config(arch), shape), shape,
            n=n, r=r)
        assert got.keys() == want.keys(), (arch, shape)
        for key, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[key].shape), (arch, shape)
            assert str(t.dtype).removeprefix("torch.") == \
                str(want[key].dtype), (arch, shape, key)


def test_input_specs_refuse_an_uneven_batch():
    with pytest.raises(ValueError, match="multiple of n"):
        tconfigs.input_specs(tconfigs.get_config("gemma3-4b"), "train_4k",
                             n=12)


def test_model_flops_global_is_the_references():
    jd = _jdryrun()
    for arch, shape in COMBOS:
        jc = jconfigs.get_config(arch)
        if not jconfigs.shape_supported(jc, shape):
            continue
        got = dryrun.model_flops_global(
            tconfigs.resolve(tconfigs.get_config(arch), shape), shape)
        assert got == jd.model_flops_global(jconfigs.resolve(jc, shape),
                                            shape), (arch, shape)


@pytest.mark.parametrize("arch", ["gemma3-4b", "mistral-nemo-12b"])
def test_long_variant_smoke_matches_the_reference(arch):
    """The long variant's smoke config (2 layers, both sliding-window, W
    32) in float32 with the reference's weights: the forward over 48
    tokens, then a 40-token prefill and three decode steps on ring caches,
    past the window, every logit within 2e-4."""
    jcfg = jconfigs.long_variant(jconfigs.get_config(arch)).smoke()
    tcfg = tconfigs.long_variant(tconfigs.get_config(arch)).smoke()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert {s.mixer for s in tcfgmod.layer_specs(tcfg)} == {"swa"}
    assert tcfg.sliding_window == 32
    params = jax.jit(j_init_params, static_argnums=1)(
        jax.random.PRNGKey(3), jcfg)
    model = tmodel.init_params(tcfg, device="cpu")
    model.load_state_dict(convert.lm_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 48))
    jfwd = jax.jit(j_forward, static_argnums=1)
    want, _, _ = jfwd(params, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got, _, _ = tmodel.forward(model, tcfg, torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    jc = j_init_cache(jcfg, 2, 64)
    tc = tmodel.init_cache(tcfg, 2, 64, device="cpu")
    assert tc["layers"][0]["attn"]["k"].shape[2] == 32      # a ring
    for t0, t1 in ((0, 40), (40, 41), (41, 42), (42, 43)):
        want, _, jc = jfwd(params, jcfg, jnp.asarray(toks[:, t0:t1]),
                           cache=jc)
        with torch.no_grad():
            got, _, tc = tmodel.forward(model, tcfg, torch.as_tensor(
                toks[:, t0:t1]), cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_ATOL, rtol=0)
    assert tc["pos"] == int(jc["pos"]) == 43
