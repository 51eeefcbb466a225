"""llava-next-34b and ``forward(embeds=)`` in the port against the JAX
package, in float32 at the reference's smoke config (2 dense layers, d
256, 16 patch embeddings of width 128 through ``frontend_proj``):
``forward`` with and without embeddings and prefill with them then decode
against the JAX decode (atol 2e-4, tests/test_torch_models.py's logits
bound), positions and the cache's ``pos`` covering the patches and the
text; decode against the port's own full forward (2e-3); the per-sequence
loss on the text positions only; the straggler train step with slot-major
``embeds`` on one round of a JAX-drawn trace (tests/test_torch_train.py's
bounds); the initialisation's scales; the parameter tree at full size
against ``jax.eval_shape`` and ``active_params``, and its bf16 weights
within one card; the text-only serve run, the trainer CLI's refusal, and
embeddings given to a model without a frontend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import config as tcfgmod
from repro_torch.models import model as tmodel
from repro_torch.train import lm_loss_per_seq
from test_torch_models import _assert_init_like_the_reference
from torch_lm_parity import (DECODE_ATOL, LOGITS_ATOL,
                             assert_config_is_the_references,
                             assert_full_size_like_the_reference, lm_pair,
                             straggler_step_parity, tcfg)
from torch_parity import rel_err
from torch_parity import one_thread  # noqa: F401

ARCH = "llava-next-34b"
JCFG = jconfigs.get_config(ARCH).smoke()
TCFG = tcfg(JCFG)
JFWD = jax.jit(j_forward, static_argnums=1)
B, T = 2, 12
P = JCFG.frontend_seq


@pytest.fixture(scope="module")
def pair():
    return lm_pair(JCFG)


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (B, T))


def _embeds(seed=2):
    return np.random.default_rng(seed).standard_normal(
        (B, P, JCFG.frontend_dim)).astype(np.float32)


def test_config_is_the_references():
    assert_config_is_the_references(ARCH)
    assert [(s.mixer, s.ffn) for s in tcfgmod.layer_specs(TCFG)] == [
        ("gqa", "swiglu")] * 2
    assert (TCFG.frontend, P, TCFG.frontend_dim) == ("vision_stub", 16, 128)


@pytest.mark.parametrize("with_embeds", [True, False],
                         ids=["embeds", "text"])
def test_forward_matches_jax(pair, with_embeds):
    params, model = pair
    toks, emb = _tokens(), _embeds() if with_embeds else None
    want, _, _ = JFWD(params, JCFG, jnp.asarray(toks),
                      embeds=None if emb is None else jnp.asarray(emb))
    with torch.no_grad():
        got, aux, _ = tmodel.forward(
            model, TCFG, torch.as_tensor(toks),
            embeds=None if emb is None else torch.as_tensor(emb))
    assert got.shape == (B, T + (P if with_embeds else 0),
                         TCFG.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    assert float(aux) == 0.0
    if with_embeds:                       # the patches reach the text
        with torch.no_grad():
            other, _, _ = tmodel.forward(model, TCFG, torch.as_tensor(toks),
                                         embeds=torch.as_tensor(_embeds(9)))
        assert (other[:, P:] - got[:, P:]).abs().max() > 1e-3


def test_prefill_with_embeds_then_decode_matches_jax(pair):
    params, model = pair
    toks, emb = _tokens(3), _embeds(3)
    jc = j_init_cache(JCFG, B, 32)
    tc = tmodel.init_cache(TCFG, B, 32, device="cpu")
    for t0, t1 in ((0, 8), (8, 9), (9, 10), (10, 12)):
        first = t0 == 0
        want, _, jc = JFWD(params, JCFG, jnp.asarray(toks[:, t0:t1]),
                           cache=jc,
                           embeds=jnp.asarray(emb) if first else None)
        with torch.no_grad():
            got, _, tc = tmodel.forward(
                model, TCFG, torch.as_tensor(toks[:, t0:t1]), cache=tc,
                embeds=torch.as_tensor(emb) if first else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_ATOL, rtol=0)
    assert tc["pos"] == int(jc["pos"]) == P + T


def test_decode_matches_full_forward(pair):
    _, model = pair
    toks, emb = torch.as_tensor(_tokens(4)), torch.as_tensor(_embeds(4))
    with torch.no_grad():
        full, _, _ = tmodel.forward(model, TCFG, toks, embeds=emb)
        cache = tmodel.init_cache(TCFG, B, 32, device="cpu")
        _, _, cache = tmodel.forward(model, TCFG, toks[:, :5], cache=cache,
                                     embeds=emb)
        for t in range(5, T):
            lg, _, cache = tmodel.forward(model, TCFG, toks[:, t:t + 1],
                                          cache=cache)
            err = (lg[:, 0] - full[:, P + t]).abs().max().item()
            assert err < DECODE_ATOL, (t, err)


def test_loss_on_text_positions_only(pair):
    params, model = pair
    gen = np.random.default_rng(5)
    toks, labs = (gen.integers(0, JCFG.vocab_size, (B, T)) for _ in "tl")
    emb = _embeds(5)
    want, _ = jax.jit(jsteps.lm_loss_per_seq, static_argnums=1)(
        params, JCFG, jnp.asarray(toks), jnp.asarray(labs),
        embeds=jnp.asarray(emb))
    with torch.no_grad():
        got, aux = lm_loss_per_seq(model, TCFG, torch.as_tensor(toks),
                                   torch.as_tensor(labs),
                                   embeds=torch.as_tensor(emb))
    assert got.shape == (B,) and float(aux) == 0.0
    assert rel_err(got, want) <= 1e-5


def test_straggler_step_with_embeds_matches_jax(pair):
    params, _ = pair
    straggler_step_parity(JCFG, params, {"embeds": lambda r, n, b, gen: (
        gen.standard_normal((r, n, b, P, JCFG.frontend_dim))
        .astype(np.float32))})


def test_init_params_like_the_reference():
    _assert_init_like_the_reference(
        TCFG, tmodel.init_params(TCFG, seed=3, device="cpu"))


def test_parameter_tree_at_full_size():
    model = assert_full_size_like_the_reference(ARCH)
    n = tmodel.num_params(model)
    assert 34.3e9 < n < 34.5e9 and len(model.blocks) == 60
    assert tuple(model.frontend_proj.w.shape) == (1024, 7168)
    # bf16 weights within one 80 GB card, with room for the prefill
    assert 2 * n < 70e9


def test_serve_runs_text_only():
    res = serve.run(TCFG, batch=2, prompt_len=4, gen=3, device="cpu")
    assert res.finite and tuple(res.tokens.shape) == (2, 3)
    assert res.init_s > 0
    again = serve.run(TCFG, batch=2, prompt_len=4, gen=3, device="cpu")
    assert torch.equal(again.tokens, res.tokens)          # seeded


def test_trainer_cli_refuses_llava_and_embeds_need_a_frontend():
    with pytest.raises(SystemExit, match="text archs"):
        train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "1"])
    cfg = get_config("gemma3-4b").smoke()
    model = tmodel.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="frontend"):
        tmodel.forward(model, cfg, torch.zeros((1, 4), dtype=torch.long),
                       embeds=torch.zeros((1, 2, 8)))
