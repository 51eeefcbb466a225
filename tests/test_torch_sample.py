"""Sampled decode of the port (``make_serve_step(cfg, greedy=False)``)
against the JAX package's, at phi4-mini-3.8b's smoke config in float32.

The port draws by Gumbel-max from its own Philox (``gumbel_scores``: the
key (seed, step), trial id = batch row, element = vocabulary index), the
reference by ``jax.random.categorical``: the two streams differ, so they
are held together by distribution (parity level 3, ROADMAP.md).  One
decode step of N = 20 000 identical rows gives N draws from one logits
row in each package (each step jitted or run once, on fixed keys); the
statistics are asserted as drawn, never retried:

* each package's draws against its own softmax, a chi-square goodness of
  fit over the categories with an expected count of at least 5 (the rest
  pooled into one bin), p > 1e-3;
* the two packages' draws against each other, a two-sample chi-square
  over the same bins, p > 1e-3.

The port's own invariants: the greedy path's tokens are the logits'
first argmax bit for bit, with or without a key; ``rng=None`` is
greedy; the same key gives the same tokens and another key others; a
row's draw depends on its row index, not on the batch around it; no
padded vocabulary id is ever drawn; the noise is finite and inside the
range 24-bit uniforms allow.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro import configs as jconfigs
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.train import make_serve_step as j_make_serve_step
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import init_cache, init_params
from repro_torch.train import gumbel_scores, make_serve_step

from torch_parity import one_thread  # noqa: F401

ARCH = "phi4-mini-3.8b"
N = 20_000
P_MIN = 1e-3
#: the Gumbel noise's range under 24-bit uniforms, a 0 taken as 2**-25
NOISE_LO, NOISE_HI = -np.log(25 * np.log(2)), -np.log(-np.log1p(-2.0 ** -24))


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.get_config(ARCH).smoke()
    tcfg = tconfigs.get_config(ARCH).smoke()
    params = jax.jit(j_init_params, static_argnums=1)(jax.random.PRNGKey(3),
                                                      jcfg)
    model = init_params(tcfg, device="cpu")
    model.load_state_dict(convert.lm_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jcfg, tcfg, params, model


def _step(model, cfg, B, tokens, greedy=True, rng=None):
    """One decode step of the port from an empty cache on ``tokens``."""
    cache = init_cache(cfg, B, 8, device="cpu")
    with torch.inference_mode():
        return make_serve_step(cfg, greedy=greedy)(
            model, cache, torch.as_tensor(tokens).reshape(B, 1), rng=rng)


@pytest.fixture(scope="module")
def draws(models):
    """N draws of each package from one logits row: N identical rows, one
    decode step, one key each."""
    jcfg, tcfg, params, model = models
    tokens = np.full((N, 1), 7, np.int32)
    jstep = jax.jit(j_make_serve_step(jcfg, greedy=False))
    jnext, _ = jstep(params, j_init_cache(jcfg, N, 8), jnp.asarray(tokens),
                     jax.random.PRNGKey(11))
    tnext, _, last = _step(model, tcfg, N, tokens, greedy=False,
                           rng=(11, 0))
    jlogits, _, _ = jax.jit(j_forward, static_argnums=1)(
        params, jcfg, jnp.asarray(tokens[:1]), cache=j_init_cache(jcfg, 1, 8))
    return (np.asarray(jnext)[:, 0], tnext[:, 0].numpy(),
            np.asarray(jlogits[0, -1], np.float64),
            last[0].double().numpy())


def _bins(p):
    """Category bins with an expected count of at least 5 under ``p``, the
    rest pooled into one: (index of each category's bin, bin count)."""
    keep = np.flatnonzero(N * p >= 5)
    idx = np.full(p.shape[0], len(keep))
    idx[keep] = np.arange(len(keep))
    return idx, len(keep) + 1


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def _goodness(drawn, logits):
    p = _softmax(logits)
    idx, nb = _bins(p)
    obs = np.bincount(idx[drawn], minlength=nb)
    exp = np.bincount(idx, weights=p * N, minlength=nb)
    return stats.chisquare(obs, exp)


@pytest.mark.parametrize("who", ["port", "jax"])
def test_draws_follow_the_softmax(draws, who):
    jd, td, jl, tl = draws
    drawn, logits = (td, tl) if who == "port" else (jd, jl)
    res = _goodness(drawn, logits)
    assert res.pvalue > P_MIN, (who, res)


def test_port_and_jax_draws_share_a_distribution(draws):
    jd, td, jl, tl = draws
    np.testing.assert_allclose(tl, jl, atol=2e-4)    # one logits row
    idx, nb = _bins(_softmax(tl))
    table = np.stack([np.bincount(idx[td], minlength=nb),
                      np.bincount(idx[jd], minlength=nb)])
    table = table[:, table.sum(0) > 0]
    res = stats.chi2_contingency(table)
    assert res.pvalue > P_MIN, res


def test_greedy_path_is_the_first_argmax(models):
    _, tcfg, _, model = models
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (6, 1))
    nxt, _, last = _step(model, tcfg, 6, toks)
    assert torch.equal(nxt[:, 0], last.argmax(dim=-1).to(torch.int32))
    keyed, _, last_k = _step(model, tcfg, 6, toks, rng=(5, 1))
    assert torch.equal(keyed, nxt) and torch.equal(last_k, last)
    unkeyed, _, _ = _step(model, tcfg, 6, toks, greedy=False)
    assert torch.equal(unkeyed, nxt)


def test_same_key_same_tokens_and_rows_keyed_by_index(models):
    _, tcfg, _, model = models
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (64, 1))
    a, _, last = _step(model, tcfg, 64, toks, greedy=False, rng=(9, 3))
    b, _, _ = _step(model, tcfg, 64, toks, greedy=False, rng=(9, 3))
    c, _, _ = _step(model, tcfg, 64, toks, greedy=False, rng=(9, 4))
    assert torch.equal(a, b)
    assert (a != c).any()
    assert not torch.equal(a[:, 0], last.argmax(dim=-1).to(torch.int32))
    head = gumbel_scores(last[:5], (9, 3))
    assert torch.equal(head, gumbel_scores(last, (9, 3))[:5])


def test_padded_ids_are_never_drawn():
    """vocab 500 padded to 512: the masked tail (-1e9) is never drawn,
    from the model's rows or from a row whose real logits are all -30."""
    cfg = dataclasses.replace(tconfigs.get_config(ARCH).smoke(),
                              vocab_size=500)
    assert cfg.padded_vocab == 512
    model = init_params(cfg, seed=4, device="cpu")
    toks = np.random.default_rng(2).integers(0, 500, (256, 1))
    for step in range(8):
        nxt, _, last = _step(model, cfg, 256, toks, greedy=False,
                             rng=(13, step))
        assert int(nxt.max()) < 500
    assert bool((last[:, 500:] == -1e9).all())
    flat = torch.full((4096, 512), -1e9)
    flat[:, :500] = -30.0
    assert int(gumbel_scores(flat, (1, 2)).argmax(dim=-1).max()) < 500


def test_noise_is_finite_and_inside_the_24_bit_range():
    zero = torch.zeros((512, 4096))
    noise = gumbel_scores(zero, (17, 0))
    assert bool(torch.isfinite(noise).all())
    assert NOISE_LO - 1e-5 <= float(noise.min())
    assert float(noise.max()) <= NOISE_HI + 1e-5
    # Gumbel(0, 1): mean Euler's gamma, variance pi^2 / 6
    assert abs(float(noise.mean()) - np.euler_gamma) < 5e-3
    assert abs(float(noise.var()) - np.pi ** 2 / 6) < 2e-2
