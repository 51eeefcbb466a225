"""The port's LM token sources against the reference's, by distribution.
The port draws with Philox (``repro_torch.data.pipeline``), the reference
with threefry, so the tokens differ bit for bit; what must agree is their
law:

* ``synthetic_tokens``: the unigram counts of the two sources are one
  distribution (two-sample chi-square) and uniform (one-sample);
* ``bigram_tokens``: the empirical entropy rate of each source (plug-in
  from the bigram counts, Miller-Madow corrected) equals the entropy rate
  its own chain implies, and the two sources' rates agree within the
  spread of the chain law (transition logits N(0, 1) / temperature) that
  both draw their chain from;
* the per-token NLL of each source's tokens under its own chain equals the
  chain's expected value from the uniform first token on, and the two
  sources' residuals agree.

Every tolerance is ``Z`` standard errors: the chi-square statistic's own
(sqrt(2 df)), and for the chain, the spread of per-sequence means (the
sequences are independent), whose square root of N also bounds the plug-in
estimate (its influence function is the per-token NLL's).
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as jp
from repro_torch.data import pipeline as tp
from torch_parity import one_thread  # noqa: F401

Z = 5.0
V_UNI, SEQ_UNI, TASKS, BATCH_UNI = 50, 64, 64, 50
V_CHAIN, T_CHAIN, SEQ, BATCH = 64, 0.5, 65, 256


def _chi2_limit(df: int) -> float:
    return df + Z * np.sqrt(2.0 * df)


def test_unigram_frequencies_match_the_reference():
    port = tp.synthetic_tokens(11, torch.arange(TASKS), BATCH_UNI, SEQ_UNI,
                               V_UNI).numpy().ravel()
    ref = np.asarray(jp.synthetic_tokens(jax.random.PRNGKey(11),
                                         TASKS * BATCH_UNI, SEQ_UNI,
                                         V_UNI)).ravel()
    assert port.min() >= 0 and port.max() < V_UNI
    a = np.bincount(port, minlength=V_UNI).astype(np.float64)
    b = np.bincount(ref, minlength=V_UNI).astype(np.float64)
    assert a.sum() == b.sum() == TASKS * BATCH_UNI * SEQ_UNI
    # two-sample homogeneity: the 2 x V table's chi-square, V - 1 df
    both = a + b
    ea, eb = both * a.sum() / both.sum(), both * b.sum() / both.sum()
    chi2 = (((a - ea) ** 2 / ea) + ((b - eb) ** 2 / eb)).sum()
    assert chi2 <= _chi2_limit(V_UNI - 1), chi2
    for counts in (a, b):                      # each against uniform
        e = counts.sum() / V_UNI
        assert ((counts - e) ** 2 / e).sum() <= _chi2_limit(V_UNI - 1)


def _softmax(logits: np.ndarray) -> np.ndarray:
    x = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _expected_rate(P: np.ndarray, seq: int) -> float:
    """Mean over the seq - 1 transitions of E[-log P(x_{t+1} | x_t)] from
    a uniform first token: sum_a pi_t(a) H(P_a), pi_{t+1} = pi_t P."""
    with np.errstate(divide="ignore", invalid="ignore"):
        rows = -np.where(P > 0, P * np.log(P), 0.0).sum(axis=-1)
    pi = np.full(P.shape[0], 1.0 / P.shape[0])
    total = 0.0
    for _ in range(seq - 1):
        total += pi @ rows
        pi = pi @ P
    return total / (seq - 1)


def _chains():
    """Each package's transition matrix (float64) at (V_CHAIN, T_CHAIN)."""
    cdf = tp._chain_cdf(V_CHAIN, T_CHAIN).numpy()
    p_port = np.diff(cdf, axis=-1, prepend=0.0)
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(1234),
                                          (V_CHAIN, V_CHAIN)) / T_CHAIN)
    return p_port / p_port.sum(-1, keepdims=True), _softmax(
        logits.astype(np.float64))


def _samples():
    port = tp.bigram_tokens(3, torch.arange(TASKS), BATCH, SEQ, V_CHAIN,
                            temperature=T_CHAIN,
                            chain_vocab=V_CHAIN).numpy().reshape(-1, SEQ)
    ref = np.asarray(jp.bigram_tokens(jax.random.PRNGKey(3), TASKS * BATCH,
                                      SEQ, V_CHAIN, temperature=T_CHAIN,
                                      chain_vocab=V_CHAIN))
    return port, ref


@pytest.fixture(scope="module")
def chains_and_samples():
    return _chains(), _samples()


def _nll(tokens: np.ndarray, P: np.ndarray):
    """(mean per-token NLL under P, its standard error over sequences)."""
    per_seq = -np.log(P[tokens[:, :-1], tokens[:, 1:]]).mean(axis=1)
    return per_seq.mean(), per_seq.std(ddof=1) / np.sqrt(len(per_seq))


def _plugin_rate(tokens: np.ndarray) -> float:
    """The empirical conditional entropy of the next token given the
    current one from the bigram counts, plus the Miller-Madow correction
    (nonzero cells less rows over 2N)."""
    V = V_CHAIN
    n = np.bincount((tokens[:, :-1] * V + tokens[:, 1:]).ravel(),
                    minlength=V * V).reshape(V, V).astype(np.float64)
    N, rows = n.sum(), n.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = -np.where(n > 0, n / N * np.log(n / rows), 0.0).sum()
    return h + ((n > 0).sum() - (rows > 0).sum()) / (2.0 * N)


def _chain_law_spread(draws: int = 500) -> float:
    """The standard deviation of the expected rate over chains of the law
    both packages draw from (numpy draws, fixed seed)."""
    g = np.random.default_rng(0)
    rates = [_expected_rate(_softmax(g.standard_normal((V_CHAIN, V_CHAIN))
                                     / T_CHAIN), SEQ) for _ in range(draws)]
    return float(np.std(rates, ddof=1))


def test_bigram_entropy_rate_matches_the_reference(chains_and_samples):
    (p_port, p_ref), (t_port, t_ref) = chains_and_samples
    got = {}
    for name, toks, P in (("port", t_port, p_port), ("ref", t_ref, p_ref)):
        assert toks.shape == (TASKS * BATCH, SEQ)
        assert toks.min() >= 0 and toks.max() < V_CHAIN
        rate, se = _plugin_rate(toks), _nll(toks, P)[1]
        want = _expected_rate(P, SEQ)
        assert abs(rate - want) <= Z * se, (name, rate, want, se)
        got[name] = (rate, se)
    # the two chains are two draws of one law: the rates agree within its
    # spread plus the sampling error
    spread = _chain_law_spread()
    gap = abs(got["port"][0] - got["ref"][0])
    assert gap <= Z * np.sqrt(got["port"][1] ** 2 + got["ref"][1] ** 2
                              + 2 * spread ** 2), (gap, spread)


def test_nll_under_the_chain_matches_the_reference(chains_and_samples):
    (p_port, p_ref), (t_port, t_ref) = chains_and_samples
    resid = {}
    for name, toks, P in (("port", t_port, p_port), ("ref", t_ref, p_ref)):
        nll, se = _nll(toks, P)
        resid[name] = (nll - _expected_rate(P, SEQ), se)
        assert abs(resid[name][0]) <= Z * se, (name, resid[name])
    gap = resid["port"][0] - resid["ref"][0]
    assert abs(gap) <= Z * np.hypot(resid["port"][1], resid["ref"][1])
