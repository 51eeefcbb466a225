"""The float32 swa_attention kernel's arithmetic (csrc/swa_attention_f32.cu),
emulated with plain PyTorch on the CPU: TF32 rounding (cvt.rna: 11
significant bits, ties away from zero) done on the float32 bit pattern
with integer ops as the kernel does it, Q K^T as three TF32 products and
P V as four (V in three exact terms) into float32.  The emulation is held
against JAX's Pallas kernel in interpret mode (max abs 2e-4, as
tests/test_torch_swa.py holds the plain version) and against a float64
evaluation of ``ref.swa_attention_ref``: its max-abs error there is at most
10x the plain float32 version's own, the guard the card tests put on the
kernel.  A single TF32 product fails that guard, and so does V in two
terms at window 1, where the plain version is exact."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref
from torch_parity import one_thread  # noqa: F401

JAX_SHAPES = [(128, 2, 64, 32), (200, 1, 32, 64), (256, 2, 128, 100),
              (64, 4, 16, 8), (96, 1, 64, 96), (130, 2, 32, 17)]
#: the guard's factor: the kernel's error against float64 over the plain
#: float32 version's
GUARD = 10.0


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 on its bit pattern: add half of the 13 dropped
    bits' weight, clear them (the kernel's tf32_rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split2(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split3(x):
    hi = tf32_rna(x)
    r = x - hi
    lo = tf32_rna(r)
    return hi, lo, r - lo


def _mm(eq, terms):
    """The sum of TF32 products, small terms first, in float32 (a product
    of two TF32 values is exact in float32)."""
    out = None
    for a, b in terms:
        y = torch.einsum(eq, a, b)
        out = y if out is None else out + y
    return out


def emulate(q, k, v, window, products=3, v_terms=3):
    """Causal sliding-window attention with the kernel's split arithmetic:
    ``products`` TF32 products a float32 product of Q K^T (3, or 1: plain
    TF32), and P V with P in two terms and V in ``v_terms`` (3: the
    kernel's four products; 2: three products; 1 with products=1: plain
    TF32).  Softmax and the division are float32."""
    B, T, H, dh = q.shape
    G = H // k.shape[2]
    kf, vf = (a.repeat_interleave(G, dim=2) for a in (k, v))
    eq_s, eq_o = "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd"
    if products == 1:
        s = _mm(eq_s, [(tf32_rna(q), tf32_rna(kf))])
    else:
        (qh, ql), (kh, kl) = split2(q), split2(kf)
        s = _mm(eq_s, [(ql, kh), (qh, kl), (qh, kh)])
    s = s * (1.0 / math.sqrt(dh))
    pos = torch.arange(T)
    ok = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)
    if products == 1:
        acc = _mm(eq_o, [(tf32_rna(p), tf32_rna(vf))])
    else:
        ph, pl = split2(p)
        if v_terms == 3:
            vh, vl, vz = split3(vf)
            acc = _mm(eq_o, [(pl, vh), (ph, vz), (ph, vl), (ph, vh)])
        else:
            vh, vl = split2(vf)
            acc = _mm(eq_o, [(pl, vh), (ph, vl), (ph, vh)])
    return acc / l.clamp_min(1e-30).permute(0, 2, 1)[..., None]


def _qkv(B, T, H, K, dh, seed):
    gen = np.random.default_rng(seed)
    q = 0.5 * gen.standard_normal((B, T, H, dh))
    k = 0.5 * gen.standard_normal((B, T, K, dh))
    v = gen.standard_normal((B, T, K, dh))
    return [torch.as_tensor(a, dtype=torch.float32) for a in (q, k, v)]


def _errors(q, k, v, W, **kw):
    """Max-abs errors of the emulation and of the plain float32 version
    against the float64 evaluation."""
    exact = ref.swa_attention_ref(q.double(), k.double(), v.double(), W)
    got = emulate(q, k, v, W, **kw)
    plain = ref.swa_attention_ref(q, k, v, W)
    return ((got.double() - exact).abs().max().item(),
            (plain.double() - exact).abs().max().item())


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_rounding_is_rna_on_11_bits(seed):
    """tf32_rna keeps 11 significant bits, rounds to the nearest such value
    and sends exact ties away from zero (cvt.rna's rule), for normal
    values of either sign."""
    gen = np.random.default_rng(seed)
    x = gen.standard_normal(4096) * np.exp2(gen.integers(-60, 60, 4096))
    x = torch.as_tensor(x, dtype=torch.float32)
    r = tf32_rna(x).double()
    xd = x.double()
    e = torch.floor(torch.log2(xd.abs()))
    ulp = torch.exp2(e - 10)                       # 11 significant bits
    scaled = xd / ulp
    want = torch.sign(scaled) * torch.floor(scaled.abs() + 0.5) * ulp
    assert torch.equal(r, want)
    # exact ties: 1 + 2^-11 (+ the ulp below, for the carry)
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                         2 - 2 ** -12], dtype=torch.float32)
    assert tf32_rna(ties).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                       1 + 2 ** -9, 2.0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_terms_hold_v_exactly(seed):
    """V's split: hi + lo + lo2 == v in float32, each term a TF32 value;
    two terms miss v by up to ~2^-22 |v|."""
    gen = np.random.default_rng(seed)
    v = torch.as_tensor(gen.standard_normal(1 << 14) * 4, dtype=torch.float32)
    hi, lo, lo2 = split3(v)
    for term in (hi, lo, lo2):
        assert torch.equal(tf32_rna(term), term)
    assert torch.equal((lo2 + lo) + hi, v)
    h2, l2 = split2(v)
    miss = ((l2 + h2) - v).abs() / v.abs()
    assert 0 < miss.max().item() <= 2 ** -21


@pytest.mark.parametrize("T,H,dh,W", JAX_SHAPES)
def test_emulation_matches_jax_kernel(T, H, dh, W):
    q, k, v = _qkv(1, T, H, H, dh, seed=T + W)
    got = emulate(q, k, v, W)[0].numpy()
    pallas = np.asarray(jops.swa_attention(
        *(jnp.asarray(a[0].numpy()) for a in (q, k, v)), window=W,
        block_q=64, block_k=64, interpret=True))
    assert np.abs(got - pallas).max() < 2e-4


@pytest.mark.parametrize("B,T,H,K,dh,W", [
    (1, 512, 2, 1, 256, 256), (1, 600, 2, 2, 256, 600),
    (1, 640, 2, 1, 256, 1), (2, 128, 8, 4, 32, 1)])
def test_emulation_is_within_the_float64_guard(B, T, H, K, dh, W):
    """The kernel's arithmetic stays within 10x the plain float32 version's
    error against float64; at window 1 both are exact."""
    q, k, v = _qkv(B, T, H, K, dh, seed=T + W)
    err, plain = _errors(q, k, v, W)
    assert err <= GUARD * plain
    if W == 1:
        assert err == 0 and plain == 0


@pytest.mark.parametrize("B,T,H,K,dh,W", [(1, 512, 2, 1, 256, 256),
                                          (1, 600, 2, 2, 256, 600)])
def test_one_tf32_product_fails_the_guard(B, T, H, K, dh, W):
    """Plain TF32 (one product each) is off by two orders of magnitude and
    more: the guard tells TF32 from float32 accuracy."""
    q, k, v = _qkv(B, T, H, K, dh, seed=T + W)
    err, plain = _errors(q, k, v, W, products=1)
    assert err > 100 * GUARD * plain


def test_v_in_two_terms_fails_the_guard_at_window_1():
    """With V in two TF32 terms (three products for P V) a row with one
    visible key returns hi + lo != v, while the plain version is exact:
    why the kernel takes V in three terms."""
    q, k, v = _qkv(1, 640, 2, 1, 256, seed=641)
    err, plain = _errors(q, k, v, 1, v_terms=2)
    assert plain == 0 and err > 0
