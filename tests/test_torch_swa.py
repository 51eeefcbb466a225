"""The port's sliding-window attention against the JAX package: the plain
version (``ref.swa_attention_ref``) and the CPU path of the wrapper
(``ops.swa_attention``) against JAX's ``ref.swa_attention_ref`` and its
Pallas kernel (``ops.swa_attention``, interpret mode on the CPU, as
tests/test_kernels.py runs it), at the JAX kernel tests' shapes with their
tolerances (max abs 2e-4 in float32, 3e-2 in bfloat16); the batched GQA
mapping against ``repeat_kv`` and a per-batch call; window 1 and window >= T
as closed forms; the edge shapes of the tensor-core kernel's tiling (T not
a multiple of 64 or 128, W not a multiple of 64, W >= T, batched GQA with
K = 1) against JAX's reference; the route that picks the kernel on a card
(the float32 kernel's split arithmetic is in tests/test_torch_swa_split.py);
and the wrapper's input checks.  The CUDA kernels themselves are held
against the plain version in tests/test_torch_card.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import repeat_kv as jax_repeat_kv
from repro_torch.kernels import ops, ref
from torch_parity import one_thread  # noqa: F401

JAX_SHAPES = [(128, 2, 64, 32), (200, 1, 32, 64), (256, 2, 128, 100),
              (64, 4, 16, 8), (96, 1, 64, 96), (130, 2, 32, 17)]


def _qkv(T, H, dh, seed=0, K=None, B=None):
    """q (scaled 0.5), k (0.5), v as float32 numpy arrays from a seed:
    (T, H, dh), or (B, T, H|K, dh) when B is given."""
    gen = np.random.default_rng(seed)
    K = H if K is None else K
    lead = () if B is None else (B,)
    q = 0.5 * gen.standard_normal(lead + (T, H, dh))
    k = 0.5 * gen.standard_normal(lead + (T, K, dh))
    v = gen.standard_normal(lead + (T, K, dh))
    return [a.astype(np.float32) for a in (q, k, v)]


@pytest.mark.parametrize("T,H,dh,W", JAX_SHAPES)
def test_plain_version_matches_jax(T, H, dh, W):
    q, k, v = _qkv(T, H, dh, seed=T + W)
    want = np.asarray(jref.swa_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), W))
    got = ref.swa_attention_ref(*(torch.as_tensor(a)[None]
                                  for a in (q, k, v)), W)[0].numpy()
    assert np.abs(got - want).max() < 2e-4
    wrapped = ops.swa_attention(*(torch.as_tensor(a)[None] for a in (q, k, v)),
                                window=W)
    assert torch.equal(wrapped[0], torch.as_tensor(got))
    pallas = np.asarray(jops.swa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=W,
        block_q=64, block_k=64, interpret=True))
    assert np.abs(got - pallas).max() < 2e-4


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
def test_dtypes_match_jax_kernel(dtype, tol):
    T, H, dh, W = 128, 2, 64, 48
    q, k, v = _qkv(T, H, dh, seed=5)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    pallas = jops.swa_attention(jq, jk, jv, window=W, interpret=True)
    tq, tk, tv = (torch.as_tensor(np.array(a.astype(jnp.float32)))
                  .to(getattr(torch, dtype))[None] for a in (jq, jk, jv))
    got = ops.swa_attention(tq, tk, tv, window=W)[0]
    assert got.dtype == getattr(torch, dtype)
    diff = np.abs(got.float().numpy() - np.asarray(pallas, np.float32)).max()
    assert diff < tol


@pytest.mark.parametrize("B,T,H,K,dh,W", [(3, 40, 6, 2, 16, 7),
                                          (2, 33, 4, 4, 32, 33),
                                          (2, 50, 8, 1, 16, 64)])
def test_gqa_batched_mapping(B, T, H, K, dh, W):
    """Query head h reads KV head h // (H // K): the batched, grouped call
    equals JAX's ``repeat_kv`` followed by one (T, H, dh) call per batch
    row."""
    q, k, v = _qkv(T, H, dh, seed=B * T, K=K, B=B)
    got = ops.swa_attention(torch.as_tensor(q), torch.as_tensor(k),
                            torch.as_tensor(v), window=W).numpy()
    kr = np.asarray(jax_repeat_kv(jnp.asarray(k).transpose(0, 2, 1, 3),
                                  H // K)).transpose(0, 2, 1, 3)
    vr = np.asarray(jax_repeat_kv(jnp.asarray(v).transpose(0, 2, 1, 3),
                                  H // K)).transpose(0, 2, 1, 3)
    for b in range(B):
        want = np.asarray(jref.swa_attention_ref(
            jnp.asarray(q[b]), jnp.asarray(kr[b]), jnp.asarray(vr[b]), W))
        assert np.abs(got[b] - want).max() < 2e-4


def test_window_1_is_v():
    q, k, v = _qkv(64, 2, 32, seed=1, K=1, B=2)
    got = ops.swa_attention(torch.as_tensor(q), torch.as_tensor(k),
                            torch.as_tensor(v), window=1)
    want = np.repeat(v, 2, axis=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_window_at_least_t_is_causal():
    T, H, dh = 96, 2, 32
    q, k, v = _qkv(T, H, dh, seed=2)
    s = np.einsum("qhd,khd->hqk", q, k) / np.sqrt(dh)
    s = np.where(np.tril(np.ones((T, T), bool))[None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("hqk,khd->qhd", p, v)
    for W in (T, T + 1, 10 * T):
        got = ops.swa_attention(*(torch.as_tensor(a)[None] for a in (q, k, v)),
                                window=W)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,T,H,K,dh,W", [
    (1, 130, 2, 2, 64, 70), (1, 257, 2, 2, 64, 70), (1, 130, 2, 2, 32, 130),
    (1, 257, 1, 1, 16, 1000), (2, 130, 4, 1, 64, 70), (3, 257, 4, 1, 16, 257),
    (2, 257, 8, 4, 32, 1)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
def test_plain_version_matches_jax_at_edge_shapes(B, T, H, K, dh, W, dtype,
                                                  tol):
    """The plain version, batched and grouped, against JAX's reference on
    each batch row with the KV heads repeated, at the shapes that cut the
    tensor-core kernel's 64-row tiles and 128-row blocks raggedly."""
    q, k, v = _qkv(T, H, dh, seed=B * T + W, K=K, B=B)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(np.array(a.astype(jnp.float32)))
                  .to(getattr(torch, dtype)) for a in (jq, jk, jv))
    got = ref.swa_attention_ref(tq, tk, tv, W)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, T, H, dh)
    assert torch.equal(ops.swa_attention(tq, tk, tv, window=W), got)
    kr, vr = (jnp.repeat(a, H // K, axis=2) for a in (jk, jv))
    for b in range(B):
        want = np.asarray(jref.swa_attention_ref(jq[b], kr[b], vr[b], W),
                          np.float32)
        assert np.abs(got[b].float().numpy() - want).max() < tol


@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_by_dtype_and_head_dim(dtype, dh):
    """float32 takes its tensor-core kernel (error-compensated TF32) at
    every dh; bfloat16 at dh 64, 128 and 256 takes the wgmma kernel, and
    the narrow bfloat16 heads the CUDA-core kernel."""
    want = ("tensor_core_f32" if dtype == torch.float32
            else "tensor_core" if dh >= 64 else "cuda_core")
    assert ops.swa_route(dtype, dh) == want


def test_wrapper_input_checks():
    q, k, v = (torch.as_tensor(a) for a in _qkv(16, 4, 16, K=2, B=1))
    for bad in (0, -3):
        with pytest.raises(ValueError, match="window"):
            ops.swa_attention(q, k, v, window=bad)
    with pytest.raises(ValueError):                     # no batch axis
        ops.swa_attention(q[0], k[0], v[0], window=4)
    with pytest.raises(ValueError):                     # H % K != 0
        ops.swa_attention(q[:, :, :3], k, v, window=4)
    with pytest.raises(ValueError):                     # k and v differ
        ops.swa_attention(q, k, v[:, :8], window=4)
    with pytest.raises(ValueError):                     # T differs
        ops.swa_attention(q, k[:, :8], v[:, :8], window=4)
    with pytest.raises(ValueError, match="CUDA"):       # mixed devices
        ops.swa_attention(q, k.to("meta"), v, window=4)
    before = dict(ops.LAUNCHES)
    ops.swa_attention(q, k, v, window=4)                # CPU: plain version
    assert ops.LAUNCHES == before
