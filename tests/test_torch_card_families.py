"""whisper-base, rwkv6-1.6b, deepseek-v3 (naive and absorbed MLA),
llama4-maverick, llava-next-34b and jamba-v0.1-52b (at the CLIs' hybrid
smoke cut: a Mamba and an attention + MoE layer) on a CUDA card, at their
smoke configs in float32: the logits of a full forward and of a prefill
plus decode steps on the card against the same weights on the CPU (rel
1e-4, the gemma check's bound in tests/test_torch_card.py; llava with its
patch embeddings, the MoE families at the default capacity, where pairs
are dropped, the same ones on both devices), the recurrent states too
(rwkv6's ``S``, Mamba's ``h`` and ``conv``); an MoE layer whose router
sends every token past one expert's capacity, its routing equal and its
output within rel 1e-4; decode against
the full forward on the card (2e-3, tests/test_models.py's bound; the MoE
families at capacity_factor E/K, where no call drops a pair);
``init_params`` on the card against the CPU (each element within 4 units
in the last place of the CPU's value: float32 ``erfinv``; constant leaves
exactly).

Skipped without a card.  This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_card_families.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import cli_config
from repro_torch.kernels import ops
from repro_torch.models import forward, init_cache, init_params
from repro_torch.models import layers as TL

ARCHS = ["whisper-base", "rwkv6-1.6b", "deepseek-v3-671b",
         "deepseek-v3-671b+absorb", "llama4-maverick-400b-a17b",
         "llava-next-34b", "jamba-v0.1-52b"]
MOE_ARCHS = ["deepseek-v3-671b", "llama4-maverick-400b-a17b",
             "jamba-v0.1-52b"]
#: float32 erfinv on the card and on the CPU part by at most this many
#: units in the last place (tests/test_torch_card.py's bound)
INIT_ERFINV_ULPS = 4


@pytest.fixture
def cuda():
    """The CUDA device, or a skip (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _smoke(arch, *, no_drops=False):
    """The smoke config of ``arch`` as the CLIs run it (a hybrid's cut
    keeps an attention layer; ``+absorb``: with ``mla_absorb``);
    ``no_drops``: an MoE config at capacity_factor E/K."""
    name, _, variant = arch.partition("+")
    cfg = cli_config(name, smoke=True)
    if variant:
        cfg = dataclasses.replace(cfg, mla_absorb=True)
    if no_drops and cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    return cfg


def _inputs(cfg, T=24, seed=2):
    """Tokens (2, T), and the encoder frames (whisper) or the patch
    embeddings (llava) of two requests, else None."""
    gen = np.random.default_rng(seed)
    toks = torch.as_tensor(gen.integers(0, cfg.vocab_size, (2, T)))
    shape = ((2, cfg.encoder_seq, cfg.frontend_dim) if cfg.encoder_layers
             else (2, cfg.frontend_seq, cfg.frontend_dim)
             if cfg.frontend_seq else None)
    extra = (None if shape is None else
             torch.as_tensor(gen.standard_normal(shape, dtype=np.float32)))
    return toks, extra


def _kw(cfg, extra, dev):
    """``forward``'s keyword for ``extra`` on ``dev``."""
    if extra is None:
        return {}
    key = "enc_frames" if cfg.encoder_layers else "embeds"
    return {key: extra.to(dev)}


def _rel(a, b):
    return ((a.cpu() - b).abs().max() / b.abs().max()).item()


@torch.inference_mode()
@pytest.mark.parametrize("arch", ARCHS)
def test_family_on_card_matches_cpu(cuda, arch):
    cfg = _smoke(arch)
    cpu_model = init_params(cfg, seed=3, device="cpu")
    gpu_model = init_params(cfg, seed=3, device="cpu").to(cuda)
    toks, ex = _inputs(cfg)
    before = dict(ops.LAUNCHES)
    a, aux_a, _ = forward(gpu_model, cfg, toks.to(cuda), **_kw(cfg, ex, cuda))
    b, aux_b, _ = forward(cpu_model, cfg, toks, **_kw(cfg, ex, "cpu"))
    assert _rel(a, b) < 1e-4
    assert abs(aux_a.item() - aux_b.item()) <= 1e-4 * abs(aux_b.item())
    ca = init_cache(cfg, 2, 48, device=cuda)
    cb = init_cache(cfg, 2, 48, device="cpu")
    for t0, t1 in ((0, 16),) + tuple((t, t + 1) for t in range(16, 24)):
        first = t0 == 0
        a, _, ca = forward(gpu_model, cfg, toks[:, t0:t1].to(cuda), cache=ca,
                           **(_kw(cfg, ex, cuda) if first else {}))
        b, _, cb = forward(cpu_model, cfg, toks[:, t0:t1], cache=cb,
                           **(_kw(cfg, ex, "cpu") if first else {}))
        assert _rel(a, b) < 1e-4, (t0, _rel(a, b))
    for la, lb in zip(ca["layers"], cb["layers"]):
        for key, state in la.get("ssm", {}).items():
            assert state.dtype == lb["ssm"][key].dtype, key
            assert _rel(state, lb["ssm"][key]) < 1e-4, key
    assert dict(ops.LAUNCHES) == before           # no kernel on this path


@torch.inference_mode()
@pytest.mark.parametrize("arch", ARCHS)
def test_family_decode_matches_full_forward_on_card(cuda, arch):
    cfg = _smoke(arch, no_drops=True)
    model = init_params(cfg, seed=4, device=cuda)
    toks, ex = _inputs(cfg, T=12, seed=4)
    toks = toks.to(cuda)
    P = cfg.frontend_seq if ex is not None and not cfg.encoder_layers else 0
    full, _, _ = forward(model, cfg, toks, **_kw(cfg, ex, cuda))
    cache = init_cache(cfg, 2, 48, device=cuda)
    _, _, cache = forward(model, cfg, toks[:, :5], cache=cache,
                          **_kw(cfg, ex, cuda))
    for t in range(5, 12):
        lg, _, cache = forward(model, cfg, toks[:, t:t + 1], cache=cache)
        err = (lg[:, 0] - full[:, P + t]).abs().max().item()
        assert err < 2e-3, (t, err)


@torch.inference_mode()
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forced_overflow_on_card_matches_cpu(cuda, arch):
    """A router that puts expert 0 about 8 and expert 1 about 4 above the
    rest for every one of 24 tokens: the first choices (and, top-2, the
    second ones) overflow their capacity; the routing on the card equals
    the CPU's and the output is within rel 1e-4."""
    cfg = _smoke(arch)
    moe = init_params(cfg, seed=5, device="cpu").blocks[1].ffn
    gen = np.random.default_rng(5)
    x = gen.standard_normal((24, cfg.d_model)).astype(np.float32)
    x[:, 0] = 8.0 + gen.random(24).astype(np.float32)
    x[:, 1] = 4.0
    moe.router[:2] = 0.0
    moe.router[0, 0] = moe.router[1, 1] = 1.0
    x = torch.as_tensor(x)
    args = (moe.router, moe.w_gate, moe.w_up, moe.w_down)
    rb = TL.moe_route(x, moe.router, cfg)
    ra = TL.moe_route(x.to(cuda), moe.router.to(cuda), cfg)
    assert int((~rb.ok).sum()) == cfg.experts_per_token * (24 - rb.capacity)
    for key in ("top_i", "order", "slot", "ok", "counts"):
        assert torch.equal(getattr(ra, key).cpu(), getattr(rb, key)), key
    b, aux_b = TL.moe_local(x, *args, cfg=cfg)
    a, aux_a = TL.moe_local(x.to(cuda), *(t.to(cuda) for t in args), cfg=cfg)
    assert _rel(a, b) < 1e-4
    assert abs(aux_a.item() - aux_b.item()) <= 1e-4 * aux_b.item()


@pytest.mark.parametrize("arch", ARCHS)
def test_family_init_on_card_equals_cpu(cuda, arch):
    """Every leaf, the float32 ones of a bf16 model (RWKV-6's ``w0``,
    ``u``, ``ln_out``, Mamba's ``A_log`` and ``D``, the MoE router) among
    them."""
    cfg = _smoke(arch)
    a = init_params(cfg, seed=7, device=cuda)
    b = init_params(cfg, seed=7, device="cpu")
    inf = torch.tensor(float("inf"))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        p = p.detach().cpu()
        assert p.dtype == q.dtype and p.shape == q.shape, name
        ulp = torch.nextafter(q.abs(), inf) - q.abs()
        assert ((p - q).abs() <= INIT_ERFINV_ULPS * ulp).all(), name
        if bool((q == q.flatten()[0]).all()):
            assert torch.equal(p, q), name
