"""whisper-base and rwkv6-1.6b on a CUDA card, at their smoke configs in
float32: the logits of a full forward and of a prefill plus decode steps
on the card against the same weights on the CPU (rel 1e-4, the gemma
check's bound in tests/test_torch_card.py), rwkv6's recurrent state ``S``
too; decode against the full forward on the card (2e-3,
tests/test_models.py's bound); ``init_params`` on the card against the CPU
(each element within 4 units in the last place of the CPU's value:
float32 ``erfinv``; constant leaves exactly).

Skipped without a card.  This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_card_families.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import forward, init_cache, init_params

ARCHS = ["whisper-base", "rwkv6-1.6b"]
#: float32 erfinv on the card and on the CPU part by at most this many
#: units in the last place (tests/test_torch_card.py's bound)
INIT_ERFINV_ULPS = 4


@pytest.fixture
def cuda():
    """The CUDA device, or a skip (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(cfg, T=24, seed=2):
    gen = np.random.default_rng(seed)
    toks = torch.as_tensor(gen.integers(0, cfg.vocab_size, (2, T)))
    frames = (torch.as_tensor(gen.standard_normal(
        (2, cfg.encoder_seq, cfg.frontend_dim), dtype=np.float32))
        if cfg.encoder_layers else None)
    return toks, frames


def _to(x, dev):
    return None if x is None else x.to(dev)


def _rel(a, b):
    return ((a.cpu() - b).abs().max() / b.abs().max()).item()


@torch.inference_mode()
@pytest.mark.parametrize("arch", ARCHS)
def test_family_on_card_matches_cpu(cuda, arch):
    cfg = get_config(arch).smoke()
    cpu_model = init_params(cfg, seed=3, device="cpu")
    gpu_model = init_params(cfg, seed=3, device="cpu").to(cuda)
    toks, fr = _inputs(cfg)
    before = dict(ops.LAUNCHES)
    a, _, _ = forward(gpu_model, cfg, toks.to(cuda), enc_frames=_to(fr, cuda))
    b, _, _ = forward(cpu_model, cfg, toks, enc_frames=fr)
    assert _rel(a, b) < 1e-4
    ca = init_cache(cfg, 2, 32, device=cuda)
    cb = init_cache(cfg, 2, 32, device="cpu")
    for t0, t1 in ((0, 16),) + tuple((t, t + 1) for t in range(16, 24)):
        first = t0 == 0
        a, _, ca = forward(gpu_model, cfg, toks[:, t0:t1].to(cuda), cache=ca,
                           enc_frames=_to(fr, cuda) if first else None)
        b, _, cb = forward(cpu_model, cfg, toks[:, t0:t1], cache=cb,
                           enc_frames=fr if first else None)
        assert _rel(a, b) < 1e-4, (t0, _rel(a, b))
    for la, lb in zip(ca["layers"], cb["layers"]):
        if "ssm" in la:
            assert la["ssm"]["S"].dtype == torch.float32
            assert _rel(la["ssm"]["S"], lb["ssm"]["S"]) < 1e-4
    assert dict(ops.LAUNCHES) == before           # no kernel on this path


@torch.inference_mode()
@pytest.mark.parametrize("arch", ARCHS)
def test_family_decode_matches_full_forward_on_card(cuda, arch):
    cfg = get_config(arch).smoke()
    model = init_params(cfg, seed=4, device=cuda)
    toks, fr = _inputs(cfg, T=12, seed=4)
    toks, fr = toks.to(cuda), _to(fr, cuda)
    full, _, _ = forward(model, cfg, toks, enc_frames=fr)
    cache = init_cache(cfg, 2, 32, device=cuda)
    _, _, cache = forward(model, cfg, toks[:, :5], cache=cache, enc_frames=fr)
    for t in range(5, 12):
        lg, _, cache = forward(model, cfg, toks[:, t:t + 1], cache=cache)
        err = (lg[:, 0] - full[:, t]).abs().max().item()
        assert err < 2e-3, (t, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_init_on_card_equals_cpu(cuda, arch):
    """Every leaf, the RWKV-6 float32 ones (``w0``, ``u``, ``ln_out``)
    among them."""
    cfg = get_config(arch).smoke()
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
