"""The port's serving path against the JAX package: ``make_serve_step``'s
greedy tokens equal JAX's wherever the top-two logit gap exceeds the
tolerance (until the first near-tie, after which the sequences may part
legitimately); the ``repro_torch.launch.serve`` CLI on the CPU and its
default to the card; the redundant-dispatch serving example on the CPU."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.train import make_serve_step as j_make_serve_step
from repro_torch import convert
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import forward, init_cache, init_params
from repro_torch.train import make_serve_step

from torch_parity import REPO
from torch_parity import one_thread  # noqa: F401

GAP = 2e-4     # the logits' parity tolerance (tests/test_torch_models.py)


@pytest.mark.parametrize("arch,n_layers", [("gemma3-4b", 7),
                                           ("qwen2-72b", 2),
                                           ("phi4-mini-3.8b", 2)])
def test_greedy_decode_matches_jax(arch, n_layers):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(),
                               n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).smoke(),
                               n_layers=n_layers)
    params = jax.jit(j_init_params, static_argnums=1)(jax.random.PRNGKey(1),
                                                      jcfg)
    model = init_params(tcfg, device="cpu")
    model.load_state_dict(convert.lm_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    B, P, steps = 2, 36, 8
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, (B, P))
    jc = j_init_cache(jcfg, B, P + steps + 8)
    tc = init_cache(tcfg, B, P + steps + 8, device="cpu")
    jl, _, jc = jax.jit(j_forward, static_argnums=1)(
        params, jcfg, jnp.asarray(prompt), cache=jc)
    tl, _, tc = forward(model, tcfg, torch.as_tensor(prompt), cache=tc)
    jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tt = tl[:, -1:].argmax(dim=-1).to(torch.int32)
    jstep = jax.jit(j_make_serve_step(jcfg))
    tstep = make_serve_step(tcfg)
    compared = 0
    last = tl[:, -1]
    for _ in range(steps):
        top2 = torch.topk(last, 2, dim=-1).values
        if bool(((top2[:, 0] - top2[:, 1]) <= GAP).any()):
            break                               # a near-tie may part them
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        compared += 1
        jt, jc = jstep(params, jc, jt)
        tt, tc, last = tstep(model, tc, tt)
        assert tt.dtype == torch.int32 and tt.shape == (B, 1)
    assert compared >= 4
    assert tc["pos"] == P + compared


def test_serve_cli_on_cpu(capsys):
    res = serve.main(["--arch", "gemma3-4b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40", "--gen", "5"])
    assert res.tokens.shape == (2, 5) and res.finite
    assert res.tokens.dtype == torch.int32
    assert res.prefill_s > 0 and res.decode_s > 0
    assert res.launches_after_prefill == {k: 0 for k in
                                          res.launches_after_prefill}
    out = capsys.readouterr().out
    assert out.startswith("gemma3-4b-smoke: prefill 40 tok")
    assert "4 decode steps" in out
    again = serve.run(tconfigs.get_config("gemma3-4b").smoke(), batch=2,
                      prompt_len=40, gen=5, device="cpu")
    assert torch.equal(again.tokens, res.tokens)     # seeded


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma3-4b", "--smoke", "--gen", "2"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "no-such-arch", "--smoke", "--device",
                    "cpu"])


def test_serve_redundant_example_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, str(REPO / "examples_torch" / "serve_redundant.py"),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == ["r=1", "r=2", "r=3"]
    assert "redundancy r=2 cuts p99" in out.stdout
    assert lines[-1].startswith("decoded final tokens for 16 requests")
