"""The port's optimizers against the JAX package's (``repro.optim``): the
constant and cosine schedules, ``global_norm`` and ``clip_by_global_norm``,
and every optimizer (SGD, momentum with and without Nesterov, Adam,
AdamW) over 10 steps on the same trees, rel 1e-6 in float32 (both
compute the same float32 ops in the same order; the schedules' ``cos`` and
the bias corrections' ``pow`` may differ in the last bit).  ``apply`` on
bfloat16 weights rounds to the JAX package's bits, and the in-place
``step_`` gives the bits of ``update`` then ``apply``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt
from torch_parity import np_of, rel_err
from torch_parity import one_thread  # noqa: F401

SHAPES = {"embed": (7, 5), "blocks.0.w": (5, 3), "norm": (5,), "b": (1,)}


def _tree(seed, scale=1.0):
    gen = np.random.default_rng(seed)
    return {k: (scale * gen.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree, dtype=torch.float32):
    return {k: torch.as_tensor(v).to(dtype) for k, v in tree.items()}


SCHEDULES = {
    "constant": (lambda m: m.constant_schedule(0.05)),
    "cosine": (lambda m: m.cosine_schedule(0.1, 10, warmup=3, floor=0.01)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match(name):
    js, ts = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    for step in range(14):
        want = np.asarray(js(jnp.asarray(step, jnp.int32)))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert rel_err(got, want) <= 1e-6, (step, float(got), want)


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_global_norm_and_clip_match(scale):
    tree = _tree(1, scale)
    want_g = np.asarray(jopt.global_norm(_j(tree)))
    assert rel_err(topt.global_norm(_t(tree)), want_g) <= 1e-6
    want, want_n = jopt.clip_by_global_norm(_j(tree), 1.0)
    got, got_n = topt.clip_by_global_norm(_t(tree), 1.0)
    assert rel_err(got_n, want_n) <= 1e-6
    for k in SHAPES:
        assert got[k].dtype == torch.float32
        assert rel_err(got[k], want[k]) <= 1e-6, k
    # bfloat16 leaves: the clipped tree is float32, as the strong float32
    # scale makes it in the JAX package
    g16 = {k: v.to(torch.bfloat16) for k, v in _t(tree).items()}
    got16, _ = topt.clip_by_global_norm(g16, 1.0)
    assert all(v.dtype == torch.float32 for v in got16.values())


OPTIMIZERS = {
    "sgd": lambda m, lr: m.sgd(lr),
    "momentum": lambda m, lr: m.momentum(lr, beta=0.8),
    "nesterov": lambda m, lr: m.momentum(lr, beta=0.8, nesterov=True),
    "adam": lambda m, lr: m.adam(lr),
    "adamw": lambda m, lr: m.adamw(lr, weight_decay=0.05),
}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_over_ten_steps(name, sched):
    jo = OPTIMIZERS[name](jopt, SCHEDULES[sched](jopt))
    to = OPTIMIZERS[name](topt, SCHEDULES[sched](topt))
    jp, tp = _j(_tree(0)), _t(_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for step in range(10):
        grads = _tree(100 + step)
        ju, js = jo.update(_j(grads), js, jp)
        jp = jo.apply(jp, ju)
        tu, ts = to.update(_t(grads), ts, tp)
        tp = to.apply(tp, tu)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for k in SHAPES:
            assert rel_err(tu[k], ju[k]) <= 1e-6, (step, k)
            assert rel_err(tp[k], jp[k]) <= 1e-6, (step, k)
    for mom in set(ts) - {"step"}:
        jm = js[mom]
        for k in SHAPES:
            assert rel_err(ts[mom][k], jm[k]) <= 1e-6, (mom, k)


def test_apply_rounds_bf16_weights_to_the_same_bits():
    p = _tree(3)
    u = _tree(4, 1e-2)
    want = jopt.Optimizer(None, None).apply(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}, _j(u))
    got = topt.Optimizer((), None, None).apply(_t(p, torch.bfloat16), _t(u))
    for k in SHAPES:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[k].view(torch.int16).numpy(),
            np.asarray(want[k]).view(np.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["momentum", "adamw"])
def test_in_place_step_equals_update_then_apply(name, dtype):
    """``step_`` (one tensor at a time, in place, gradients scaled by the
    clip) gives the bits of ``clip_by_global_norm``, ``update``, ``apply``."""
    opt = OPTIMIZERS[name](topt, topt.cosine_schedule(0.1, 10, warmup=2))
    ref_p = _t(_tree(5), dtype)
    inp_p = {k: v.clone() for k, v in ref_p.items()}
    ref_s, inp_s = opt.init(ref_p), opt.init(inp_p)
    for step in range(4):
        grads = _t(_tree(200 + step, 3.0), dtype)
        clipped, _ = topt.clip_by_global_norm(grads, 1.0)
        u, ref_s = opt.update(clipped, ref_s, ref_p)
        ref_p = opt.apply(ref_p, u)
        inp_s = opt.step_(inp_p, grads, inp_s,
                          topt.clip_scale(topt.global_norm(grads), 1.0))
        for k in SHAPES:
            assert torch.equal(inp_p[k], ref_p[k]), (step, k)
            assert inp_p[k].dtype == dtype
        for mom in set(ref_s) - {"step"}:
            for k in SHAPES:
                assert torch.equal(inp_s[mom][k], ref_s[mom][k])
    assert int(inp_s["step"]) == int(ref_s["step"]) == 4


def test_state_is_keyed_by_parameter_name():
    st = topt.adamw(1e-3).init(_t(_tree(0)))
    assert set(st) == {"step", "m", "v"}
    assert set(st["m"]) == set(st["v"]) == set(SHAPES)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert all(v.dtype == torch.float32 for v in st["m"].values())
    assert np_of(st["v"]["embed"]).shape == SHAPES["embed"]
