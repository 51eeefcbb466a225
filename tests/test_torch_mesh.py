"""The mesh half of the port's sharding against the JAX package's rules,
every architecture's smoke config under stub contexts (the 16x16 pod,
the 2x16x16 multi-pod and a (4, 2) local mesh), no process group and no
device: ``param_spec`` / ``params_shardings`` for every parameter (the
port's dotted names mapped to the reference's pytree paths through
``convert._unstack``'s correspondence), ``cache_shardings`` for every
cache leaf at batch 16 and at batch 1, ``batch_shardings`` (plain and
slot-major), ``zero1_shardings``, and the fallback tuples, all equal to
the reference's; the reference's functions run on a stub ``ctx`` with
``NamedSharding`` stubbed to return its spec, as tests/test_launch.py:
48-82 runs ``param_spec``.  Also the port's ``MeshCtx`` helpers
(``resolve``, ``spec``, ``axis_size``, ``placements``), ``shard``'s
fallback record and its no-op without a context.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import shardings as jsh
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro_torch.launch import shardings as tsh
from repro_torch.models import model as tmodel
from repro_torch.sharding import (BOTH, DATA, MODEL, MeshCtx, axis_size,
                                  mesh_context, placements, shard)
from torch_lm_parity import tcfg
from torch_parity import one_thread  # noqa: F401

MESHES = {"16x16": ((16, 16), ("data", "model"), ("data",)),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"),
                      ("pod", "data")),
          "4x2": ((4, 2), ("data", "model"), ("data",))}


def _ctxs(mesh):
    """(the port's MeshCtx over a stub mesh, the reference's stub ctx)."""
    shape, names, data_axes = MESHES[mesh]
    stub = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    port = MeshCtx(mesh=stub, data_axes=data_axes, model_axis="model")
    ref = types.SimpleNamespace(mesh=None, data_axes=data_axes,
                                model_axis="model",
                                model_size=port.model_size,
                                data_size=port.data_size)
    return port, ref


@pytest.fixture
def no_named(monkeypatch):
    """The reference's ``NamedSharding`` keeping its spec as a tuple."""
    monkeypatch.setattr(jsh, "NamedSharding", _Named)


def _Named(mesh, spec):
    return types.SimpleNamespace(spec=tuple(spec))


def _ref_tree(jcfg, fn):
    shapes = jax.eval_shape(fn)
    return jax.tree_util.tree_flatten_with_path(shapes)[0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_and_fallbacks_are_the_references(arch, mesh,
                                                      no_named):
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = tcfg(jcfg)
    port, ref = _ctxs(mesh)
    want, want_fb = {}, []
    for path, leaf in _ref_tree(jcfg, lambda: j_init_params(
            jax.random.PRNGKey(0), jcfg)):
        ps = jsh._path_str(path)
        shape = tuple(leaf.shape)
        stacked = ps.startswith("segments") or "blocks" in ps
        want[ps] = tuple(jsh.param_spec(ps, shape[1:] if stacked else shape,
                                        ref, want_fb))
    model = tmodel.init_params(cfg, device="meta")
    fb = []
    got = tsh.params_shardings(model, port, fb)
    assert got.keys() == dict(model.named_parameters()).keys()
    for name, spec in got.items():
        path = tsh.reference_path(name, cfg)
        assert spec == want[path], (name, path, spec, want[path])
    assert sorted(map(str, fb)) == sorted(map(str, want_fb))
    # zero1 over the same specs
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    z = tsh.zero1_shardings(shapes, got, port)
    for name, spec in z.items():
        path = tsh.reference_path(name, cfg)
        assert spec == _ref_zero1(shapes[name], want[path], ref), name


def _ref_zero1(shape, base, ref):
    """The reference's ``zero1_shardings`` on one leaf."""
    leaf = jax.ShapeDtypeStruct(shape, jax.numpy.float32)
    return jsh.zero1_shardings({"x": leaf}, {"x": _Named(None, base)},
                               ref)["x"].spec


@pytest.mark.parametrize("batch,seq", [(16, 64), (1, 512)])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_cache_specs_and_fallbacks_are_the_references(arch, mesh, batch,
                                                      seq, no_named):
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = tcfg(jcfg)
    port, ref = _ctxs(mesh)
    shapes = jax.eval_shape(lambda: j_init_cache(jcfg, batch, seq))
    want_fb = []
    want_tree = jsh.cache_shardings(shapes, ref, want_fb)
    want = {jsh._path_str(p): s.spec for p, s in
            jax.tree_util.tree_flatten_with_path(
                want_tree,
                is_leaf=lambda x: isinstance(x, types.SimpleNamespace))[0]}
    cache = tmodel.init_cache(cfg, batch, seq, device="meta")
    for layer in cache["layers"]:           # as after a prefill
        if "xk" in layer:
            layer["xk"] = layer["xv"] = torch.empty(
                (batch, cfg.n_heads, cfg.encoder_seq, cfg.head_dim),
                device="meta")
    fb = []
    got = tsh.cache_shardings(cache, cfg, port, fb)
    keys = tsh._layer_keys(cfg)
    seen = set()
    for li, lspecs in enumerate(got["layers"]):
        si, j, _reps = keys[li]
        for name, sp in lspecs.items():
            items = sp.items() if isinstance(sp, dict) else [(None, sp)]
            for leaf, spec in items:
                path = "/".join(["segments", str(si), str(j), name] +
                                ([] if leaf is None else [leaf]))
                assert (None,) + spec == want[path], (path, spec)
                seen.add(path)
    # every leaf of the reference's cache but the positions (host
    # integers in the port)
    assert seen == {p for p in want if p.rsplit("/", 1)[-1] != "pos"}
    assert sorted(map(str, fb)) == sorted(map(str, want_fb))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_are_the_references(mesh, no_named):
    port, ref = _ctxs(mesh)
    leaves = {"tokens": (32, 8), "odd": (3, 8), "embeds": (32, 4, 16)}
    slot = {"t": (2, 16, 2, 8), "odd": (2, 3, 2, 8)}
    for tree, major in ((leaves, False), (slot, True)):
        want = jsh.batch_shardings(
            {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in tree.items()},
            ref, slot_major=major)
        got = tsh.batch_shardings(
            {k: torch.empty(v, device="meta") for k, v in tree.items()},
            port, slot_major=major)
        assert got == {k: v.spec for k, v in want.items()}


def test_mesh_ctx_helpers_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    port, _ = _ctxs("2x16x16")
    assert port.data_size == 32 and port.model_size == 16
    assert port.resolve(DATA) == ("pod", "data")
    assert port.resolve(BOTH) == ("pod", "data", "model")
    assert port.spec(DATA, None, MODEL) == (("pod", "data"), None, "model")
    assert placements(port, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements(port, (None, None)) == [Replicate()] * 3
    dp = dataclasses.replace(port, data_axes=("pod", "data", "model"),
                             model_axis=None)
    assert dp.model_size == 1 and dp.resolve(MODEL) is None
    assert dp.resolve(BOTH) == ("pod", "data", "model")
    with mesh_context(port):
        assert axis_size(DATA) == 32 and axis_size(BOTH) == 512
        x = torch.empty((8, 5, 64))
        assert shard(x, DATA, None, MODEL, note="t") is x   # plain: local
        assert port.fallbacks == [("t", 0, 8, 32)]
    assert axis_size(MODEL) == 1
    y = torch.ones(4, 8)
    assert shard(y, DATA, MODEL) is y          # no context: a no-op
