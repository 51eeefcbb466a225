"""The reference's expert-parallel MoE gradient under its own mesh, for
``tests/test_torch_mesh_train.py``: the JAX package's ``moe_apply``
(``torch_mesh_ranks.MOE``'s widths: 8 experts, top 2, capacity 1, a
shared expert) on a 1 x 2 ``make_local_mesh_ctx`` over two forced host
devices, ``jax.grad`` of sum(out * w) + aux_w x aux, against the same on
one device with the mesh's aux (model_size x the one-device aux).  For
the input and each weight: the largest one-device value, each device's
copy's largest gap to it (of a sharded array: the blocks assembled),
and whether the copies are equal.
Run with ``XLA_FLAGS=--xla_force_host_platform_device_count=2``:
``python torch_mesh_train_ref.py OUT``.
"""
from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch.mesh import make_local_mesh_ctx
from repro.models import layers as L
from repro.models.config import ModelConfig
from repro.sharding import mesh_context

MOE = ModelConfig(name="moe", arch_type="moe", n_layers=1, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97,
                  n_experts=8, experts_per_token=2, d_ff_expert=32,
                  n_shared_experts=1, capacity_factor=1.0,
                  param_dtype="float32", dtype="float32", remat=False)
AUX_WS = (0.5, 0.0)


def probe(aux_w: float) -> dict:
    params = L.moe_init(jax.random.PRNGKey(3), MOE)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((4, 6, MOE.d_model)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((4, 6, MOE.d_model)), jnp.float32)

    def objective(p, xs, aux_scale):
        out, aux = L.moe_apply(p, MOE, xs)
        return (out * w).sum() + aux_w * aux_scale * aux

    grad = jax.grad(objective, argnums=(0, 1))
    one_p, one_x = grad(params, x, 2.0)
    ctx = make_local_mesh_ctx(1, 2)
    with mesh_context(ctx):
        mesh_p, mesh_x = jax.jit(lambda p, xs: grad(p, xs, 1.0))(params, x)
    out = {}
    for name, got, want in [("x", mesh_x, one_x)] + [
            (k, mesh_p[k], one_p[k])
            for k in ("router", "w_gate", "w_up", "w_down")]:
        want = np.asarray(want)
        # a replicated array: each device's own copy; a sharded one: the
        # blocks assembled
        copies = [np.asarray(s.data) for s in got.addressable_shards]
        if copies[0].shape != want.shape:
            copies = [np.asarray(got)]
        out[name] = {
            "one_max": float(np.abs(want).max()),
            "device_gaps": [float(np.abs(c - want).max()) for c in copies],
            "devices_equal": all(np.array_equal(c, copies[0])
                                 for c in copies),
            "spec": str(got.sharding.spec)}
    return out


def main(path: str) -> None:
    assert len(jax.devices()) == 2, jax.devices()
    with open(path, "w") as f:
        json.dump({str(a): probe(a) for a in AUX_WS}, f)


if __name__ == "__main__":
    main(sys.argv[1])
