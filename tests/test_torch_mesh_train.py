"""Training under the port's mesh, held to one device: gloo over 2 CPU ranks
(a 1 x 2 mesh) and over 4 (2 x 2), four processes spawned by one
subprocess (``torch_mesh_train_ranks.main``, each rank on one thread),
in float32:

* the expert-parallel ``moe_apply`` under autograd: the gradients of the
  router, the expert stacks, the shared expert and the input within
  ``GRAD_REL`` of the largest one-device value, tensor by tensor, against
  one device with the reference's mesh semantics (on 2 x 2 the routing,
  capacity and aux of each data shard; the aux model_size x the mean of
  the shards', ``torch_mesh_train_ranks.mesh_semantics``);
* two straggler AdamW steps (eps 1e-5) of every family's smoke config on
  the 1 x 2 mesh, and of the three MoE families on 2 x 2 with the AdamW
  moments ZeRO-1 sharded over the data axis, against the
  same steps on one device under those semantics: each step's loss and
  grad norm within rel ``TRAIN_REL`` x the step number, every weight
  after the last step within ``TRAIN_REL`` x the step count x the
  largest weight, and every gradient at step 1 within ``GRAD_REL`` of
  its largest one-device value, or, where rounding alone moves the
  one-device gradient further (the one-device run from weights
  perturbed at float32 rounding), within that movement, itself held
  under ``ROUNDING_CAP``;
* deepseek-v3's smoke config with ``remat`` on the 1 x 2 mesh, its
  backward outside the mesh context (where a CUDA backward runs): the
  gradients of the same without ``remat``;
* the MoE layer's train step on a 1 x 2 ``meta`` mesh over the fake
  process group (``torch_mesh_train_ranks.main_dry``): its all-reduces
  against the hand count;
* the reference's own expert-parallel gradient (``torch_mesh_train_ref``,
  two forced host devices): the expert stacks equal to its one-device
  gradient, the router's and the input's not, and unequal between the
  devices of a replicated array (ROADMAP.md section 3, reference
  caveats).  The port's tests hold the port to one device, not to it.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

GRAD_REL = 1e-5
TRAIN_REL = 1e-5
AUX_REL = 1e-6
#: the most that rounding of the weights may move a one-device gradient
#: before the check counts it as no bound at all (a 2x gradient is 1.0)
ROUNDING_CAP = 1e-3
FAMILIES = ("deepseek-v3-671b", "llama4-maverick-400b-a17b",
            "jamba-v0.1-52b", "rwkv6-1.6b", "gemma3-4b", "whisper-base",
            "llava-next-34b")
CASES = [f"{a}@2" for a in FAMILIES] + [f"{a}@4" for a in FAMILIES[:3]]

HERE = pathlib.Path(__file__).resolve().parent


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE),
         os.environ.get("PYTHONPATH", "")]), **extra)


def _run(tmp_path_factory, args, **env):
    out = tmp_path_factory.mktemp("mesh_train") / "out.json"
    subprocess.run([sys.executable] + args + [str(out)], env=_env(**env),
                   cwd=HERE, check=True, timeout=600, capture_output=True)
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _run(tmp_path_factory, [str(HERE / "torch_mesh_train_ranks.py")])


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    return _run(tmp_path_factory,
                [str(HERE / "torch_mesh_train_ranks.py"), "--dry"])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _run(tmp_path_factory, [str(HERE / "torch_mesh_train_ref.py")],
                JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=2")


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_moe_gradients_match_one_device(ranks, world):
    seen = [r["moe"][str(world)] for r in ranks if str(world) in r["moe"]]
    assert len(seen) == world
    for moe in seen:
        assert set(moe["grad_rel"]) == {
            "x", "router", "w_gate", "w_up", "w_down", "shared.w_gate.w",
            "shared.w_up.w", "shared.w_down.w"}
        assert max(moe["grad_rel"].values()) <= GRAD_REL, moe["grad_rel"]
        assert abs(moe["aux"] - moe["aux_want"]) <= AUX_REL * abs(
            moe["aux_want"])


def test_remat_recomputes_under_the_forwards_mesh(ranks):
    """A CUDA backward runs on autograd's own thread, outside the
    thread-local mesh context: the recomputed blocks must still take
    their mesh paths (the expert-parallel MoE's ``local_map`` among
    them), and give the gradients the stored activations give."""
    for r in ranks[:2]:
        assert "error" not in r["remat"], r["remat"]
        assert max(r["remat"]["grad_rel"].values()) <= GRAD_REL, r["remat"]


@pytest.mark.parametrize("case", CASES)
def test_family_mesh_train_step_matches_one_device(ranks, case):
    t = ranks[0]["train"][case]
    world = int(case.split("@")[1])
    for r in ranks[1:world]:               # every rank saw the same steps
        assert r["train"][case]["loss"] == t["loss"]
        assert r["train"][case]["grad_norm"] == t["grad_norm"]
    for key in ("loss", "grad_norm"):
        for i, (got, want) in enumerate(zip(t[key], t[key + "_want"])):
            assert abs(got - want) <= TRAIN_REL * (i + 1) * abs(want), (
                key, i, got, want)
    assert t["param_diff_max"] <= TRAIN_REL * len(t["loss"]) * \
        t["param_max"]
    assert (t["moments_data_sharded"] > 0) == (world == 4)   # ZeRO-1
    for name, gap in t["grad_rel"].items():
        rounding = t["grad_rounding"][name]
        assert rounding <= ROUNDING_CAP, (name, rounding)
        assert gap <= max(GRAD_REL, rounding), (name, gap, rounding)


def test_moe_layer_train_step_collectives_are_the_hand_count(dry):
    """Forward: the outputs' sum over the model axis, (tokens, d), and the
    aux's, a scalar; backward: none (each sum's gradient is the output
    gradient as it is); reading the gradients: the tokens' pending sum
    over the model axis, (tokens, d), and the router's, (d, E); the
    expert stacks' gradients are each rank's own experts'.  float32."""
    tokens, d, E, f32 = dry["tokens"], dry["d"], dry["experts"], 4
    want = {"forward": (tokens * d * f32 + f32, 2), "backward": (0, 0),
            "read": (tokens * d * f32 + d * E * f32, 2)}
    for phase, (nbytes, count) in want.items():
        got = dry[phase]
        assert got["bytes"]["all-reduce"] == nbytes, (phase, got)
        assert got["counts"]["all-reduce"] == count, (phase, got)
        assert sum(got["bytes"].values()) == nbytes, (phase, got)


@pytest.mark.parametrize("aux_w", ["0.5", "0.0"])
def test_reference_router_gradient_under_its_mesh(reference, aux_w):
    """The reference's ``shard_map`` gives the expert stacks the
    one-device gradient exactly, but the router's and the input's are
    replicated arrays whose two device copies differ from each other and
    from one device's by a third or more of its largest value, with or
    without the aux term: a caveat of the reference, recorded, not a
    target."""
    r = reference[aux_w]
    for k in ("w_gate", "w_up", "w_down"):
        assert r[k]["device_gaps"] == [0.0], (k, r[k])
    for k in ("router", "x"):
        assert r[k]["spec"] == "PartitionSpec()"
        assert not r[k]["devices_equal"]
        assert min(r[k]["device_gaps"]) >= 0.3 * r[k]["one_max"], (k, r[k])
