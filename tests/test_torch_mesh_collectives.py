"""The port's expert-parallel MoE and ring decode on real process groups:
gloo over 2 CPU ranks (a 1 x 2 mesh) and over 4 (2 x 2), four processes
spawned by one subprocess (``torch_mesh_ranks.main``, each rank on one
thread; a process group is global state, kept out of the test worker),
against the port's one-device paths in float32:

* ``moe_apply`` with its experts sharded over the model axis
  (``local_map``, the outputs summed over the model axis): the output
  within 1e-6 of the largest one-device output (the sums over K and over
  the ranks round in another order), each rank holding E / model_size
  experts; the aux loss equal to model_size x the mean of the data
  shards' one-device aux within rel 1e-6, the reference's sum over every
  axis divided by the data size (ROADMAP.md section 3);
* three ``seq_sharded_decode_attention`` steps against the one-device
  grouped decode within 2e-6 (one max and two sum all-reduces assemble
  the softmax); the caches, gathered, bit-equal to the one-device caches;
  a rank that does not own the written position leaves its block
  untouched; a heads-sharded cache comes back sharded by sequence;
* three straggler AdamW train steps at phi4-mini-3.8b's smoke config on
  the 1 x 2 and the 2 x 2 mesh (weights and moments placed by
  ``shardings.distribute_train_state``, ZeRO-1 too) against the same steps
  on one device: each step's loss and grad norm within rel 1e-5 x the
  step number (the data ranks' sums round in another order), and the
  weights after step 3 within 3e-5 of their largest value.  AdamW divides
  each gradient by its own magnitude, so an element whose gradient is
  rounding noise on both sides moves by up to lr a step either way
  (tests/test_torch_train.py): at eps 1e-8 at most ``ADAM_NOISE_SHARE``
  of the elements may pass 3e-5 (5-6 of 1 443 072 do), all within
  ``ADAM_ABS``; at eps 1e-5, above that noise, every element holds (8.1e-7
  measured);
* ``reduce_partial``'s half-precision gloo branch (``_ReduceHalf``) taken
  by float32 CPU tensors: the same train steps as above, and the
  function alone, its input's gradient equal to the all-reduce of a
  pending-sum output gradient and to a replicated one as it stands;
* the c10d all-gather that a CUDA mesh over gloo takes
  (``launch.mesh._c10d_all_gather``), forced for CPU tensors, equal to
  the functional all-gather on every gather dim;
* a sampled decode's draw (``gumbel_scores``) on logits sharded by
  vocabulary, gathered first as the serve step does, equal to the draw
  on the whole logits.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

OUT_REL = 1e-6
AUX_REL = 1e-6
RING_ATOL = 2e-6
#: per step: the losses' and grad norms' rel bound, the weights' bound
#: over their largest value
TRAIN_REL = 1e-5
ADAM_NOISE_SHARE = 1e-5
ADAM_ABS = 5e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    here = pathlib.Path(__file__).resolve().parent
    out = tmp_path_factory.mktemp("ranks") / "ranks.json"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), str(here),
         os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, str(here / "torch_mesh_ranks.py"),
                    str(out)], env=env, cwd=here, check=True, timeout=600,
                   capture_output=True)
    return {int(k): v for k, v in json.loads(out.read_text()).items()}


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_moe_matches_one_device(ranks, world):
    model = {2: 2, 4: 2}[world]
    for res in ranks[world]:
        moe = res["moe"]
        assert moe["out_err"] <= OUT_REL
        assert abs(moe["aux"] - moe["aux_want"]) <= AUX_REL * abs(
            moe["aux_want"])
        assert moe["weights_local"][0] == 8 // model


@pytest.mark.parametrize("world", [2, 4])
def test_ring_decode_matches_the_grouped_decode(ranks, world):
    for res in ranks[world]:
        ring = res["ring"]
        assert ring["out_err"] <= RING_ATOL
        assert ring["cache_equal"] and ring["pos"] == 8
        assert ring["seq_sharded_after"][-1] == "S(2)"


@pytest.mark.parametrize("world", [2, 4])
def test_ring_decode_writes_only_where_a_rank_owns_the_position(ranks,
                                                                world):
    """Positions 5-7 lie in the first half of the 16-slot cache: the
    model-axis rank 0 writes, rank 1 leaves its block as it was."""
    owners = [r["ring"]["owned_steps"] for r in ranks[world]]
    untouched = [u for r in ranks[world] for u in r["ring"]["untouched"]]
    assert untouched and all(untouched)
    assert sum(o > 0 for o in owners) == world // 2


TRAIN = {"adamw": 2, "adamw_eps": 2, "half_branch": 2, "adamw_2x2": 4,
         "zero1_2x2": 4}


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_mesh_train_step_matches_one_device(ranks, case):
    for res in ranks[TRAIN[case]]:
        t = res["train"][case]
        for i, (got, want) in enumerate(zip(t["loss"], t["loss_want"])):
            assert abs(got - want) <= TRAIN_REL * (i + 1) * abs(want)
        for i, (got, want) in enumerate(zip(t["grad_norm"],
                                            t["grad_norm_want"])):
            assert abs(got - want) <= TRAIN_REL * (i + 1) * abs(want)
        bound = TRAIN_REL * len(t["loss"]) * t["param_max"]
        over = [d for d in t["param_diffs"] if d > bound]
        if case == "adamw_eps":
            assert not over, over
        else:
            assert len(over) <= ADAM_NOISE_SHARE * t["n_params"], over
            assert t["param_diffs"][0] <= ADAM_ABS
        assert (t["moments_data_sharded"] > 0) == case.startswith("zero1")


@pytest.mark.parametrize("grad", ["pending", "replicated"])
def test_reduce_half_gradient_is_the_all_reduced_gradient(ranks, grad):
    for res in ranks[2]:
        r = res["reduce_half"][grad]
        assert r["forward_equal"] and r["placements"] == ["R", "R"]
        assert r["grad_err"] <= 1e-6


def test_c10d_all_gather_route_equals_the_functional_one(ranks):
    for res in ranks[2]:
        assert res["c10d_gather"] == {"0": True, "1": True, "2": True}


def test_sampled_draw_under_the_mesh_equals_one_device(ranks):
    for res in ranks[2]:
        r = res["sample"]
        assert r["sharded"] == ["R", "S(1)"] and r["placements"] == ["R", "R"]
        assert r["equal"] and r["tokens_equal"]
