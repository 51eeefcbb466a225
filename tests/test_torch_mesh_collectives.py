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
  untouched; a heads-sharded cache comes back sharded by sequence.
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
