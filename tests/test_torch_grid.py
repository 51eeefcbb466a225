"""The grid engine (``repro_torch.core.grid``) and the evaluator cache, the
port against the JAX package.

* ``GridSpec.cells``: the same cell names, feasible corners, specs (TO
  matrices with RA included: integer outputs, level 1) and fusion keys as
  the reference for several axis sets; ``GridSpec`` JSON read both ways.
* ``stream_grid`` on the port equals a per-cell ``sweep`` / ``sweep_rounds``
  bit for bit (the reference's contract, tests/test_grid.py): dense,
  ragged, message budgets, ``comm_eps``, single-k and all-k, a rounds cell
  with a deadline; its ``fused_dispatches`` / ``buckets`` /
  ``rounds_cells`` equal the reference's on the same cells, and its means
  are within z <= 4 combined standard errors of the reference's (the two
  packages draw different random numbers: level 3).
* One evaluator build per shape bucket, renamed specs share the bucket,
  the LRU capacity bounds the cache; a cached rounds function gives the
  same bits on a second call.
* Grid artifacts written by either package are read by the other, and
  ``best_cell`` (ties included) answers the same on both sides; the grid
  CLI with ``--device cpu`` writes an artifact the reference reads.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import grid as jg
from repro.core import scheduling as js
from repro.core import delays as jd
from repro_torch.core import cluster as tcl
from repro_torch.core import delays as td
from repro_torch.core import grid as tg
from repro_torch.core import montecarlo as tm
from repro_torch.core import trace as tt
from repro_torch.launch import grid as grid_cli

from torch_parity import z_scores
from torch_parity import one_thread  # noqa: F401

MODEL = td.scenario1()
CPU = "cpu"
AXES = {
    "paper": dict(n=8, families=("cs", "ss", "ra", "lb", "pc", "pcmm"),
                  loads=(1, 2, 4, 8), messages=(None, 2, 4),
                  comm_eps=(0.0, 0.1)),
    "single_k": dict(n=6, families=("cs", "ra", "pc", "pcmm"),
                     loads=(1, 2, 6), messages=(None, 4),
                     comm_eps=(0.0, 0.02), ks=(None, 3)),
    "coded_only": dict(n=5, families=("pc", "pcmm"), loads=(1, 2, 3, 5),
                       messages=(None, 1, 2)),
}


def _spec_fields(sp):
    return (sp.name, sp.kind, sp.C, sp.r, sp.messages, sp.loads,
            sp.rebalance, sp.comm_eps)


@pytest.mark.parametrize("axes", sorted(AXES))
@pytest.mark.parametrize("seed", [0, 7])
def test_cells_equal_the_reference(axes, seed):
    kw = dict(AXES[axes], trials=300, seed=seed, chunk=100)
    got = tg.GridSpec(**kw).cells(MODEL)
    want = jg.GridSpec(**kw).cells(jd.scenario1())
    assert [c.name for c in got] == [c.name for c in want]
    for c, w in zip(got, want):
        assert [_spec_fields(sp) for sp in c.specs] == [
            _spec_fields(sp) for sp in w.specs]
        assert ((c.n, c.r_max, c.ks, c.trials, c.seed, c.chunk, c.is_rounds)
                == (w.n, w.r_max, w.ks, w.trials, w.seed, w.chunk,
                    w.is_rounds))


def test_ra_matrices_equal_the_reference_at_full_load():
    for seed in (0, 3, 11):
        got = tg._family_spec("ra", 9, 9, None, 0.0, seed)
        want = jg._family_spec("ra", 9, 9, None, 0.0, seed)
        assert got.C == want.C
    assert tg._family_spec("ra", 9, 4, None, 0.0, 0) is None


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_grid_spec_json_both_ways(direction):
    kw = dict(n=12, families=("ss", "lb"), loads=(2, 3), messages=(None, 2),
              comm_eps=(0.0, 0.01), ks=(None, 4), trials=777, seed=9,
              chunk=100)
    src, dst = ((tg, jg) if direction == "port_to_ref" else (jg, tg))
    doc = json.loads(json.dumps(src.GridSpec(**kw).to_json()))
    back = dst.GridSpec.from_json(doc)
    assert dataclasses.asdict(back) == dataclasses.asdict(dst.GridSpec(**kw))
    assert doc == tg.GridSpec(**kw).to_json() == jg.GridSpec(**kw).to_json()


def test_grid_spec_errors():
    with pytest.raises(ValueError, match="empty"):
        tg.GridSpec(n=8, families=("pcmm",), loads=(1,), trials=10).cells(
            MODEL)
    with pytest.raises(ValueError, match="unknown families"):
        tg.GridSpec(n=8, families=("nope",))
    with pytest.raises(ValueError, match="at least one value"):
        tg.GridSpec(n=8, loads=())
    with pytest.raises(ValueError, match="newer"):
        tg.GridSpec.from_json({"version": 999, "n": 4})
    with pytest.raises(ValueError, match="not a grid-spec"):
        tg.GridSpec.from_json({"kind": "grid-result", "n": 4})
    sp = tm.to_spec("x", js.cyclic_to_matrix(4, 2))
    with pytest.raises(ValueError, match="at least one spec"):
        tg.GridCell("empty", (), 4, MODEL)
    with pytest.raises(ValueError, match="rounds cells"):
        tg.GridCell("half", (sp,), 4, MODEL, rounds=3)


# --------------------- bit-exact against the per-cell path ---------------------

def _assert_stream_matches_per_cell(cells):
    res = tg.stream_grid(cells, devices=CPU)
    for c in cells:
        got = res.cell(c.name)
        if c.is_rounds:
            ref = tm.sweep_rounds(c.specs, c.model, c.n, rounds=c.rounds,
                                  k=c.k, trials=c.trials, seed=c.seed,
                                  chunk=c.chunk, deadline=c.deadline,
                                  deadline_policy=c.deadline_policy,
                                  devices=CPU)
            for sp in c.specs:
                for key in ("per_round", "stderr", "wallclock",
                            "wallclock_stderr"):
                    np.testing.assert_array_equal(
                        got[key][sp.name], getattr(ref, key)[sp.name])
                if c.deadline is not None:
                    for key in ("realized_k", "missed", "stale", "khist"):
                        np.testing.assert_array_equal(
                            got["degradation"][sp.name][key],
                            ref.degradation[sp.name][key])
        else:
            ref = tm.sweep(c.specs, c.model, c.n, trials=c.trials,
                           seed=c.seed, chunk=c.chunk, ks=c.ks, devices=CPU)
            for sp in c.specs:
                np.testing.assert_array_equal(
                    got["means"][sp.name], np.atleast_1d(ref.means[sp.name]))
                np.testing.assert_array_equal(
                    got["stderr"][sp.name],
                    np.atleast_1d(ref.stderr[sp.name]))
    return res


def _cell_set(case, n=5):
    """Fixed mixed cell sets: dense / ragged TO schemes x message budgets
    x comm_eps x all-k / single-k, beside lb specs, and a rounds cell."""
    cells = []
    for i, (r, m, eps, ragged, ks) in enumerate(case):
        if ragged:
            loads = [r, 1, r - 1, 2, 1][:n]
            sp = tm.to_spec("s", js.cyclic_to_matrix(n, r), messages=m,
                            loads=loads, comm_eps=eps)
        else:
            sp = tm.to_spec("s", js.staircase_to_matrix(n, r), messages=m,
                            comm_eps=eps)
        cells.append(tg.GridCell(f"cell{i}", (sp, tm.lb_spec(r, messages=m)),
                                 n, MODEL, trials=250, seed=i % 2, ks=ks,
                                 chunk=100 if i % 2 else None))
    return cells


CASES = {
    "dense_allk": [(2, None, 0.0, False, None), (3, 2, 0.0, False, None),
                   (2, None, 0.02, False, None)],
    "ragged_k1": [(3, None, 0.0, True, 1), (3, 2, 0.02, True, 1),
                  (3, None, 0.0, False, 1)],
    "single_vs_all": [(4, None, 0.0, False, None), (4, None, 0.0, False, 2),
                      (4, 1, 0.02, False, 2), (2, 2, 0.0, False, 2)],
    "budgets": [(4, 1, 0.0, False, None), (4, 2, 0.0, False, None),
                (4, 4, 0.05, False, None), (4, None, 0.05, True, 1)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_grid_equals_per_cell_sweeps(case):
    _assert_stream_matches_per_cell(_cell_set(CASES[case]))


@pytest.mark.parametrize("deadline,policy", [(None, "wait"),
                                             (3e-3, "close_partial")])
def test_rounds_cell_equals_sweep_rounds(deadline, policy):
    n = 5
    proc = tcl.MarkovRegimeProcess(base=MODEL, persistence=0.8)
    cells = _cell_set(CASES["dense_allk"], n) + [tg.GridCell(
        "rcell", (tm.to_spec("cs", js.cyclic_to_matrix(n, 2)),
                  tm.adaptive_spec("adapt", js.cyclic_to_matrix(n, 2)),
                  tm.lb_spec(2)), n, proc, trials=60, seed=1, rounds=3, k=3,
        chunk=40, deadline=deadline, deadline_policy=policy)]
    res = _assert_stream_matches_per_cell(cells)
    assert res.meta["rounds_cells"] == 1
    assert ("degradation" in res.cell("rcell")) == (deadline is not None)


def test_fusion_groups_by_draw_coordinates():
    sp = tm.to_spec("x", js.cyclic_to_matrix(6, 2))
    cells = [tg.GridCell("a", (sp,), 6, MODEL, trials=200, seed=0),
             tg.GridCell("b", (tm.lb_spec(2),), 6, MODEL, trials=200, seed=0),
             tg.GridCell("c", (sp,), 6, MODEL, trials=200, seed=1)]
    res = tg.stream_grid(cells, devices=CPU)
    assert res.meta["fused_dispatches"] == 2
    assert res.meta["devices"] == "cpu"
    ref = tm.sweep([sp], MODEL, 6, trials=200, seed=1, devices=CPU)
    np.testing.assert_array_equal(res.cell("c")["means"]["x"],
                                  ref.means["x"])


def test_stream_grid_refusals():
    sp = tm.to_spec("x", js.cyclic_to_matrix(4, 2))
    cell = tg.GridCell("a", (sp,), 4, MODEL, trials=50)
    with pytest.raises(ValueError, match="duplicate"):
        tg.stream_grid([cell, cell], devices=CPU)
    with pytest.raises(ValueError, match="pipeline"):
        tg.stream_grid([cell], pipeline=0, devices=CPU)
    with pytest.raises(ValueError, match="at least one"):
        tg.stream_grid([], devices=CPU)
    with pytest.raises(ValueError, match="mix"):
        tg.stream_grid([cell], devices=["cpu", "cuda"])
    # two devices are no refusal: the same cell, bit for bit
    two = tg.stream_grid([cell], devices=["cpu", "cpu"])
    one = tg.stream_grid([cell], devices=CPU)
    assert two.meta["devices"] == "cpu,cpu"
    np.testing.assert_array_equal(two.cell("a")["means"]["x"],
                                  one.cell("a")["means"]["x"])


@pytest.mark.parametrize("pipeline", [1, 2, 5])
def test_pipeline_depth_leaves_the_bits(pipeline):
    cells = tg.GridSpec(n=6, families=("cs", "lb", "pc"), loads=(2, 3, 6),
                        messages=(None, 2), trials=300, chunk=100
                        ).cells(MODEL)
    a = tg.stream_grid(cells, devices=CPU, pipeline=pipeline)
    b = tg.stream_grid(cells, devices=CPU, pipeline=1)
    for c in cells:
        for sp in c.specs:
            np.testing.assert_array_equal(a.cell(c.name)["means"][sp.name],
                                          b.cell(c.name)["means"][sp.name])


# -------------------- the reference on the same cells (level 3) ----------------

REF_KW = dict(n=6, families=("cs", "ss", "lb", "pc", "pcmm"), loads=(2, 3),
              messages=(None, 2), comm_eps=(0.0, 0.05), ks=(None, 4),
              trials=1500, seed=0)


@pytest.fixture(scope="module")
def both_grids():
    """The same 2-bucket grid streamed by both packages."""
    got = tg.stream_grid(tg.GridSpec(**REF_KW).cells(MODEL), devices=CPU)
    want = jg.stream_grid(jg.GridSpec(**REF_KW).cells(jd.scenario1()),
                          devices=1)
    return got, want


def test_grid_meta_equals_the_reference(both_grids):
    got, want = both_grids
    for key in ("cells", "fused_dispatches", "buckets", "rounds_cells",
                "pipeline"):
        assert got.meta[key] == want.meta[key], key
    assert got.meta["devices"] == "cpu"
    assert sorted(got.cells) == sorted(want.cells)


def test_grid_means_within_z4_of_the_reference(both_grids):
    got, want = both_grids
    for nm, c in want.cells.items():
        for scheme, mu in c["means"].items():
            z = z_scores(got.cells[nm]["means"][scheme],
                         got.cells[nm]["stderr"][scheme], mu,
                         c["stderr"][scheme])
            assert float(np.max(z)) <= 4.0, (nm, scheme, z)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_grid_artifacts_read_both_ways(both_grids, tmp_path, writer):
    got, want = both_grids
    res = got if writer == "port" else want
    path = str(tmp_path / "grid.json")
    res.save(path)
    on_port = tg.GridResult.load(path)
    on_ref = jg.GridResult.load(path)
    assert sorted(on_port.cells) == sorted(on_ref.cells) == sorted(res.cells)
    for nm, c in res.cells.items():
        for scheme in c["means"]:
            np.testing.assert_array_equal(on_port.means(nm, scheme),
                                          on_ref.means(nm, scheme))
            np.testing.assert_array_equal(on_port.means(nm, scheme),
                                          np.asarray(c["means"][scheme]))
    for k in (None, 2, 6):
        for z in (0.0, 2.0, np.inf):
            assert on_port.best_cell(k=k, z=z) == on_ref.best_cell(k=k, z=z)
    assert on_port.meta == on_ref.meta


def test_rounds_artifact_read_by_the_reference(tmp_path):
    cells = [tg.GridCell("ro", (tm.to_spec("x", js.cyclic_to_matrix(5, 2)),),
                         5, MODEL, trials=40, rounds=2, k=3, deadline=3e-3,
                         deadline_policy="close_partial")]
    res = tg.stream_grid(cells, devices=CPU)
    path = res.save(str(tmp_path / "grid.json"))
    back = jg.GridResult.load(path)
    np.testing.assert_array_equal(
        back.cell("ro")["degradation"]["x"]["khist"],
        res.cell("ro")["degradation"]["x"]["khist"])
    with pytest.raises(ValueError, match="no scorable"):
        tg.GridResult.load(path).best_cell()


def test_grid_result_load_rejects_foreign_and_newer(tmp_path):
    p = str(tmp_path / "x.json")
    with open(p, "w") as fh:
        json.dump({"kind": "other"}, fh)
    with pytest.raises(ValueError, match="not a grid-result"):
        tg.GridResult.load(p)
    with open(p, "w") as fh:
        json.dump({"kind": "grid-result", "version": 999, "cells": {}}, fh)
    with pytest.raises(ValueError, match="newer"):
        tg.GridResult.load(p)


# ------------------------- the evaluator cache ---------------------------------

def _two_bucket_cells():
    cells = []
    for i, (r, eps) in enumerate([(2, 0.0), (2, 0.1), (3, 0.0), (3, 0.1)]):
        for fam, build in (("cs", js.cyclic_to_matrix),
                           ("ss", js.staircase_to_matrix)):
            cells.append(tg.GridCell(
                f"{fam}{i}", (tm.to_spec(fam, build(6, r), comm_eps=eps),),
                6, MODEL, trials=150, seed=0))
    return cells


def test_one_build_per_shape_bucket():
    cells = _two_bucket_cells()
    tm.clear_cache()
    before = tm.cache_stats()
    res = tg.stream_grid(cells, devices=CPU)
    after = tm.cache_stats()
    assert res.meta["buckets"] == 2
    assert after["traces"] - before["traces"] == res.meta["buckets"]
    assert after["exec"]["misses"] - before["exec"]["misses"] == 2
    # the whole grid again: hits only, no new build
    tg.stream_grid(cells, devices=CPU)
    final = tm.cache_stats()
    assert final["traces"] == after["traces"]
    assert final["exec"]["misses"] == after["exec"]["misses"]
    assert final["exec"]["hits"] > after["exec"]["hits"]
    assert set(final) == {"exec", "rounds", "traces"}
    assert set(final["exec"]) == {"size", "capacity", "hits", "misses",
                                  "evictions", "compile_s"}


def test_renamed_specs_share_the_bucket():
    tm.clear_cache()
    C = js.cyclic_to_matrix(6, 2)
    before = tm.cache_stats()["traces"]
    tm.sweep([tm.to_spec("alpha", C)], MODEL, 6, trials=100, devices=CPU)
    tm.sweep([tm.to_spec("omega", C)], MODEL, 6, trials=100, devices=CPU)
    tm.sweep([tm.to_spec("x", js.staircase_to_matrix(6, 2), comm_eps=0.3)],
             MODEL, 6, trials=100, devices=CPU)
    assert tm.cache_stats()["traces"] - before == 1


def test_lru_capacity_bounds_and_evicts():
    tm.clear_cache()
    tm.set_cache_capacity(2)
    try:
        before = tm.cache_stats()["exec"]["evictions"]
        for r in (2, 3, 4):        # 3 distinct buckets, capacity 2
            tm.sweep([tm.lb_spec(r)], MODEL, 6, trials=60, devices=CPU)
        stats = tm.cache_stats()["exec"]
        assert stats["size"] == 2 and stats["capacity"] == 2
        assert stats["evictions"] - before == 1
        assert stats["compile_s"] >= 0.0
        with pytest.raises(ValueError, match="capacity"):
            tm.set_cache_capacity(0)
    finally:
        tm.set_cache_capacity(128)
        tm.clear_cache()


def test_unhashable_model_builds_uncached():
    @dataclasses.dataclass(frozen=True)     # a list field: unhashable
    class Scaled(td.DelayModel):
        scale: list = dataclasses.field(default_factory=lambda: [2.0])

        def _sample(self, seed, tids, n, r):
            T1, T2 = MODEL._sample(seed, tids, n, r)
            return T1 * self.scale[0], T2

    model = Scaled()
    before = tm.cache_stats()
    tm.sweep([tm.lb_spec(2)], model, 5, trials=50, devices=CPU)
    tm.sweep([tm.lb_spec(2)], model, 5, trials=50, devices=CPU)
    after = tm.cache_stats()
    assert after["traces"] - before["traces"] == 2
    assert after["exec"]["size"] == before["exec"]["size"]


def test_cached_rounds_function_carries_no_state():
    n, r = 6, 2
    proc = tcl.MarkovRegimeProcess(base=MODEL, persistence=0.9)
    specs = (tm.adaptive_spec("adapt", js.cyclic_to_matrix(n, r)),
             tm.to_spec("cs", js.cyclic_to_matrix(n, r)))
    args = (specs, proc, n, r, 4, 3, 0.7, 0.5, True, None,
            (torch.device("cpu"),), 3e-3, "reissue")
    before = tm.cache_stats()["rounds"]
    fns = tm._get_rounds_exec(*args)
    assert tm._get_rounds_exec(*args) is fns
    fn = fns[torch.device("cpu")]
    assert tm.cache_stats()["rounds"]["hits"] - before["hits"] == 1
    tids = torch.arange(50)
    a_times, a_aux = fn(5, tids)
    b_times, b_aux = fn(5, tids)
    for nm in a_times:
        assert torch.equal(a_times[nm], b_times[nm])
        for key in a_aux[nm]:
            assert torch.equal(a_aux[nm][key], b_aux[nm][key])
    # and through sweep_rounds: a cache hit gives the first call's bits
    kw = dict(rounds=3, k=4, trials=50, seed=5, censored_feedback=True,
              deadline=3e-3, deadline_policy="reissue", devices=CPU)
    first = tm.sweep_rounds(specs, proc, n, **kw)
    second = tm.sweep_rounds(specs, proc, n, **kw)
    for nm in first.per_round:
        np.testing.assert_array_equal(first.per_round[nm],
                                      second.per_round[nm])


def test_trace_process_stays_uncached():
    gen = np.random.default_rng(4)
    T1 = (1e-4 * (1 + gen.random((2, 30, 5, 2)))).astype(np.float32)
    T2 = (5e-4 * (1 + gen.random((2, 30, 5, 2)))).astype(np.float32)
    proc = tt.TraceProcess(tt.DelayTrace(T1, T2))
    spec = tm.to_spec("cs", js.cyclic_to_matrix(5, 2))
    before = tm.cache_stats()
    for _ in range(2):
        tm.sweep_rounds([spec], proc, 5, rounds=2, k=3, trials=30,
                        devices=CPU)
    after = tm.cache_stats()
    assert after["rounds"]["size"] == before["rounds"]["size"]
    assert after["traces"] - before["traces"] == 2


# --------------------------------- the CLI -------------------------------------

def test_grid_cli_writes_an_artifact_the_reference_reads(tmp_path, capsys):
    out = str(tmp_path / "out" / "grid.json")
    rc = grid_cli.main(["--n", "5", "--families", "cs", "lb",
                        "--loads", "2", "--trials", "200", "--device", "cpu",
                        "--window", "3", "--out", out])
    assert rc == 0
    text = capsys.readouterr().out
    assert "cells/s" in text and "best:" in text
    res = jg.GridResult.load(out)
    assert res.meta["cells"] == 2 and res.meta["model"] == "scenario1"
    assert res.meta["spec"]["n"] == 5
    assert res.meta["window"] == res.meta["pipeline"] == 3
    assert res.meta["devices"] == "cpu"
    assert set(res.meta["cache"]) == {"exec", "rounds", "traces"}
    ref = tm.sweep([tg._family_spec("cs", 5, 2, None, 0.0, 0)], MODEL, 5,
                   trials=200, devices=CPU)
    np.testing.assert_array_equal(res.means("cs/r2", "cs"), ref.means["cs"])


def test_grid_cli_spec_file_pipeline_alias_and_devices(tmp_path):
    spec_path = str(tmp_path / "spec.json")
    gs = tg.GridSpec(n=4, families=("ss",), loads=(2,), trials=100, seed=2)
    with open(spec_path, "w") as fh:
        json.dump(gs.to_json(), fh)
    out = str(tmp_path / "res.json")
    assert grid_cli.main(["--spec", spec_path, "--out", out, "--device",
                          "cpu", "--pipeline", "4", "--devices", "1"]) == 0
    res = tg.GridResult.load(out)
    assert res.meta["spec"] == gs.to_json()
    assert list(res.cells) == ["ss/r2"] and res.meta["window"] == 4
    out2 = str(tmp_path / "res2.json")
    assert grid_cli.main(["--spec", spec_path, "--out", out2, "--device",
                          "cpu", "--devices", "2"]) == 0
    res2 = tg.GridResult.load(out2)
    assert res2.meta["devices"] == "cpu,cpu"
    np.testing.assert_array_equal(res2.means("ss/r2", "ss"),
                                  res.means("ss/r2", "ss"))


def test_grid_cli_runs_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grid_cli.main(["--n", "4", "--families", "cs", "--trials", "50",
                       "--out", str(tmp_path / "g.json")])
