"""The port's benchmark harness (``python -m benchmarks_torch.run``) on the
CPU: it writes ``BENCH_<name>.json``, refuses non-finite metrics and the
jobs of later slices (a planted one: none is left), fig9's and fig10-13's guards pass, table1's ``ok``
holds, and the
seed-style ``legacy`` path of ``mc_engine`` gives per-trial CS / SS order
statistics bit-equal to the fused engine's on shared draws (mins and sorts
are exact).  Row names and derived keys of the ported figures are held to the
reference's in tests/test_torch_bench_rows.py; here fig6's and mc_engine's,
whose reference runs cost more than ~10 s of JAX compiles, are held to the
reference's loop constants (``benchmarks/fig6_vs_workers.py``: ``for n in
(10, 11, 12, 13, 14, 15)``; ``benchmarks/mc_engine.py``: its rows
``legacy``, ``fused``, ``speedup``, ``scan_overhead``, ``chunked1M`` and
``scaling1``, the ``scaling`` row only with more than one device), and so
are the grid and planner jobs' (``benchmarks/grid_stream.py``,
``benchmarks/planner.py``), run here at a few hundred trials with their
guards passing, and made to fire."""
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmarks_torch import (common, fig6_vs_workers, fig10_load_rebalance,
                              fig11_trace_replay, fig12_faults, fig13_live,
                              grid_stream, mc_engine, planner, run)
from repro.core.grid import GridResult as JaxGridResult
from repro_torch.core import (completion_samples, cyclic_to_matrix,
                              scenario1, staircase_to_matrix, to_spec)

from torch_parity import REPO
from torch_parity import one_thread  # noqa: F401

SCHEMES = ["cs", "ss", "ra", "pc", "pcmm", "lb"]


def _keys(rows):
    return [(r["name"], sorted(r["derived"])) for r in rows]


def test_harness_writes_bench_json(tmp_path, capsys):
    done = run.main(["--quick", "--device", "cpu", "--only", "fig3,fig7",
                     "--out", str(tmp_path)])
    assert sorted(done) == ["fig3", "fig7"]
    for name in ("fig3", "fig7"):
        blob = json.loads((tmp_path / f"BENCH_{name}.json").read_text())
        assert blob["bench"] == name and blob["quick"] is True
        assert blob["trials"] == 4000 and blob["device"] == "cpu"
        assert [r["name"] for r in blob["rows"]] == [
            r["name"] for r in done[name]["rows"]]
        assert blob["seconds"] > 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert "fig3/summary" in out[4] and out[-1].startswith("fig7/claims")


def test_harness_refuses_non_finite_metrics(tmp_path, monkeypatch):
    def poisoned(trials, device):
        common.emit("fig3/worker1", 1.0, "comp_mean=nan;ok=True")
    from benchmarks_torch import fig3_delays
    monkeypatch.setattr(fig3_delays, "run", poisoned)
    with pytest.raises(SystemExit, match="non-finite"):
        run.main(["--device", "cpu", "--only", "fig3", "--out",
                  str(tmp_path)])
    # the artifact is written all the same: the rows are the diagnosis
    blob = json.loads((tmp_path / "BENCH_fig3.json").read_text())
    assert blob["rows"][0]["derived_raw"] == "comp_mean=nan;ok=True"


@pytest.mark.parametrize("name", ["mesh"])
def test_harness_refuses_later_slices_by_roadmap_item(name, monkeypatch):
    """Every job of benchmarks/run.py is ported (``run.LATER`` is empty
    since the roofline job runs), so a pending job is planted to hold the
    refusal."""
    assert run.LATER == {}
    monkeypatch.setitem(run.LATER, name, "queue 1 item 8.8 (the mesh)")
    with pytest.raises(SystemExit, match=f"{name} waits for ROADMAP.md "
                                         f"queue 1 item"):
        run.main(["--device", "cpu", "--only", f"fig3,{name}", "--out", ""])


@pytest.mark.parametrize("name", ["fig10", "fig11", "fig12", "fig13"])
def test_fault_figures_pass_on_the_cpu(name, tmp_path):
    """The fault-tolerance figures and the live cluster's Fig. 13 (no
    longer refused) at 64 trials on the CPU: every guard passes and the
    status rows read PASS."""
    mod = {"fig10": fig10_load_rebalance, "fig11": fig11_trace_replay,
           "fig12": fig12_faults, "fig13": fig13_live}[name]
    kw = {"out": str(tmp_path)} if name in ("fig11", "fig12") else {}
    common.drain_rows()
    mod.run(64, "cpu", **kw)
    rows = common.drain_rows()
    status = [r["derived"]["status"] for r in rows
              if "status" in r["derived"]]
    assert status and set(status) == {"PASS"}, rows
    assert all(r["derived"]["trials"] == 64 for r in rows
               if "trials" in r["derived"])


def test_harness_refuses_unknown_names_as_the_reference_does():
    with pytest.raises(SystemExit, match=r"unknown --only name\(s\) "
                                         r"\['nope'\]; valid names: "):
        run.main(["--device", "cpu", "--only", "nope", "--out", ""])


def test_harness_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["--only", "fig7", "--out", ""])


def test_fig9_guards_pass_at_quick_scale(tmp_path):
    rows = run.main(["--quick", "--device", "cpu", "--only", "fig9",
                     "--out", str(tmp_path)])["fig9"]["rows"]
    last = {r["name"]: r["derived"] for r in rows}
    assert last["fig9/mm_beats_single"]["all_schemes"] == "PASS"
    assert last["fig9/opt_m"]["nontrivial"] == "PASS"


def test_table1_updates_hold_their_bounds(tmp_path):
    rows = run.main(["--device", "cpu", "--only", "table1", "--out",
                     str(tmp_path)])["table1"]["rows"]
    assert [r["name"] for r in rows] == ["table1/cs_uncoded", "table1/pc",
                                         "table1/pcmm"]
    for r in rows:
        assert r["derived"]["ok"] == "True", r


@pytest.mark.parametrize("n,r,k", [(16, 16, 16), (16, 4, 1), (16, 4, 9)])
def test_legacy_and_fused_order_statistics_are_bit_equal(n, r, k):
    model = scenario1()
    legacy = mc_engine.legacy_samples(model, n, r, k, trials=300,
                                      device="cpu")
    for name, C in (("cs", cyclic_to_matrix(n, r)),
                    ("ss", staircase_to_matrix(n, r))):
        fused = completion_samples(to_spec(name, C), model, n, trials=300,
                                   k=k, devices="cpu")
        assert torch.equal(legacy[name], fused), name


def test_fig6_rows_follow_the_references_loop():
    common.drain_rows()
    fig6_vs_workers.run(200, "cpu")
    got = _keys(common.drain_rows())
    want = [(f"fig6/n{n}", sorted(SCHEMES)) for n in range(10, 16)]
    want.append(("fig6/claims", sorted(
        ["ss_improves_with_n", "ss_beats_pc", "pcmm_n15_over_n10",
         "pcmm_degradation_needs_contention_model"])))
    assert got == want


def test_mc_engine_rows_follow_the_reference():
    common.drain_rows()
    out = mc_engine.run(400, "cpu")
    got = _keys(common.drain_rows())
    assert got == [
        ("mc_engine/legacy", ["schemes", "throughput", "trials"]),
        ("mc_engine/fused", ["schemes", "throughput", "trials"]),
        ("mc_engine/speedup", ["fused_over_legacy"]),
        ("mc_engine/scan_overhead", ["chunked_over_fused", "chunks",
                                     "throughput", "trials"]),
        ("mc_engine/chunked1M", ["chunk", "cs_at_k", "throughput",
                                 "trials"]),
        ("mc_engine/scaling1", ["chunk", "devices", "trials",
                                "trials_per_sec"])]
    assert out["scaling_devices"] == 1


def test_module_run_from_the_repo_root(tmp_path):
    """``python -m benchmarks_torch.run`` from the repository root, with no
    PYTHONPATH: the package finds the checkout's ``src`` itself."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks_torch.run", "--quick", "--device",
         "cpu", "--only", "fig3", "--out", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("fig3/summary,")
    assert (tmp_path / "BENCH_fig3.json").exists()


GRID_ROWS = [
    ("grid/stream", sorted(["cells", "trials", "cells_per_sec", "buckets",
                            "compiles", "fused_dispatches"])),
    ("grid/naive", sorted(["cells", "subset_of", "trials",
                           "cells_per_sec"])),
    ("grid/speedup", sorted(["stream_over_naive", "bitexact"]))]
PLANNER_ROWS = [
    ("planner/exhaustive", sorted(["cells", "trials", "trial_evals", "best",
                                   "best_mean", "ties"])),
    ("planner/race", sorted(["winner", "trials_spent", "exhaustive_trials",
                             "saved", "pruned", "raced", "rungs",
                             "lb_gap"])),
    ("planner/agreement", sorted(["agree", "planner", "exhaustive",
                                  "mean_gap"]))]


def test_grid_rows_follow_the_reference_and_guards_pass(tmp_path):
    common.drain_rows()
    out = grid_stream.run(300, "cpu", out=str(tmp_path))
    rows = common.drain_rows()
    assert _keys(rows) == GRID_ROWS
    last = {r["name"]: r["derived"] for r in rows}
    assert last["grid/stream"]["cells"] == 64
    assert last["grid/stream"]["buckets"] == 4
    assert last["grid/stream"]["compiles"] == 4 == out["builds"]
    assert last["grid/stream"]["fused_dispatches"] == 4
    assert last["grid/naive"]["cells"] == 8
    assert last["grid/speedup"]["bitexact"] == "PASS"
    # the artifact is the JAX package's schema
    res = JaxGridResult.load(str(tmp_path / "GRID_result.json"))
    assert len(res.cells) == 64 and res.meta["devices"] == "cpu"


def test_planner_rows_follow_the_reference_and_guards_pass():
    common.drain_rows()
    out = planner.run(300, "cpu")
    rows = common.drain_rows()
    assert _keys(rows) == PLANNER_ROWS
    last = {r["name"]: r["derived"] for r in rows}
    assert last["planner/agreement"]["agree"] == 1.0
    assert out["winner"] == out["best"]
    assert last["planner/race"]["saved"] > 1.0
    assert out["trials_spent"] < out["exhaustive_trials"] == 64 * 300


def test_grid_guard_fires_on_a_changed_cell(monkeypatch):
    real = grid_stream.stream_grid

    def shifted(cells, **kw):
        res = real(cells, **kw)
        first = next(iter(res.cells.values()))
        for nm in first["means"]:
            first["means"][nm] = first["means"][nm] * (1 + 1e-7)
        return res

    monkeypatch.setattr(grid_stream, "stream_grid", shifted)
    common.drain_rows()
    with pytest.raises(SystemExit, match="NOT bit-exact"):
        grid_stream.run(200, "cpu", out="")
    assert common.drain_rows()[-1]["derived"]["bitexact"] == "FAIL"


def test_planner_guard_fires_on_another_winner(monkeypatch):
    real = planner.plan

    def other(*a, **kw):
        res = real(*a, **kw)
        res.winner = "pc/r2"
        return res

    monkeypatch.setattr(planner, "plan", other)
    common.drain_rows()
    with pytest.raises(SystemExit, match="argmin disagreement"):
        planner.run(200, "cpu")
    assert common.drain_rows()[-1]["derived"]["agree"] == 0.0
