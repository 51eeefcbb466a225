"""The port's benchmark-regression gate (``benchmarks_torch.regression_gate``):
it passes on synthetic ``BENCH_*.json`` files that meet the port's
baseline, exits 1 on each planted regression and on a NaN anywhere, and 2
on a missing file, row, field or baseline value; its machine-independent
thresholds are the reference's; the mc_engine scaling row it reads on a
sharded run."""
import json
import math
import os
import subprocess
import sys

import pytest

from benchmarks_torch import common, mc_engine
from benchmarks_torch import regression_gate as gate

from torch_parity import REPO
from torch_parity import one_thread  # noqa: F401

BASE_PATH = gate.DEFAULT_BASELINE
with open(BASE_PATH) as _f:
    BASE = json.load(_f)


def _rows():
    """One run's rows, every metric at its baseline's comfortable side."""
    return {
        "mc_engine": {
            "mc_engine/fused": {"throughput":
                                BASE["mc_engine_fused_throughput"] * 1.1,
                                "trials": 4000.0, "schemes": 6.0},
            "mc_engine/scaling1": {"devices": 1.0,
                                   "trials_per_sec": 17000.0}},
        "grid": {
            "grid/stream": {"cells_per_sec": BASE["grid_cells_per_sec"],
                            "buckets": 4.0, "compiles": 4.0},
            "grid/speedup": {"stream_over_naive": 9.0, "bitexact": "PASS"}},
        "planner": {
            "planner/race": {"saved": 7.8, "winner": "ss/r8"},
            "planner/agreement": {"agree": 1.0, "planner": "ss/r8",
                                  "exhaustive": "ss/r8"}},
        "fig8": {BASE["fig8_cell"]: {"adapt_vs_static": 10.0}},
        "fig10": {"fig10/rebalance": {"rebal_vs_perm": 3.0}},
        "fig11": {"fig11/trace": {"adapt_vs_static": 9.1}},
        "fig12": {"fig12/preemption": {"adapt_vs_static": 6.4}},
        "fig13": {"fig13/exact": {"status": "PASS"},
                  "fig13/deadline": {"status": "PASS"},
                  "fig13/accuracy": {"rel_err": 0.0046}},
    }


def _write(path, rows):
    os.makedirs(path, exist_ok=True)
    for bench, named in rows.items():
        with open(os.path.join(path, f"BENCH_{bench}.json"), "w") as f:
            json.dump({"bench": bench, "rows": [
                {"name": nm, "us_per_call": 1.0, "derived": d}
                for nm, d in named.items()]}, f)
    return str(path)


def _run(tmp_path, rows, *extra):
    return gate.main(["--results", _write(tmp_path / "res", rows),
                      *extra])


def test_gate_passes_on_synthetic_artifacts(tmp_path, capsys):
    assert _run(tmp_path, _rows()) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert sum(ln.startswith("PASS ") for ln in lines) == 8
    assert lines[-1] == "regression_gate: all checks passed"


def _plant(bench, row, field, value):
    def edit(rows):
        rows[bench][row][field] = value
    return edit


PLANTED = {
    "fig8_margin": _plant("fig8", BASE["fig8_cell"], "adapt_vs_static",
                          BASE["fig8_adapt_vs_static"] - 6.5),
    "fig8_negative": _plant("fig8", BASE["fig8_cell"], "adapt_vs_static",
                            -1.0),
    "fig10_margin": _plant("fig10", "fig10/rebalance", "rebal_vs_perm",
                           BASE["fig10_rebal_vs_perm"] - 2.5),
    "fig11_margin": _plant("fig11", "fig11/trace", "adapt_vs_static",
                           BASE["fig11_trace_adapt_vs_static"] - 6.5),
    "fig12_margin": _plant("fig12", "fig12/preemption", "adapt_vs_static",
                           BASE["fig12_fault_margin"] - 5.5),
    "fig13_rel_err": _plant("fig13", "fig13/accuracy", "rel_err",
                            BASE["fig13_live_rel_err_max"] * 1.01),
    "fig13_exact": _plant("fig13", "fig13/exact", "status", "FAIL"),
    "fig13_deadline": _plant("fig13", "fig13/deadline", "status", "FAIL"),
    "planner_agree0": _plant("planner", "planner/agreement", "agree", 0.0),
    "planner_saved": _plant("planner", "planner/race", "saved",
                            BASE["planner_trials_saved_min"] * 0.99),
    "mc_engine_throughput": _plant(
        "mc_engine", "mc_engine/fused", "throughput",
        BASE["mc_engine_fused_throughput"] * 0.24),
    "grid_cells_per_sec": _plant("grid", "grid/stream", "cells_per_sec",
                                 BASE["grid_cells_per_sec"] * 0.24),
    "grid_speedup": _plant("grid", "grid/speedup", "stream_over_naive",
                           BASE["grid_speedup_min"] * 0.99),
    "grid_bitexact": _plant("grid", "grid/speedup", "bitexact", "FAIL"),
    "grid_builds": _plant("grid", "grid/stream", "compiles", 5.0),
    "nan_read": _plant("fig10", "fig10/rebalance", "rebal_vs_perm",
                       math.nan),
    "nan_unread_row": _plant("mc_engine", "mc_engine/scaling1",
                             "trials_per_sec", math.nan),
    "inf": _plant("grid", "grid/stream", "cells_per_sec", math.inf),
}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_planted_regression_exits_1(tmp_path, name):
    rows = _rows()
    PLANTED[name](rows)
    assert _run(tmp_path, rows) == 1


def test_margins_at_their_floor_pass(tmp_path):
    rows = _rows()
    rows["fig8"][BASE["fig8_cell"]]["adapt_vs_static"] = \
        BASE["fig8_adapt_vs_static"] - 6.0
    rows["fig10"]["fig10/rebalance"]["rebal_vs_perm"] = \
        BASE["fig10_rebal_vs_perm"] - 2.0
    rows["mc_engine"]["mc_engine/fused"]["throughput"] = \
        BASE["mc_engine_fused_throughput"] * 0.25
    assert _run(tmp_path, rows) == 0


def _drop_file(rows):
    del rows["fig12"]


def _drop_row(rows):
    del rows["planner"]["planner/agreement"]


def _drop_field(rows):
    del rows["grid"]["grid/stream"]["cells_per_sec"]


def _text_field(rows):
    rows["fig8"][BASE["fig8_cell"]]["adapt_vs_static"] = "n/a"


@pytest.mark.parametrize("edit", [_drop_file, _drop_row, _drop_field,
                                  _text_field])
def test_missing_input_exits_2(tmp_path, edit):
    rows = _rows()
    edit(rows)
    assert _run(tmp_path, rows) == 2


def test_only_selects_checks_and_refuses_unknown_names(tmp_path):
    rows = _rows()
    del rows["fig12"]
    PLANTED["fig8_margin"](rows)
    assert _run(tmp_path, rows, "--only", "mc_engine,grid") == 0
    assert _run(tmp_path, rows, "--only", "fig8") == 1
    assert _run(tmp_path, rows, "--only", "fig12") == 2
    assert _run(tmp_path, rows, "--only", "roofline") == 2
    assert _run(tmp_path, rows, "--baseline",
                str(tmp_path / "absent.json")) == 2


def _scaling_row(speedup):
    return {"devices": 4.0, "device_list": "cuda:0+cuda:1+cuda:2+cuda:3",
            "trials": 4000.0, "chunk": 250.0, "trials_per_sec": 60000.0,
            "strong_speedup": speedup, "weak_efficiency": 0.9}


def test_scaling_check(tmp_path, capsys):
    rows = _rows()
    # no scaling row, or no baseline value yet: a missing input
    assert _run(tmp_path, rows, "--only", "scaling") == 2
    rows["mc_engine"]["mc_engine/scaling"] = _scaling_row(3.5)
    assert _run(tmp_path, rows, "--only", "scaling") == 2
    assert "mc_engine_strong_speedup" in capsys.readouterr().out
    base = dict(BASE, mc_engine_strong_speedup=3.0)
    path = tmp_path / "base.json"
    path.write_text(json.dumps(base))
    assert _run(tmp_path, rows, "--only", "scaling", "--baseline",
                str(path)) == 0
    rows["mc_engine"]["mc_engine/scaling"] = _scaling_row(2.2)
    assert _run(tmp_path, rows, "--only", "scaling", "--baseline",
                str(path)) == 1
    del rows["mc_engine"]["mc_engine/scaling"]["weak_efficiency"]
    assert _run(tmp_path, rows, "--only", "scaling", "--baseline",
                str(path)) == 2


def test_baseline_copies_the_reference_thresholds():
    with open(REPO / "benchmarks" / "baselines"
              / "bench_quick_baseline.json") as f:
        ref = json.load(f)
    for key in ("fig8_cell", "fig8_adapt_vs_static", "fig10_rebal_vs_perm",
                "fig11_trace_adapt_vs_static", "fig12_fault_margin",
                "fig13_live_rel_err_max", "grid_speedup_min",
                "planner_trials_saved_min"):
        assert BASE[key] == ref[key], key
    # card low-water marks of the port's own, no multi-card value yet
    assert BASE["mc_engine_fused_throughput"] > 0
    assert BASE["grid_cells_per_sec"] > 0
    assert "mc_engine_strong_speedup" not in BASE
    assert "H100" in BASE["_comment"] and " W" in BASE["_comment"]


def test_sharded_scaling_row_feeds_the_gate(tmp_path):
    """mc_engine's scaling row on ["cpu"] * 2 names its device list and
    carries the fields the gate's scaling check reads."""
    common.drain_rows()
    out = mc_engine._scaling(mc_engine.scenario1(), 8, 2, 160, "cpu",
                             ["cpu", "cpu"])
    rows = {r["name"]: r["derived"] for r in common.drain_rows()}
    assert out["scaling_devices"] == 2
    row = rows["mc_engine/scaling"]
    assert row["device_list"] == "cpu+cpu" and row["devices"] == 2
    for field in ("trials_per_sec", "strong_speedup", "weak_efficiency"):
        assert math.isfinite(row[field]) and row[field] > 0
    synthetic = _rows()
    synthetic["mc_engine"]["mc_engine/scaling"] = row
    base = dict(BASE, mc_engine_strong_speedup=1e-3)
    path = tmp_path / "base.json"
    path.write_text(json.dumps(base))
    assert _run(tmp_path, synthetic, "--only", "scaling", "--baseline",
                str(path)) == 0
    # one device: no scaling row, as in the reference
    mc_engine._scaling(mc_engine.scenario1(), 8, 2, 160, "cpu", None)
    assert [r["name"] for r in common.drain_rows()] == ["mc_engine/scaling1"]


def test_module_exit_codes(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res_dir = _write(tmp_path / "res", _rows())
    ok = subprocess.run([sys.executable, "-m",
                         "benchmarks_torch.regression_gate", "--results",
                         res_dir], cwd=REPO, capture_output=True, text=True,
                        timeout=120, env=env)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    missing = subprocess.run([sys.executable, "-m",
                              "benchmarks_torch.regression_gate",
                              "--results", str(tmp_path / "none")],
                             cwd=REPO, capture_output=True, text=True,
                             timeout=120, env=env)
    assert missing.returncode == 2 and "missing" in missing.stdout
