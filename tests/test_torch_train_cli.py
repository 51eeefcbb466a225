"""The port's trainer CLI (``python -m repro_torch.launch.train``) on the
CPU through ``main(argv)`` with ``--smoke --device cpu``: the JAX
package's flags plus ``--device``; the reference's printed lines; a
``--config`` RoundConfig document; ``--log-delays`` then ``--cluster
trace`` giving the same rounds (completion times, winner weights,
delivered tasks: exact) and the same losses (rel 1e-5); ``--resume`` from
a checkpoint against a straight run (losses rel 1e-5, weights at
tests/test_torch_train.py's AdamW tolerance: a CPU BLAS may sum in
another order from run to run, and AdamW turns a last-bit difference of a
tiny gradient into up to lr a step); ``--mesh pod`` refused; a model whose
training state exceeds the card refused before anything is allocated;
and both training examples at tiny sizes."""
import contextlib
import importlib.util
import io
import re
import types

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.core import RoundConfig, load_trace
from repro_torch.configs import get_config
from repro_torch.launch import train as ttrain
from torch_parity import REPO
from torch_parity import one_thread  # noqa: F401

SMOKE = ["--arch", "gemma3-4b", "--smoke", "--device", "cpu", "--seq", "12",
         "--batch", "8"]


def _flags(main) -> set:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(--[a-z][a-z-]*)", out.getvalue())) - {"--help"}


def test_flags_are_the_references_plus_device():
    assert _flags(ttrain.main) == _flags(jtrain.main) | {"--device"}


def _run(argv, capsys):
    res = ttrain.main(SMOKE + argv)
    return res, capsys.readouterr().out


def test_adaptive_markov_run_prints_the_reference_lines(capsys, tmp_path):
    res, out = _run(["--steps", "5", "--n", "4", "--r", "2", "--k", "3",
                     "--schedule", "cs", "--adaptive", "--cluster", "markov",
                     "--deadline", "2e-3", "--deadline-policy", "reissue",
                     "--ckpt-dir", str(tmp_path)], capsys)
    assert re.search(r"gemma3-4b-smoke: [\d,]+ params \| round n=4 r=2 k=3 "
                     r"cs\+adaptive \| cluster markov deadline=0.002/reissue",
                     out)
    assert len(re.findall(r"^step +\d+  loss \d+\.\d+  gnorm \d+\.\d+  "
                          r"vclock \d+\.\d+ ms$", out, re.M)) == 5
    assert "done: 5 rounds in" in out
    assert re.search(r"deadline 0.002s/reissue: \d+/5 rounds missed", out)
    assert f"saved {tmp_path}/gemma3-4b-00000005.npz" in out
    assert len(res.history) == len(res.step_seconds) == 5
    assert res.state.step == 5
    for h in res.history:
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
        assert sorted(h["row_of_worker"]) == [0, 1, 2, 3]
        assert h["realized_k"] <= 3
        # the scheduler's greedy pick ran once a round (the plain version
        # on the CPU: no kernel launch is counted)
        assert h["launches"]["greedy_assign"] == 0


def test_config_document_sets_the_round(capsys, tmp_path):
    path = tmp_path / "round.json"
    RoundConfig(n=4, k=2, kind="ss", r=3, loads=(3, 1, 2, 3),
                deadline=5e-3, deadline_policy="close_partial").save(path)
    res, out = _run(["--config", str(path), "--steps", "2", "--n", "9"],
                    capsys)
    assert "round n=4 r=3 k=2 ss loads=3,1,2,3" in out
    assert "deadline=0.005/close_partial" in out
    assert all(h["realized_k"] <= 2 for h in res.history)


def test_log_delays_then_trace_replays_the_same_rounds(capsys, tmp_path):
    log = str(tmp_path / "delays.npz")
    a, out = _run(["--steps", "4", "--cluster", "ar1", "--straggle",
                   "--log-delays", log], capsys)
    assert f"logged 4 rounds of delays -> {log}" in out
    tr = load_trace(log)
    assert tr.T1.shape == (4, 1, 4, 2) and tr.meta["cluster"] == "ar1"
    b, _ = _run(["--steps", "4", "--cluster", "trace", "--trace", log],
                capsys)
    for ha, hb in zip(a.history, b.history):
        for key in ("completion_time", "winners", "delivered_tasks",
                    "realized_k", "weights", "row_of_worker"):
            assert ha[key] == hb[key], key
        for key in ("loss", "grad_norm"):
            assert ha[key] == pytest.approx(hb[key], rel=1e-5), key
    with pytest.raises(ValueError, match="recorded only 4"):
        _run(["--steps", "5", "--cluster", "trace", "--trace", log], capsys)
    with pytest.raises(SystemExit, match="--trace PATH"):
        _run(["--cluster", "trace"], capsys)


def test_resume_equals_a_straight_run(capsys, tmp_path):
    """Four steps, a checkpoint, --resume to eight, against eight straight
    (the i.i.d. cluster carries no state; the warm-up covers steps 0-4 in
    both runs, so the learning rates agree)."""
    ck = str(tmp_path / "ck")
    _run(["--steps", "4", "--ckpt-dir", ck], capsys)
    resumed, out = _run(["--steps", "8", "--ckpt-dir", ck, "--resume"],
                        capsys)
    assert f"resumed from {ck}/gemma3-4b-00000004.npz at step 4" in out
    assert resumed.start == 4 and len(resumed.history) == 4
    straight, _ = _run(["--steps", "8"], capsys)
    assert [h["loss"] for h in resumed.history] == pytest.approx(
        [h["loss"] for h in straight.history[4:]], rel=1e-5)
    diffs = torch.cat([
        (a - b).abs().flatten().detach() for a, b in zip(
            resumed.state.params.parameters(),
            straight.state.params.parameters())])
    assert float(diffs.max()) <= 5e-4
    assert float(torch.quantile(diffs, 0.999)) <= 1e-5


def test_mesh_other_than_local_is_refused(capsys):
    with pytest.raises(SystemExit, match=r"ROADMAP.md item 8.8 \(c\)"):
        _run(["--mesh", "pod"], capsys)


def test_state_that_exceeds_the_card_is_refused(monkeypatch):
    assert ttrain.state_bytes(get_config("gemma3-4b")) == 4_550_996_480 * 12
    monkeypatch.setattr(ttrain, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            total_memory=80 * 10 ** 9))
    monkeypatch.setattr(ttrain, "init_train_state", None)   # never reached
    for arch in ("qwen2-72b", "mistral-nemo-12b"):
        with pytest.raises(SystemExit, match="exceed"):
            ttrain.main(["--arch", arch])


def _example(name):
    path = REPO / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_at_tiny_sizes(capsys):
    m = _example("quickstart").main(["--device", "cpu", "--trials", "200"])
    assert int(m["winners"]) >= 6 and np.isfinite(float(m["loss"]))
    res = _example("train_lm_straggler").main(
        ["--smoke", "--device", "cpu", "--steps", "3", "--seq", "8",
         "--batch", "8", "--schedules", "ss,adaptive", "--cluster",
         "markov"])
    assert set(res) == {"ss", "adaptive"}
    out = capsys.readouterr().out
    assert "SS TO matrix" in out and "curve,adaptive,2," in out
