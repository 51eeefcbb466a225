"""The port runs on the card by default and never on the CPU unasked; it
imports neither JAX nor the JAX package nor the JAX side's benchmarks;
``convert`` carries the JAX side's state across; ``chip_smoke.py`` refuses
to report without a card."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import delays as jd
from repro.core import scheduling as js
from repro.core import spec as jspec
from repro_torch import convert, dgd, resolve_device
from repro_torch.configs import RegressionConfig, get_config
from repro_torch.core import (AdaptiveScheduler, StragglerAggregator,
                              adaptive_spec, completion_samples,
                              cyclic_to_matrix, greedy_row_assignment,
                              lb_spec, lower_bound_mean_mc,
                              mean_completion_time, scenario1,
                              simulate_lower_bound, sweep, sweep_rounds,
                              theorem1_mean_mc, trajectory_samples)
from repro_torch.core import spec as tspec
from repro_torch.data import regression_dataset
from repro_torch.launch import serve
from repro_torch.models import init_cache, init_params

from torch_parity import REPO, assert_bit_equal
from torch_parity import one_thread  # noqa: F401

ENTRY_POINTS = {
    "resolve_device": lambda: resolve_device(),
    "sweep": lambda: sweep([lb_spec(2)], scenario1(), 4, trials=4),
    "completion_samples": lambda: completion_samples(lb_spec(2), scenario1(),
                                                     4, trials=4),
    "aggregator": lambda: StragglerAggregator(tspec.RoundConfig(n=4, k=2,
                                                                r=2),
                                              scenario1()),
    "regression_dataset": lambda: regression_dataset(torch.Generator(), 8, 3),
    "paper_problem": lambda: dgd.paper_problem(RegressionConfig(N=8, d=3,
                                                                n=2)),
    "convert": lambda: convert.regression_state(np.zeros((2, 2)),
                                                np.zeros(2)),
    "sweep_rounds": lambda: sweep_rounds([lb_spec(2)], scenario1(), 4,
                                         rounds=2, k=2, trials=4),
    "trajectory_samples": lambda: trajectory_samples(
        adaptive_spec("a", cyclic_to_matrix(4, 2)), scenario1(), 4,
        rounds=2, k=2, trials=4),
    "adaptive_aggregator": lambda: StragglerAggregator(
        tspec.RoundConfig(n=4, k=2, r=2, adaptive=True), scenario1()),
    "adaptive_scheduler": lambda: AdaptiveScheduler(cyclic_to_matrix(4, 2)),
    "greedy_row_assignment": lambda: greedy_row_assignment(
        cyclic_to_matrix(4, 2)),
    "run_paper": lambda: dgd.run_paper(RegressionConfig(N=8, d=3, n=2, r=1,
                                                        k=2), 1),
    "lm_init_params": lambda: init_params(get_config("gemma3-4b").smoke()),
    "lm_init_cache": lambda: init_cache(get_config("gemma3-4b").smoke(), 1,
                                        8),
    "serve_run": lambda: serve.run(get_config("gemma3-4b").smoke(), batch=1,
                                   prompt_len=4, gen=2),
    "mean_completion_time": lambda: mean_completion_time(
        cyclic_to_matrix(4, 2), scenario1(), 2, trials=4),
    "simulate_lower_bound": lambda: simulate_lower_bound(scenario1(), 4, 2,
                                                         trials=4),
    "theorem1_mean_mc": lambda: theorem1_mean_mc(
        cyclic_to_matrix(4, 2), scenario1(), 2, tmax=1e-3, trials=4),
    "lower_bound_mean_mc": lambda: lower_bound_mean_mc(scenario1(), 4, 2,
                                                       r=2, trials=4),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        ENTRY_POINTS[name]()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ENTRY_POINTS[name]()


def test_cpu_on_request():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += sorted((REPO / "examples_torch").glob("*.py"))
    files += sorted((REPO / "benchmarks_torch").glob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks"), (
                path, name)


MODELS = [jd.scenario1(), jd.scenario2(5, seed=3), jd.ec2_like(5),
          jd.TruncatedGaussianDelays(rho=0.3),
          jd.ShiftedExponentialDelays(mean1=1e-5),
          jd.BimodalStragglerDelays(slow=3.0),
          jd.EmpiricalDelays(samples1=((1e-4, 2e-4),), samples2=((3e-4, 4e-4),))]


@pytest.mark.parametrize("model", MODELS, ids=lambda m: type(m).__name__)
def test_convert_delay_models(model):
    got = convert.delay_model(type(model).__name__, dataclasses.asdict(model))
    assert type(got).__name__ == type(model).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(model)


def test_convert_matrices_configs_tables():
    C = js.staircase_to_matrix(6, 3, loads=[3, 1, 2, 3, 2, 1])
    assert_bit_equal(convert.to_matrix(C), C)
    with pytest.raises(ValueError):
        convert.to_matrix(np.array([[0, 0], [1, 1]]))
    cj = jspec.RoundConfig(n=6, k=4, kind="ss", r=3, messages=2,
                           loads=(3, 1, 2, 3, 2, 1))
    ct = convert.round_config(cj.to_dict())
    assert ct == tspec.RoundConfig(**{f.name: getattr(cj, f.name)
                                      for f in dataclasses.fields(cj)})
    T1 = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (3, 4, 2)))
    T2 = T1.copy()
    T2[0, 1, 1] = np.inf
    a, b = convert.delay_tables(T1, T2, device="cpu")
    assert_bit_equal(a, T1)
    assert_bit_equal(b, T2)
    with pytest.raises(ValueError):
        convert.delay_tables(T1, T2[:, :, :1], device="cpu")
    X, y, th = convert.regression_state(np.ones((4, 3)), np.ones(4),
                                        np.ones(3), device="cpu")
    assert X.dtype == y.dtype == th.dtype == torch.float32
    with pytest.raises(ValueError):
        convert.delay_model("Nope", {})


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", script)
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_example_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, str(REPO / "examples_torch" /
                             "linear_regression_dgd.py"),
         "--iters", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr
    table = out.stdout.strip().splitlines()[-6:]
    assert [row.split()[0] for row in table] == ["CS", "SS", "RA", "ADAPT",
                                                 "PC", "PCMM"]


def test_markov_example_and_fig8_clis_run_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, str(REPO / "examples_torch" /
                             "linear_regression_dgd.py"),
         "--iters", "2", "--device", "cpu", "--cluster", "markov",
         "--persistence", "0.9", "--spread", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "cluster=markov" in out.stdout
    assert out.stdout.strip().splitlines()[-3].split()[0] == "ADAPT"
    out = subprocess.run(
        [sys.executable, str(REPO / "benchmarks_torch" /
                             "fig8_convergence.py"), "--trials", "200",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    rows = out.stdout.strip().splitlines()
    assert len(rows) == 7 and rows[-1].startswith("fig8/adaptive_beats")
    assert "PASS" in rows[-1]
