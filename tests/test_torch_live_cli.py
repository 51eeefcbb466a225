"""The port's live CLI (``python -m repro_torch.launch.live``) and its
cluster helpers (``repro_torch.launch.cluster``) against the JAX
package's (``repro.launch.live``, ``repro.launch.train``): the integer
seeds of ``derive_seeds`` bit for bit (Threefry-2x32 in numpy against
``jax.random.fold_in``), the worker scales ``build_cluster`` builds for
every ``--cluster``, the refusal of ``--scenario`` over a trace, the
reference's flags plus ``--device``, a ``local`` run whose summary and
trace file the reference reads, and ``master`` + ``worker`` over TCP
in-process through ``main(argv)``; and the live-cluster example on the
CPU.  Each thread or process that runs a cluster has a time limit of its
own."""
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro.core import trace as jtrace
from repro.launch import live as jcli
from repro.launch import train as jtrain
from repro_torch.core import RoundConfig
from repro_torch.core import trace as ttrace
from repro_torch.launch import cluster as tcluster
from repro_torch.launch import live as tcli

from torch_parity import REPO

LIMIT_S = 60.0


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 12345, 2**31 - 1, 2**32 + 5,
                                  -3])
def test_derive_seeds_equal_the_references(seed):
    want = jtrain.derive_seeds(seed)
    got = tcluster.derive_seeds(seed)
    assert sorted(got) == sorted(want)
    for key in ("data_seed", "schedule_seed", "cluster_seed"):
        assert type(got[key]) is int and got[key] == want[key], key
    for key in ("init_key", "delay_root"):
        assert got[key].dtype == np.uint32
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


def _args(cluster, **kw):
    base = dict(n=6, cluster=cluster, trace=None, trace_pad="error",
                straggle=False, scenario="none", persistence=0.8, spread=3.0,
                p_slow=0.25, slow=6.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _fields(proc):
    """A process's parameters as plain values (the base model by type and
    fields, a fault overlay's own fields beside its base's)."""
    if not dataclasses.is_dataclass(proc):
        return proc
    out = {"type": type(proc).__name__}
    for f in dataclasses.fields(proc):
        v = getattr(proc, f.name)
        out[f.name] = (_fields(v) if dataclasses.is_dataclass(v)
                       else (tuple(v) if isinstance(v, (list, tuple))
                             else v))
    return out


@pytest.mark.parametrize("cluster,extra", [
    ("iid", {}), ("iid", {"straggle": True}), ("markov", {}),
    ("ar1", {}), ("markov", {"scenario": "preemption"}),
    ("ar1", {"scenario": "partition"})])
def test_build_cluster_builds_the_references(cluster, extra):
    seeds = tcluster.derive_seeds(5)
    got = tcluster.build_cluster(_args(cluster, **extra), seeds)
    want = jtrain.build_cluster(_args(cluster, **extra),
                                jtrain.derive_seeds(5))
    assert _fields(got) == _fields(want)
    if cluster != "iid":
        scales = got.base.worker_scale if extra else got.worker_scale
        assert len(scales) == 6 and len(set(scales)) == 6


def test_build_cluster_replays_traces_and_refuses_overlays(tmp_path):
    gen = np.random.default_rng(0)
    T = (1e-4 * (1 + gen.random((3, 1, 6, 2)))).astype(np.float32)
    path = jtrace.save_trace(str(tmp_path / "t.npz"),
                             jtrace.DelayTrace(T, 2 * T))
    seeds = tcluster.derive_seeds(0)
    got = tcluster.build_cluster(_args("trace", trace=path,
                                       trace_pad="cycle"), seeds)
    assert isinstance(got, ttrace.TraceProcess)
    assert got.pad_rounds == "cycle"
    np.testing.assert_array_equal(got.trace.T2, 2 * T)
    errs = []
    for mod, sd in ((tcluster, seeds), (jtrain, jtrain.derive_seeds(0))):
        with pytest.raises(SystemExit) as e:
            mod.build_cluster(_args("trace", trace=path,
                                    scenario="preemption"), sd)
        errs.append(str(e.value))
        with pytest.raises(SystemExit, match="--cluster trace needs"):
            mod.build_cluster(_args("trace"), sd)
    assert errs[0] == errs[1]


def _flags(main, sub, capsys):
    with pytest.raises(SystemExit):
        main([sub, "--help"])
    return set(re.findall(r"(--[a-z][a-z-]*)", capsys.readouterr().out))


@pytest.mark.parametrize("sub", ["local", "master", "worker"])
def test_flags_are_the_references_plus_device(sub, capsys):
    assert _flags(tcli.main, sub, capsys) == (
        _flags(jcli.main, sub, capsys) | {"--device"})


@pytest.fixture
def round_json(tmp_path):
    path = tmp_path / "round.json"
    RoundConfig(n=4, k=3, kind="cs", r=2, seed=42).save(path)
    return str(path)


def test_local_run_writes_what_the_reference_reads(round_json, tmp_path):
    out, npz = tmp_path / "sum.json", tmp_path / "run.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.live", "local",
         "--config", round_json, "--rounds", "4", "--cluster", "markov",
         "--device", "cpu", "--out", str(out), "--save-trace", str(npz)],
        cwd=REPO, capture_output=True, text=True, timeout=LIMIT_S,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("rounds=4 mean=")
    summary = json.loads(out.read_text())
    trace = jtrace.load_trace(str(npz))
    assert summary["trace_digest"] == trace.header()["digest"]
    assert trace.meta["source"] == "live" and trace.rounds == 4
    assert summary["config"] == RoundConfig.load(round_json).to_dict()
    assert summary["realized"] == [3] * 4 and summary["missed"] == [0] * 4
    assert len(summary["per_round"]) == 4


def _thread(fn, argv, box, key):
    def target():
        try:
            box[key] = fn(argv)
        except BaseException as e:           # reported by the test
            box[key] = e
    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t


def test_master_and_workers_over_tcp(round_json, tmp_path, monkeypatch,
                                     capsys):
    """``master --listen tcp://127.0.0.1:0`` and four ``worker``s, each
    through ``main(argv)`` on a thread of its own; the summary equals the
    ``local`` run of the same config.  Both run with ``--no-abort``: threads
    of their own race a ``close`` against the rest of a round, and only
    dense tables are the same from run to run."""
    ready, bound = threading.Event(), {}
    real_listen = tcli.listen

    async def listen(address):
        lst = await real_listen(address)
        bound["address"] = lst.address
        ready.set()
        return lst
    monkeypatch.setattr(tcli, "listen", listen)
    out_m, out_l = tmp_path / "master.json", tmp_path / "local.json"
    box = {}
    master = _thread(tcli.main, ["master", "--config", round_json,
                                 "--rounds", "3", "--listen",
                                 "tcp://127.0.0.1:0", "--device", "cpu",
                                 "--no-abort", "--out", str(out_m)],
                     box, "master")
    assert ready.wait(LIMIT_S), box
    workers = [_thread(tcli.main, ["worker", "--config", round_json,
                                   "--connect", bound["address"],
                                   "--cluster", "markov", "--device", "cpu"],
                       box, f"w{i}") for i in range(4)]
    for t in [master] + workers:
        t.join(LIMIT_S)
        assert not t.is_alive(), "a live CLI thread hung"
    assert not any(isinstance(v, BaseException) for v in box.values()), box
    tcli.main(["local", "--config", round_json, "--rounds", "3",
               "--cluster", "markov", "--device", "cpu", "--no-abort",
               "--out", str(out_l)])
    got, want = (json.loads(p.read_text()) for p in (out_m, out_l))
    assert got == want
    text = capsys.readouterr().out
    assert text.count("worker done") == 4
    assert "listening on tcp://127.0.0.1:" in text


def test_cli_runs_on_the_card_unless_asked(round_json):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["local", "--config", round_json, "--rounds", "2"])
    with pytest.raises(SystemExit):
        tcli.main(["local", "--config", round_json, "--device", "cpu",
                   "--cluster", "trace"])


def test_live_cluster_example_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, str(REPO / "examples_torch" / "live_cluster.py"),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=LIMIT_S,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "config: cs n=4 k=3 r=2 seed=42 device=cpu"
    assert "replay: mean=" in out.stdout and "(bit-exact: True)" in out.stdout
    assert "close_partial: missed" in out.stdout
    assert lines[-1].endswith("(identical to inproc: True)")
