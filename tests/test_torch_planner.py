"""The racing planner (``repro_torch.core.planner``) and its substrate, the
resumable sweep, the port against the JAX package.

* ``ResumableSweep``: an extension equals a fresh ``sweep`` at the combined
  count bit for bit (dense and ragged, all-k and single-k); its samples
  equal ``completion_samples``; a non-aligned total is terminal, an
  extension must grow, ``narrow`` keeps the survivors' bits.
* ``_enumerate_points``, ``_theory_prune`` (float64 closed forms),
  ``_rung_ladder`` and ``_metric_column`` equal the reference's exactly on
  the same inputs.
* The race against the reference's: one fake engine serves the same
  per-trial samples (a pure function of the spec and the trial) to both
  ``plan``s, through a test-scoped monkeypatch of each planner module's
  ``mc.resumable_sweep`` / ``mc.sweep``; the winner, every point's record,
  the trajectory, the ties, the trials spent and the ``RoundConfig`` JSON
  are equal.  No JAX program is compiled for it.
* The port's ``plan`` on the CPU names its own exhaustive ``stream_grid``
  winner with fewer trial-evaluations; ``PlanResult`` artifacts are read
  both ways; the plan CLI with ``--device cpu`` writes an artifact and a
  ``RoundConfig`` the reference reads.
"""
import dataclasses
import json
import zlib

import numpy as np
import pytest
import torch

from repro.core import delays as jd
from repro.core import grid as jg
from repro.core import planner as jp
from repro.core import spec as jspec
from repro.core import theory as jth
from repro_torch.core import delays as td
from repro_torch.core import grid as tg
from repro_torch.core import montecarlo as tm
from repro_torch.core import planner as tp
from repro_torch.core import scheduling as ts
from repro_torch.core import theory as tth
from repro_torch.core.spec import RoundConfig
from repro_torch.launch import plan as plan_cli
from torch_parity import one_thread  # noqa: F401

MODEL = td.scenario1()
N = 8
CPU = "cpu"


def _specs(ragged: bool):
    C = ts.cyclic_to_matrix(N, 4)
    if ragged:
        loads = np.array([4, 3, 2, 1, 4, 3, 2, 1])
        return [tm.to_spec("a", C, loads=loads), tm.lb_spec(4, name="b"),
                tm.pc_spec(4, name="c")]
    return [tm.to_spec("a", C), tm.lb_spec(4, name="b"),
            tm.pcmm_spec(4, name="c", messages=2)]


def _assert_same_result(got, want):
    assert sorted(got.means) == sorted(want.means)
    for nm in want.means:
        np.testing.assert_array_equal(got.means[nm], want.means[nm])
        np.testing.assert_array_equal(got.stderr[nm], want.stderr[nm])
    assert got.trials == want.trials and got.fixed == want.fixed


# ------------------------------ ResumableSweep ---------------------------------

@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("ks", [None, 5])
def test_extension_equals_a_fresh_sweep(ragged, ks):
    rs = tm.resumable_sweep(_specs(ragged), MODEL, N, seed=3, chunk=64,
                            ks=ks, devices=CPU)
    for total in (128, 256, 1024, 1100):
        got = rs.extend_trials(total)
        fresh = tm.sweep(_specs(ragged), MODEL, N, trials=total, seed=3,
                         chunk=64, ks=ks, devices=CPU)
        _assert_same_result(got, fresh)
        _assert_same_result(rs.result(), fresh)
    assert rs.trials == 1100 and rs.chunk == 64
    assert rs.spec_names == ("a", "b", "c")


@pytest.mark.parametrize("k", [None, 5])
def test_samples_equal_completion_samples(k):
    rs = tm.resumable_sweep(_specs(False), MODEL, N, seed=1, chunk=32, ks=k,
                            devices=CPU, keep_samples=True)
    rs.extend_trials(64)
    rs.extend_trials(150)
    got = rs.samples()
    for sp in _specs(False):
        ref = tm.completion_samples(sp, MODEL, N, trials=150, seed=1,
                                    chunk=32, k=k, devices=CPU)
        assert got[sp.name].dtype == np.float32
        np.testing.assert_array_equal(got[sp.name].reshape(ref.shape),
                                      ref.numpy())


def test_non_aligned_extension_is_terminal():
    rs = tm.resumable_sweep(_specs(False), MODEL, N, chunk=64, devices=CPU)
    with pytest.raises(ValueError, match="no trials"):
        rs.result()
    _assert_same_result(rs.extend_trials(100),
                        tm.sweep(_specs(False), MODEL, N, trials=100,
                                 chunk=64, devices=CPU))
    with pytest.raises(ValueError, match="multiple of chunk"):
        rs.extend_trials(200)


def test_extension_must_grow_and_other_refusals():
    rs = tm.resumable_sweep(_specs(False), MODEL, N, chunk=64, devices=CPU)
    rs.extend_trials(64)
    with pytest.raises(ValueError, match="must exceed"):
        rs.extend_trials(64)
    with pytest.raises(ValueError, match="keep_samples"):
        rs.samples()
    with pytest.raises(ValueError, match="chunk must be"):
        tm.resumable_sweep(_specs(False), MODEL, N, chunk=0, devices=CPU)
    # two devices: the same extensions, bit for bit
    rs2 = tm.resumable_sweep(_specs(False), MODEL, N, chunk=8,
                             devices=["cpu", "cpu"])
    rs1 = tm.resumable_sweep(_specs(False), MODEL, N, chunk=8, devices=CPU)
    for total in (24, 64):
        _assert_same_result(rs2.extend_trials(total),
                            rs1.extend_trials(total))


def test_narrow_keeps_the_survivors_bitwise():
    rs = tm.resumable_sweep(_specs(False), MODEL, N, seed=7, chunk=64,
                            devices=CPU, keep_samples=True)
    rs.extend_trials(128)
    rs.narrow(["a", "c"])
    rs.extend_trials(512)
    # the survivors equal a fresh run of the whole stack (the draws keep
    # the original r_max)
    fresh = tm.sweep(_specs(False), MODEL, N, trials=512, seed=7, chunk=64,
                     devices=CPU)
    got = rs.result()
    assert sorted(got.means) == ["a", "c"]
    for nm in ("a", "c"):
        np.testing.assert_array_equal(got.means[nm], fresh.means[nm])
        np.testing.assert_array_equal(got.stderr[nm], fresh.stderr[nm])
    assert rs.samples()["a"].shape == (512, N)
    with pytest.raises(ValueError, match="unknown"):
        rs.narrow(["nope"])
    with pytest.raises(ValueError, match="at least one"):
        rs.narrow([])


# ------------------------ the planner's parts, exactly -------------------------

GRIDS = {
    "paper": dict(n=8, families=("cs", "ss", "ra", "lb", "pc", "pcmm"),
                  loads=(2, 4, 8), messages=(None, 2), comm_eps=(0.0, 0.02)),
    "targets": dict(n=6, families=("cs", "ss", "lb", "pc"), loads=(2, 3, 6),
                    messages=(None, 1), ks=(None, 2, 5)),
    "no_coded": dict(n=5, families=("cs", "lb"), loads=(1, 5),
                     comm_eps=(0.0, 0.05)),
}


def _grids(name, trials=2048, seed=0, chunk=None):
    kw = dict(GRIDS[name], trials=trials, seed=seed, chunk=chunk)
    return tg.GridSpec(**kw), jg.GridSpec(**kw)


def _spec_fields(sp):
    return (sp.name, sp.kind, sp.C, sp.r, sp.messages, sp.loads,
            sp.rebalance, sp.comm_eps)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("k", [None, 3])
def test_enumerate_points_equals_the_reference(grid, k):
    gt, gj = _grids(grid)
    kd = gt.n if k is None else k
    st, pt, et = tp._enumerate_points(gt, kd)
    sj, pj, ej = jp._enumerate_points(gj, kd)
    assert list(st) == list(sj) and et == ej
    assert [_spec_fields(sp) for sp in st.values()] == [
        _spec_fields(sp) for sp in sj.values()]
    assert [dataclasses.asdict(p) for p in pt] == [
        dataclasses.asdict(p) for p in pj]


@pytest.mark.parametrize("grid", ["paper", "targets"])
@pytest.mark.parametrize("slack", [0.0, 0.25, 1.0])
def test_theory_prune_equals_the_reference(grid, slack):
    gt, gj = _grids(grid)
    _, pt, _ = tp._enumerate_points(gt, gt.n)
    _, pj, _ = jp._enumerate_points(gj, gj.n)
    pdf_t = tth.delay_model_pdfs(td.scenario1())
    pdf_j = jth.delay_model_pdfs(jd.scenario1())
    pruned_t, kept_t, pred_t = tp._theory_prune(pt, pdf_t, gt.n, slack)
    pruned_j, kept_j, pred_j = jp._theory_prune(pj, pdf_j, gj.n, slack)
    assert pruned_t == pruned_j and pred_t == pred_j
    assert [p.name for p in kept_t] == [p.name for p in kept_j]


@pytest.mark.parametrize("trials,base,eta", [(2048, 256, 4), (2048, 256, 2),
                                             (300, 256, 4), (256, 256, 3),
                                             (10000, 313, 4), (7, 1, 2)])
def test_rung_ladder_equals_the_reference(trials, base, eta):
    assert tp._rung_ladder(trials, base, eta) == jp._rung_ladder(trials,
                                                                 base, eta)


@pytest.mark.parametrize("cols,k", [(1, 1), (8, 1), (8, 5), (8, 8)])
def test_metric_column_equals_the_reference(cols, k):
    x = np.random.default_rng(cols + k).random((33, cols)).astype(np.float32)
    pt = tp._Point("p", "p", "cs", 2, None, 0.0, k, False)
    pj = jp._Point("p", "p", "cs", 2, None, 0.0, k, False)
    got = tp._metric_column(x, pt, 8)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jp._metric_column(x, pj, 8))


# --------------------- the race on shared samples (fake engine) ----------------

def _fake_table(name: str, L: int, trials: int, spread: float):
    """Per-trial float32 samples of one racing spec: a pure function of its
    name, so any grouping of specs into sweeps reads the same rows."""
    h = zlib.crc32(name.encode())
    gen = np.random.default_rng(h)
    mean = 1.0 + spread * (h % 1000) / 1000.0
    base = mean + 0.01 * np.arange(L)                # rises with k
    return (base + 0.05 * gen.standard_normal((trials, L))).astype(
        np.float32)


def _fake_engine(trials: int, spread: float):
    calls = []

    class FakeSweep:
        def __init__(self, specs, model, n, *, seed=0, chunk, ks=None,
                     devices=None, keep_samples=False):
            assert ks is None and keep_samples
            self._tables = {sp.name: _fake_table(
                sp.name, 1 if sp.kind in ("pc", "pcmm") else n, trials,
                spread) for sp in specs}
            self._names = [sp.name for sp in specs]
            self._done = 0
            calls.append(("new", tuple(self._names), chunk))

        @property
        def spec_names(self):
            return tuple(self._names)

        def extend_trials(self, total):
            assert total > self._done
            self._done = total

        def samples(self):
            return {nm: self._tables[nm][:self._done] for nm in self._names}

        def narrow(self, names):
            assert names and set(names) <= set(self._names)
            self._names = [nm for nm in self._names if nm in set(names)]

    class FakeLB:
        def __init__(self, spec):
            self.r = spec.r

        def at_k(self, name, k):
            return 0.9 + 0.001 * k + 0.0001 * self.r

    def fake_sweep(specs, model, n, **kw):
        assert [sp.kind for sp in specs] == ["lb"]
        return FakeLB(specs[0])

    return FakeSweep, fake_sweep, calls


RACES = [("paper", 4, 3.0, 0.05), ("paper", 2, 2.0, 0.02),
         ("targets", 4, 3.0, 0.05), ("no_coded", 2, 3.0, 0.2)]


@pytest.mark.parametrize("grid,eta,z,spread", RACES)
@pytest.mark.parametrize("prune", [True, False])
def test_race_equals_the_reference_on_shared_samples(monkeypatch, grid, eta,
                                                     z, spread, prune):
    trials = 4096
    gt, gj = _grids(grid, trials=trials)
    out = {}
    for side, mod, gs, model in (("port", tp, gt, td.scenario1()),
                                 ("ref", jp, gj, jd.scenario1())):
        fake_rs, fake_sweep, calls = _fake_engine(trials, spread)
        monkeypatch.setattr(mod.mc, "resumable_sweep", fake_rs)
        monkeypatch.setattr(mod.mc, "sweep", fake_sweep)
        kw = {"devices": CPU} if side == "port" else {}
        out[side] = (mod.plan(gs, model, k=gs.n - 1, base_trials=256,
                              eta=eta, z=z, theory_prune=prune, **kw), calls)
    got, want = out["port"][0], out["ref"][0]
    assert got.winner == want.winner
    assert got.points == want.points
    assert got.trajectory == want.trajectory
    assert got.meta["ties"] == want.meta["ties"]
    assert got.trials_spent == want.trials_spent
    assert got.exhaustive_trials == want.exhaustive_trials
    assert (got.predicted_mean, got.predicted_stderr, got.lb_mean,
            got.lb_gap) == (want.predicted_mean, want.predicted_stderr,
                            want.lb_mean, want.lb_gap)
    assert got.config_note == want.config_note
    if want.config is not None:
        assert got.config.to_json() == want.config.to_json()
    else:
        assert got.config is None
    for key in ("n", "k", "eta", "z", "base_trials", "chunk", "ladder",
                "theory_pruned", "raced_points", "excluded",
                "exhaustive_cells"):
        assert got.meta[key] == want.meta[key], key
    assert len({st for rec in got.points.values()
                for st in [rec["status"]]}) >= 3
    # the port draws each load at its own width: one sweep a load
    loads = {p.r for p in tp._enumerate_points(gt, gt.n)[1]}
    n_new = sum(1 for c in out["port"][1] if c[0] == "new")
    assert n_new <= len(loads)


def test_race_artifacts_read_both_ways(monkeypatch, tmp_path):
    trials = 2048
    gt, gj = _grids("paper", trials=trials)
    paths = {}
    for side, mod, gs, model in (("port", tp, gt, td.scenario1()),
                                 ("ref", jp, gj, jd.scenario1())):
        fake_rs, fake_sweep, _ = _fake_engine(trials, 0.05)
        monkeypatch.setattr(mod.mc, "resumable_sweep", fake_rs)
        monkeypatch.setattr(mod.mc, "sweep", fake_sweep)
        kw = {"devices": CPU} if side == "port" else {}
        res = mod.plan(gs, model, k=gs.n, base_trials=256, **kw)
        paths[side] = res.save(str(tmp_path / f"{side}.json"))
    for path in paths.values():
        on_port = tp.PlanResult.load(path)
        on_ref = jp.PlanResult.load(path)
        for f in ("winner", "predicted_mean", "predicted_stderr", "points",
                  "trajectory", "trials_spent", "exhaustive_trials",
                  "lb_mean", "lb_gap", "config_note"):
            assert getattr(on_port, f) == getattr(on_ref, f), f
        assert on_port.savings == on_ref.savings
        assert ((on_port.config is None and on_ref.config is None)
                or on_port.config.to_json() == on_ref.config.to_json())
    doc = json.loads(open(paths["port"]).read())
    doc["version"] = tp.PLAN_FORMAT_VERSION + 1
    future = tmp_path / "future.json"
    future.write_text(json.dumps(doc))
    for mod in (tp, jp):
        with pytest.raises(ValueError, match="newer"):
            mod.PlanResult.load(str(future))
    future.write_text(json.dumps({"kind": "grid-result"}))
    with pytest.raises(ValueError, match="not a plan-result"):
        tp.PlanResult.load(str(future))


# ------------------------- the real race on the CPU ----------------------------

GS = tg.GridSpec(n=N, families=("cs", "ss", "lb", "pc"), loads=(2, 4, 8),
                 messages=(None, 2), trials=2048, seed=0)


@pytest.fixture(scope="module")
def planned():
    return tp.plan(GS, MODEL, k=N, base_trials=256, eta=4, devices=CPU)


def test_plan_finds_the_exhaustive_winner_with_fewer_trials(planned):
    grid = tg.stream_grid(GS.cells(MODEL), devices=CPU)
    best = grid.best_cell(k=N)
    assert planned.winner == best["cell"]
    # every point reads its grid cell's draws: the winning means differ by
    # the float64 sample mean against the float32 chunk partials only
    assert planned.predicted_mean == pytest.approx(best["mean"], rel=1e-6)
    assert planned.trials_spent < planned.exhaustive_trials
    assert planned.exhaustive_trials == len(GS.cells(MODEL)) * GS.trials
    assert planned.points[planned.winner]["trials"] == GS.trials
    assert planned.trajectory[-1]["trials"] == GS.trials
    assert planned.meta["devices"] == "cpu"


def test_plan_records_cover_every_cell(planned):
    assert len(planned.points) == len(GS.cells(MODEL))
    statuses = {r["status"] for r in planned.points.values()}
    assert statuses <= {"won", "survived", "eliminated", "pruned",
                        "excluded"}
    assert sum(r["status"] == "won" for r in planned.points.values()) == 1
    for nm, r in planned.points.items():
        if nm.startswith("lb"):
            assert r["status"] == "excluded"
        if r["status"] == "eliminated":
            assert r["trials"] < GS.trials and r["gap"] > 0.0
    assert planned.lb_gap >= 0.0 and planned.config.k == N


def test_plan_decisions_chunk_invariant(planned):
    again = tp.plan(dataclasses.replace(GS, chunk=128), MODEL, k=N,
                    base_trials=256, eta=4, devices=CPU)
    assert again.winner == planned.winner
    assert again.trajectory == planned.trajectory
    assert again.trials_spent == planned.trials_spent


def test_plan_refusals():
    with pytest.raises(ValueError, match="1 <= k"):
        tp.plan(GS, MODEL, k=N + 1, devices=CPU)
    with pytest.raises(ValueError, match="eta"):
        tp.plan(GS, MODEL, eta=1, devices=CPU)
    with pytest.raises(ValueError, match="z must"):
        tp.plan(GS, MODEL, z=0.0, devices=CPU)
    with pytest.raises(ValueError, match="multiple"):
        tp.plan(dataclasses.replace(GS, chunk=96), MODEL, k=N,
                base_trials=256, devices=CPU)
    with pytest.raises(ValueError, match="raceable"):
        tp.plan(tg.GridSpec(n=4, families=("lb",), trials=64), MODEL,
                devices=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tp.plan(GS, MODEL)


# --------------------------------- the CLI -------------------------------------

def test_plan_cli_writes_what_the_reference_reads(tmp_path, capsys):
    out = tmp_path / "plan.json"
    cfg = tmp_path / "cfg" / "round.json"
    rc = plan_cli.main([
        "--n", str(N), "--families", "cs", "ss", "lb", "pc",
        "--loads", "2", "4", "8", "--trials", "1024",
        "--base-trials", "256", "--k", str(N), "--device", "cpu",
        "--out", str(out), "--emit-config", str(cfg)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "winner:" in text and "saved" in text
    ref = jp.PlanResult.load(str(out))
    port = tp.PlanResult.load(str(out))
    assert ref.winner == port.winner and ref.savings > 1.0
    assert port.meta["devices"] == "cpu" and port.meta["model"] == "scenario1"
    loaded = jspec.RoundConfig.load(cfg)
    assert loaded.to_json() == port.config.to_json()
    assert RoundConfig.load(cfg) == port.config
    assert cfg.read_text() == port.config.to_json() + "\n"
    # --devices 4 on the CPU: four blocks, the same race and winner
    out4 = tmp_path / "plan4.json"
    assert plan_cli.main([
        "--n", str(N), "--families", "cs", "ss", "lb", "pc",
        "--loads", "2", "4", "8", "--trials", "1024",
        "--base-trials", "256", "--k", str(N), "--device", "cpu",
        "--devices", "4", "--out", str(out4)]) == 0
    port4 = tp.PlanResult.load(str(out4))
    assert port4.meta["devices"] == "cpu,cpu,cpu,cpu"
    assert port4.winner == port.winner and port4.savings == port.savings
    assert port4.predicted_mean == port.predicted_mean
    assert port4.points == port.points


@pytest.mark.parametrize("kind,r,messages,eps", [("cs", 4, None, 0.0),
                                                 ("ss", 2, 2, 0.02),
                                                 ("ra", 8, 1, 0.0)])
def test_round_config_json_byte_equal(kind, r, messages, eps):
    kw = dict(n=8, k=7, kind=kind, r=r, messages=messages, comm_eps=eps,
              seed=3)
    assert RoundConfig(**kw).to_json() == jspec.RoundConfig(**kw).to_json()
