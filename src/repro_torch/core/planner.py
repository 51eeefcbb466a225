"""Racing planner: a successive-halving search for a ``GridSpec``'s argmin
operating point; counterpart of ``repro.core.planner``.

The paper's question -- which (scheme family, load r, message budget,
overhead, target k) minimizes the average round completion time (eq. 5)
-- is answered exhaustively by ``stream_grid``: every feasible cell at the
full trial count.  Most cells are plainly dominated after a few hundred
trials, so the planner spends trials only where the decision is close:

1. **Theory pruning** (no trials).  Where the delay model's marginals have
   a closed form (``theory.delay_model_pdfs``), each point's oracle lower
   bound (eq. 46, ``theory.operating_point_mean_lb``) is held against the
   best closed-form *achievable* mean (the coded schemes' eqs. 51-52 /
   56-57): a point whose bound exceeds that anchor by the slack factor
   cannot win and leaves before any sampling.
2. **Paired racing under common random numbers.**  The surviving points
   of each load run in one ``ResumableSweep``, whose delays are drawn at
   that load's slot-grid width, as ``stream_grid`` draws that load's
   cells: every point reads exactly the per-trial samples of its
   exhaustive grid cell.  Two points compare by their paired per-trial
   differences (common random numbers within a load; across loads the
   pairs are independent draws, and the paired-gap stderr is then that of
   two independent samples).  A point leaves when the lower confidence
   bound of its gap to the incumbent (the current argmin) clears zero at
   ``z`` sigmas.  (The JAX package races every point in one sweep drawn
   at the grid's largest load, so a point there reads other draws than
   its grid cell, and a near-tie can resolve differently from the
   exhaustive grid; the decisions from given samples are the same.)
3. **A geometric rung ladder.**  Trials grow by ``eta`` a rung and the
   survivors are *extended*: a point raced to the last rung costs exactly
   the trials of a fresh full run, an eliminated one only the rungs it
   survived.  The last rung's survivors reach ``GridSpec.trials``, so the
   argmin carries the exhaustive grid's confidence.

The result is a versioned ``PlanResult`` artifact with the JAX package's
schema: the recommended ``RoundConfig``, the gap to the lower bound, the
trials spent against the exhaustive count and every point's fate.  CLI:
``python -m repro_torch.launch.plan``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Dict, Optional

import numpy as np

from .. import sharding
from . import montecarlo as mc
from . import theory
from .grid import GridSpec, _cell_name, _family_spec, _jsonable
from .spec import RoundConfig

__all__ = ["plan", "PlanResult", "PLAN_FORMAT_VERSION"]

PLAN_FORMAT_VERSION = 1

#: families the planner emits a ``RoundConfig`` for (the TO-matrix
#: schedules a round runs; a coded winner is reported without one).
_CONFIG_FAMILIES = ("cs", "ss", "ra")


@dataclasses.dataclass(frozen=True)
class _Point:
    """One operating point: a scheme spec and a computation target.
    Points sharing a spec (several targets) race on its columns."""
    name: str                 # grid cell name (the exhaustive grid's key)
    spec_name: str            # racing spec it reads
    family: str
    r: int
    messages: Optional[int]
    comm_eps: float
    k: int                    # effective target (coded: decode threshold)
    coded: bool               # pc/pcmm: metric is their single column


@dataclasses.dataclass
class PlanResult:
    """Outcome of one planner run.

    ``points[name]`` records each point's fate: ``status`` (``won`` /
    ``survived`` / ``eliminated`` / ``pruned`` / ``excluded``), the trials
    it took, its mean / stderr there, the rung it left the race at, its
    paired gap to the incumbent and the theory guides where available.
    ``trajectory`` is the per-rung history.  ``config`` is the
    recommended ``RoundConfig`` for a TO-matrix winner (cs / ss / ra),
    else None with ``config_note`` saying why.  ``trials_spent`` counts
    every trial-evaluation (the race and the final lower-bound run);
    ``exhaustive_trials`` is what ``stream_grid`` spends on the same grid
    (cells x trials)."""
    winner: str
    predicted_mean: float
    predicted_stderr: float
    config: Optional[RoundConfig]
    config_note: Optional[str]
    points: Dict[str, dict]
    trajectory: list
    trials_spent: int
    exhaustive_trials: int
    lb_mean: Optional[float]
    lb_gap: Optional[float]
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def savings(self) -> float:
        """Exhaustive trial-evaluations per trial-evaluation spent."""
        return (self.exhaustive_trials / self.trials_spent
                if self.trials_spent else float("inf"))

    def to_json(self) -> dict:
        return {
            "version": PLAN_FORMAT_VERSION, "kind": "plan-result",
            "winner": self.winner,
            "predicted_mean": self.predicted_mean,
            "predicted_stderr": self.predicted_stderr,
            "config": (None if self.config is None
                       else self.config.to_dict()),
            "config_note": self.config_note,
            "points": _jsonable(self.points),
            "trajectory": _jsonable(self.trajectory),
            "trials_spent": self.trials_spent,
            "exhaustive_trials": self.exhaustive_trials,
            "lb_mean": self.lb_mean, "lb_gap": self.lb_gap,
            "meta": _jsonable(self.meta),
        }

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)
        return path

    @classmethod
    def load(cls, path: str) -> "PlanResult":
        with open(path) as fh:
            doc = json.load(fh)
        if doc.get("kind") != "plan-result":
            raise ValueError(f"{path}: not a plan-result artifact "
                             f"(kind={doc.get('kind')!r})")
        v = doc.get("version", 0)
        if v > PLAN_FORMAT_VERSION:
            raise ValueError(f"{path}: plan-result version {v} is newer "
                             f"than this reader ({PLAN_FORMAT_VERSION})")
        cfg = doc.get("config")
        return cls(
            winner=doc["winner"], predicted_mean=doc["predicted_mean"],
            predicted_stderr=doc["predicted_stderr"],
            config=None if cfg is None else RoundConfig.from_dict(cfg),
            config_note=doc.get("config_note"),
            points=doc["points"], trajectory=doc["trajectory"],
            trials_spent=doc["trials_spent"],
            exhaustive_trials=doc["exhaustive_trials"],
            lb_mean=doc.get("lb_mean"), lb_gap=doc.get("lb_gap"),
            meta=doc.get("meta", {}))


def _enumerate_points(gs: GridSpec, k_default: int):
    """The grid's operating points and the deduplicated racing specs.

    Points that differ only in the target ``k`` share one spec (``k`` is
    a column of the all-k statistic), so the race carries each (family,
    r, messages, eps) spec once.  ``lb`` cells stay out of the race (the
    oracle bound beats every schedule at its own load and cannot be
    scheduled); it returns as the winner's predicted-vs-LB gap."""
    specs: Dict[str, mc.SchemeSpec] = {}
    points: list[_Point] = []
    excluded: list[str] = []
    for r in gs.loads:
        for fam in gs.families:
            for m in gs.messages:
                for eps in gs.comm_eps:
                    sp = _family_spec(fam, gs.n, r, m, eps, gs.seed)
                    if sp is None:
                        continue
                    sname = _cell_name(fam, r, m, eps, None)
                    for k in gs.ks:
                        cname = _cell_name(fam, r, m, eps, k)
                        if fam == "lb":
                            excluded.append(cname)
                            continue
                        coded = fam in ("pc", "pcmm")
                        if coded:
                            k_eff = (mc._pc_threshold(gs.n, r) if fam == "pc"
                                     else mc._pcmm_threshold(gs.n))
                        else:
                            k_eff = k if k is not None else k_default
                        if sname not in specs:
                            specs[sname] = dataclasses.replace(sp, name=sname)
                        points.append(_Point(
                            name=cname, spec_name=sname, family=fam, r=r,
                            messages=m, comm_eps=eps, k=int(k_eff),
                            coded=coded))
    if not points:
        raise ValueError("grid has no raceable operating points (only lb "
                         "cells?); nothing to plan")
    names = [p.name for p in points]
    if len(set(names)) != len(names):       # duplicate (fam,r,m,eps,k)
        raise ValueError(f"duplicate operating points in grid: "
                         f"{sorted(nm for nm in set(names) if names.count(nm) > 1)}")
    return specs, points, excluded


def _theory_prune(points, pdfs, n: int, slack: float):
    """``(pruned names -> guide record, kept points, predicted means)``.

    The anchor is the smallest closed-form *achievable* mean among the
    grid's coded points (eqs. 51-52 / 56-57).  A point whose oracle
    lower-bound guide exceeds ``(1 + slack) * anchor`` cannot be the
    argmin.  Both sides assume in-order delivery within a worker
    (``theory.multimessage_coded_tail``); the slack absorbs that, so the
    pruning stays conservative."""
    pdf1, pdf2, sup1, sup2 = pdfs

    def _tmax(p: _Point) -> float:
        m_eff = p.r if p.messages is None else min(p.messages, p.r)
        return 1.25 * (p.r * sup1 + sup2 + m_eff * p.comm_eps)

    anchor = None
    predicted: Dict[str, float] = {}
    for p in points:
        if not p.coded:
            continue
        if p.family == "pc":
            mu = theory.multimessage_coded_mean(
                n, p.r, 1, pdf1, pdf2, tmax=_tmax(p),
                threshold=mc._pc_threshold(n, p.r))
        else:
            m_eff = p.r if p.messages is None else min(p.messages, p.r)
            mu = theory.multimessage_coded_mean(
                n, p.r, m_eff, pdf1, pdf2, tmax=_tmax(p))
        predicted[p.name] = mu
        anchor = mu if anchor is None else min(anchor, mu)
    if anchor is None:          # no closed-form achievable mean to prune on
        return {}, list(points), predicted
    pruned: Dict[str, dict] = {}
    kept = []
    for p in points:
        guide = theory.operating_point_mean_lb(
            n, p.r, p.k, pdf1, pdf2, messages=p.messages,
            comm_eps=p.comm_eps, tmax=_tmax(p))
        if guide > (1.0 + slack) * anchor:
            pruned[p.name] = {"lb_guide": guide, "anchor": anchor}
        else:
            kept.append(p)
    if not kept:                # slack misconfigured: never prune everything
        return {}, list(points), predicted
    return pruned, kept, predicted


def _rung_ladder(trials: int, base: int, eta: int) -> list[int]:
    """Geometric rung totals ``base * eta^j`` capped at ``trials`` (the
    last rung lands exactly on ``trials``)."""
    ladder, t = [], base
    while t < trials:
        ladder.append(t)
        t *= eta
    ladder.append(trials)
    return ladder


def _metric_column(samp: np.ndarray, p: _Point, n: int) -> np.ndarray:
    """Per-trial completion times of one operating point, float64: TO and
    lb specs carry one column per k in all-k mode, coded specs their own
    decode threshold in one column."""
    x = np.asarray(samp, np.float64)
    if x.shape[1] == 1:
        return x[:, 0]
    return x[:, p.k - 1]


def plan(grid: GridSpec, model, *, k: Optional[int] = None,
         base_trials: Optional[int] = None, eta: int = 4, z: float = 3.0,
         theory_prune: bool = True, prune_slack: float = 0.25,
         devices=None) -> PlanResult:
    """The grid's argmin operating point by successive-halving racing
    (see the module docstring) instead of exhaustive streaming.

    ``grid``: the ``GridSpec`` to search (``grid.trials`` is the last
    rung's, and the exhaustive sweep's, trial count).  ``model``: the
    delay model.  ``k``: the target of all-k points (default ``n``); cells
    with an explicit ``ks`` race at their own.  ``base_trials``: the first
    rung (default ``grid.trials / eta^3``, at least 256), also the racing
    chunk when ``grid.chunk`` is unset, so every rung but the last stays
    chunk-aligned.  ``eta``: rung growth (>= 2).  ``z``: the elimination
    threshold in paired-gap sigmas, also the survivors' tie report.
    ``theory_prune`` / ``prune_slack``: the closed-form stage (only where
    ``theory.delay_model_pdfs(model)`` knows the marginals and coded cells
    anchor it).  ``devices`` shards every rung's sweep, as in ``sweep``.

    The race runs in all-k mode (one sort a trial serves every target),
    one resumable sweep a load, and compares points by paired per-trial
    differences."""
    t0 = time.perf_counter()
    devs = sharding.trial_devices(devices)
    n = grid.n
    k_default = n if k is None else int(k)
    if not 1 <= k_default <= n:
        raise ValueError(f"need 1 <= k <= n={n}, got k={k_default}")
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")
    if z <= 0:
        raise ValueError(f"z must be > 0, got {z}")

    specs, points, excluded = _enumerate_points(grid, k_default)
    exhaustive_cells = len(points) + len(excluded)
    exhaustive_trials = exhaustive_cells * grid.trials

    records: Dict[str, dict] = {}
    for cname in excluded:
        records[cname] = {"status": "excluded", "trials": 0,
                          "note": "lb is the oracle bound, not a "
                                  "schedulable operating point; it returns "
                                  "as the final predicted-vs-LB gap"}

    # ---- layer 1: closed-form dominance pruning (no trials) -------------
    predicted: Dict[str, float] = {}
    pdfs = theory.delay_model_pdfs(model) if theory_prune else None
    if pdfs is not None:
        pruned, points, predicted = _theory_prune(points, pdfs, n,
                                                  prune_slack)
        for cname, rec in pruned.items():
            records[cname] = {"status": "pruned", "trials": 0, **rec}

    # ---- rung ladder ----------------------------------------------------
    if base_trials is None:
        base_trials = max(256, -(-grid.trials // eta ** 3))
    base_trials = int(min(base_trials, grid.trials))
    chunk = grid.chunk if grid.chunk is not None else base_trials
    chunk = int(min(chunk, base_trials))
    if base_trials % chunk:
        raise ValueError(
            f"base_trials ({base_trials}) must be a multiple of the grid "
            f"chunk ({chunk}) so every rung total stays chunk-aligned for "
            f"the resumable extension")
    ladder = _rung_ladder(grid.trials, base_trials, eta)

    # ---- layers 2 and 3: the paired successive-halving race -------------
    # one resumable sweep a load: its draws are the grid cells' of that load
    alive = list(points)
    needed = {p.spec_name for p in alive}
    by_load: Dict[int, list] = {}
    for nm, sp in specs.items():
        if nm in needed:
            by_load.setdefault(sp.load, []).append(sp)
    sweeps = [mc.resumable_sweep(grp, model, n, seed=grid.seed, chunk=chunk,
                                 ks=None, devices=devs, keep_samples=True)
              for grp in by_load.values()]
    trajectory: list[dict] = []
    spec_trials: Dict[str, int] = {}

    def _samples() -> Dict[str, np.ndarray]:
        return {nm: x for rs in sweeps for nm, x in rs.samples().items()}

    for rung, t in enumerate(ladder):
        for rs in sweeps:
            rs.extend_trials(t)
        samp = _samples()
        cols = {p.name: _metric_column(samp[p.spec_name], p, n)
                for p in alive}
        means = {nm: float(x.mean()) for nm, x in cols.items()}
        inc = min(alive, key=lambda p: means[p.name])   # incumbent argmin
        x_inc = cols[inc.name]
        eliminated: list[dict] = []
        survivors: list[_Point] = []
        for p in alive:
            if p is inc:
                survivors.append(p)
                continue
            d = cols[p.name] - x_inc                    # paired gap
            gap = float(d.mean())
            gap_se = float(d.std(ddof=1) / math.sqrt(t)) if t > 1 else 0.0
            if rung < len(ladder) - 1 and gap - z * gap_se > 0.0:
                x = cols[p.name]
                records[p.name] = {
                    "status": "eliminated", "trials": t, "rung": rung,
                    "mean": means[p.name],
                    "stderr": float(x.std(ddof=1) / math.sqrt(t)),
                    "gap": gap, "gap_stderr": gap_se,
                    "vs": inc.name,
                }
                eliminated.append({"point": p.name, "gap": gap,
                                   "gap_stderr": gap_se})
            else:
                survivors.append(p)
        trajectory.append({
            "rung": rung, "trials": t, "incumbent": inc.name,
            "survivors": [p.name for p in survivors],
            "eliminated": [e["point"] for e in eliminated],
        })
        dropped_specs = ({p.spec_name for p in alive}
                         - {p.spec_name for p in survivors})
        for snm in dropped_specs:
            spec_trials[snm] = t
        alive = survivors
        if rung < len(ladder) - 1 and dropped_specs:
            keep = {p.spec_name for p in alive}
            narrowed = []
            for rs in sweeps:
                names = [nm for nm in rs.spec_names if nm in keep]
                if len(names) < len(rs.spec_names) and names:
                    rs.narrow(names)
                if names:
                    narrowed.append(rs)
            sweeps = narrowed
    for snm in {p.spec_name for p in alive}:
        spec_trials[snm] = grid.trials

    # ---- final selection and the survivors' records ---------------------
    samp = _samples()
    final_cols = {p.name: _metric_column(samp[p.spec_name], p, n)
                  for p in alive}
    winner = min(alive, key=lambda p: float(final_cols[p.name].mean()))
    w_x = final_cols[winner.name]
    w_mean = float(w_x.mean())
    w_se = float(w_x.std(ddof=1) / math.sqrt(grid.trials))
    for p in alive:
        x = final_cols[p.name]
        rec = {"status": "won" if p is winner else "survived",
               "trials": grid.trials, "mean": float(x.mean()),
               "stderr": float(x.std(ddof=1) / math.sqrt(grid.trials))}
        if p is not winner:
            d = x - w_x
            rec["gap"] = float(d.mean())
            rec["gap_stderr"] = float(d.std(ddof=1)
                                      / math.sqrt(grid.trials))
            rec["vs"] = winner.name
        records[p.name] = rec
    for nm, mu in predicted.items():
        if nm in records:
            records[nm]["theory_mean"] = mu

    # ---- the winner's gap to the lower bound ----------------------------
    trials_spent = sum(spec_trials.values())
    lb_sp = mc.lb_spec(winner.r, messages=winner.messages,
                       comm_eps=winner.comm_eps)
    lb_res = mc.sweep([lb_sp], model, n, trials=grid.trials,
                      seed=grid.seed, chunk=chunk, ks=None, devices=devs)
    # a coded winner recovers the full gradient at its decode threshold,
    # so the comparable oracle target is k = n (the threshold can exceed n)
    lb_mean = lb_res.at_k("lb", n if winner.coded else winner.k)
    lb_gap = (w_mean - lb_mean) / lb_mean if lb_mean > 0 else float("inf")
    trials_spent += grid.trials

    # ---- RoundConfig ----------------------------------------------------
    config = config_note = None
    if winner.family in _CONFIG_FAMILIES:
        config = RoundConfig(
            n=n, k=winner.k, kind=winner.family, r=winner.r,
            messages=winner.messages, comm_eps=winner.comm_eps,
            seed=grid.seed)
    else:
        config_note = (f"winner {winner.name!r} is a coded scheme "
                       f"({winner.family}); it has no TO-matrix round "
                       f"config — wire its encoder in directly")

    ties = [p.name for p in alive if p is not winner
            and records[p.name]["gap"]
            <= z * records[p.name]["gap_stderr"]]
    meta = {
        "n": n, "k": k_default, "eta": eta, "z": z,
        "base_trials": base_trials, "chunk": chunk, "ladder": ladder,
        "theory_pruned": sum(1 for r2 in records.values()
                             if r2["status"] == "pruned"),
        "raced_points": len(points), "excluded": len(excluded),
        "exhaustive_cells": exhaustive_cells,
        "ties": ties,
        "seconds": time.perf_counter() - t0,
        "devices": sharding.device_label(devs),
    }
    return PlanResult(
        winner=winner.name, predicted_mean=w_mean, predicted_stderr=w_se,
        config=config, config_note=config_note, points=records,
        trajectory=trajectory, trials_spent=trials_spent,
        exhaustive_trials=exhaustive_trials, lb_mean=lb_mean,
        lb_gap=lb_gap, meta=meta)
