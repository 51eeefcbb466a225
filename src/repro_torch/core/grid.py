"""Streaming grid sweeps: whole (scheme family x load x message budget x
comm_eps x k) grids in one call; counterpart of ``repro.core.grid``.

The paper's object is the average completion time as a function of the
computation load r and the target k.  Evaluating every point of that
surface as its own ``sweep`` pays twice, and ``stream_grid`` saves both:

1. **Evaluator builds.**  Cells whose scheme-kind structure lands in the
   same ``(n, r_max, ks, counts)`` shape bucket share one built evaluator
   (``montecarlo._get_exec``) with their own runtime gather plans: one
   build per bucket for the whole grid (``cache_stats()["traces"]``).
2. **Sampling passes and host syncs.**  Cells that share their
   draw-defining coordinates ``(n, r_max, ks, trials, seed, chunk,
   model)`` are *fused* into one multi-spec sweep: one pass of delay
   draws serves every scheme at that load (common random numbers; the
   evaluator scores each spec independently, and the float64 host
   combine runs in global chunk order either way), so each cell equals
   its own per-cell ``sweep`` bit for bit.  Up to ``pipeline`` fused
   dispatches stay in flight (``montecarlo._Pending``): group ``j + 1``'s
   chunks are issued before group ``j``'s partials are read back.

Rounds cells (``GridCell(rounds=..., k=...)``) go one by one through
``sweep_rounds`` (deadlines and ``degradation`` included), so one artifact
carries both surfaces.

``stream_grid`` returns a ``GridResult`` whose versioned JSON artifact
(``save`` / ``load``) has the JAX package's schema: each package reads the
other's.  The racing planner (``core/planner``) searches the same
``GridSpec`` without streaming all of it.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .. import sharding
from . import montecarlo as mc
from .montecarlo import (SchemeSpec, lb_spec, pc_spec, pcmm_spec, sweep_rounds,
                         to_spec)
from .scheduling import (cyclic_to_matrix, random_assignment_to_matrix,
                         staircase_to_matrix)

__all__ = ["GridCell", "GridSpec", "GridResult", "stream_grid",
           "GRID_FORMAT_VERSION", "FAMILIES"]

GRID_FORMAT_VERSION = 1

#: scheme families ``GridSpec`` can enumerate: ``cs`` / ``ss`` / ``ra``
#: the paper's TO-matrix schedules, ``lb`` the oracle bound, ``pc`` /
#: ``pcmm`` the coded schemes (their decode thresholds ignore the k).
FAMILIES = ("cs", "ss", "ra", "lb", "pc", "pcmm")


@dataclasses.dataclass(frozen=True)
class GridCell:
    """One grid point: a named spec set evaluated at fixed Monte-Carlo
    coordinates.  Single-round cells (``rounds=None``) go through the
    fused, pipelined ``sweep`` path; rounds cells (``rounds`` and ``k``
    set) through ``sweep_rounds`` with its adaptive and deadline knobs."""
    name: str
    specs: Tuple[SchemeSpec, ...]
    n: int
    model: object
    trials: int = 20000
    seed: int = 0
    chunk: Optional[int] = None
    ks: Optional[int] = None
    # rounds-axis cells:
    rounds: Optional[int] = None
    k: Optional[int] = None
    feedback_beta: float = 0.7
    coverage_gamma: float = 0.5
    censored_feedback: bool = False
    deadline: Optional[float] = None
    deadline_policy: str = "wait"

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))
        if not self.specs:
            raise ValueError(f"cell {self.name!r}: need at least one spec")
        if (self.rounds is None) != (self.k is None):
            raise ValueError(f"cell {self.name!r}: rounds cells need both "
                             f"rounds= and k= (got rounds={self.rounds}, "
                             f"k={self.k})")

    @property
    def is_rounds(self) -> bool:
        return self.rounds is not None

    @property
    def r_max(self) -> int:
        """The cell's slot-grid width: the draws' shape on the per-cell
        path, so only cells of equal ``r_max`` fuse."""
        return max(sp.load for sp in self.specs)


def _family_spec(fam: str, n: int, r: int, m: Optional[int], eps: float,
                 seed: int) -> Optional[SchemeSpec]:
    """The family's spec at one (r, messages, comm_eps) point, or None
    where the family cannot take the combination (a declarative grid holds
    such corners, e.g. pc x messages=4: they are skipped, not errors)."""
    if m is not None and m > r:
        return None
    if fam in ("cs", "ss", "ra"):
        if fam == "ra" and r != n:     # RA permutes full columns: r == n
            return None
        C = {"cs": cyclic_to_matrix, "ss": staircase_to_matrix,
             "ra": lambda nn, rr: random_assignment_to_matrix(
                 nn, rr, seed=seed)}[fam](n, r)
        return to_spec(fam, C, messages=m, comm_eps=eps)
    if fam == "lb":
        return lb_spec(r, messages=m, comm_eps=eps)
    if fam == "pc":
        # one-shot by construction; no per-message overhead model
        if eps or (m is not None and m != 1):
            return None
        return pc_spec(r)
    if fam == "pcmm":
        if eps or n * r < 2 * n - 1:       # no overhead model / infeasible
            return None
        return pcmm_spec(r, messages=m)
    raise ValueError(f"unknown scheme family {fam!r}; have {FAMILIES}")


def _cell_name(fam: str, r: int, m: Optional[int], eps: float,
               k: Optional[int]) -> str:
    parts = [fam, f"r{r}"]
    if m is not None:
        parts.append(f"m{m}")
    if eps:
        parts.append(f"eps{eps:g}")
    if k is not None:
        parts.append(f"k{k}")
    return "/".join(parts)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """A declarative grid: the cross product of scheme families x loads x
    message budgets x per-message overheads x computation targets, at
    shared Monte-Carlo coordinates.  Infeasible corners (pc with several
    messages, pcmm below its decode threshold, budgets above the load) are
    skipped.  A ``ks`` entry of ``None`` is all-k mode (one sort gives
    every k in 1..n), an int that single order statistic.  ``to_json`` /
    ``from_json`` is the grid CLI's input format."""
    n: int
    families: Tuple[str, ...] = ("cs", "ss", "lb", "pc")
    loads: Tuple[int, ...] = (2,)
    messages: Tuple[Optional[int], ...] = (None,)
    comm_eps: Tuple[float, ...] = (0.0,)
    ks: Tuple[Optional[int], ...] = (None,)
    trials: int = 20000
    seed: int = 0
    chunk: Optional[int] = None

    def __post_init__(self):
        for f2 in ("families", "loads", "messages", "comm_eps", "ks"):
            object.__setattr__(self, f2, tuple(getattr(self, f2)))
        bad = [f2 for f2 in self.families if f2 not in FAMILIES]
        if bad:
            raise ValueError(f"unknown families {bad}; have {FAMILIES}")
        if not (self.families and self.loads and self.messages
                and self.comm_eps and self.ks):
            raise ValueError("every grid axis needs at least one value")

    def cells(self, model) -> Tuple[GridCell, ...]:
        """One single-spec ``GridCell`` per feasible (family, r, messages,
        eps, k) point, all sharing ``model`` and the Monte-Carlo
        coordinates, so ``stream_grid`` fuses them as far as it can."""
        out = []
        for r in self.loads:
            for fam in self.families:
                for m in self.messages:
                    for eps in self.comm_eps:
                        sp = _family_spec(fam, self.n, r, m, eps, self.seed)
                        if sp is None:
                            continue
                        for k in self.ks:
                            out.append(GridCell(
                                name=_cell_name(fam, r, m, eps, k),
                                specs=(sp,), n=self.n, model=model,
                                trials=self.trials, seed=self.seed,
                                chunk=self.chunk, ks=k))
        if not out:
            raise ValueError("grid is empty: every (family, load, budget) "
                             "combination was infeasible")
        return tuple(out)

    def to_json(self) -> dict:
        return {"version": GRID_FORMAT_VERSION, "kind": "grid-spec",
                "n": self.n, "families": list(self.families),
                "loads": list(self.loads),
                "messages": list(self.messages),
                "comm_eps": list(self.comm_eps), "ks": list(self.ks),
                "trials": self.trials, "seed": self.seed,
                "chunk": self.chunk}

    @classmethod
    def from_json(cls, doc: dict) -> "GridSpec":
        if doc.get("kind", "grid-spec") != "grid-spec":
            raise ValueError(f"not a grid-spec document: "
                             f"kind={doc.get('kind')!r}")
        v = doc.get("version", GRID_FORMAT_VERSION)
        if v > GRID_FORMAT_VERSION:
            raise ValueError(f"grid-spec version {v} is newer than this "
                             f"reader ({GRID_FORMAT_VERSION})")
        kw = {k2: doc[k2] for k2 in ("n", "families", "loads", "messages",
                                     "comm_eps", "ks", "trials", "seed",
                                     "chunk") if k2 in doc}
        return cls(**kw)


# ------------------------------ result artifact ------------------------------

_ARRAY_FIELDS = ("means", "stderr", "per_round", "wallclock",
                 "wallclock_stderr")


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, dict):
        return {k2: _jsonable(v) for k2, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def _arrays_back(cell: dict) -> dict:
    out = dict(cell)
    for f2 in _ARRAY_FIELDS:
        if f2 in out:
            out[f2] = {k2: np.asarray(v, np.float64)
                       for k2, v in out[f2].items()}
    if out.get("degradation"):
        out["degradation"] = {
            nm: {k2: np.asarray(v, np.float64) for k2, v in d.items()}
            for nm, d in out["degradation"].items()}
    return out


@dataclasses.dataclass
class GridResult:
    """Per-cell statistics of one ``stream_grid`` run and its metadata
    (cells/s, shape buckets, fused dispatches, device).

    ``cells[name]`` is a plain dict: ``kind`` (``"sweep"`` / ``"rounds"``),
    the cell's Monte-Carlo coordinates and its statistics: ``means`` /
    ``stderr`` per scheme for sweep cells (one column per k in all-k mode),
    the ``sweep_rounds`` streams (``per_round``, ``wallclock``, their
    stderrs, and ``degradation`` under a deadline) for rounds cells.  The
    JSON artifact is versioned and round-trips through ``save`` /
    ``load``."""
    cells: Dict[str, dict]
    meta: dict = dataclasses.field(default_factory=dict)

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise ValueError(f"unknown grid cell {name!r}; have "
                             f"{sorted(self.cells)[:8]}...")
        return self.cells[name]

    def means(self, name: str, scheme: Optional[str] = None) -> np.ndarray:
        c = self.cell(name)
        schemes = sorted(c["means"])
        if scheme is None:
            if len(schemes) != 1:
                raise ValueError(f"cell {name!r} has schemes {schemes}; "
                                 f"pass scheme=")
            scheme = schemes[0]
        return c["means"][scheme]

    def best_cell(self, metric: str = "mean", k: Optional[int] = None,
                  exclude: Tuple[str, ...] = ("lb",),
                  z: float = 2.0) -> dict:
        """The grid's argmin operating point at target ``k`` (default each
        cell's ``ks``, else ``n``): the (cell, scheme) pair of smallest mean
        completion time over the sweep cells.  ``exclude`` drops schemes by
        name (default the oracle ``lb``, which always wins and cannot be
        scheduled).  Returns ``{"cell", "scheme", "mean", "stderr",
        "ties"}``; ``ties`` lists the other pairs within ``z`` combined
        standard errors of the winner (the resolution of the grid's trial
        budget).  Rounds cells are skipped (their metric is a stream)."""
        if metric != "mean":
            raise ValueError(f"unknown metric {metric!r}; only 'mean'")
        entries = []
        for nm, c in self.cells.items():
            if c.get("kind") != "sweep":
                continue
            fixed = set(c.get("fixed", ()))
            for scheme, v in c["means"].items():
                if scheme in exclude:
                    continue
                v = np.atleast_1d(np.asarray(v, np.float64))
                se = np.atleast_1d(np.asarray(c["stderr"][scheme],
                                              np.float64))
                if v.shape[-1] == 1 or scheme in fixed:
                    col = 0
                else:
                    kk = k if k is not None else (c.get("ks") or c["n"])
                    if not 1 <= kk <= v.shape[-1]:
                        raise ValueError(f"cell {nm!r} scheme {scheme!r}: "
                                         f"need 1 <= k <= {v.shape[-1]}, "
                                         f"got {kk}")
                    col = int(kk) - 1
                entries.append((nm, scheme, float(v[col]), float(se[col])))
        if not entries:
            raise ValueError("grid has no scorable sweep cells after "
                             f"excluding {exclude}")
        nm, scheme, mu, se = min(entries, key=lambda e: e[2])
        ties = [{"cell": e[0], "scheme": e[1], "mean": e[2],
                 "stderr": e[3]}
                for e in entries if e[0] != nm or e[1] != scheme
                if e[2] - mu <= z * math.hypot(se, e[3])]
        return {"cell": nm, "scheme": scheme, "mean": mu, "stderr": se,
                "ties": ties}

    @property
    def cells_per_sec(self) -> float:
        return self.meta.get("cells_per_sec", float("nan"))

    def to_json(self) -> dict:
        return {"version": GRID_FORMAT_VERSION, "kind": "grid-result",
                "meta": _jsonable(self.meta),
                "cells": {nm: _jsonable(c) for nm, c in self.cells.items()}}

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)
        return path

    @classmethod
    def load(cls, path: str) -> "GridResult":
        with open(path) as fh:
            doc = json.load(fh)
        if doc.get("kind") != "grid-result":
            raise ValueError(f"{path}: not a grid-result artifact "
                             f"(kind={doc.get('kind')!r})")
        v = doc.get("version", 0)
        if v > GRID_FORMAT_VERSION:
            raise ValueError(f"{path}: grid-result version {v} is newer "
                             f"than this reader ({GRID_FORMAT_VERSION})")
        return cls(cells={nm: _arrays_back(c)
                          for nm, c in doc["cells"].items()},
                   meta=doc.get("meta", {}))


# ----------------------------- streaming engine ------------------------------

def _model_key(model):
    """A delay model's identity in a fusion group: hashable models group
    by equality (frozen dataclasses), unhashable custom models by object
    identity, never across distinct objects."""
    try:
        hash(model)
        return model
    except TypeError:
        return id(model)


def stream_grid(cells: Sequence[GridCell], *, devices=None,
                pipeline: int = 2) -> GridResult:
    """Evaluate every cell, fusing the cells that share their
    draw-defining coordinates into one multi-spec sweep and keeping up to
    ``pipeline`` fused dispatches in flight (two by default).  ``devices``
    shards every dispatch's trial axis, as in ``sweep`` (``None`` = every
    CUDA card, ``"cpu"`` on request); ``meta["devices"]`` names the
    devices (``sharding.device_label``).

    Every cell's ``means`` / ``stderr`` equal a per-cell ``sweep`` (or
    ``sweep_rounds``) at the same coordinates bit for bit: fusion only
    widens the evaluator's spec stack over the same ``(n, r_max)`` draws,
    each chunk's partials are ``_tree_sum``s over the chunk, and the
    float64 host combine runs in global chunk order either way."""
    cells = tuple(cells)
    if not cells:
        raise ValueError("need at least one GridCell")
    names = [c.name for c in cells]
    dup = [nm for nm, cnt in collections.Counter(names).items() if cnt > 1]
    if dup:
        raise ValueError(f"duplicate grid cell names: {dup}")
    if pipeline < 1:
        raise ValueError(f"pipeline depth must be >= 1, got {pipeline}")
    devs = sharding.trial_devices(devices)

    t0 = time.perf_counter()
    sweep_cells = [c for c in cells if not c.is_rounds]
    rounds_cells = [c for c in cells if c.is_rounds]

    # ---- fuse sweep cells sharing their draw-defining coordinates ----
    groups: Dict[tuple, list] = {}
    for c in sweep_cells:
        key = (c.n, c.r_max, c.ks, c.trials, c.seed, c.chunk,
               _model_key(c.model))
        groups.setdefault(key, []).append(c)

    results: Dict[str, dict] = {}
    sigs = set()
    pending: collections.deque = collections.deque()

    def _resolve_one() -> None:
        grp, handle = pending.popleft()
        means, stderr = handle.resolve()
        for cell in grp:
            results[cell.name] = {
                "kind": "sweep", "n": cell.n, "trials": cell.trials,
                "seed": cell.seed, "ks": cell.ks,
                "means": {sp.name: np.atleast_1d(
                    means[f"{cell.name}:{sp.name}"]) for sp in cell.specs},
                "stderr": {sp.name: np.atleast_1d(
                    stderr[f"{cell.name}:{sp.name}"]) for sp in cell.specs},
                "fixed": [sp.name for sp in cell.specs
                          if sp.kind in ("pc", "pcmm")],
            }

    for grp in groups.values():
        c0 = grp[0]
        # spec names are unique per cell only: prefix the cell's name (the
        # bucket signature holds no names, so renamed specs share it)
        fused = tuple(dataclasses.replace(sp, name=f"{cell.name}:{sp.name}")
                      for cell in grp for sp in cell.specs)
        sigs.add(mc._eval_layout(fused, c0.n, c0.r_max, c0.ks)[0])
        while len(pending) >= pipeline:       # keep the window bounded
            _resolve_one()
        pending.append((grp, mc._dispatch_run(
            fused, c0.model, c0.n, trials=c0.trials, seed=c0.seed,
            chunk=c0.chunk, ks=c0.ks, want_samples=False, devices=devs)))
    while pending:
        _resolve_one()

    # ---- rounds cells: one sweep_rounds each (not fused) ----
    for cell in rounds_cells:
        res = sweep_rounds(cell.specs, cell.model, cell.n,
                           rounds=cell.rounds, k=cell.k, trials=cell.trials,
                           seed=cell.seed, chunk=cell.chunk,
                           feedback_beta=cell.feedback_beta,
                           coverage_gamma=cell.coverage_gamma,
                           censored_feedback=cell.censored_feedback,
                           deadline=cell.deadline,
                           deadline_policy=cell.deadline_policy,
                           devices=devs)
        entry = {
            "kind": "rounds", "n": cell.n, "trials": cell.trials,
            "seed": cell.seed, "rounds": cell.rounds, "k": cell.k,
            "deadline": cell.deadline,
            "deadline_policy": cell.deadline_policy,
            "per_round": res.per_round, "stderr": res.stderr,
            "wallclock": res.wallclock,
            "wallclock_stderr": res.wallclock_stderr,
        }
        if res.degradation is not None:
            entry["degradation"] = res.degradation
        results[cell.name] = entry

    seconds = time.perf_counter() - t0
    meta = {"cells": len(cells), "seconds": seconds,
            "cells_per_sec": len(cells) / seconds if seconds > 0 else 0.0,
            "fused_dispatches": len(groups), "buckets": len(sigs),
            "rounds_cells": len(rounds_cells), "pipeline": pipeline,
            "devices": sharding.device_label(devs)}
    return GridResult(cells=results, meta=meta)
