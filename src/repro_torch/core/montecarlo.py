"""Monte-Carlo sweep engines — the port's hot path; counterpart of
``repro.core.montecarlo``: the single-round ``sweep`` and the rounds axis
(``sweep_rounds`` / ``trajectory_samples``).

Every paper figure (Figs. 4-7) is an average-completion-time sweep over a
(scheme, r, k, scenario) grid.  ``sweep`` evaluates every scheme against ONE
shared set of delay draws per trial (common random numbers):

1. trial ``t``'s delays are a pure function of ``(seed, t)`` through the
   counter-based generator (``rng``), so per-trial samples are identical
   under any chunking of the trial axis and on any device;
2. slot arrivals are eq. (1) as an explicit running sum over the slots;
3. task arrivals (eq. 2) come from a static gather plan + min (each task's
   copy positions are known from the TO matrix before the run);
4. all-k mode sorts the task arrivals once (every k in 1..n), single-k mode
   takes a partial selection (``torch.topk``);
5. trials stream through a Python loop over fixed-size chunks; each chunk
   emits float32 partial sums reduced by an explicit pairwise tree
   (``_tree_sum``: the association order depends on the chunk length only),
   and the host combines the partials in float64 in global chunk order.

The evaluator is the JAX package's *bucketed* one (``_eval_layout`` +
``_build_bucket_eval``): every spec's static structure (gather plans,
flat windows, message offsets, decode thresholds) becomes runtime arrays
padded to a shape signature.  Given the same slot-arrival table it returns
the same values as the JAX evaluator bit for bit — every step is a gather,
a min, a sort/selection or one elementwise float32 add.

Scheme kinds: ``"to"`` (a TO matrix, eqs. 1-2, 6), ``"tau"`` (raw task
arrivals), ``"lb"`` (the oracle lower bound, eq. 46), ``"pc"`` (eqs. 51-52)
and ``"pcmm"`` (eqs. 56-57), each with the intra-round message budget
(``messages``, paper Sec. V-C), ragged per-worker ``loads`` and the
per-message overhead ``comm_eps``.

The rounds axis (``sweep_rounds``, ``trajectory_samples``) scores every
scheme over consecutive rounds of one ``DelayProcess`` realization per
trial: the process state (straggler persistence) and the adaptive schemes'
per-trial delay estimates carry from round to round in a Python loop
inside each chunk.  ``adaptive_spec`` schemes re-assign their base
matrix's rows every round from that feedback through
``scheduling.greedy_row_assignment_batch`` (the ``greedy_assign`` kernel
on the card), with idealized or censored feedback.  Round ``t`` draws
under ``rng.round_seed(seed, t + 1)`` and the process starts under
``rng.round_seed(seed, 0)``, keyed by the global trial id, so trajectories
are chunk-invariant.  Per-round partials are float32 per chunk, combined in
float64 on the host in global chunk order.  Deadlines, load re-balancing,
trace recording, resumable sweeps and multi-device sharding wait for later
slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import rng, scheduling

__all__ = [
    "SchemeSpec", "SweepResult", "to_spec", "lb_spec", "pc_spec",
    "pcmm_spec", "tau_spec", "task_gather_plan",
    "task_arrival_times_gather", "message_boundaries", "message_slot_map",
    "message_group_sizes", "slot_arrival_times", "sweep",
    "completion_samples", "task_arrival_samples", "adaptive_spec",
    "RoundsResult", "sweep_rounds", "trajectory_samples",
]

_LATER = ("arrives with the port's fault-tolerance slice (re-balancing, "
          "deadlines, faults, trace recording)")

INF = math.inf


# --------------------------- scheme specification ----------------------------

@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One scheme to evaluate in a sweep (C stored as nested tuples)."""
    name: str
    kind: str                 # "to" | "lb" | "pc" | "pcmm" | "tau" | "adaptive"
    C: Optional[tuple] = None       # TO matrix for "to"/"tau"/"adaptive"
    r: Optional[int] = None         # computation load for "lb"/"pc"/"pcmm"
    messages: Optional[int] = None  # per-round messages per worker
                                    # (None = the kind's default semantics)
    loads: Optional[tuple] = None   # per-worker loads (None = uniform/dense)
    comm_eps: float = 0.0           # per-message protocol overhead: a
                                    # worker's l-th message lands (l+1)*eps
                                    # late (serialized uplink)

    @property
    def load(self) -> int:
        """Width of this scheme's slot grid (the maximum per-worker load)."""
        if self.kind in ("to", "tau", "adaptive"):
            return len(self.C[0])
        return int(self.r)

    @property
    def n_messages(self) -> int:
        """Messages each worker sends per round; ``None`` resolves to one
        per slot (eq. 1) for uncoded schemes / lb / pcmm, one-shot for pc."""
        if self.messages is not None:
            return int(self.messages)
        return 1 if self.kind == "pc" else self.load

    def load_vector(self, n: Optional[int] = None) -> np.ndarray:
        """Per-worker loads as an array (uniform when ``loads`` is None).
        ``n`` is required for matrix-less kinds (lb/pc/pcmm)."""
        if self.loads is not None:
            return np.asarray(self.loads, np.int64)
        n_w = len(self.C) if self.C is not None else n
        if n_w is None:
            raise ValueError(f"{self.name}: need n for a matrix-less spec")
        return np.full(n_w, self.load, np.int64)

    def matrix(self) -> np.ndarray:
        return np.asarray(self.C, dtype=np.int64)


def _freeze_matrix(C) -> tuple:
    C = np.asarray(C)
    if C.ndim != 2:
        raise ValueError(f"TO matrix must be 2-D, got shape {C.shape}")
    return tuple(tuple(int(v) for v in row) for row in C)


def _freeze_ragged(C, loads) -> Tuple[tuple, Optional[tuple]]:
    """Canonicalize a (possibly ragged) TO matrix + load vector: masked
    slots hold ``scheduling.MASKED``, and a uniform full-width ``loads``
    canonicalizes to ``None`` (the dense representation)."""
    C = np.asarray(C)
    if C.ndim != 2:
        raise ValueError(f"TO matrix must be 2-D, got shape {C.shape}")
    if loads is not None:
        C = scheduling.mask_matrix_loads(C, loads)
    lv = scheduling.loads_of_matrix(C)             # validates trailing masks
    if (lv == C.shape[1]).all():
        return _freeze_matrix(C), None
    return _freeze_matrix(C), tuple(int(v) for v in lv)


def to_spec(name: str, C, messages: Optional[int] = None, *,
            loads=None, comm_eps: float = 0.0) -> SchemeSpec:
    """A TO-matrix scheme (CS / SS / RA / custom)."""
    Cf, lt = _freeze_ragged(C, loads)
    return SchemeSpec(name=name, kind="to", C=Cf, messages=messages,
                      loads=lt, comm_eps=float(comm_eps))


def tau_spec(name: str, C, messages: Optional[int] = None, *,
             loads=None, comm_eps: float = 0.0) -> SchemeSpec:
    """Raw task-arrival samples for a TO matrix (no order statistics)."""
    Cf, lt = _freeze_ragged(C, loads)
    return SchemeSpec(name=name, kind="tau", C=Cf, messages=messages,
                      loads=lt, comm_eps=float(comm_eps))


def adaptive_spec(name: str, C, messages: Optional[int] = None, *,
                  loads=None, rebalance: bool = False) -> SchemeSpec:
    """An adaptive scheme: base TO matrix ``C`` whose rows are re-assigned
    to workers each round from observed per-worker delay feedback (only
    valid in ``sweep_rounds``).  ``loads`` makes the base ragged (rows
    carry their loads through the re-permutation).  ``rebalance`` waits for
    a later slice of the port."""
    if rebalance:
        raise NotImplementedError(f"adaptive load re-balancing {_LATER}")
    Cf, lt = _freeze_ragged(C, loads)
    return SchemeSpec(name=name, kind="adaptive", C=Cf, messages=messages,
                      loads=lt)


def lb_spec(r: Optional[int] = None, name: str = "lb",
            messages: Optional[int] = None, *,
            loads=None, comm_eps: float = 0.0) -> SchemeSpec:
    """Oracle lower bound (eq. 46) at computation load ``r``; ``loads``
    generalizes it to a per-worker load vector."""
    lt = None
    if loads is not None:
        lv = np.asarray(loads, np.int64)
        if lv.ndim != 1 or lv.min() < 1:
            raise ValueError(f"loads must be a vector of positive per-worker "
                             f"loads, got {loads}")
        r = int(lv.max()) if r is None else int(r)
        if lv.max() > r:
            raise ValueError(f"max load {lv.max()} exceeds r={r}")
        if not (lv == r).all():                    # uniform -> canonical dense
            lt = tuple(int(v) for v in lv)
    elif r is None:
        raise ValueError("need a load r (or a loads vector)")
    return SchemeSpec(name=name, kind="lb", r=int(r), messages=messages,
                      loads=lt, comm_eps=float(comm_eps))


def pc_spec(r: int, name: str = "pc") -> SchemeSpec:
    """Polynomially-coded scheme at load ``r`` — one-shot by construction."""
    return SchemeSpec(name=name, kind="pc", r=int(r))


def pcmm_spec(r: int, name: str = "pcmm",
              messages: Optional[int] = None) -> SchemeSpec:
    """Polynomially-coded multi-message scheme at load ``r``."""
    return SchemeSpec(name=name, kind="pcmm", r=int(r), messages=messages)


def _pc_threshold(n: int, r: int) -> int:
    return 2 * math.ceil(n / r) - 1


def _pcmm_threshold(n: int) -> int:
    return 2 * n - 1


# ----------------------- intra-round message layout --------------------------

def message_boundaries(r: int, messages: int) -> np.ndarray:
    """Closing slot index of each message when ``r`` sequential slots are
    sent in ``messages`` as-even-as-possible consecutive groups (earlier
    messages carry the extra slot)."""
    if int(messages) != messages:
        raise ValueError(f"messages must be an integer, got {messages!r}")
    if not 1 <= int(messages) <= r:
        raise ValueError(f"message budget out of range: need 1 <= messages "
                         f"<= r={r}, got messages={messages}")
    sizes = [len(g) for g in np.array_split(np.arange(r), int(messages))]
    return np.cumsum(sizes, dtype=np.int64) - 1


def message_group_sizes(r: int, messages: int) -> np.ndarray:
    """Number of slots (results / coded partials) each message carries."""
    b = message_boundaries(r, messages)
    return np.diff(np.concatenate([[-1], b])).astype(np.int64)


def message_slot_map(r: int, messages: int) -> np.ndarray:
    """Slot ``j`` -> the closing slot of ``j``'s message."""
    b = message_boundaries(r, messages)
    return b[np.searchsorted(b, np.arange(r))]


def _slot_map_of(spec: SchemeSpec) -> Optional[np.ndarray]:
    """The spec's message remap (shared length-``r`` or per-worker
    ``(n, r)``), or None when it is the identity."""
    m = spec.n_messages
    r = spec.load
    if spec.loads is None:
        return None if m == r else message_slot_map(r, m)
    rows, nontrivial = [], False
    for l in spec.loads:
        mi = min(m, int(l))
        row = np.arange(r, dtype=np.int64)
        row[:l] = message_slot_map(int(l), mi)
        nontrivial |= mi != l
        rows.append(row)
    return np.stack(rows) if nontrivial else None


def _message_index_grid(spec: SchemeSpec, n: int) -> np.ndarray:
    """(n_w, r) message index of each slot under the spec's budget."""
    r = spec.load
    m = spec.n_messages
    lv = spec.load_vector(n)
    grid = np.zeros((len(lv), r), np.int64)
    for i, l in enumerate(lv):
        b = message_boundaries(int(l), min(m, int(l)))
        grid[i, :l] = np.searchsorted(b, np.arange(int(l)))
    return grid


def _offsets_flat_of(spec: SchemeSpec, n: int, r_max: int
                     ) -> Optional[np.ndarray]:
    """Static per-slot ``comm_eps`` arrival offsets laid out flat over the
    row-major ``(n_w, r_max)`` slot grid plus the +inf sentinel position;
    ``None`` when ``eps == 0``."""
    if not spec.comm_eps:
        return None
    grid = _message_index_grid(spec, n)
    n_w, r = grid.shape
    smap = _slot_map_of(spec)
    if smap is None:
        smap = np.broadcast_to(np.arange(r), (n_w, r))
    elif smap.ndim == 1:
        smap = np.broadcast_to(smap, (n_w, r))
    off = np.zeros(n_w * r_max + 1, np.float32)
    for i in range(n_w):
        for j in range(r):
            off[i * r_max + int(smap[i, j])] = spec.comm_eps * (grid[i, j] + 1)
    return off


# ------------------- static gather layout for task arrivals ------------------

def task_gather_plan(C, n: int, r_max: Optional[int] = None,
                     slot_map: Optional[np.ndarray] = None) -> np.ndarray:
    """Where every task's copies live: an ``(n, m)`` int32 array of flat
    slot indices into the row-major ``(n_w, r_max)`` slot grid, padded with
    the sentinel ``n_w * r_max`` (read as +inf).  ``MASKED`` slots are
    dropped; ``slot_map`` redirects slot ``j``'s read to its message's
    closing slot."""
    C = np.asarray(C)
    n_w, r = C.shape
    r_max = r if r_max is None else int(r_max)
    if r > r_max:
        raise ValueError(f"TO matrix load r={r} exceeds slot grid r_max={r_max}")
    if slot_map is None:
        slot_map = np.broadcast_to(np.arange(r), (n_w, r))
    else:
        slot_map = np.asarray(slot_map)
        if slot_map.ndim == 1:
            slot_map = np.broadcast_to(slot_map, (n_w, r))
        if (slot_map.shape != (n_w, r) or slot_map.min() < 0
                or slot_map.max() >= r):
            raise ValueError(f"slot_map must be ({r},) or ({n_w}, {r}) with "
                             f"values in [0, {r}); got shape {slot_map.shape}")
    sentinel = n_w * r_max
    positions: list[list[int]] = [[] for _ in range(n)]
    for i in range(n_w):
        for j in range(r):
            if C[i, j] < 0:            # MASKED slot: statically dropped
                continue
            positions[int(C[i, j])].append(i * r_max + int(slot_map[i, j]))
    m = max((len(p) for p in positions), default=0) or 1
    plan = np.full((n, m), sentinel, dtype=np.int32)
    for p, lst in enumerate(positions):
        plan[p, :len(lst)] = lst
    return plan


def _index_on(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           device=device).to(torch.int64)


def _float_on(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           device=device).to(torch.float32)


def task_arrival_times_gather(plan, s: torch.Tensor,
                              offsets=None) -> torch.Tensor:
    """eq. (2) via the static gather plan.  ``s`` (..., n_w, r_max);
    ``plan`` ``(n, m)`` or ``(S, n, m)`` gives (..., n) or (..., S, n).
    ``offsets`` (same shape as ``plan``) adds static per-copy offsets
    before the min."""
    sf = s.reshape(s.shape[:-2] + (-1,))
    sp = torch.cat([sf, sf.new_full(sf.shape[:-1] + (1,), INF)], dim=-1)
    g = sp[..., _index_on(plan, s.device)]
    if offsets is not None:
        g = g + _float_on(offsets, s.device)
    return g.amin(dim=-1)


def _plan_of(spec: SchemeSpec, n: int, r_max: int) -> np.ndarray:
    return task_gather_plan(spec.matrix(), n, r_max,
                            slot_map=_slot_map_of(spec))


def _plan_offsets_of(spec: SchemeSpec, plan: np.ndarray, n: int,
                     r_max: int) -> Optional[np.ndarray]:
    off_flat = _offsets_flat_of(spec, n, r_max)
    if off_flat is None:
        return None
    return off_flat[plan]


def _left_fold(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Running sum along ``dim`` as an explicit left fold (same bits on
    every device; ``torch.cumsum`` may associate differently)."""
    x = x.movedim(dim, 0)
    acc = x[0]
    cols = [acc]
    for j in range(1, x.shape[0]):
        acc = acc + x[j]
        cols.append(acc)
    return torch.stack(cols).movedim(0, dim)


def slot_arrival_times(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """eq. (1): s[..., i, j] = sum_{m<=j} T1[..., i, m] + T2[..., i, j],
    as an explicit left-to-right running sum over the slots.  (A library
    cumsum may associate differently on the CPU; the fold keeps the result
    equal, bit for bit, to the JAX package's sequential cumsum.)"""
    return _left_fold(T1, -1) + T2


# --------------------- shape-bucketed runtime evaluator ----------------------

_GROUPS = ("to", "tau", "lb", "pcmm", "pc")


def _smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest entries of x along the last axis, ascending."""
    return torch.topk(x, k, dim=-1, largest=False, sorted=True).values


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 2 ** (x - 1).bit_length()


def _flat_indices_of(sp: SchemeSpec, n: int, r_max: int):
    """Flat indices of the spec's active (message-remapped) slots in the
    row-major ``(n, r_max)`` grid, plus their ``comm_eps`` offsets (None
    when the spec has no overhead)."""
    r = sp.load
    lv = sp.load_vector(n)
    smap = _slot_map_of(sp)
    if smap is None:
        smap = np.broadcast_to(np.arange(r), (n, r))
    elif smap.ndim == 1:
        smap = np.broadcast_to(smap, (n, r))
    idx = np.asarray([i * r_max + int(smap[i, j])
                      for i in range(n) for j in range(int(lv[i]))],
                     np.int32)
    off_flat = _offsets_flat_of(sp, n, r_max)
    if off_flat is None:
        return idx, None
    return idx, off_flat[idx].astype(np.float32)


def _eval_layout(specs: Tuple[SchemeSpec, ...], n: int, r_max: int,
                 ks: Optional[int]):
    """Split one sweep's specs into the fixed evaluator groups and lay out
    every per-spec static structure as numpy arrays padded to the bucket
    signature.  Returns ``(sig, params, slots)`` exactly as the JAX
    package's ``_eval_layout`` does: ``sig`` the shape bucket, ``params``
    the runtime arrays, ``slots`` ``{scheme name: (group, index)}``."""
    W = n * r_max                     # flat slot-grid width; sentinel = W
    by: Dict[str, list] = {g: [] for g in _GROUPS}
    slots: Dict[str, Tuple[str, int]] = {}
    for sp in specs:
        slots[sp.name] = (sp.kind, len(by[sp.kind]))
        by[sp.kind].append(sp)

    params: Dict[str, np.ndarray] = {}

    def _plan_group(group):
        gspecs = by[group]
        if not gspecs:
            return 0, 1
        plans = [_plan_of(sp, n, r_max) for sp in gspecs]
        m = _next_pow2(max(p.shape[1] for p in plans))
        plan = np.full((len(gspecs), n, m), W, np.int32)
        offs = np.zeros((len(gspecs), n, m), np.float32)
        for i, (sp, p) in enumerate(zip(gspecs, plans)):
            plan[i, :, :p.shape[1]] = p
            o = _plan_offsets_of(sp, p, n, r_max)
            if o is not None:
                offs[i, :, :p.shape[1]] = o
        params[group + "_plan"] = plan
        params[group + "_off"] = offs
        return len(gspecs), m

    S_to, M_to = _plan_group("to")
    S_tau, M_tau = _plan_group("tau")

    def _flat_group(group):
        gspecs = by[group]
        if not gspecs:
            return 0
        idx = np.full((len(gspecs), W), W, np.int32)   # sentinel -> +inf
        offs = np.zeros((len(gspecs), W), np.float32)
        for i, sp in enumerate(gspecs):
            fi, fo = _flat_indices_of(sp, n, r_max)
            idx[i, :len(fi)] = fi
            if fo is not None:
                offs[i, :len(fi)] = fo
        params[group + "_idx"] = idx
        params[group + "_off"] = offs
        return len(gspecs)

    F_lb = _flat_group("lb")
    F_pcmm = _flat_group("pcmm")

    pc = by["pc"]
    if pc:
        params["pc_slot"] = np.asarray([sp.load - 1 for sp in pc], np.int32)
        params["pc_th"] = np.asarray(
            [_pc_threshold(n, sp.load) - 1 for sp in pc], np.int32)
        params["pc_eps"] = np.asarray([sp.comm_eps for sp in pc], np.float32)

    sig = ("v1", n, r_max, ks, S_to, M_to, S_tau, M_tau, F_lb, F_pcmm,
           len(pc))
    return sig, params, slots


def params_on(params: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The layout's numpy params as tensors on ``device`` (int64 indices,
    float32 offsets) — the form ``_build_bucket_eval``'s function takes."""
    return {k: (_index_on(v, device) if np.asarray(v).dtype.kind in "iu"
                else _float_on(v, device)) for k, v in params.items()}


def _build_bucket_eval(sig):
    """Evaluator for one shape bucket: slot arrivals ``s`` (chunk, n, r_max)
    + ``params`` (``params_on``) -> {group: (chunk, S_g, L_g)}."""
    _, n, r_max, ks, S_to, M_to, S_tau, M_tau, F_lb, F_pcmm, P_pc = sig

    def eval_fn(s: torch.Tensor, params) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if F_lb or F_pcmm:
            sf = s.reshape(s.shape[0], -1)
            s_pad = torch.cat([sf, sf.new_full((sf.shape[0], 1), INF)], -1)
        if S_to:
            tau = task_arrival_times_gather(
                params["to_plan"], s, params["to_off"])
            out["to"] = (torch.sort(tau, dim=-1).values if ks is None
                         else _smallest(tau, ks)[..., -1:])
        if S_tau:
            out["tau"] = task_arrival_times_gather(
                params["tau_plan"], s, params["tau_off"])
        if F_lb:
            win = s_pad[:, params["lb_idx"]] + params["lb_off"]
            fs = _smallest(win, n if ks is None else ks)
            out["lb"] = fs if ks is None else fs[..., -1:]
        if F_pcmm:
            th = _pcmm_threshold(n)
            win = s_pad[:, params["pcmm_idx"]] + params["pcmm_off"]
            out["pcmm"] = _smallest(win, th)[..., -1:]
        if P_pc:
            # per-worker one-shot times at each pc spec's closing slot,
            # ranked by a full sort so the decode threshold is a runtime
            # gather index
            tw = s[..., params["pc_slot"]].movedim(-1, -2)
            tw = tw + params["pc_eps"][:, None]            # (chunk, P, n)
            srt = torch.sort(tw, dim=-1).values
            idx = params["pc_th"].reshape(1, P_pc, 1).expand(
                srt.shape[0], P_pc, 1)
            out["pc"] = torch.take_along_dim(srt, idx, dim=-1)
        return out

    return eval_fn


# ------------------------------- trial loop ----------------------------------

def _normalize_chunk(trials: int, chunk: Optional[int]) -> int:
    """``None`` means one chunk; anything outside ``1..trials`` is an
    error."""
    if trials < 1:
        raise ValueError(f"trials must be >= 1, got {trials}")
    if chunk is None:
        return trials
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got chunk={chunk}")
    if chunk > trials:
        raise ValueError(
            f"chunk ({chunk}) exceeds trials ({trials}); pass chunk <= "
            f"trials (or chunk=None for a single chunk)")
    return chunk


def _tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 through an explicit balanced pairwise tree (zero-pad
    to a power of two, then halve): every add is elementwise, so the
    float32 association order is a function of the axis length alone —
    the same on every device and for any thread count."""
    m = v.shape[0]
    p = _next_pow2(m)
    if p != m:
        v = torch.cat([v, v.new_zeros((p - m,) + tuple(v.shape[1:]))], dim=0)
    while v.shape[0] > 1:
        v = v[0::2] + v[1::2]
    return v[0]


def _single_device(devices) -> torch.device:
    """The one device a sweep runs on (``None`` = the CUDA card)."""
    if isinstance(devices, (list, tuple)):
        if len(devices) != 1:
            raise NotImplementedError(
                "the port's sweeps run on one device; multi-device sharding "
                "arrives with a later slice")
        devices = devices[0]
    return resolve_device(devices)


def _check_specs(specs: Sequence[SchemeSpec], n: int) -> Tuple[SchemeSpec, ...]:
    specs = tuple(specs)
    if not specs:
        raise ValueError("need at least one SchemeSpec")
    names = [sp.name for sp in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate scheme names: {names}")
    for sp in specs:
        if sp.kind not in _GROUPS + ("adaptive",):
            raise ValueError(f"{sp.name}: unknown scheme kind {sp.kind!r}; "
                             f"the port's engines take "
                             f"{_GROUPS + ('adaptive',)}")
        if sp.kind in ("to", "tau", "adaptive") and len(sp.C) != n:
            raise ValueError(f"{sp.name}: TO matrix has {len(sp.C)} rows, "
                             f"expected n={n}")
        if sp.kind in ("lb", "pc", "pcmm") and not 1 <= sp.load:
            raise ValueError(f"{sp.name}: bad load r={sp.r}")
        if sp.kind == "pcmm" and n * sp.load < _pcmm_threshold(n):
            raise ValueError(
                f"{sp.name}: PCMM infeasible: n*r={n * sp.load} < "
                f"2n-1={_pcmm_threshold(n)}")
        if sp.comm_eps < 0:
            raise ValueError(f"{sp.name}: comm_eps must be >= 0, got "
                             f"{sp.comm_eps}")
        if sp.messages is not None:
            if sp.kind == "pc" and sp.messages != 1:
                raise ValueError(
                    f"{sp.name}: pc is one-shot by construction (the decoder "
                    f"needs each worker's full sum); use pcmm for "
                    f"multi-message coded rounds")
            if not 1 <= sp.messages <= sp.load:
                raise ValueError(
                    f"{sp.name}: need 1 <= messages <= load={sp.load}, got "
                    f"messages={sp.messages}")
        if sp.loads is not None:
            if sp.kind in ("pc", "pcmm"):
                raise ValueError(f"{sp.name}: ragged loads are not defined "
                                 f"for coded schemes (the decode threshold "
                                 f"assumes a uniform load)")
            lv = np.asarray(sp.loads, np.int64)
            if lv.shape != (n,) or lv.min() < 1 or lv.max() > sp.load:
                raise ValueError(
                    f"{sp.name}: loads must be ({n},) with 1 <= load <= "
                    f"{sp.load}, got {sp.loads}")
        if sp.kind in ("to", "tau", "adaptive"):
            C = sp.matrix()
            if sp.loads is not None or (C < 0).any():
                scheduling.validate_to_matrix(C, n, loads=sp.loads)
        if sp.comm_eps and sp.kind == "adaptive":
            raise ValueError(f"{sp.name}: comm_eps is not supported for "
                             f"adaptive specs yet")
    return specs


def _covered_tasks(sp: SchemeSpec) -> int:
    """Number of distinct tasks a (possibly ragged) TO spec can deliver
    (row re-permutation keeps the union of active slots)."""
    C = sp.matrix()
    return len(np.unique(C[C >= 0]))


def _validate_single_round(specs: Sequence[SchemeSpec], n: int,
                           ks: Optional[int]) -> Tuple[SchemeSpec, ...]:
    """Spec well-formedness, target-k range, and task coverage (a ragged
    schedule that cannot deliver ``k`` distinct tasks has an infinite
    completion time)."""
    specs = _check_specs(specs, n)
    for sp in specs:
        if sp.kind == "adaptive":
            raise ValueError(f"{sp.name}: adaptive schemes need a rounds "
                             f"axis — use sweep_rounds")
    if ks is not None and not 1 <= ks <= n:
        raise ValueError(f"need 1 <= k <= n={n}, got k={ks}")
    for sp in specs:
        if sp.kind != "to":
            continue                   # tau: raw arrivals, +inf meaningful
        covered = _covered_tasks(sp)
        if ks is not None and covered < ks:
            raise ValueError(
                f"{sp.name}: ragged schedule covers only {covered} "
                f"distinct tasks < k={ks}; the completion time would be "
                f"infinite")
        if ks is None and covered < n:
            raise ValueError(
                f"{sp.name}: schedule covers only {covered} of {n} tasks, "
                f"so all-k completion times are infinite beyond "
                f"k={covered}; sweep with ks <= {covered} instead")
    return specs


def _chunk_stats(model, seed: int, tids: torch.Tensor, n: int, r_max: int,
                 eval_fn, params) -> Dict[str, torch.Tensor]:
    """One chunk of the trial loop: sample one round of delays per trial
    id, form slot arrivals (eq. 1) and score every scheme of the bucket."""
    T1, T2 = model.sample(seed, tids, n, r_max)
    return eval_fn(slot_arrival_times(T1, T2), params)


def _run(specs: Sequence[SchemeSpec], model, n: int, *, trials: int,
         seed: int, chunk: Optional[int], ks: Optional[int],
         want_samples: bool, devices=None):
    dev = _single_device(devices)
    specs = _validate_single_round(specs, n, ks)
    r_max = max(sp.load for sp in specs)
    chunk = _normalize_chunk(trials, chunk)
    sig, params, slots = _eval_layout(specs, n, r_max, ks)
    eval_fn = _build_bucket_eval(sig)
    pt = params_on(params, dev)
    offs = torch.arange(chunk, dtype=torch.int64, device=dev)
    samples: Dict[str, list] = {}
    p0: Dict[str, list] = {}
    p1: Dict[str, list] = {}
    for start in range(0, trials, chunk):
        tids_raw = start + offs
        # a partial last chunk repeats the last real trial in masked lanes
        st = _chunk_stats(model, seed, tids_raw.clamp(max=trials - 1), n,
                          r_max, eval_fn, pt)
        ok = (tids_raw < trials).reshape(-1, 1, 1)
        for g, v in st.items():
            if want_samples:
                samples.setdefault(g, []).append(v)
                continue
            p0.setdefault(g, []).append(_tree_sum(torch.where(ok, v, 0.0)))
            p1.setdefault(g, []).append(_tree_sum(torch.where(ok, v * v, 0.0)))

    if want_samples:
        ys = {g: torch.cat(v, dim=0)[:trials] for g, v in samples.items()}
        return {name: ys[g][:, i, :] for name, (g, i) in slots.items()}

    # per-chunk float32 partials -> float64 on the host, in global chunk
    # order
    mu_g = {g: torch.stack(v).cpu().numpy().astype(np.float64).sum(axis=0)
            / trials for g, v in p0.items()}
    sq_g = {g: torch.stack(v).cpu().numpy().astype(np.float64).sum(axis=0)
            for g, v in p1.items()}
    means, stderr = {}, {}
    for name, (g, i) in slots.items():
        mu = mu_g[g][i]
        var = np.maximum(sq_g[g][i] / trials - mu * mu, 0.0)
        means[name] = mu
        stderr[name] = np.sqrt(var / trials)
    return means, stderr


# ------------------------------- public API ----------------------------------

@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Mean completion times (and MC standard errors) per scheme.

    ``means[name]`` has one column per k in 1..n in all-k mode
    (``ks=None``), a single column for single-k sweeps and for coded
    schemes (their own decode thresholds)."""
    means: Dict[str, np.ndarray]
    stderr: Dict[str, np.ndarray]
    trials: int
    n: int
    ks: Optional[int]
    fixed: frozenset = frozenset()      # pc/pcmm: scheme-defined thresholds

    def at_k(self, name: str, k: Optional[int] = None) -> float:
        """Mean completion time of ``name`` at target ``k`` (ignored for
        coded schemes)."""
        if name not in self.means:
            raise ValueError(f"unknown scheme {name!r}; have "
                             f"{sorted(self.means)}")
        v = self.means[name]
        if name in self.fixed:
            return float(v[0])
        if k is None:
            raise ValueError(f"{name} needs an explicit k")
        if v.shape[-1] == self.n:
            if not 1 <= k <= self.n:
                raise ValueError(f"need 1 <= k <= {self.n}, got {k}")
            return float(v[k - 1])
        if self.ks is not None and k != self.ks:
            raise ValueError(f"sweep ran with k={self.ks}; asked for k={k}")
        return float(v[0])


def sweep(specs: Sequence[SchemeSpec], model, n: int, *, trials: int = 20000,
          seed: int = 0, chunk: Optional[int] = None,
          ks: Optional[int] = None, devices=None) -> SweepResult:
    """Evaluate every scheme against ONE shared set of delay draws.

    ``model`` is a ``DelayModel``; ``n`` the number of tasks (= workers);
    ``chunk`` streams the trials in chunks of that size (default one chunk;
    per-trial samples are chunk-invariant, means agree to float32
    round-off); ``ks=None`` gives every k in 1..n from one sort, an int only
    that order statistic.  ``devices``: the one device to run on (``None``
    = the CUDA card; ``"cpu"`` to run on the CPU)."""
    means, stderr = _run(specs, model, n, trials=trials, seed=seed,
                         chunk=chunk, ks=ks, want_samples=False,
                         devices=devices)
    fixed = frozenset(sp.name for sp in specs if sp.kind in ("pc", "pcmm"))
    return SweepResult(means=means, stderr=stderr, trials=trials, n=n, ks=ks,
                       fixed=fixed)


def completion_samples(spec: SchemeSpec, model, n: int, *, trials: int = 10000,
                       seed: int = 0, chunk: Optional[int] = None,
                       k: Optional[int] = None, devices=None) -> torch.Tensor:
    """Per-trial completion-time samples for one scheme: ``(trials,)`` when
    ``k`` is given (or for coded schemes), else ``(trials, n)`` with column
    ``k-1`` holding the k-th order statistic."""
    out = _run([spec], model, n, trials=trials, seed=seed, chunk=chunk,
               ks=k, want_samples=True, devices=devices)[spec.name]
    return out[:, 0] if out.shape[-1] == 1 else out


def task_arrival_samples(C, model, *, trials: int = 10000, seed: int = 0,
                         chunk: Optional[int] = None,
                         messages: Optional[int] = None,
                         loads=None, comm_eps: float = 0.0,
                         devices=None) -> torch.Tensor:
    """Raw per-task arrival-time samples ``tau`` of shape (trials, n) for a
    TO matrix (tasks with no active copy come out +inf)."""
    n = np.asarray(C).shape[0]
    spec = tau_spec("tau", C, messages=messages, loads=loads,
                    comm_eps=comm_eps)
    return _run([spec], model, n, trials=trials, seed=seed, chunk=chunk,
                ks=None, want_samples=True, devices=devices)[spec.name]


# ----------------------------- rounds axis -----------------------------------

def _build_rounds_fn(specs: Tuple[SchemeSpec, ...], process, n: int,
                     r_max: int, ks: int, rounds: int, beta: float,
                     gamma: float, censored: bool,
                     greedy_impl: Optional[str], device: torch.device):
    """Multi-round evaluator for one chunk: ``(seed, tids)`` -> {name:
    (rounds, chunk)} per-round completion times (the JAX package's
    ``_build_rounds_fn`` without deadlines and re-balancing).

    A Python loop over rounds carries (a) the delay process's state and (b)
    the adaptive schemes' per-trial delay estimates.  Every scheme scores
    the same delay realization each round (common random numbers).  Static
    schemes go through the bucketed single-round evaluator at ``ks``;
    adaptive ones re-assign their base rows from the estimates of earlier
    rounds, permute the worker axis and take the k-th task arrival.

    Feedback: uncensored, one estimate shared by the adaptive schemes, set
    to the round's mean compute delay per worker in round 0 and an EMA
    with weight ``beta`` on history after (+inf observations keep the old
    estimate); censored, one estimate per scheme, updated by
    ``scheduling.censored_feedback_update`` from the messages that beat
    that scheme's own round close.  Slot sums are explicit left folds."""
    static_specs = tuple(sp for sp in specs if sp.kind != "adaptive")
    ad_specs = tuple(sp for sp in specs if sp.kind == "adaptive")
    eval_fn = None
    if static_specs:
        sig, params, slots = _eval_layout(static_specs, n, r_max, ks)
        eval_fn = _build_bucket_eval(sig)
        pt = params_on(params, device)
    ad_mats = tuple(sp.matrix() for sp in ad_specs)
    ad_plans = tuple(_index_on(_plan_of(sp, n, r_max), device)
                     for sp in ad_specs)
    ad_mmaps = tuple(_slot_map_of(sp) for sp in ad_specs)
    ad_mmaps_t = tuple(None if m is None else _index_on(m, device)
                       for m in ad_mmaps)
    ad_lrow = tuple(None if sp.loads is None
                    else _index_on(np.asarray(sp.loads, np.int64), device)
                    for sp in ad_specs)

    def _worker_arrivals(i, w_of_row, s):
        """Worker-major per-message arrivals feeding the censored feedback:
        worker w's own slots, grouped by the message layout of the row it
        executes, +inf beyond that row's load."""
        r_sp = ad_mats[i].shape[1]
        s_w = s[..., :, :r_sp]
        mmap, mm_t = ad_mmaps[i], ad_mmaps_t[i]
        row_of_worker = None
        if mmap is None:
            arr_w = s_w
        elif mmap.ndim == 1:                       # row-invariant map
            arr_w = s_w[..., mm_t]
        else:
            row_of_worker = torch.argsort(w_of_row, dim=-1)
            arr_w = torch.take_along_dim(s_w, mm_t[row_of_worker], dim=-1)
        if ad_lrow[i] is not None:                 # static ragged rows
            if row_of_worker is None:
                row_of_worker = torch.argsort(w_of_row, dim=-1)
            l_of_w = ad_lrow[i][row_of_worker]
            act = (torch.arange(r_sp, device=s.device)[None, None, :]
                   < l_of_w[..., None])
            arr_w = torch.where(act, arr_w, INF)
        return arr_w

    def rounds_fn(seed: int, tids: torch.Tensor) -> Dict[str, torch.Tensor]:
        chunk = tids.shape[0]
        pstate = process.init_trials(rng.round_seed(seed, 0), tids, n)
        if censored:
            ests = [torch.full((chunk, n), INF, device=device)
                    for _ in ad_specs]
        else:
            est = torch.ones((chunk, n), device=device)
        times: Dict[str, list] = {sp.name: [] for sp in specs}
        for t in range(rounds):
            pstate, T1, T2 = process.step(pstate, rng.round_seed(seed, t + 1),
                                          tids, n, r_max)
            s = slot_arrival_times(T1, T2)                  # eq. (1)
            if eval_fn is not None:
                out = eval_fn(s, pt)
                for name, (g, i) in slots.items():
                    times[name].append(out[g][:, i, 0])
            new_ests = []
            for i, sp in enumerate(ad_specs):
                e = ests[i] if censored else est
                w_of_row = scheduling.greedy_row_assignment_batch(
                    ad_mats[i], e, gamma=gamma,
                    impl=greedy_impl).to(torch.int64)
                # row p's slots are executed by worker w_of_row[p]
                s2 = torch.take_along_dim(s, w_of_row[..., None], dim=1)
                tau = task_arrival_times_gather(ad_plans[i], s2)
                v = _smallest(tau, ks)[..., -1]
                times[sp.name].append(v)
                if censored:
                    r_sp = ad_mats[i].shape[1]
                    new_ests.append(scheduling.censored_feedback_update(
                        e, T1[..., :r_sp], _worker_arrivals(i, w_of_row, s),
                        v, beta=beta))
            if censored:
                ests = new_ests
            elif ad_specs:
                # per-worker mean compute delay (a left-fold sum times the
                # float32 reciprocal of r, as XLA evaluates the reference's
                # mean); a +inf observation keeps the previous estimate
                obs = scheduling._left_fold_sum(T1) * (1.0 / T1.shape[-1])
                upd = obs if t == 0 else beta * est + (1.0 - beta) * obs
                est = torch.where(torch.isfinite(obs), upd, est)
        return {name: torch.stack(v) for name, v in times.items()}

    return rounds_fn


def _check_rounds_args(specs, n, ks, rounds):
    specs = _check_specs(specs, n)
    for sp in specs:
        if sp.kind == "tau":
            raise ValueError(f"{sp.name}: tau specs are single-round only")
    if not 1 <= ks <= n:
        raise ValueError(f"need 1 <= k <= n={n}, got k={ks}")
    for sp in specs:
        if sp.kind in ("to", "adaptive") and _covered_tasks(sp) < ks:
            raise ValueError(
                f"{sp.name}: ragged schedule covers only "
                f"{_covered_tasks(sp)} distinct tasks < k={ks}; the "
                f"completion time would be infinite")
    if rounds < 1:
        raise ValueError(f"need rounds >= 1, got {rounds}")
    return specs


def _run_rounds(specs, process, n, *, rounds: int, k: int, trials: int,
                seed: int, chunk: Optional[int], beta: float, gamma: float,
                censored: bool, want_samples: bool, record: bool = False,
                deadline: Optional[float] = None,
                deadline_policy: str = "wait", devices=None,
                greedy_impl: Optional[str] = None):
    from .cluster import as_process
    from .spec import validate_deadline
    if validate_deadline(deadline, deadline_policy) is not None:
        raise NotImplementedError(f"round deadlines {_LATER}")
    if record:
        raise NotImplementedError(f"trace recording (record_trace) {_LATER}")
    dev = _single_device(devices)
    process = as_process(process)
    process.check_rounds(rounds)
    specs = _check_rounds_args(specs, n, k, rounds)
    scheduling._resolve_greedy_impl(greedy_impl)
    rng.round_seed(seed, rounds)                 # validate the seed range
    r_max = max(sp.load for sp in specs)
    chunk = _normalize_chunk(trials, chunk)
    rounds_fn = _build_rounds_fn(specs, process, n, r_max, k, rounds, beta,
                                 gamma, censored, greedy_impl, dev)
    offs = torch.arange(chunk, dtype=torch.int64, device=dev)
    samples: Dict[str, list] = {}
    parts: Dict[str, list] = {}
    for start in range(0, trials, chunk):
        tids_raw = start + offs
        # a partial last chunk repeats the last real trial in masked lanes
        ys = rounds_fn(seed, tids_raw.clamp(max=trials - 1))
        if want_samples:
            for nm, v in ys.items():
                samples.setdefault(nm, []).append(v)
            continue
        ok = (tids_raw < trials)[None, :]
        for nm, v in ys.items():
            cum = _left_fold(v, 0)
            parts.setdefault(nm, []).append(torch.stack([
                _tree_sum(torch.where(ok, x, 0.0).T)
                for x in (v, v * v, cum, cum * cum)]))

    if want_samples:
        return {nm: torch.cat(v, dim=1)[:, :trials].T
                for nm, v in samples.items()}

    def moments(p0, p1):
        mu = p0.sum(axis=0) / trials
        var = np.maximum(p1.sum(axis=0) / trials - mu * mu, 0.0)
        return mu, np.sqrt(var / trials)

    per_round, stderr, wallclock, wc_stderr = {}, {}, {}, {}
    for nm, v in parts.items():
        # per-chunk float32 partials -> float64 in global chunk order
        p = torch.stack(v).cpu().numpy().astype(np.float64)  # (nc, 4, R)
        per_round[nm], stderr[nm] = moments(p[:, 0], p[:, 1])
        wallclock[nm], wc_stderr[nm] = moments(p[:, 2], p[:, 3])
    return per_round, stderr, wallclock, wc_stderr


@dataclasses.dataclass(frozen=True)
class RoundsResult:
    """Wall-clock trajectories from a multi-round sweep.

    ``per_round[name]``  (rounds,) mean completion time of each round;
    ``wallclock[name]``  (rounds,) mean cumulative wall-clock after each
                         round; ``stderr`` / ``wallclock_stderr`` the
                         matching Monte-Carlo standard errors."""
    per_round: Dict[str, np.ndarray]
    stderr: Dict[str, np.ndarray]
    wallclock: Dict[str, np.ndarray]
    wallclock_stderr: Dict[str, np.ndarray]
    trials: int
    rounds: int
    n: int
    k: int

    def _get(self, d: Dict[str, np.ndarray], name: str) -> np.ndarray:
        if name not in d:
            raise ValueError(f"unknown scheme {name!r}; have {sorted(d)}")
        return d[name]

    def mean_round(self, name: str) -> float:
        """Mean completion time per round, averaged over the run."""
        return float(self._get(self.per_round, name).mean())

    def total(self, name: str) -> float:
        """Mean wall-clock of the whole run."""
        return float(self._get(self.wallclock, name)[-1])


def sweep_rounds(specs: Sequence[SchemeSpec], process, n: int, *,
                 rounds: int, k: int, trials: int = 20000, seed: int = 0,
                 chunk: Optional[int] = None, feedback_beta: float = 0.7,
                 coverage_gamma: float = 0.5,
                 censored_feedback: bool = False,
                 record_trace: bool = False,
                 deadline: Optional[float] = None,
                 deadline_policy: str = "wait", devices=None,
                 greedy_impl: Optional[str] = None) -> RoundsResult:
    """Evaluate every scheme over ``rounds`` consecutive rounds of ONE
    shared ``DelayProcess`` realization per trial (a stateless
    ``DelayModel`` is coerced to ``IIDProcess``, a ``DelayTrace`` to a
    ``TraceProcess``).  ``adaptive_spec`` entries re-assign their base
    matrix's rows each round from delay feedback (EMA weight
    ``feedback_beta``, coverage discount ``coverage_gamma``;
    ``censored_feedback`` restricts it to messages that beat the scheme's
    own round close).  ``k`` is the single computation target; ``seed``
    (below 2**32), ``trials`` and ``chunk`` as in ``sweep``; ``devices``
    the one device (``None`` = the CUDA card).  ``greedy_impl``: ``None``/
    ``"auto"``/``"kernel"`` (the ``greedy_assign`` kernel on the card, its
    plain version on the CPU) or ``"scan"`` (the plain version anywhere).
    ``deadline``/``deadline_policy`` and ``record_trace`` wait for a later
    slice of the port."""
    per_round, stderr, wallclock, wc_stderr = _run_rounds(
        specs, process, n, rounds=rounds, k=k, trials=trials, seed=seed,
        chunk=chunk, beta=feedback_beta, gamma=coverage_gamma,
        censored=censored_feedback, want_samples=False,
        record=record_trace, deadline=deadline,
        deadline_policy=deadline_policy, devices=devices,
        greedy_impl=greedy_impl)
    return RoundsResult(per_round=per_round, stderr=stderr,
                        wallclock=wallclock, wallclock_stderr=wc_stderr,
                        trials=trials, rounds=rounds, n=n, k=k)


def trajectory_samples(spec: SchemeSpec, process, n: int, *, rounds: int,
                       k: int, trials: int = 10000, seed: int = 0,
                       chunk: Optional[int] = None,
                       feedback_beta: float = 0.7,
                       coverage_gamma: float = 0.5,
                       censored_feedback: bool = False,
                       record_trace: bool = False,
                       deadline: Optional[float] = None,
                       deadline_policy: str = "wait", devices=None,
                       greedy_impl: Optional[str] = None) -> torch.Tensor:
    """Per-trial completion-time trajectories for one scheme, shape
    ``(trials, rounds)`` (arguments as in ``sweep_rounds``)."""
    return _run_rounds([spec], process, n, rounds=rounds, k=k,
                       trials=trials, seed=seed, chunk=chunk,
                       beta=feedback_beta, gamma=coverage_gamma,
                       censored=censored_feedback, want_samples=True,
                       record=record_trace, deadline=deadline,
                       deadline_policy=deadline_policy, devices=devices,
                       greedy_impl=greedy_impl)[spec.name]
