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
on the card), with idealized or censored feedback; with ``rebalance=True``
they also re-allocate whole slots between workers every round
(``scheduling.greedy_load_rebalance_batch``).  Round ``t`` draws under
``rng.round_seed(seed, t + 1)`` and the process starts under
``rng.round_seed(seed, 0)``, keyed by the global trial id, so trajectories
are chunk-invariant.  Per-round partials are float32 per chunk, combined in
float64 on the host in global chunk order.

Fault tolerance: a round ``deadline`` closes rounds under the ``wait``,
``close_partial`` or ``reissue`` policy and adds degradation metrics
(realized k, missed rounds, stale gradient mass, the realized-k histogram);
under ``reissue`` the tasks a round did not deliver become the next round's
re-gather priority, the ``need`` rows of the ``greedy_assign`` kernel.
``record_trace=True`` captures the delay tables a run draws as a
``DelayTrace`` and scores the run by replaying them.

The built evaluators are cached (``cache_stats``, ``clear_cache``,
``set_cache_capacity``): one per shape bucket, delay model and device for
the single-round sweep, one per rounds configuration.  ``_dispatch_run``
issues a sweep's chunks without waiting for them (the grid engine keeps a
few in flight); ``ResumableSweep`` extends a sweep's trial axis chunk by
chunk, bit-equal to a fresh sweep at the combined count.

``devices`` shards the trial axis (``repro_torch.sharding``): whole chunks
go to the devices in contiguous blocks (``_shard_layout``, the JAX
package's layout), each device runs its block through the same per-chunk
scans, and the host combines the partials in global chunk order, so every
statistic and every per-trial sample equals the one-device result bit for
bit.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import sharding
from . import rng, scheduling

__all__ = [
    "SchemeSpec", "SweepResult", "to_spec", "lb_spec", "pc_spec",
    "pcmm_spec", "tau_spec", "task_gather_plan",
    "task_arrival_times_gather", "message_boundaries", "message_slot_map",
    "message_group_sizes", "slot_arrival_times", "sweep",
    "completion_samples", "task_arrival_samples", "adaptive_spec",
    "RoundsResult", "sweep_rounds", "trajectory_samples", "clear_cache",
    "cache_stats", "set_cache_capacity", "ResumableSweep", "resumable_sweep",
]

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
    loads: Optional[tuple] = None   # per-worker loads (None = uniform/dense;
                                    # for rebalance: the initial budget)
    rebalance: bool = False         # adaptive only: re-allocate whole slots
                                    # between workers each round
    comm_eps: float = 0.0           # per-message protocol overhead: a
                                    # worker's l-th message lands (l+1)*eps
                                    # late (serialized uplink)

    @property
    def load(self) -> int:
        """Width of this scheme's slot grid (the maximum per-worker load;
        for rebalance specs, the per-worker load cap)."""
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
    carry their loads through the re-permutation); with ``rebalance=True``
    the base must be dense — its width is the per-worker load cap,
    ``loads`` the initial budget — and per-worker loads are re-balanced
    each round from the same feedback."""
    if rebalance:
        # the budget stays a budget: it is not folded into row masks
        lt = (None if loads is None
              else tuple(int(v) for v in np.asarray(loads, np.int64)))
        return SchemeSpec(name=name, kind="adaptive", C=_freeze_matrix(C),
                          messages=messages, loads=lt, rebalance=True)
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


def _rebalance_remap(spec: SchemeSpec) -> Optional[np.ndarray]:
    """The load-indexed closing-slot table of a rebalance spec with a
    message budget (``_rebalance_remap_table``), or None (not a rebalance
    spec, or every slot its own message)."""
    if not spec.rebalance:
        return None
    return _rebalance_remap_table(spec.load, spec.n_messages)


def _rebalance_remap_table(cap: int, messages: int) -> Optional[np.ndarray]:
    """``(cap, cap)`` table whose row ``l - 1`` maps slot ``j < l`` to the
    closing slot of ``j``'s message when ``l`` active slots go out in
    ``min(messages, l)`` messages; slots at or past ``l`` keep the identity
    (they are +inf before the gather).  Re-balanced loads change every
    round, so the rounds engine and the aggregator index this table by the
    realized load.  None when ``messages >= cap``."""
    if messages >= cap:
        return None
    tab = np.empty((cap, cap), np.int64)
    for l in range(1, cap + 1):
        row = np.arange(cap)
        row[:l] = message_slot_map(l, min(messages, l))
        tab[l - 1] = row
    return tab


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


def _build_bucket_eval(sig, deadline: Optional[float] = None):
    """Evaluator for one shape bucket: slot arrivals ``s`` (chunk, n, r_max)
    + ``params`` (``params_on``) -> {group: (chunk, S_g, L_g)}.

    With ``deadline`` it returns ``(out, counts)``, ``counts[group] =
    (by_deadline, deliverable)`` each (chunk, S_g) float32, the JAX
    package's ``_build_eval`` arrival counts: TO specs count the tasks that
    arrive by the deadline and those that arrive at all (finite); LB counts
    slot arrivals capped at n; PC / PCMM decode all-or-nothing, n or 0."""
    _, n, r_max, ks, S_to, M_to, S_tau, M_tau, F_lb, F_pcmm, P_pc = sig
    DL = None if deadline is None else float(np.float32(deadline))

    def _flat_counts(win):
        return ((win <= DL).sum(-1).clamp(max=n).to(torch.float32),
                torch.isfinite(win).sum(-1).clamp(max=n).to(torch.float32))

    def _coded_counts(v0):
        return (torch.where(v0 <= DL, float(n), 0.0),
                torch.where(torch.isfinite(v0), float(n), 0.0))

    def eval_fn(s: torch.Tensor, params):
        out: Dict[str, torch.Tensor] = {}
        cnts: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        if F_lb or F_pcmm:
            sf = s.reshape(s.shape[0], -1)
            s_pad = torch.cat([sf, sf.new_full((sf.shape[0], 1), INF)], -1)
        if S_to:
            tau = task_arrival_times_gather(
                params["to_plan"], s, params["to_off"])
            out["to"] = (torch.sort(tau, dim=-1).values if ks is None
                         else _smallest(tau, ks)[..., -1:])
            if DL is not None:
                cnts["to"] = ((tau <= DL).sum(-1).to(torch.float32),
                              torch.isfinite(tau).sum(-1).to(torch.float32))
        if S_tau:
            out["tau"] = task_arrival_times_gather(
                params["tau_plan"], s, params["tau_off"])
        if F_lb:
            win = s_pad[:, params["lb_idx"]] + params["lb_off"]
            fs = _smallest(win, n if ks is None else ks)
            out["lb"] = fs if ks is None else fs[..., -1:]
            if DL is not None:
                # oracle: the first results received are distinct, so the
                # realized count is the slot-arrival count capped at n
                cnts["lb"] = _flat_counts(win)
        if F_pcmm:
            th = _pcmm_threshold(n)
            win = s_pad[:, params["pcmm_idx"]] + params["pcmm_off"]
            out["pcmm"] = _smallest(win, th)[..., -1:]
            if DL is not None:
                cnts["pcmm"] = _coded_counts(out["pcmm"][..., -1])
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
            if DL is not None:
                cnts["pc"] = _coded_counts(out["pc"][..., -1])
        return out if DL is None else (out, cnts)

    return eval_fn


# ----------------------- evaluator caches + observability ---------------------

class _LRUCache:
    """Least-recently-used bound on the built-evaluator caches, and the
    home of the counters ``cache_stats()`` reports.  The port compiles
    nothing: an entry is a built evaluator (its closures and the device
    tensors they hold), and ``compile_s`` sums the seconds spent building
    the entries, not a compile time."""

    def __init__(self, capacity: int = 128):
        self.capacity = int(capacity)
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compile_s = 0.0

    def get(self, key):
        hit = self._d.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        self._trim()

    def set_capacity(self, capacity: int) -> None:
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._trim()

    def _trim(self) -> None:
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)            # evict least recent
            self.evictions += 1

    def clear(self) -> None:
        self._d.clear()

    def stats(self) -> dict:
        return {"size": len(self._d), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "compile_s": round(self.compile_s, 6)}


_EXEC_CACHE = _LRUCache()
_ROUNDS_CACHE = _LRUCache()
_BUILD_COUNT = 0


def _cached(cache: _LRUCache, key, build):
    """``cache[key]``, or ``build()`` stored under ``key``; an unhashable
    key (a custom model or process) builds uncached, and so does ``key=None``.
    Every build counts in ``cache_stats()["traces"]`` and its seconds in
    the cache's ``compile_s``."""
    global _BUILD_COUNT
    if key is not None:
        try:
            hit = cache.get(key)
        except TypeError:                  # unhashable: build uncached
            key = None
        else:
            if hit is not None:
                return hit
    t0 = time.perf_counter()
    fn = build()
    cache.compile_s += time.perf_counter() - t0
    _BUILD_COUNT += 1
    if key is not None:
        cache.put(key, fn)
    return fn


def clear_cache() -> None:
    """Drop the built evaluators (mainly for benchmarking cold starts)."""
    _EXEC_CACHE.clear()
    _ROUNDS_CACHE.clear()


def set_cache_capacity(capacity: int) -> None:
    """Bound both evaluator caches to ``capacity`` entries (evicting the
    least-recently-used at once if already over)."""
    _EXEC_CACHE.set_capacity(capacity)
    _ROUNDS_CACHE.set_capacity(capacity)


def cache_stats() -> dict:
    """The evaluator caches, in the JAX package's schema: ``exec`` (the
    single-round evaluators, one per shape bucket, delay model and device)
    and ``rounds`` (the rounds evaluators) each with ``size``,
    ``capacity``, ``hits``, ``misses``, ``evictions`` and ``compile_s``,
    and ``traces``.  The port compiles nothing, so ``traces`` counts
    evaluator builds since import and ``compile_s`` the seconds spent
    building them (closures and their device tensors; no kernel is built
    here) -- one build per shape bucket when the cache holds."""
    return {"exec": _EXEC_CACHE.stats(), "rounds": _ROUNDS_CACHE.stats(),
            "traces": _BUILD_COUNT}


def _get_exec(sig, model, devs: Tuple[torch.device, ...]):
    """The built single-round evaluator of one shape bucket for ``model``
    on the device tuple ``devs``, cached by ``(sig, model, devs)`` (the
    JAX package's key): ``sig`` carries only counts and padded widths
    (``_eval_layout``), so every sweep with the same scheme-kind structure
    reuses it with its own runtime ``params``.

    ``scan(seed, starts, chunk, limit, params, *, sums, samples)`` issues
    one chunk per global start id, the chunks dealt to ``devs`` in
    contiguous blocks (``sharding.issue_order``): trial ids ``start +
    arange(chunk)`` (lanes at or past ``limit`` repeat the last real trial
    and are masked out), one round of delays per trial, slot arrivals (eq.
    1), every scheme of the bucket scored with the layout ``params``
    (numpy, moved once to each device).  It returns ``(p0, p1, ys)``: with
    ``sums`` the per-chunk float32 partials of the statistics and of their
    squares (``_tree_sum`` over the chunk, so their bits depend on the
    chunk length alone), with ``samples`` the per-chunk statistics, each
    ``{group: [per-chunk tensors]}`` in global chunk order on the devices
    that ran them.  Nothing in it syncs the host."""
    n, r_max = sig[1], sig[2]

    def build():
        eval_fn = _build_bucket_eval(sig)

        def scan(seed, starts, chunk, limit, params, *, sums=True,
                 samples=False):
            starts = list(starts)
            local = {d: (torch.arange(chunk, dtype=torch.int64, device=d),
                         params_on(params, d)) for d in dict.fromkeys(devs)}
            out = [None] * len(starts)
            for i, d in sharding.issue_order(len(starts), devs):
                offs, pt = local[d]
                tids_raw = starts[i] + offs
                T1, T2 = model.sample(seed, tids_raw.clamp(max=limit - 1), n,
                                      r_max)
                st = eval_fn(slot_arrival_times(T1, T2), pt)
                ok = (tids_raw < limit).reshape(-1, 1, 1)
                out[i] = {g: (_tree_sum(torch.where(ok, v, 0.0))
                              if sums else None,
                              _tree_sum(torch.where(ok, v * v, 0.0))
                              if sums else None,
                              v if samples else None)
                          for g, v in st.items()}
            p0: Dict[str, list] = {}
            p1: Dict[str, list] = {}
            ys: Dict[str, list] = {}
            for part in out:
                for g, (a, b, v) in part.items():
                    if sums:
                        p0.setdefault(g, []).append(a)
                        p1.setdefault(g, []).append(b)
                    if samples:
                        ys.setdefault(g, []).append(v)
            return p0, p1, ys

        return scan

    return _cached(_EXEC_CACHE, (sig, model, devs), build)


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


def _shard_layout(trials: int, chunk: int, devices):
    """Device and padding layout of a sharded sweep, the JAX package's
    ``_shard_layout``: the trial axis is cut into ``ceil(trials / chunk)``
    chunks whatever the device count (which keeps sharded results bit-equal
    to one device), the chunks go to the devices in contiguous blocks, and
    the chunk count is padded up to a multiple of the ``d_eff`` devices
    used.  Returns ``(devs[:d_eff], nc_pad, padded_trials)``, read off
    ``sharding.chunk_blocks``, the one layout that the scans deal their
    chunks by.  The port runs no padded chunk; the JAX package's padded
    lanes repeat the last real trial and are masked out, so both give the
    same statistics."""
    devs = sharding.trial_devices(devices)
    blocks = sharding.chunk_blocks(-(-trials // chunk), len(devs))
    nc_pad = len(blocks) * len(blocks[0])
    return devs[:len(blocks)], nc_pad, nc_pad * chunk


def _to_host(ts: Sequence[torch.Tensor], join=torch.stack) -> np.ndarray:
    """Per-chunk tensors, in global chunk order and possibly on several
    devices, joined (``torch.stack`` or ``torch.cat`` along axis 0) on the
    host: one transfer for each run of chunks on one device."""
    runs: list = []
    for t in ts:
        if runs and runs[-1][0].device == t.device:
            runs[-1].append(t)
        else:
            runs.append([t])
    parts = [join(r).cpu().numpy() for r in runs]
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


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
        if sp.kind in ("to", "tau", "adaptive") and not sp.rebalance:
            C = sp.matrix()
            if sp.loads is not None or (C < 0).any():
                scheduling.validate_to_matrix(C, n, loads=sp.loads)
        if sp.rebalance:
            if sp.kind != "adaptive":
                raise ValueError(f"{sp.name}: rebalance is only defined for "
                                 f"adaptive specs")
            C = sp.matrix()
            if (C < 0).any():
                raise ValueError(f"{sp.name}: rebalance needs a dense base "
                                 f"matrix (its width is the load cap)")
            if sp.loads is None:
                raise ValueError(f"{sp.name}: rebalance needs an initial "
                                 f"loads budget below the grid width")
            if sorted(C[:, 0].tolist()) != list(range(n)):
                raise ValueError(
                    f"{sp.name}: rebalance needs a slot-0 diagonal (every "
                    f"row's first task distinct, e.g. CS/SS) so any load "
                    f"vector keeps all tasks covered")
            if sp.comm_eps:
                raise ValueError(f"{sp.name}: rebalance does not support "
                                 f"comm_eps yet")
        elif sp.comm_eps and sp.kind == "adaptive":
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


class _Pending:
    """A dispatched sweep: its chunks' work is issued (asynchronously on a
    card) and its per-chunk partials are still device tensors.
    ``resolve()`` is the one host sync; it finishes the float64 host
    combine.  ``stream_grid`` keeps a few of these in flight."""

    __slots__ = ("_resolve", "_out", "_done")

    def __init__(self, resolve_fn):
        self._resolve = resolve_fn
        self._out = None
        self._done = False

    def resolve(self):
        if not self._done:
            self._out = self._resolve()
            self._done = True
            self._resolve = None
        return self._out


def _combine(p0: Dict[str, list], p1: Dict[str, list], slots, trials: int):
    """Per-chunk float32 partials -> float64 on the host, in global chunk
    order: ``(means, stderr)`` per scheme name."""
    mu_g = {g: _to_host(v).astype(np.float64).sum(axis=0) / trials
            for g, v in p0.items()}
    sq_g = {g: _to_host(v).astype(np.float64).sum(axis=0)
            for g, v in p1.items()}
    means, stderr = {}, {}
    for name, (g, i) in slots.items():
        mu = mu_g[g][i]
        var = np.maximum(sq_g[g][i] / trials - mu * mu, 0.0)
        means[name] = mu
        stderr[name] = np.sqrt(var / trials)
    return means, stderr


def _dispatch_run(specs: Sequence[SchemeSpec], model, n: int, *, trials: int,
                  seed: int, chunk: Optional[int], ks: Optional[int],
                  want_samples: bool, devices=None) -> _Pending:
    """Validate and issue one sweep without waiting for its results: every
    chunk's work is issued and its float32 partials stay on the devices
    that ran it.  The returned ``_Pending`` resolves to ``_run``'s output
    (per-trial samples gathered on the first device)."""
    specs = _validate_single_round(specs, n, ks)
    r_max = max(sp.load for sp in specs)
    chunk = _normalize_chunk(trials, chunk)
    devs, _, _ = _shard_layout(trials, chunk, devices)
    sig, params, slots = _eval_layout(specs, n, r_max, ks)
    scan = _get_exec(sig, model, devs)
    p0, p1, ys = scan(seed, range(0, trials, chunk), chunk, trials, params,
                      sums=not want_samples, samples=want_samples)

    if want_samples:
        def resolve_samples():
            cat = {g: torch.cat([x.to(devs[0]) for x in v], dim=0)[:trials]
                   for g, v in ys.items()}
            return {name: cat[g][:, i, :] for name, (g, i) in slots.items()}
        return _Pending(resolve_samples)
    return _Pending(lambda: _combine(p0, p1, slots, trials))


def _run(specs: Sequence[SchemeSpec], model, n: int, *, trials: int,
         seed: int, chunk: Optional[int], ks: Optional[int],
         want_samples: bool, devices=None):
    return _dispatch_run(specs, model, n, trials=trials, seed=seed,
                         chunk=chunk, ks=ks, want_samples=want_samples,
                         devices=devices).resolve()


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


def _reject_single_round_trace(record_trace: bool, fn: str) -> None:
    """The single-round entry points take ``record_trace`` for signature
    uniformity with the rounds axis and refuse ``True``."""
    if record_trace:
        raise ValueError(f"record_trace is only available on the rounds "
                         f"axis (sweep_rounds / trajectory_samples); "
                         f"{fn} evaluates a single round and has no "
                         f"per-round delay tables to record")


def sweep(specs: Sequence[SchemeSpec], model, n: int, *, trials: int = 20000,
          seed: int = 0, chunk: Optional[int] = None,
          ks: Optional[int] = None, record_trace: bool = False,
          devices=None) -> SweepResult:
    """Evaluate every scheme against ONE shared set of delay draws.

    ``model`` is a ``DelayModel``; ``n`` the number of tasks (= workers);
    ``chunk`` streams the trials in chunks of that size (default one chunk;
    per-trial samples are chunk-invariant, means agree to float32
    round-off); ``ks=None`` gives every k in 1..n from one sort, an int only
    that order statistic.  ``devices`` shards the trial axis: ``None``
    every CUDA card, an int the first that many, a device (``"cpu"`` to
    run on the CPU) or a sequence of devices of one type, repeats allowed;
    whole chunks are dealt to them in contiguous blocks, so at most
    ``ceil(trials / chunk)`` devices are used, and every result equals the
    one-device result bit for bit.  ``record_trace=True`` raises: a single
    round has no per-round tables to record."""
    _reject_single_round_trace(record_trace, "sweep")
    means, stderr = _run(specs, model, n, trials=trials, seed=seed,
                         chunk=chunk, ks=ks, want_samples=False,
                         devices=devices)
    fixed = frozenset(sp.name for sp in specs if sp.kind in ("pc", "pcmm"))
    return SweepResult(means=means, stderr=stderr, trials=trials, n=n, ks=ks,
                       fixed=fixed)


def completion_samples(spec: SchemeSpec, model, n: int, *, trials: int = 10000,
                       seed: int = 0, chunk: Optional[int] = None,
                       k: Optional[int] = None, record_trace: bool = False,
                       devices=None) -> torch.Tensor:
    """Per-trial completion-time samples for one scheme: ``(trials,)`` when
    ``k`` is given (or for coded schemes), else ``(trials, n)`` with column
    ``k-1`` holding the k-th order statistic."""
    _reject_single_round_trace(record_trace, "completion_samples")
    out = _run([spec], model, n, trials=trials, seed=seed, chunk=chunk,
               ks=k, want_samples=True, devices=devices)[spec.name]
    return out[:, 0] if out.shape[-1] == 1 else out


def task_arrival_samples(C, model, *, trials: int = 10000, seed: int = 0,
                         chunk: Optional[int] = None,
                         messages: Optional[int] = None,
                         loads=None, comm_eps: float = 0.0,
                         record_trace: bool = False,
                         devices=None) -> torch.Tensor:
    """Raw per-task arrival-time samples ``tau`` of shape (trials, n) for a
    TO matrix (tasks with no active copy come out +inf)."""
    _reject_single_round_trace(record_trace, "task_arrival_samples")
    n = np.asarray(C).shape[0]
    spec = tau_spec("tau", C, messages=messages, loads=loads,
                    comm_eps=comm_eps)
    return _run([spec], model, n, trials=trials, seed=seed, chunk=chunk,
                ks=None, want_samples=True, devices=devices)[spec.name]


# ----------------------------- resumable sweeps ------------------------------

class ResumableSweep:
    """A sweep whose trial axis can be *extended* instead of recomputed.

    Trial ``t``'s draws are a pure function of ``(seed, t)`` (``rng``) and
    the statistics combine per-chunk float32 partials (``_tree_sum`` over
    the chunk: their bits depend on the chunk length alone) in float64 in
    global chunk order, so a sweep paused at ``t`` trials continues by
    issuing only the chunks covering trials ``t..total-1``: the new
    partials equal those of the same chunks of a fresh run at ``total``,
    and ``extend_trials(total)`` equals a fresh ``sweep(...,
    trials=total)`` bit for bit.  The racing planner (``core/planner``)
    deepens only the points whose comparison is still close this way.

    * ``chunk`` is required: resumability is defined by the chunk
      decomposition.  Every total but the last must land on a chunk
      boundary (a partial final chunk repeats its last trial in masked
      lanes, so there is no continuation past it: extending raises).
    * ``narrow(names)`` drops schemes from later extensions.  The draws
      keep the original slot-grid width ``r_max``, so the survivors'
      partials do not change.
    * ``keep_samples=True`` also keeps each extension's per-trial
      statistics, float32 numpy on the host (``samples()``, memory
      ``O(trials * L)`` per scheme).  They come from the same chunk scan as
      the partials; the sums still come from the ``_tree_sum`` path that
      ``sweep`` takes, so one code path defines them.
    * ``devices`` as in ``sweep``: each extension's chunks are dealt to
      them in contiguous blocks.
    """

    def __init__(self, specs: Sequence[SchemeSpec], model, n: int, *,
                 seed: int = 0, chunk: int, ks: Optional[int] = None,
                 devices=None, keep_samples: bool = False):
        self._devs = sharding.trial_devices(devices)
        specs = _validate_single_round(specs, n, ks)
        chunk = int(chunk)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got chunk={chunk}")
        self._specs = specs
        self._model = model
        self._n = int(n)
        self._seed = int(seed)
        self._chunk = chunk
        self._ks = ks
        self._keep = bool(keep_samples)
        self._r_max = max(sp.load for sp in specs)
        self._done = 0
        self._p0: Dict[str, list] = {sp.name: [] for sp in specs}
        self._p1: Dict[str, list] = {sp.name: [] for sp in specs}
        self._samp: Dict[str, list] = (
            {sp.name: [] for sp in specs} if self._keep else {})

    @property
    def trials(self) -> int:
        """Trials evaluated so far."""
        return self._done

    @property
    def chunk(self) -> int:
        return self._chunk

    @property
    def spec_names(self) -> Tuple[str, ...]:
        return tuple(sp.name for sp in self._specs)

    def extend_trials(self, total: int) -> SweepResult:
        """Continue the sweep to ``total`` trials and return the combined
        result, bit-equal to ``sweep(..., trials=total)`` at the same
        (seed, chunk)."""
        total = int(total)
        if total <= self._done:
            raise ValueError(
                f"extend_trials: total ({total}) must exceed the "
                f"{self._done} trials already evaluated")
        if self._done % self._chunk != 0:
            raise ValueError(
                f"extend_trials: current total ({self._done}) is not a "
                f"multiple of chunk ({self._chunk}); a partial final chunk "
                f"repeats its last trial in masked lanes, so the sweep "
                f"cannot be extended past it (keep every total but the "
                f"last chunk-aligned)")
        add = total - self._done
        devs, _, _ = _shard_layout(add, self._chunk, self._devs)
        sig, params, slots = _eval_layout(self._specs, self._n, self._r_max,
                                          self._ks)
        scan = _get_exec(sig, self._model, devs)
        p0, p1, ys = scan(self._seed, range(self._done, total, self._chunk),
                          self._chunk, total, params, sums=True,
                          samples=self._keep)
        p0 = {g: _to_host(v) for g, v in p0.items()}
        p1 = {g: _to_host(v) for g, v in p1.items()}
        ys = {g: _to_host(v, torch.cat)[:add] for g, v in ys.items()}
        for name, (g, i) in slots.items():
            self._p0[name].append(p0[g][:, i, :])
            self._p1[name].append(p1[g][:, i, :])
            if self._keep:
                self._samp[name].append(ys[g][:, i, :])
        self._done = total
        return self.result()

    def result(self) -> SweepResult:
        """The combined result over every trial evaluated so far (the same
        float64 host combine as ``sweep``, in global chunk order)."""
        if self._done == 0:
            raise ValueError("no trials evaluated yet; call extend_trials")
        t = self._done
        means: Dict[str, np.ndarray] = {}
        stderr: Dict[str, np.ndarray] = {}
        for sp in self._specs:
            s0 = np.concatenate(self._p0[sp.name], axis=0).astype(np.float64)
            s1 = np.concatenate(self._p1[sp.name], axis=0).astype(np.float64)
            mu = s0.sum(axis=0) / t
            var = np.maximum(s1.sum(axis=0) / t - mu * mu, 0.0)
            means[sp.name] = mu
            stderr[sp.name] = np.sqrt(var / t)
        fixed = frozenset(sp.name for sp in self._specs
                          if sp.kind in ("pc", "pcmm"))
        return SweepResult(means=means, stderr=stderr, trials=t, n=self._n,
                           ks=self._ks, fixed=fixed)

    def samples(self) -> Dict[str, np.ndarray]:
        """Per-trial statistics ``{name: (trials, L)}`` float32 so far
        (paired across schemes: row ``t`` of every scheme saw the same
        delay draws).  Needs ``keep_samples=True``."""
        if not self._keep:
            raise ValueError("per-trial samples were not kept; construct "
                             "with keep_samples=True")
        return {sp.name: np.concatenate(self._samp[sp.name], axis=0)
                for sp in self._specs}

    def narrow(self, names: Sequence[str]) -> None:
        """Drop every scheme not in ``names`` from later extensions (its
        accumulated state is freed).  The draws keep the original
        ``r_max``, so the survivors' partials are unchanged."""
        keep = set(names)
        have = {sp.name for sp in self._specs}
        unknown = sorted(keep - have)
        if unknown:
            raise ValueError(f"narrow: unknown scheme(s) {unknown}; have "
                             f"{sorted(have)}")
        if not keep:
            raise ValueError("narrow: need at least one surviving scheme")
        self._specs = tuple(sp for sp in self._specs if sp.name in keep)
        for d in (self._p0, self._p1, self._samp):
            for nm in list(d):
                if nm not in keep:
                    del d[nm]


def resumable_sweep(specs: Sequence[SchemeSpec], model, n: int, *,
                    seed: int = 0, chunk: int, ks: Optional[int] = None,
                    devices=None, keep_samples: bool = False
                    ) -> ResumableSweep:
    """A ``ResumableSweep`` (see its docstring): a sweep whose trial axis
    extends by ``extend_trials``, bit-equal to a fresh ``sweep`` at the
    combined trial count."""
    return ResumableSweep(specs, model, n, seed=seed, chunk=chunk, ks=ks,
                          devices=devices, keep_samples=keep_samples)


# ----------------------------- rounds axis -----------------------------------

def _build_rounds_fn(specs: Tuple[SchemeSpec, ...], process, n: int,
                     r_max: int, ks: int, rounds: int, beta: float,
                     gamma: float, censored: bool,
                     greedy_impl: Optional[str], device: torch.device,
                     deadline: Optional[float] = None,
                     policy: str = "wait"):
    """Multi-round evaluator for one chunk: ``(seed, tids)`` -> ``(times,
    aux)``, ``times[name]`` the (rounds, chunk) per-round completion times
    and ``aux[name]`` the degradation streams (empty without a deadline);
    the JAX package's ``_build_rounds_fn``.

    A Python loop over rounds carries (a) the delay process's state, (b)
    the adaptive schemes' per-trial delay estimates and, under ``reissue``,
    (c) the per-trial backlog of every scheme and the per-task need of the
    adaptive ones.  Every scheme scores the same delay realization each
    round (common random numbers).  Static schemes go through the bucketed
    single-round evaluator at ``ks``; adaptive ones re-assign their base
    rows from the estimates of earlier rounds (and, for rebalance specs,
    re-balance the per-worker loads and mask each row past its executor's
    load), permute the worker axis and take the k-th task arrival.

    Feedback: uncensored, one estimate shared by the adaptive schemes, set
    to the round's mean compute delay per worker in round 0 and an EMA
    with weight ``beta`` on history after (+inf observations keep the old
    estimate); censored, one estimate per scheme, updated by
    ``scheduling.censored_feedback_update`` from the messages that beat
    that scheme's own (effective) round close.

    ``deadline`` caps every round; ``aux[name]`` then holds ``realized``,
    ``missed`` and ``stale`` (each (rounds, chunk)):

    * ``wait``: times unchanged; ``realized`` = min(deliverable, k),
      ``missed`` marks rounds that closed after the deadline, ``stale`` =
      (k - realized) / k;
    * ``close_partial``: the round closes at min(t_done, deadline) with
      ``realized`` = min(arrived by the deadline, k) results, ``missed`` =
      realized < k, ``stale`` = (k - realized) / k;
    * ``reissue``: as ``close_partial``, but undelivered results pile up in
      a per-trial backlog (``stale`` = backlog / k), and each adaptive
      scheme's undelivered tasks are its next round's ``need``, so the
      greedy assignment re-gathers them first.

    ``stale`` multiplies by the float32 reciprocal of k, as XLA evaluates
    the reference's division by a constant.  With ``deadline=None`` every
    number is what it was before deadlines existed."""
    static_specs = tuple(sp for sp in specs if sp.kind != "adaptive")
    ad_specs = tuple(sp for sp in specs if sp.kind == "adaptive")
    DL = None if deadline is None else float(np.float32(deadline))
    reissue = deadline is not None and policy == "reissue"
    kf, nf = float(ks), float(n)
    rk = float(np.float32(1.0) / np.float32(ks))   # XLA's x / k -> x * (1/k)
    eval_fn = None
    if static_specs:
        sig, params, slots = _eval_layout(static_specs, n, r_max, ks)
        eval_fn = _build_bucket_eval(sig, DL)
        pt = params_on(params, device)
    ad_mats = tuple(sp.matrix() for sp in ad_specs)
    # rebalance specs mask slots per round, so their plan keeps every slot
    # of the dense base; static ragged specs bake their masks in
    ad_plans = tuple(_index_on(task_gather_plan(sp.matrix(), n, r_max)
                               if sp.rebalance else _plan_of(sp, n, r_max),
                               device) for sp in ad_specs)
    ad_mmaps = tuple(None if sp.rebalance else _slot_map_of(sp)
                     for sp in ad_specs)
    ad_mmaps_t = tuple(None if m is None else _index_on(m, device)
                       for m in ad_mmaps)
    ad_remap = tuple(None if (m := _rebalance_remap(sp)) is None
                     else _index_on(m, device) for sp in ad_specs)
    # the same tables over the whole slot grid: slots past the cap keep
    # the identity (they are +inf), so a cap below r_max keeps the grid's
    # width (the JAX package gathers the (cap, cap) table there, and its
    # gather plan then reads clamped indices)
    ad_remap_grid = tuple(
        None if m is None else torch.cat(
            [m, torch.arange(m.shape[0], r_max, device=device).expand(
                m.shape[0], r_max - m.shape[0])], dim=1)
        for m in ad_remap)
    ad_lrow = tuple(None if sp.loads is None or sp.rebalance
                    else _index_on(np.asarray(sp.loads, np.int64), device)
                    for sp in ad_specs)
    ad_l0 = tuple(np.asarray(sp.loads, np.int64) if sp.rebalance else None
                  for sp in ad_specs)

    def _policy_close(v, by, dv):
        """(v_eff, realized, missed) of one scheme's raw completion."""
        if policy == "wait":
            return v, dv.clamp(max=kf), (~(v <= DL)).to(torch.float32)
        return (v.clamp(max=DL), by.clamp(max=kf),
                (by < kf).to(torch.float32))

    def _degrade(nm, v, by, dv, backs, new_backs):
        """The deadline policy on one scheme: (v_eff, aux or None); under
        reissue also the scheme's new backlog."""
        if DL is None:
            return v, None
        v_eff, realized, missed = _policy_close(v, by, dv)
        if reissue:
            nb = (backs[nm] + kf - by.clamp(max=kf)).clamp(0.0, nf)
            new_backs[nm] = nb
            stale = nb * rk
        else:
            stale = (kf - realized) * rk
        return v_eff, {"realized": realized, "missed": missed,
                       "stale": stale}

    def _assign_and_score(i, est, s, need):
        """Greedy row re-assignment (and, for rebalance specs, the load
        re-balance) from ``est``, then this scheme's completion on the
        permuted, masked slot grid: (w_of_row, loads_w, v, tau)."""
        sp = ad_specs[i]
        w_of_row = scheduling.greedy_row_assignment_batch(
            ad_mats[i], est, gamma=gamma, need=need,
            impl=greedy_impl).to(torch.int64)
        # row p's slots are executed by worker w_of_row[p]
        s2 = torch.take_along_dim(s, w_of_row[..., None], dim=1)
        loads_w = None
        if sp.rebalance:
            loads_w = scheduling.greedy_load_rebalance_batch(
                est, ad_l0[i], r_max=ad_mats[i].shape[1],
                min_load=1).to(torch.int64)
            # row p inherits its executor's load: trailing slots -> +inf
            l_row = torch.take_along_dim(loads_w, w_of_row, dim=-1)
            act = (torch.arange(s2.shape[-1], device=s.device)[None, None, :]
                   < l_row[..., None])
            s2 = torch.where(act, s2, INF)
            if ad_remap_grid[i] is not None:
                # message budget: slot j rides its message's closing slot,
                # which depends on the row's realized load
                s2 = torch.take_along_dim(s2, ad_remap_grid[i][l_row - 1],
                                          dim=-1)
        tau = task_arrival_times_gather(ad_plans[i], s2)
        return w_of_row, loads_w, _smallest(tau, ks)[..., -1], tau

    def _worker_arrivals(i, w_of_row, loads_w, s):
        """Worker-major per-message arrivals feeding the censored feedback:
        worker w's own slots, grouped by the message layout of the row it
        executes (or of its re-balanced load), +inf beyond its load."""
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
        if loads_w is not None:                    # rebalance: per round
            if ad_remap[i] is not None:
                arr_w = torch.take_along_dim(arr_w, ad_remap[i][loads_w - 1],
                                             dim=-1)
            act = (torch.arange(r_sp, device=s.device)[None, None, :]
                   < loads_w[..., None])
            arr_w = torch.where(act, arr_w, INF)
        elif ad_lrow[i] is not None:               # static ragged rows
            if row_of_worker is None:
                row_of_worker = torch.argsort(w_of_row, dim=-1)
            l_of_w = ad_lrow[i][row_of_worker]
            act = (torch.arange(r_sp, device=s.device)[None, None, :]
                   < l_of_w[..., None])
            arr_w = torch.where(act, arr_w, INF)
        return arr_w

    def rounds_fn(seed: int, tids: torch.Tensor):
        chunk = tids.shape[0]
        pstate = process.init_trials(rng.round_seed(seed, 0), tids, n)
        if censored:
            ests = [torch.full((chunk, n), INF, device=device)
                    for _ in ad_specs]
        else:
            est = torch.ones((chunk, n), device=device)
        backs = ({sp.name: torch.zeros(chunk, device=device) for sp in specs}
                 if reissue else {})
        needs = ({sp.name: torch.zeros((chunk, n), device=device)
                  for sp in ad_specs} if reissue else {})
        times: Dict[str, list] = {sp.name: [] for sp in specs}
        aux: Dict[str, Dict[str, list]] = {}

        def _keep(nm, v_eff, a):
            times[nm].append(v_eff)
            if a is not None:
                for key, x in a.items():
                    aux.setdefault(nm, {}).setdefault(key, []).append(x)

        for t in range(rounds):
            pstate, T1, T2 = process.step(pstate, rng.round_seed(seed, t + 1),
                                          tids, n, r_max)
            s = slot_arrival_times(T1, T2)                  # eq. (1)
            new_backs, new_needs = {}, {}
            if eval_fn is not None:
                out = eval_fn(s, pt)
                cnts = None
                if DL is not None:
                    out, cnts = out
                for name, (g, i) in slots.items():
                    by = dv = None
                    if cnts is not None:
                        by, dv = cnts[g][0][:, i], cnts[g][1][:, i]
                    _keep(name, *_degrade(name, out[g][:, i, 0], by, dv,
                                          backs, new_backs))
            new_ests = []
            for i, sp in enumerate(ad_specs):
                e = ests[i] if censored else est
                w_of_row, loads_w, v, tau = _assign_and_score(
                    i, e, s, needs.get(sp.name))
                by = dv = None
                if DL is not None:
                    by = (tau <= DL).sum(-1).to(torch.float32)
                    dv = torch.isfinite(tau).sum(-1).to(torch.float32)
                v_eff, a = _degrade(sp.name, v, by, dv, backs, new_backs)
                _keep(sp.name, v_eff, a)
                if reissue:
                    # undelivered tasks: next round's re-gather priority,
                    # while a backlog is owed
                    delivered = (tau <= v_eff[..., None]) & torch.isfinite(tau)
                    owed = (new_backs[sp.name] > 0)[..., None]
                    new_needs[sp.name] = (~delivered & owed).to(torch.float32)
                if censored:
                    r_sp = ad_mats[i].shape[1]
                    new_ests.append(scheduling.censored_feedback_update(
                        e, T1[..., :r_sp],
                        _worker_arrivals(i, w_of_row, loads_w, s), v_eff,
                        beta=beta))
            if reissue:
                backs, needs = new_backs, new_needs
            if censored:
                ests = new_ests
            elif ad_specs:
                # per-worker mean compute delay (a left-fold sum times the
                # float32 reciprocal of r, as XLA evaluates the reference's
                # mean); a +inf observation keeps the previous estimate
                obs = scheduling._left_fold_sum(T1) * (1.0 / T1.shape[-1])
                upd = obs if t == 0 else beta * est + (1.0 - beta) * obs
                est = torch.where(torch.isfinite(obs), upd, est)
        return ({name: torch.stack(v) for name, v in times.items()},
                {name: {key: torch.stack(v) for key, v in a.items()}
                 for name, a in aux.items()})

    return rounds_fn


def _get_rounds_exec(specs: Tuple[SchemeSpec, ...], process, n: int,
                     r_max: int, ks: int, rounds: int, beta: float,
                     gamma: float, censored: bool,
                     greedy_impl: Optional[str],
                     devs: Tuple[torch.device, ...],
                     deadline: Optional[float] = None,
                     policy: str = "wait"):
    """``_build_rounds_fn``'s evaluator on each distinct device of
    ``devs`` (``{device: rounds_fn}``), cached by every argument and the
    device tuple (the JAX package's ``_get_rounds_exec`` key).  A
    ``TraceProcess`` stays uncached (its function holds the whole
    recording, and traces are one-shot), and so does an unhashable custom
    process.  A cached function carries no state from one call to the
    next: each call starts its process state, estimates and backlogs
    afresh."""
    from .trace import TraceProcess
    key = (None if isinstance(process, TraceProcess) else
           (specs, process, n, r_max, ks, rounds, beta, gamma, censored,
            deadline, policy, devs, greedy_impl))
    return _cached(_ROUNDS_CACHE, key, lambda: {
        d: _build_rounds_fn(specs, process, n, r_max, ks, rounds, beta,
                            gamma, censored, greedy_impl, d, deadline, policy)
        for d in dict.fromkeys(devs)})


def _capture_tables(process, n: int, r_max: int, rounds: int, seed: int,
                    tids: torch.Tensor):
    """The recording pass for one chunk: step the process alone under the
    same per-round seeds as ``_build_rounds_fn`` and return its tables,
    ``(T1, T2)`` each (rounds, chunk, n, r_max) float32 numpy."""
    pstate = process.init_trials(rng.round_seed(seed, 0), tids, n)
    T1s, T2s = [], []
    for t in range(rounds):
        pstate, T1, T2 = process.step(pstate, rng.round_seed(seed, t + 1),
                                      tids, n, r_max)
        T1s.append(T1.cpu().numpy())
        T2s.append(T2.cpu().numpy())
    return np.stack(T1s), np.stack(T2s)


def _record_trace(process, n, r_max, *, rounds, trials, seed, chunk, devs,
                  meta: dict):
    """The delay tables a rounds run over ``process`` draws, as a
    ``DelayTrace`` (the first pass of ``record_trace=True``): every trial
    id's draws are those of the evaluation, so replaying the trace scores
    the same rounds.  The chunks are dealt to ``devs`` as the evaluation
    deals them."""
    from .trace import DelayTrace
    starts = list(range(0, trials, chunk))
    parts = [None] * len(starts)
    for i, d in sharding.issue_order(len(starts), devs):
        lo = starts[i]
        tids = torch.arange(lo, min(lo + chunk, trials), dtype=torch.int64,
                            device=d)
        parts[i] = _capture_tables(process, n, r_max, rounds, seed, tids)
    return DelayTrace(np.concatenate([p[0] for p in parts], axis=1),
                      np.concatenate([p[1] for p in parts], axis=1),
                      meta=meta)


def _check_rounds_args(specs, n, ks, rounds):
    specs = _check_specs(specs, n)
    for sp in specs:
        if sp.kind == "tau":
            raise ValueError(f"{sp.name}: tau specs are single-round only")
    if not 1 <= ks <= n:
        raise ValueError(f"need 1 <= k <= n={n}, got k={ks}")
    for sp in specs:
        if (sp.kind in ("to", "adaptive") and not sp.rebalance
                and _covered_tasks(sp) < ks):
            raise ValueError(
                f"{sp.name}: ragged schedule covers only "
                f"{_covered_tasks(sp)} distinct tasks < k={ks}; the "
                f"completion time would be infinite")
    if rounds < 1:
        raise ValueError(f"need rounds >= 1, got {rounds}")
    return specs


def _chunk_sums(ys, ok: torch.Tensor):
    """One chunk's partials of each scheme's (rounds, chunk) times: (4,
    rounds) float32 sums over the valid trials of the times, their
    squares, the cumulative wall-clock and its squares."""
    out = {}
    for nm, v in ys.items():
        cum = _left_fold(v, 0)
        out[nm] = torch.stack([_tree_sum(torch.where(ok, x, 0.0).T)
                               for x in (v, v * v, cum, cum * cum)])
    return out


def _chunk_aux(aux, ok: torch.Tensor, ks: int):
    """One chunk's degradation partials: (rounds,) float32 sums over the
    valid trials of realized / missed / stale, and the realized-k histogram
    (rounds, k + 1)."""
    out = {}
    for nm, a in aux.items():
        hist = torch.nn.functional.one_hot(
            a["realized"].to(torch.int64), ks + 1).to(torch.float32)
        hist = torch.where(ok[..., None], hist, 0.0)
        out[nm] = {key: _tree_sum(torch.where(ok, a[key], 0.0).T)
                   for key in ("realized", "missed", "stale")}
        out[nm]["khist"] = _tree_sum(hist.transpose(0, 1))
    return out


def _run_rounds(specs, process, n, *, rounds: int, k: int, trials: int,
                seed: int, chunk: Optional[int], beta: float, gamma: float,
                censored: bool, want_samples: bool, record: bool = False,
                deadline: Optional[float] = None,
                deadline_policy: str = "wait", devices=None,
                greedy_impl: Optional[str] = None):
    """Samples: ``(samples, trace)``; sums: ``(per_round, stderr,
    wallclock, wallclock_stderr, degradation, trace)``."""
    from .cluster import as_process
    from .spec import validate_deadline
    deadline = validate_deadline(deadline, deadline_policy)
    process = as_process(process)
    process.check_rounds(rounds)
    specs = _check_rounds_args(specs, n, k, rounds)
    scheduling._resolve_greedy_impl(greedy_impl)
    rng.round_seed(seed, rounds)                 # validate the seed range
    r_max = max(sp.load for sp in specs)
    chunk = _normalize_chunk(trials, chunk)
    devs, _, _ = _shard_layout(trials, chunk, devices)

    if record:
        # two passes: capture the tables, then score the run by replaying
        # them, so a later replay of the returned trace reproduces it
        from .trace import TraceProcess
        trace = _record_trace(
            process, n, r_max, rounds=rounds, trials=trials, seed=seed,
            chunk=chunk, devs=devs,
            meta={"source": "sweep_rounds", "seed": int(seed), "k": int(k),
                  "process": type(process).__name__,
                  "schemes": [sp.name for sp in specs]})
        out = _run_rounds(specs, TraceProcess(trace), n, rounds=rounds, k=k,
                          trials=trials, seed=seed, chunk=chunk, beta=beta,
                          gamma=gamma, censored=censored,
                          want_samples=want_samples, deadline=deadline,
                          deadline_policy=deadline_policy, devices=devs,
                          greedy_impl=greedy_impl)
        return out[:-1] + (trace,)

    fns = _get_rounds_exec(specs, process, n, r_max, k, rounds, beta,
                           gamma, censored, greedy_impl, devs, deadline,
                           deadline_policy)
    offs = {d: torch.arange(chunk, dtype=torch.int64, device=d)
            for d in fns}
    starts = list(range(0, trials, chunk))
    out = [None] * len(starts)
    for i, d in sharding.issue_order(len(starts), devs):
        tids_raw = starts[i] + offs[d]
        # a partial last chunk repeats the last real trial in masked lanes
        ys, aux = fns[d](seed, tids_raw.clamp(max=trials - 1))
        if want_samples:
            out[i] = ys
            continue
        ok = (tids_raw < trials)[None, :]
        out[i] = (_chunk_sums(ys, ok), _chunk_aux(aux, ok, k))

    if want_samples:
        return ({nm: torch.cat([ys[nm].to(devs[0]) for ys in out],
                               dim=1)[:, :trials].T
                 for nm in out[0]}, None)
    parts: Dict[str, list] = {}
    aux_parts: Dict[str, Dict[str, list]] = {}
    for sums, aux in out:
        for nm, x in sums.items():
            parts.setdefault(nm, []).append(x)
        for nm, a in aux.items():
            for key, x in a.items():
                aux_parts.setdefault(nm, {}).setdefault(key, []).append(x)

    def moments(p0, p1):
        mu = p0.sum(axis=0) / trials
        var = np.maximum(p1.sum(axis=0) / trials - mu * mu, 0.0)
        return mu, np.sqrt(var / trials)

    per_round, stderr, wallclock, wc_stderr = {}, {}, {}, {}
    for nm, v in parts.items():
        # per-chunk float32 partials -> float64 in global chunk order
        p = _to_host(v).astype(np.float64)                    # (nc, 4, R)
        per_round[nm], stderr[nm] = moments(p[:, 0], p[:, 1])
        wallclock[nm], wc_stderr[nm] = moments(p[:, 2], p[:, 3])
    degr = None
    if deadline is not None:
        degr = {nm: {("realized_k" if key == "realized" else key):
                     _to_host(v).astype(np.float64).sum(0) / trials
                     for key, v in a.items()}
                for nm, a in aux_parts.items()}
    return per_round, stderr, wallclock, wc_stderr, degr, None


@dataclasses.dataclass(frozen=True)
class RoundsResult:
    """Wall-clock trajectories from a multi-round sweep.

    ``per_round[name]``  (rounds,) mean completion time of each round;
    ``wallclock[name]``  (rounds,) mean cumulative wall-clock after each
                         round; ``stderr`` / ``wallclock_stderr`` the
                         matching Monte-Carlo standard errors;
    ``trace``            the realized delay tables (a ``DelayTrace``) with
                         ``record_trace=True``, else None;
    ``degradation``      with a ``deadline``, per scheme: ``realized_k``
                         (rounds,) mean distinct results credited a round,
                         ``missed`` (rounds,) share of trials whose round
                         missed the deadline, ``stale`` (rounds,) mean
                         missing-gradient share (reissue: owed backlog /
                         k), ``khist`` (rounds, k + 1) the realized-k
                         distribution; None without a deadline."""
    per_round: Dict[str, np.ndarray]
    stderr: Dict[str, np.ndarray]
    wallclock: Dict[str, np.ndarray]
    wallclock_stderr: Dict[str, np.ndarray]
    trials: int
    rounds: int
    n: int
    k: int
    trace: Optional[object] = None
    deadline: Optional[float] = None
    deadline_policy: str = "wait"
    degradation: Optional[Dict[str, Dict[str, np.ndarray]]] = None

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

    def _degr(self, name: str, key: str) -> np.ndarray:
        if self.degradation is None:
            raise ValueError("no degradation metrics: run sweep_rounds "
                             "with a deadline")
        return self._get(self.degradation, name)[key]

    def realized_k(self, name: str) -> np.ndarray:
        """(rounds,) mean distinct results credited per round (<= k)."""
        return self._degr(name, "realized_k")

    def missed_fraction(self, name: str) -> np.ndarray:
        """(rounds,) share of trials whose round missed the deadline."""
        return self._degr(name, "missed")

    def stale_fraction(self, name: str) -> np.ndarray:
        """(rounds,) mean missing-gradient share per round."""
        return self._degr(name, "stale")

    def khist(self, name: str) -> np.ndarray:
        """(rounds, k+1) realized-k distribution (rows sum to 1)."""
        return self._degr(name, "khist")


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
    own round close) and, with ``rebalance=True``, re-balance whole slots
    between workers.  ``k`` is the single computation target; ``seed``
    (below 2**32), ``trials``, ``chunk`` and ``devices`` as in
    ``sweep``.

    ``record_trace``: also capture the realized per-(round, trial, worker,
    slot) tables as the result's ``trace`` (two passes: capture, then score
    by replaying them; memory O(rounds * trials * n * r_max) floats x2).
    ``deadline`` caps every round and enables ``degradation``;
    ``deadline_policy`` is ``"wait"``, ``"close_partial"`` or ``"reissue"``
    (see ``_build_rounds_fn``).  ``greedy_impl``: ``None``/``"auto"``/
    ``"kernel"`` (the ``greedy_assign`` kernel on the card, its plain
    version on the CPU) or ``"scan"`` (the plain version anywhere)."""
    per_round, stderr, wallclock, wc_stderr, degr, trace = _run_rounds(
        specs, process, n, rounds=rounds, k=k, trials=trials, seed=seed,
        chunk=chunk, beta=feedback_beta, gamma=coverage_gamma,
        censored=censored_feedback, want_samples=False,
        record=record_trace, deadline=deadline,
        deadline_policy=deadline_policy, devices=devices,
        greedy_impl=greedy_impl)
    return RoundsResult(per_round=per_round, stderr=stderr,
                        wallclock=wallclock, wallclock_stderr=wc_stderr,
                        trials=trials, rounds=rounds, n=n, k=k, trace=trace,
                        deadline=(None if deadline is None
                                  else float(deadline)),
                        deadline_policy=deadline_policy, degradation=degr)


def trajectory_samples(spec: SchemeSpec, process, n: int, *, rounds: int,
                       k: int, trials: int = 10000, seed: int = 0,
                       chunk: Optional[int] = None,
                       feedback_beta: float = 0.7,
                       coverage_gamma: float = 0.5,
                       censored_feedback: bool = False,
                       record_trace: bool = False,
                       deadline: Optional[float] = None,
                       deadline_policy: str = "wait", devices=None,
                       greedy_impl: Optional[str] = None):
    """Per-trial completion-time trajectories for one scheme, shape
    ``(trials, rounds)`` (arguments as in ``sweep_rounds``); with a
    deadline, the effective round closes under ``deadline_policy``.  With
    ``record_trace=True`` returns ``(trajectories, DelayTrace)``."""
    samples, trace = _run_rounds(
        [spec], process, n, rounds=rounds, k=k, trials=trials, seed=seed,
        chunk=chunk, beta=feedback_beta, gamma=coverage_gamma,
        censored=censored_feedback, want_samples=True, record=record_trace,
        deadline=deadline, deadline_policy=deadline_policy, devices=devices,
        greedy_impl=greedy_impl)
    if record_trace:
        return samples[spec.name], trace
    return samples[spec.name]
