"""swa_f32_plan, the work plan of the float32 swa_attention kernel
(csrc/swa_attention_f32.cu): blocks hold the heads of one KV group, the
items cover each query tile's visible KV tiles exactly once (whole, or in
two halves that pair up), run longest first, split exactly the ranges
past the given share of the longest, and by the rule split a wide window's
long ranges only where the modelled makespan gains; the plan's layout
constants are the kernel source's.  Then the plan's schedule emulated in
float64 with the kernel's merge of two halves (each its own online-softmax
state) against a float64 evaluation of ``ref.swa_attention_ref``: the
work decomposition itself adds no error."""
import heapq
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

# the card tests' float32 shapes (B, T, H, K, dh, W), and gemma3-4b's prefill
PLAN_SHAPES = [
    (1, 128, 2, 2, 64, 32), (1, 200, 1, 1, 32, 64), (1, 256, 2, 2, 128, 100),
    (1, 64, 4, 4, 16, 8), (3, 77, 6, 2, 16, 5), (2, 300, 8, 4, 256, 70),
    (2, 129, 8, 1, 128, 1000), (1, 257, 4, 4, 256, 1), (2, 300, 8, 1, 64, 130),
    (1, 250, 3, 3, 128, 90), (2, 200, 6, 2, 128, 64),
    (1, 1100, 8, 4, 256, 1024), (2, 513, 4, 2, 256, 129),
    (2, 2048, 8, 4, 256, 1024)]
#: the rule, and a forced split of the ranges past half the longest
SPLITS = [None, 0.5]


def _spans(plan, T, W):
    """Each query tile's visible KV tiles: {x: (first, last)}."""
    return {x: (max(0, x * plan.npos - W + 1) // plan.keys,
                (min((x + 1) * plan.npos, T) - 1) // plan.keys)
            for x in range(-(-T // plan.npos))}


def _cost(item):
    x, lo, hi, code = item
    return (hi - lo + 1 + ops.SWA_F32_BLOCK_COST
            + (ops.SWA_F32_SPLIT_COST if code >= 0 else 0))


def _makespan(costs, copies, slots):
    free = [0.0] * slots
    for c in costs:
        for _ in range(copies):
            heapq.heapreplace(free, free[0] + c)
    return max(free)


@pytest.mark.parametrize("B,T,H,K,dh,W", PLAN_SHAPES)
@pytest.mark.parametrize("split", SPLITS)
def test_plan_covers_each_tile_once(B, T, H, K, dh, W, split):
    plan = ops.swa_f32_plan(B, T, H, K, dh, W, split)
    G = H // K
    assert plan.nh & (plan.nh - 1) == 0 and G % plan.nh == 0 and plan.nh <= 8
    assert G % (2 * plan.nh) or plan.nh == 8       # the largest such
    assert plan.npos * plan.nh == ops.SWA_F32_ROWS
    assert plan.keys == ops.SWA_F32_KEYS[dh]
    seen = {}
    halves = {}
    for x, lo, hi, code in plan.items:
        assert lo <= hi
        seen.setdefault(x, []).append((lo, hi))
        if code >= 0:
            halves.setdefault(code >> 1, []).append((code & 1, x, lo, hi))
    for x, (first, last) in _spans(plan, T, W).items():
        ranges = sorted(seen[x])
        assert ranges[0][0] == first and ranges[-1][1] == last
        for (_, a), (b, _) in zip(ranges, ranges[1:]):
            assert b == a + 1                      # disjoint, no gap
        assert len(ranges) in (1, 2)
    assert sorted(halves) == list(range(plan.pairs))
    for pair in halves.values():
        (h0, x0, lo0, hi0), (h1, x1, lo1, hi1) = sorted(pair)
        assert (h0, h1) == (0, 1) and x0 == x1 and hi0 + 1 == lo1
        assert (hi0 - lo0) - (hi1 - lo1) in (0, 1)  # the first takes the odd


@pytest.mark.parametrize("B,T,H,K,dh,W", PLAN_SHAPES)
def test_plan_runs_longest_first_and_splits_only_to_gain(B, T, H, K, dh, W):
    plan = ops.swa_f32_plan(B, T, H, K, dh, W)
    tiles = [hi - lo + 1 for _, lo, hi, _ in plan.items]
    assert tiles == sorted(tiles, reverse=True)
    copies = (H // plan.nh) * B
    slots = ops.SWA_F32_SLOTS
    spans = {share: [_cost(it) for it in ops.swa_f32_plan(
        B, T, H, K, dh, W, share).items] for share in ops.SWA_F32_SHARES}
    spans = {share: _makespan(c, copies, slots) for share, c in spans.items()}
    best = min(spans.values())
    share = next(s for s in ops.SWA_F32_SHARES if spans[s] == best)
    assert plan == ops.swa_f32_plan(B, T, H, K, dh, W, share)
    assert ops.swa_f32_makespan(plan, B, H) == best
    assert (share == 1) == (plan.pairs == 0)
    if plan.pairs:
        assert best < spans[1]


@pytest.mark.parametrize("B,T,H,K,dh,W", PLAN_SHAPES)
@pytest.mark.parametrize("share", [1, 0.75, 0.5])
def test_plan_splits_the_ranges_past_the_share(B, T, H, K, dh, W, share):
    plan = ops.swa_f32_plan(B, T, H, K, dh, W, share)
    spans = _spans(plan, T, W)
    longest = max(hi - lo + 1 for lo, hi in spans.values())
    cap = -(-longest * int(share * 8) // 8)
    split = {x for x, *_, code in plan.items if code >= 0}
    assert split == {x for x, (lo, hi) in spans.items() if hi - lo + 1 > cap}
    assert plan.pairs == len(split)


def test_gemma_prefill_splits_the_tail():
    """At gemma3-4b's prefill (2, 2048, 8, 4, 256, W 1024) the 128 blocks
    of a full window (34 KV tiles) nearly fill the 132 slots, so every
    shorter block would run after one of them; the plan splits the ranges
    past 3/4 of the longest and the modelled makespan falls by over a
    tenth."""
    B, T, H, K, dh, W = 2, 2048, 8, 4, 256, 1024
    plan = ops.swa_f32_plan(B, T, H, K, dh, W)
    assert (plan.nh, plan.npos, plan.keys) == (2, 64, 32)
    assert plan == ops.swa_f32_plan(B, T, H, K, dh, W, 0.75)
    assert plan.pairs >= 16
    whole = ops.swa_f32_plan(B, T, H, K, dh, W, 1)
    assert (ops.swa_f32_makespan(plan, B, H)
            < 0.9 * ops.swa_f32_makespan(whole, B, H))


@pytest.mark.parametrize("T", [1040, 1024])
def test_f32_lm_shapes_split_past_half(T):
    """The float32 LM path's calls (gemma3-4b, B 2, the 1 040-token forward
    and the 1 024-token prefill): at most 17 x 8 blocks, one wave, so the
    longest block is the makespan; the plan splits the ranges past half of
    the longest (the fastest share timed on the card there)."""
    B, H, K, dh, W = 2, 8, 4, 256, 1024
    plan = ops.swa_f32_plan(B, T, H, K, dh, W)
    assert plan == ops.swa_f32_plan(B, T, H, K, dh, W, 0.5)
    assert plan.pairs >= 8


def test_layout_constants_are_the_kernels():
    src = (Path(ops.__file__).parent / "csrc" / "swa_attention_f32.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    assert threads == ops.SWA_F32_THREADS
    assert re.search(r"constexpr int kRows = 16 \* kWarps;", src)
    assert 16 * threads // 32 == ops.SWA_F32_ROWS
    wide, narrow = map(int, re.search(
        r"kKeys = DH == 256 \? (\d+) : (\d+);", src).groups())
    assert ops.SWA_F32_KEYS == {dh: wide if dh == 256 else narrow
                                for dh in ops.SWA_HEAD_DIMS}


def emulate_plan(q, k, v, W, plan):
    """The kernel's schedule in q's dtype: each item's online-softmax state
    (m, l, acc) over its KV tiles for every head of its query tile; a
    split range's two halves merged as the kernel merges them."""
    B, T, H, dh = q.shape
    G = H // k.shape[2]
    kf, vf = (a.repeat_interleave(G, dim=2) for a in (k, v))
    neg = -1e30
    out = torch.empty_like(q)
    parts = {}
    for x, lo, hi, code in plan.items:
        p0, p1 = x * plan.npos, min((x + 1) * plan.npos, T)
        k0, k1 = lo * plan.keys, min((hi + 1) * plan.keys, T)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, p0:p1], kf[:, k0:k1])
        s = s * (1.0 / np.sqrt(dh))
        qp = torch.arange(p0, p1)[:, None]
        kp = torch.arange(k0, k1)[None, :]
        ok = (kp <= qp) & (kp > qp - W)
        s = torch.where(ok, s, torch.full_like(s, neg))
        m = s.amax(-1)
        p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
        state = (m, p.sum(-1), torch.einsum("bhqk,bkhd->bhqd", p,
                                            vf[:, k0:k1]))
        if code >= 0:
            parts.setdefault(code >> 1, {})[code & 1] = state
            if len(parts[code >> 1]) < 2:
                continue
            (ma, la, aa), (mb, lb, ab) = parts[code >> 1][0], parts[code >> 1][1]
            mt = torch.maximum(ma, mb)
            sa, sb = torch.exp(ma - mt), torch.exp(mb - mt)
            state = (mt, la * sa + lb * sb,
                     aa * sa[..., None] + ab * sb[..., None])
        _, l, acc = state
        out[:, p0:p1] = (acc / l.clamp_min(1e-30)[..., None]).permute(
            0, 2, 1, 3)
    return out


@pytest.mark.parametrize("B,T,H,K,dh,W", PLAN_SHAPES[:-1])
@pytest.mark.parametrize("split", SPLITS)
def test_schedule_adds_no_error(B, T, H, K, dh, W, split):
    gen = np.random.default_rng(B * T + W)
    q = torch.as_tensor(0.5 * gen.standard_normal((B, T, H, dh)))
    k = torch.as_tensor(0.5 * gen.standard_normal((B, T, K, dh)))
    v = torch.as_tensor(gen.standard_normal((B, T, K, dh)))
    plan = ops.swa_f32_plan(B, T, H, K, dh, W, split)
    got = emulate_plan(q, k, v, W, plan)
    want = ref.swa_attention_ref(q, k, v, W)
    assert want.dtype == torch.float64
    assert (got - want).abs().max().item() < 1e-12
