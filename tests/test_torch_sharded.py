"""Trial sharding of the port's sweeps (``repro_torch.sharding``): the shard
layout against the JAX package's, the forms of ``devices``, chunk
validation, every entry point bit-equal on ``["cpu"] * d`` to one device
(padding included), and the evaluator cache keyed by the device tuple.
The cases mirror ``tests/test_sharded.py``; the CPU stands in for the
cards, so the device blocks run one after another here."""
import jax
import pytest
import torch

from repro import sharding as jsh
from repro.core import montecarlo as jm
from repro_torch import sharding as tsh
from repro_torch.core import cluster as tcl
from repro_torch.core import grid as tg
from repro_torch.core import montecarlo as tm
from repro_torch.core import planner as tp
from repro_torch.core.delays import scenario1
from repro_torch.core.scheduling import cyclic_to_matrix, staircase_to_matrix

from torch_parity import assert_bit_equal
from torch_parity import one_thread  # noqa: F401

N = 8
C_CYC = cyclic_to_matrix(N, 3)
C_SS = staircase_to_matrix(N, 3)


def _cpus(d):
    return ["cpu"] * d


def _specs():
    return [tm.to_spec("cyc", C_CYC), tm.to_spec("ss", C_SS),
            tm.lb_spec(3, "lb"), tm.adaptive_spec("adapt", C_CYC)]


def _markov():
    return tcl.MarkovRegimeProcess(base=scenario1(), p_slow=0.2,
                                   persistence=0.9)


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            _same(a[key], b[key])
        else:
            assert_bit_equal(a[key], b[key])


def _same_rounds(r1, r2):
    for field in ("per_round", "stderr", "wallclock", "wallclock_stderr"):
        _same(getattr(r1, field), getattr(r2, field))
    assert (r1.degradation is None) == (r2.degradation is None)
    if r1.degradation is not None:
        _same(r1.degradation, r2.degradation)


# ---------------------------------------------------------------------------
# device-free: the layout, the forms of ``devices``, chunk validation
# ---------------------------------------------------------------------------

LAYOUTS = [(100, 10, 1), (403, 50, 4), (96, 7, 4), (10, 10, 4),
           (70, 10, 4), (50, 10, 4), (8000, 1500, 3), (10 ** 6, 20000, 4),
           (121, 20, 3), (61, 10, 2)]


@pytest.mark.parametrize("trials,chunk,d", LAYOUTS)
def test_shard_layout_equals_the_reference(trials, chunk, d):
    used, nc_pad, padded = tm._shard_layout(trials, chunk, _cpus(d))
    j_used, j_pad, j_padded = jm._shard_layout(
        trials, chunk, tuple(jax.devices()[:1]) * d)
    assert (len(used), nc_pad, padded) == (len(j_used), j_pad, j_padded)
    assert all(dev == torch.device("cpu") for dev in used)


@pytest.mark.parametrize("trials,chunk,d", LAYOUTS)
def test_blocks_deal_every_real_chunk_once(trials, chunk, d):
    used, nc_pad, _ = tm._shard_layout(trials, chunk, _cpus(d))
    nc = -(-trials // chunk)
    blocks = tsh.chunk_blocks(nc, len(used))
    assert len(blocks) == len(used)
    assert [i for b in blocks for i in b] == list(range(nc))   # contiguous
    assert all(len(b) <= nc_pad // len(used) for b in blocks)
    order = tsh.issue_order(nc, used)
    assert sorted(i for i, _ in order) == list(range(nc))


def test_padding_and_fewer_chunks_than_devices():
    # 7 chunks over 4 devices: padded to 8, the last block one chunk short
    used, nc_pad, padded = tm._shard_layout(70, 10, _cpus(4))
    assert (len(used), nc_pad, padded) == (4, 8, 80)
    assert [list(b) for b in tsh.chunk_blocks(7, 4)] == [[0, 1], [2, 3],
                                                         [4, 5], [6]]
    # one chunk: one device used
    used, nc_pad, padded = tm._shard_layout(10, 10, _cpus(4))
    assert (len(used), nc_pad, padded) == (1, 1, 10)
    # the chunk decomposition does not depend on the device count
    assert tm._shard_layout(100, 10, "cpu")[1:] == (10, 100)


def test_trial_devices_forms():
    cpu = torch.device("cpu")
    assert tsh.trial_devices("cpu") == (cpu,)
    assert tsh.trial_devices(cpu) == (cpu,)
    assert tsh.trial_devices(_cpus(3)) == (cpu,) * 3          # repeats kept
    assert tsh.trial_devices((cpu, "cpu")) == (cpu, cpu)
    # a sequence is taken as it is, in both packages
    jd = tuple(jax.devices()[:1]) * 3
    assert len(jsh.trial_devices(jd)) == len(tsh.trial_devices(_cpus(3)))
    # ints count local devices: CUDA cards in the port, outside 1..count
    # refused in both packages
    count = torch.cuda.device_count()
    for bad in (0, count + 1):
        with pytest.raises(ValueError, match="devices"):
            tsh.trial_devices(bad)
    with pytest.raises(ValueError, match="devices"):
        jsh.trial_devices(0)
    with pytest.raises(ValueError, match="devices"):
        jsh.trial_devices(jax.device_count() + 1)
    for bad in ([], ()):
        with pytest.raises(ValueError, match="devices"):
            tsh.trial_devices(bad)
    with pytest.raises(ValueError, match="mix"):
        tsh.trial_devices(["cpu", "cuda:0"])
    if not torch.cuda.is_available():
        # no fallback: the card asked for without one raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsh.trial_devices(None)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsh.trial_devices(["cuda:0", "cuda:0"])
    assert tsh.device_label(_cpus(2)) == "cpu,cpu"
    assert tsh.device_label(("cpu",)) == "cpu"
    assert tsh.TRIAL_AXIS == jsh.TRIAL_AXIS


def test_chunk_validation():
    with pytest.raises(ValueError, match=r"chunk \(50\) exceeds trials"):
        tm.sweep(_specs()[:2], scenario1(), N, trials=20, chunk=50,
                 devices=_cpus(4))
    with pytest.raises(ValueError, match=r"chunk \(9\) exceeds trials"):
        tm.sweep_rounds(_specs()[:1], _markov(), N, rounds=2, k=6, trials=8,
                        chunk=9, devices=_cpus(4))
    with pytest.raises(ValueError, match="chunk"):
        tm.sweep(_specs()[:2], scenario1(), N, trials=20, chunk=0,
                 devices=_cpus(2))
    assert tm._normalize_chunk(17, None) == jm._normalize_chunk(17, None)
    assert tm._normalize_chunk(17, 5) == jm._normalize_chunk(17, 5) == 5


# ---------------------------------------------------------------------------
# bit-exact on ["cpu"] * d against one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trials,chunk,d", [(200, 25, 4), (403, 50, 4),
                                            (96, 7, 3), (96, 7, 2)])
def test_sweep_stats(trials, chunk, d):
    kw = dict(trials=trials, seed=3, chunk=chunk)
    r1 = tm.sweep(_specs()[:3], scenario1(), N, devices="cpu", **kw)
    rd = tm.sweep(_specs()[:3], scenario1(), N, devices=_cpus(d), **kw)
    _same(r1.means, rd.means)
    _same(r1.stderr, rd.stderr)


@pytest.mark.parametrize("k", [6, None])
def test_sweep_per_trial_samples(k):
    kw = dict(trials=96, seed=3, chunk=7, k=k)
    s1 = tm.completion_samples(_specs()[0], scenario1(), N, devices="cpu",
                               **kw)
    s4 = tm.completion_samples(_specs()[0], scenario1(), N, devices=_cpus(4),
                               **kw)
    assert_bit_equal(s4, s1)


def test_sweep_tau_and_message_budget():
    specs = [tm.to_spec("cs_m2", C_CYC, messages=2),
             tm.tau_spec("tau", C_SS),
             tm.to_spec("ragged", cyclic_to_matrix(
                 N, loads=[3, 1, 2, 3, 1, 3, 2, 1]))]
    kw = dict(trials=150, seed=2, chunk=25)
    r1 = tm.sweep(specs, scenario1(), N, devices="cpu", **kw)
    r4 = tm.sweep(specs, scenario1(), N, devices=_cpus(4), **kw)
    _same(r1.means, r4.means)
    _same(r1.stderr, r4.stderr)
    tau1 = tm.task_arrival_samples(C_SS, scenario1(), trials=60, chunk=9,
                                   devices="cpu")
    tau3 = tm.task_arrival_samples(C_SS, scenario1(), trials=60, chunk=9,
                                   devices=_cpus(3))
    assert_bit_equal(tau3, tau1)


def test_rounds_rebalance_and_faults():
    specs = [tm.to_spec("cs", C_CYC), tm.lb_spec(3, "lb"),
             tm.adaptive_spec("rebal", cyclic_to_matrix(N, 6),
                              rebalance=True, loads=[3] * N)]
    proc = tcl.make_scenario("preemption", _markov(), N)
    kw = dict(rounds=3, k=6, trials=120, seed=11, chunk=20,
              deadline=0.004, deadline_policy="close_partial")
    r1 = tm.sweep_rounds(specs, proc, N, devices="cpu", **kw)
    r4 = tm.sweep_rounds(specs, proc, N, devices=_cpus(4), **kw)
    _same_rounds(r1, r4)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(censored_feedback=True),
    dict(deadline=0.004),
    dict(deadline=0.004, deadline_policy="close_partial"),
    dict(deadline=0.004, censored_feedback=True,
         deadline_policy="reissue"),
], ids=["plain", "censored", "wait", "close_partial", "censored_reissue"])
@pytest.mark.parametrize("trials", [120, 121])
def test_sweep_rounds(kw, trials):
    args = (_specs(), _markov(), N)
    kw2 = dict(rounds=3, k=6, trials=trials, seed=7, chunk=20, **kw)
    r1 = tm.sweep_rounds(*args, devices="cpu", **kw2)
    r4 = tm.sweep_rounds(*args, devices=_cpus(4), **kw2)
    _same_rounds(r1, r4)


def test_record_trace_sharded():
    kw = dict(rounds=3, k=6, trials=61, seed=4, chunk=10,
              censored_feedback=True, deadline=0.004,
              deadline_policy="reissue", record_trace=True)
    r1 = tm.sweep_rounds(_specs(), _markov(), N, devices="cpu", **kw)
    r3 = tm.sweep_rounds(_specs(), _markov(), N, devices=_cpus(3), **kw)
    _same_rounds(r1, r3)
    assert_bit_equal(r3.trace.T1, r1.trace.T1)
    assert_bit_equal(r3.trace.T2, r1.trace.T2)


def test_trajectory_samples():
    kw = dict(rounds=3, k=6, trials=61, seed=5, chunk=10, deadline=0.004)
    t1 = tm.trajectory_samples(_specs()[3], _markov(), N, devices="cpu",
                               **kw)
    t4 = tm.trajectory_samples(_specs()[3], _markov(), N, devices=_cpus(4),
                               **kw)
    assert_bit_equal(t4, t1)


def test_greedy_impls_agree_sharded():
    kw = dict(rounds=3, k=6, trials=80, seed=9, chunk=20, devices=_cpus(4))
    rs = tm.sweep_rounds(_specs(), _markov(), N, greedy_impl="scan", **kw)
    rk = tm.sweep_rounds(_specs(), _markov(), N, greedy_impl="kernel", **kw)
    _same(rs.per_round, rk.per_round)
    _same(rs.wallclock, rk.wallclock)


def test_devices_forms_agree():
    # the CPU has no int form (ints count CUDA cards): a sequence of
    # strings, of torch devices, and the single device give one result
    kw = dict(trials=100, seed=1, chunk=25)
    ra = tm.sweep(_specs()[:2], scenario1(), N, devices=_cpus(4), **kw)
    rb = tm.sweep(_specs()[:2], scenario1(), N,
                  devices=[torch.device("cpu")] * 4, **kw)
    rc = tm.sweep(_specs()[:2], scenario1(), N, devices="cpu", **kw)
    _same(ra.means, rb.means)
    _same(ra.means, rc.means)


def test_resumable_sweep_sharded():
    kw = dict(seed=6, chunk=32, keep_samples=True)
    r1 = tm.resumable_sweep(_specs()[:3], scenario1(), N, devices="cpu", **kw)
    r3 = tm.resumable_sweep(_specs()[:3], scenario1(), N, devices=_cpus(3),
                            **kw)
    for total in (32, 160, 190):                 # 1 chunk, 4 more, padding
        a, b = r1.extend_trials(total), r3.extend_trials(total)
        _same(a.means, b.means)
        _same(a.stderr, b.stderr)
    _same(r1.samples(), r3.samples())
    _same(r3.result().means,
          tm.sweep(_specs()[:3], scenario1(), N, trials=190, seed=6,
                   chunk=32, devices="cpu").means)


def test_stream_grid_sharded():
    cells = tg.GridSpec(n=6, families=("cs", "lb", "pc"), loads=(2, 3),
                        trials=130, seed=2, chunk=20).cells(scenario1())
    rounds = tg.GridCell("adapt", (tm.adaptive_spec(
        "a", cyclic_to_matrix(6, 2)),), 6, _markov(), trials=70, seed=1,
        chunk=20, rounds=3, k=5, deadline=3e-3, deadline_policy="reissue",
        censored_feedback=True)
    cells = tuple(cells) + (rounds,)
    one = tg.stream_grid(cells, devices="cpu")
    three = tg.stream_grid(cells, devices=_cpus(3))
    assert three.meta["devices"] == "cpu,cpu,cpu"
    assert one.meta["devices"] == "cpu"
    for c in cells:
        a, b = one.cell(c.name), three.cell(c.name)
        for key in ("means", "stderr", "per_round", "wallclock",
                    "degradation"):
            if key in a:
                _same(a[key], b[key])


def test_plan_sharded():
    gs = tg.GridSpec(n=6, families=("cs", "ss", "lb", "pc"), loads=(2, 3),
                     trials=1024, seed=3)
    one = tp.plan(gs, scenario1(), k=6, base_trials=256, devices="cpu")
    two = tp.plan(gs, scenario1(), k=6, base_trials=256, devices=_cpus(2))
    assert two.meta["devices"] == "cpu,cpu"
    assert (two.winner, two.predicted_mean, two.trials_spent) == (
        one.winner, one.predicted_mean, one.trials_spent)
    assert two.points == one.points


# ---------------------------------------------------------------------------
# the evaluator cache: keyed by the device tuple, no rebuild, clear_cache
# ---------------------------------------------------------------------------

def test_repeated_sweeps_do_not_rebuild():
    tm.clear_cache()
    kw = dict(trials=100, seed=1, chunk=25, devices=_cpus(4))
    tm.sweep(_specs()[:2], scenario1(), N, **kw)
    builds = tm.cache_stats()["traces"]
    for _ in range(3):
        tm.sweep(_specs()[:2], scenario1(), N, **kw)
    assert tm.cache_stats()["traces"] == builds


def test_cache_keyed_by_device_tuple():
    tm.clear_cache()
    kw = dict(trials=100, seed=1, chunk=25)
    tm.sweep(_specs()[:2], scenario1(), N, devices="cpu", **kw)
    n1 = tm.cache_stats()["exec"]["size"]
    tm.sweep(_specs()[:2], scenario1(), N, devices=_cpus(4), **kw)
    assert tm.cache_stats()["exec"]["size"] == n1 + 1
    # the devices used are the key: one chunk on four devices uses one
    tm.sweep(_specs()[:2], scenario1(), N, trials=25, chunk=25,
             devices=_cpus(4))
    assert tm.cache_stats()["exec"]["size"] == n1 + 1


def test_clear_cache_drops_sharded_entries():
    kw = dict(trials=100, seed=1, chunk=25, devices=_cpus(4))
    tm.sweep(_specs()[:2], scenario1(), N, **kw)
    tm.sweep_rounds(_specs()[:1], _markov(), N, rounds=2, k=6, **kw)
    stats = tm.cache_stats()
    assert stats["exec"]["size"] and stats["rounds"]["size"]
    tm.clear_cache()
    stats = tm.cache_stats()
    assert not stats["exec"]["size"] and not stats["rounds"]["size"]
