"""Static TO matrices, message layouts, gather plans and RoundConfig: the
port against the JAX package, integer-exact."""
import numpy as np
import pytest

from repro.core import montecarlo as jmc
from repro.core import scheduling as js
from repro.core import spec as jspec
from repro_torch.core import montecarlo as tmc
from repro_torch.core import scheduling as ts
from repro_torch.core import spec as tspec

from torch_parity import assert_bit_equal
from torch_parity import one_thread  # noqa: F401

DENSE = [(n, r) for n in (5, 8, 16) for r in (1, 3, n)]
RAGGED = [(6, [3, 1, 2, 3, 1, 2]), (8, [4, 4, 1, 2, 3, 4, 2, 1]),
          (5, [5, 2, 5, 1, 3])]


@pytest.mark.parametrize("name", ["cyclic_to_matrix", "staircase_to_matrix",
                                  "block_to_matrix"])
@pytest.mark.parametrize("n,r", DENSE)
def test_dense_constructors_equal(name, n, r):
    assert_bit_equal(getattr(ts, name)(n, r), getattr(js, name)(n, r))


@pytest.mark.parametrize("name", ["cyclic_to_matrix", "staircase_to_matrix",
                                  "random_assignment_to_matrix"])
@pytest.mark.parametrize("n,loads", RAGGED)
def test_ragged_constructors_equal(name, n, loads):
    got = getattr(ts, name)(n, loads=loads)
    want = getattr(js, name)(n, loads=loads)
    assert_bit_equal(got, want)
    assert_bit_equal(ts.loads_of_matrix(got), js.loads_of_matrix(want))


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("n", [4, 9, 16])
def test_random_assignment_seeds_equal(seed, n):
    assert_bit_equal(ts.random_assignment_to_matrix(n, seed=seed),
                     js.random_assignment_to_matrix(n, seed=seed))
    assert_bit_equal(ts.to_matrix("ra", n, n, seed=seed),
                     js.to_matrix("ra", n, n, seed=seed))


@pytest.mark.parametrize("kind", ["cs", "ss", "ra", "block"])
def test_named_schedules_and_masking(kind):
    n = 8
    r = n if kind == "ra" else 3
    C = ts.to_matrix(kind, n, r)
    assert_bit_equal(C, js.to_matrix(kind, n, r))
    loads = [3, 1, 2, 3, 3, 2, 1, 3]
    assert_bit_equal(ts.mask_matrix_loads(C, loads),
                     js.mask_matrix_loads(C, loads))


@pytest.mark.parametrize("bad", [
    lambda m: m.cyclic_to_matrix(4, 5),
    lambda m: m.staircase_to_matrix(4, 0),
    lambda m: m.random_assignment_to_matrix(4, 3),
    lambda m: m.cyclic_to_matrix(4, loads=[1, 0, 2, 2]),
    lambda m: m.to_matrix("zz", 4, 2),
    lambda m: m.validate_to_matrix(np.array([[0, 0], [1, 2]])),
    lambda m: m.validate_to_matrix(np.array([[0, 3], [1, 2], [2, 0]])),
    lambda m: m.loads_of_matrix(np.array([[-1, 0], [1, 2]])),
])
def test_invalid_inputs_rejected_alike(bad):
    with pytest.raises(ValueError):
        bad(js)
    with pytest.raises(ValueError):
        bad(ts)


@pytest.mark.parametrize("r,m", [(r, m) for r in (1, 4, 7) for m in
                                 range(1, r + 1)])
def test_message_layout_equal(r, m):
    for f in ("message_boundaries", "message_group_sizes", "message_slot_map"):
        assert_bit_equal(getattr(tmc, f)(r, m), getattr(jmc, f)(r, m))


@pytest.mark.parametrize("kind,loads,messages", [
    ("cs", None, None), ("ss", None, 2), ("cs", [3, 1, 2, 3, 1, 2], None),
    ("ss", [3, 1, 2, 3, 1, 2], 2), ("ra", None, 4)])
def test_gather_plans_equal(kind, loads, messages):
    n = 6
    r = n if kind == "ra" else 3
    C = js.to_matrix(kind, n, r)
    sj = jmc.to_spec("s", C, messages, loads=loads, comm_eps=1e-5)
    st = tmc.to_spec("s", C, messages, loads=loads, comm_eps=1e-5)
    assert (st.C, st.loads, st.messages) == (sj.C, sj.loads, sj.messages)
    for r_max in (r, n):
        assert_bit_equal(tmc._plan_of(st, n, r_max), jmc._plan_of(sj, n, r_max))
        assert_bit_equal(tmc._offsets_flat_of(st, n, r_max),
                         jmc._offsets_flat_of(sj, n, r_max))


CONFIGS = [dict(n=8, k=5, kind="cs", r=3),
           dict(n=8, k=8, kind="ra"),
           dict(n=6, k=4, kind="ss", r=3, loads=(3, 1, 2, 3, 1, 2),
                messages=2, comm_eps=1e-5),
           dict(n=6, k=6, kind="ss", r=2, deadline=1e-3,
                deadline_policy="close_partial", adaptive=True),
           dict(n=6, k=4, kind="cs", r=3, loads=(3, 1, 2, 3, 2, 1),
                adaptive=True, censored_feedback=True, dead_after=2,
                messages=2)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_round_config_equal(kw):
    cj, ct = jspec.RoundConfig(**kw), tspec.RoundConfig(**kw)
    assert ct.to_dict() == cj.to_dict()
    assert_bit_equal(ct.to_matrix(), cj.to_matrix())
    assert_bit_equal(ct.base_matrix(), cj.base_matrix())
    assert tspec.RoundConfig.from_json(cj.to_json()) == ct
    sj, st = cj.to_scheme_spec(), ct.to_scheme_spec()
    assert (st.name, st.kind, st.C, st.loads, st.messages, st.comm_eps) \
        == (sj.name, sj.kind, sj.C, sj.loads, sj.messages, sj.comm_eps)
    assert ct.sweep_rounds_kwargs() == cj.sweep_rounds_kwargs()
    assert ct.aggregator_kwargs() == cj.aggregator_kwargs()


@pytest.mark.parametrize("kw", [
    dict(n=4, k=5), dict(n=4, k=2, r=5), dict(n=4, k=2, messages=9),
    dict(n=4, k=2, comm_eps=-1.0), dict(n=4, k=2, deadline_policy="bogus"),
    dict(n=4, k=2, deadline_policy="close_partial"),
    dict(n=4, k=2, rebalance=True), dict(n=4, k=2, censored_feedback=True),
    dict(n=4, k=2, kind="cs", r=2, loads=(1, 1, 1)),
    dict(n=4, k=2, kind="block", r=2, loads=(2, 1, 2, 1))])
def test_round_config_rejects_alike(kw):
    with pytest.raises(ValueError):
        jspec.RoundConfig(**kw)
    with pytest.raises(ValueError):
        tspec.RoundConfig(**kw)
