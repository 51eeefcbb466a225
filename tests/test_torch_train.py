"""The port's LM training against the JAX package's (``repro.train``), on
a 2-layer float32 config of the dense family and one of the gemma3 family
(sliding-window layers, window 8 < 12 tokens): ``lm_loss_per_seq``, the
plain ``make_train_step`` and ``make_straggler_train_step`` over one and
three steps on JAX-drawn delay traces replayed through ``TraceProcess``
(static rows, a ``row_of_worker`` permutation each round, ragged loads, a
message budget with per-message overhead, a ``close_partial`` deadline on
a preemption trace).  Both packages see the same weights
(``convert.lm_params``) and the same token arrays.

Tolerances.  The winner weights, ``winners``, ``realized_k``,
``delivered_tasks``, ``deadline_missed`` and ``completion_time`` are
exact: the same float32 tables go through the same gathers, minimums and
sorts.  Loss and grad norm rel 1e-5 (float32 forwards in two frameworks,
tests/test_torch_models.py's logits agree to 2e-4 absolute).  The weights
after momentum SGD (lr 0.1) within 1e-6 absolute: the update is linear in
the gradient, so the gradient's float32 rounding reaches the weights
scaled by the learning rate (measured 1.2e-7); the momentum trees rel
1e-4.  After AdamW (the trainer's optimizer, lr 1e-3) the weights within
5e-4 absolute, 99.9 % of them within 1e-5: Adam divides each gradient by
its own magnitude, so an element whose gradient is rounding noise on both
sides moves by up to lr per step in either direction (measured 2.4e-4
after three steps, 99.99 % within 3e-6).

The port's own invariants: ``lm_task_batches`` shapes, identical batches
for redundant tasks, all-zero masked slots, a learnable bigram chain;
the straggler step's delays are the rounds engine's trial-0 tables; under
autograd a sliding-window layer never calls the forward-only kernel
wrapper; ``remat`` changes no gradient; ``convert.train_state`` carries
the JAX ``TrainState`` across (also from a JAX checkpoint, bfloat16
leaves included); checkpoints round-trip bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro import configs as jconfigs
from repro import optim as jopt
from repro import train as jtrain
from repro.core import DelayTrace as JDelayTrace
from repro.core import RoundConfig as JRoundConfig
from repro.core import TraceProcess as JTraceProcess
from repro.core import ec2_cluster as j_ec2, make_scenario as j_scenario
from repro.core.completion import (message_arrival_times as j_arrivals,
                                   winner_mask_gather as j_winners)
from repro.core.montecarlo import task_gather_plan as j_plan
from repro.models import config as jcfgmod
from repro.models import init_params as j_init_params
from repro_torch import ckpt, convert
from repro_torch import optim as topt
from repro_torch.core import (DelayTrace, MarkovRegimeProcess, RoundConfig,
                              TraceProcess, montecarlo, staircase_to_matrix)
from repro_torch.data import (TaskPartition, bigram_tokens, lm_task_batches,
                              task_tokens)
from repro_torch.models import config as tcfgmod
from repro_torch.models import layers as TL
from repro_torch.models import model as tmodel
from repro_torch.train import (TrainState, init_train_state, lm_loss,
                               lm_loss_per_seq, make_straggler_train_step,
                               make_train_step)
from torch_parity import rel_err
from torch_parity import one_thread  # noqa: F401

N, R, K, B, S = 4, 2, 3, 2, 12
ROUNDS = 3
F32 = dict(param_dtype="float32", dtype="float32", remat=False)


def _cfgs(family):
    if family == "dense":
        kw = dict(name="dense", arch_type="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97, **F32)
        return jcfgmod.ModelConfig(**kw), tcfgmod.ModelConfig(**kw)
    jc = dataclasses.replace(jconfigs.get_config("gemma3-4b").smoke(),
                             n_layers=2, sliding_window=8)
    return jc, tcfgmod.ModelConfig(**dataclasses.asdict(jc))


FAMILIES = ("dense", "gemma")


@pytest.fixture(scope="module")
def models():
    """Per family: the JAX config and parameters, the port's config and a
    function giving a fresh trainable port model with the same weights."""
    out = {}
    for i, fam in enumerate(FAMILIES):
        jc, tc = _cfgs(fam)
        params = jax.jit(j_init_params, static_argnums=1)(
            jax.random.PRNGKey(i), jc)
        sd = convert.lm_params(jax.tree_util.tree_map(np.asarray, params), tc)

        def fresh(tc=tc, sd=sd):
            m = tmodel.init_params(tc, device="cpu", trainable=True)
            m.load_state_dict(sd)
            return m
        out[fam] = (jc, params, tc, fresh)
    return out


def _traces():
    """JAX-drawn delay tables (rounds, 1, n, r): a persistent-straggler
    EC2 cluster, and the same under spot preemption (+inf rounds)."""
    base = j_ec2(N, spread=3.0, persistence=0.9, seed=1)
    T1, T2 = base.sample_rounds(jax.random.PRNGKey(5), 1, N, 3, ROUNDS)
    pre = j_scenario("preemption", base, N, kill_p=0.35, respawn_p=0.2)
    P1, P2 = pre.sample_rounds(jax.random.PRNGKey(9), 1, N, R, ROUNDS)
    return {"ec2": (np.asarray(T1), np.asarray(T2)),
            "preemption": (np.asarray(P1), np.asarray(P2))}


@pytest.fixture(scope="module")
def traces():
    out = _traces()
    assert np.isinf(out["preemption"][0]).any()
    return out


def _close_partial_deadline(T1, T2):
    """A deadline between the round's earliest and its k-th arrivals."""
    s = np.cumsum(T1[..., :R], -1) + T2[..., :R]
    fin = np.sort(s[np.isfinite(s)])
    return float(fin[len(fin) // 3])


CASES = {
    "static": dict(kind="ss", r=R),
    "rows": dict(kind="ss", r=R),
    "ragged": dict(kind="cs", r=3, loads=(3, 1, 2, 3), comm_eps=2e-5),
    "messages": dict(kind="ss", r=R, messages=1),
    "close_partial": dict(kind="ss", r=R, deadline_policy="close_partial"),
}
ROWS = [np.array([2, 0, 3, 1]), np.array([1, 3, 0, 2]),
        np.array([3, 2, 1, 0])]


def _round(case, traces):
    kw = dict(CASES[case])
    name = "preemption" if case == "close_partial" else "ec2"
    T1, T2 = traces[name]
    width = kw["r"]
    T1, T2 = T1[..., :width], T2[..., :width]
    if case == "close_partial":
        kw["deadline"] = _close_partial_deadline(T1, T2)
    return dict(n=N, k=K, **kw), T1, T2


def _tokens(cfg, width, seed, C=None):
    gen = np.random.default_rng(seed)
    toks = gen.integers(0, cfg.vocab_size, (width, N, B, S))
    labs = gen.integers(0, cfg.vocab_size, (width, N, B, S))
    if C is not None:                       # masked slots: all zeros
        masked = (np.asarray(C) < 0).T[..., None, None]
        toks, labs = np.where(masked, 0, toks), np.where(masked, 0, labs)
    return toks, labs


def _port_weights(model):
    return {k: p.detach().numpy() for k, p in model.named_parameters()}


def _jax_weights(params, tc):
    return convert._unstack(jax.tree_util.tree_map(np.asarray, params), tc)


def _jax_winners(C, T1, T2, t, k, row, deadline):
    """JAX's per-(worker, slot) winner weights of round t (identity message
    layout), worker-major."""
    s = j_arrivals(jnp.asarray(T1[t]), jnp.asarray(T2[t]), C.shape[1])[0]
    plan = j_plan(C, N)
    if row is None:
        return np.asarray(j_winners(C, plan, s, N, k, deadline=deadline)[0])
    w2, _ = j_winners(C, plan, s[np.argsort(row)], N, k, deadline=deadline)
    return np.asarray(w2)[row]


_JAX_STEPS = {}


def _jax_step(fam, case, rc, T1, T2, opt_name, jc, jopt_):
    key = (fam, case, opt_name)
    if key not in _JAX_STEPS:
        spec = JRoundConfig(**rc).to_round_spec()
        _JAX_STEPS[key] = jax.jit(jtrain.make_straggler_train_step(
            jc, jopt_, spec, JTraceProcess(JDelayTrace(T1, T2))))
    return _JAX_STEPS[key]


OPTS = {"momentum": (lambda m: m.momentum(0.1)),
        "adamw": (lambda m: m.adamw(1e-3))}


def _check_weights(got, want, opt_name):
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    if opt_name == "momentum":
        assert diffs.max() <= 1e-6, diffs.max()
    else:
        assert diffs.max() <= 5e-4, diffs.max()
        assert np.quantile(diffs, 0.999) <= 1e-5


def _run_pair(models, traces, fam, case, opt_name):
    jc, params, tc, fresh = models[fam]
    rc, T1, T2 = _round(case, traces)
    jo, to = OPTS[opt_name](jopt), OPTS[opt_name](topt)
    jstep = _jax_step(fam, case, rc, T1, T2, opt_name, jc, jo)
    model = fresh()
    tstate = TrainState(model, to.init(dict(model.named_parameters())), 0)
    tstep = make_straggler_train_step(tc, to, RoundConfig(**rc),
                                      TraceProcess(DelayTrace(T1, T2)))
    jstate = jtrain.TrainState(params, jo.init(params),
                               jnp.zeros((), jnp.int32))
    C = RoundConfig(**rc).to_matrix()
    jcl = tcl = None
    for t in range(ROUNDS):
        row = ROWS[t] if case == "rows" else None
        toks, labs = _tokens(tc, C.shape[1], 10 * t + 1,
                             C if case == "ragged" else None)
        jstate, jm, jcl = jstep(jstate, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(labs, jnp.int32),
                                jax.random.PRNGKey(t), jcl,
                                None if row is None else jnp.asarray(row))
        tstate, tm, tcl = tstep(tstate, torch.as_tensor(toks),
                                torch.as_tensor(labs), 123, tcl, row)
        for key in ("completion_time", "winners", "realized_k",
                    "delivered_tasks", "deadline_missed"):
            got, want = tm[key].numpy(), np.asarray(jm[key])
            assert got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        for key in ("slot_t1", "slot_t2"):
            np.testing.assert_array_equal(tm[key].numpy(),
                                          np.asarray(jm[key]))
        # a float32 mean over the slots: the two frameworks may sum in
        # another order
        np.testing.assert_allclose(tm["worker_t1"].numpy(),
                                   np.asarray(jm["worker_t1"]), rtol=1e-6)
        if case in ("static", "rows", "close_partial"):
            dl = rc.get("deadline")
            np.testing.assert_array_equal(
                tm["weights"].numpy(),
                _jax_winners(C, T1, T2, t, K, row, dl))
        assert rel_err(tm["loss"], jm["loss"]) <= 1e-5
        assert rel_err(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
        if t in (0, ROUNDS - 1):
            _check_weights(_port_weights(tstate.params),
                           _jax_weights(jstate.params, tc), opt_name)
    assert tstate.step == int(jstate.step) == ROUNDS
    if opt_name == "momentum":
        want = _jax_weights(jstate.opt_state["mu"], tc)
        scale = max(np.abs(v).max() for v in want.values())
        worst = max(np.abs(tstate.opt_state["mu"][k].numpy() - want[k]).max()
                    for k in want)
        assert worst / scale <= 1e-4
    return tm, jm


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fam", FAMILIES)
def test_straggler_step_matches_jax(models, traces, fam, case):
    tm, _ = _run_pair(models, traces, fam, case, "momentum")
    if case == "close_partial":
        assert float(tm["realized_k"]) <= K


def test_straggler_step_with_adamw_matches_jax(models, traces):
    _run_pair(models, traces, "gemma", "static", "adamw")


def test_close_partial_trace_misses_the_deadline(traces):
    """The close_partial case really closes rounds short of k."""
    rc, T1, T2 = _round("close_partial", traces)
    step = make_straggler_train_step(
        tcfgmod.ModelConfig(**dataclasses.asdict(_cfgs("dense")[1])),
        topt.sgd(0.0), RoundConfig(**rc), TraceProcess(DelayTrace(T1, T2)))
    cfg = _cfgs("dense")[1]
    model = tmodel.init_params(cfg, device="cpu", trainable=True)
    state = TrainState(model, topt.sgd(0.0).init({}), 0)
    cl, missed = None, []
    for t in range(ROUNDS):
        toks, labs = _tokens(cfg, R, t)
        state, m, cl = step(state, torch.as_tensor(toks),
                            torch.as_tensor(labs), 0, cl)
        missed.append(bool(m["deadline_missed"]))
        assert float(m["completion_time"]) <= rc["deadline"]
    assert any(missed)


@pytest.mark.parametrize("fam", FAMILIES)
def test_lm_loss_per_seq_matches_jax(models, fam):
    jc, params, tc, fresh = models[fam]
    gen = np.random.default_rng(7)
    toks = gen.integers(0, jc.vocab_size, (3, S))
    labs = gen.integers(0, jc.vocab_size, (3, S))
    want, _ = jax.jit(jtrain.steps.lm_loss_per_seq, static_argnums=1)(
        params, jc, jnp.asarray(toks), jnp.asarray(labs))
    got, aux = lm_loss_per_seq(fresh(), tc, torch.as_tensor(toks),
                               torch.as_tensor(labs))
    assert got.shape == (3,) and got.dtype == torch.float32
    assert rel_err(got.detach(), want) <= 1e-5
    assert float(aux) == 0.0


@pytest.mark.parametrize("fam", FAMILIES)
def test_plain_train_step_matches_jax(models, fam):
    jc, params, tc, fresh = models[fam]
    jo, to = jopt.momentum(0.1), topt.momentum(0.1)
    jstep = jax.jit(jtrain.make_train_step(jc, jo))
    jstate = jtrain.TrainState(params, jo.init(params),
                               jnp.zeros((), jnp.int32))
    model = fresh()
    tstate = TrainState(model, to.init(dict(model.named_parameters())), 0)
    tstep = make_train_step(tc, to)
    for t in range(3):
        gen = np.random.default_rng(50 + t)
        toks = gen.integers(0, jc.vocab_size, (2 * N, S))
        labs = gen.integers(0, jc.vocab_size, (2 * N, S))
        jstate, jm = jstep(jstate, jnp.asarray(toks), jnp.asarray(labs))
        tstate, tm = tstep(tstate, torch.as_tensor(toks),
                           torch.as_tensor(labs))
        assert rel_err(tm["loss"], jm["loss"]) <= 1e-5
        assert rel_err(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
        if t in (0, 2):
            _check_weights(_port_weights(tstate.params),
                           _jax_weights(jstate.params, tc), "momentum")
    assert tstate.step == 3


# ----------------------------- the port's own --------------------------------

def test_lm_task_batches_shapes_redundancy_and_masked_slots():
    part = TaskPartition(n=4, global_batch=8, seq_len=10, vocab=300,
                         seed=11, source="bigram")
    C = staircase_to_matrix(4, loads=(2, 1, 2, 1))      # ragged, MASKED
    toks, labs = lm_task_batches(part, C, 3, device="cpu")
    assert toks.shape == labs.shape == (2, 4, 2, 10)
    assert toks.dtype == torch.int64
    assert torch.equal(toks[..., 1:], labs[..., :-1])   # next-token shift
    for s in range(2):
        for i in range(4):
            if C[i, s] < 0:
                assert not toks[s, i].any() and not labs[s, i].any()
                continue
            for s2 in range(2):
                for j in range(4):
                    if C[j, s2] == C[i, s]:
                        assert torch.equal(toks[s, i], toks[s2, j])
    assert int(toks.max()) < 300
    again, _ = lm_task_batches(part, C, 3, device="cpu")
    assert torch.equal(again, toks)
    other, _ = lm_task_batches(part, C, 4, device="cpu")
    assert not torch.equal(other, toks)
    # a task's tokens do not depend on which other tasks are drawn with it
    alone = task_tokens(part, 3, [int(C[0, 0])])
    assert torch.equal(alone[0, :, :-1], toks[0, 0])
    uni = TaskPartition(n=4, global_batch=4, seq_len=5, vocab=7, seed=1)
    ut, _ = lm_task_batches(uni, staircase_to_matrix(4, 2), 0, device="cpu")
    assert ut.shape == (2, 4, 1, 5) and int(ut.max()) < 7
    with pytest.raises(ValueError, match="divisible"):
        TaskPartition(n=3, global_batch=8, seq_len=4, vocab=9).task_batch


def test_bigram_chain_is_learnable():
    """The chain lives on the first min(vocab, 1024) ids and a tiny model
    learns it: its loss falls well below the uniform chance level."""
    seq = bigram_tokens(3, torch.arange(2), 4, 50, 5000)
    assert int(seq.max()) < 1024
    cfg = tcfgmod.ModelConfig(name="tiny", arch_type="dense", n_layers=1,
                              d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                              vocab_size=32, **F32)
    opt = topt.adamw(1e-2)
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    step = make_train_step(cfg, opt)
    part = TaskPartition(n=1, global_batch=16, seq_len=16, vocab=32,
                         source="bigram")
    losses = []
    for i in range(40):
        toks, labs = lm_task_batches(part, np.zeros((1, 1), np.int64), i,
                                     device="cpu")
        state, m = step(state, toks[0, 0], labs[0, 0])
        losses.append(float(m["loss"]))
    assert losses[0] > np.log(32) - 0.5
    assert np.mean(losses[-5:]) < losses[0] - 0.7


def test_straggler_delays_are_the_engines_trial0_tables():
    proc = MarkovRegimeProcess(p_slow=0.3, persistence=0.8, slow=4.0)
    cfg = _cfgs("dense")[1]
    step = make_straggler_train_step(cfg, topt.sgd(0.0),
                                     RoundConfig(n=N, k=K, kind="ss", r=R),
                                     proc)
    state = TrainState(tmodel.init_params(cfg, device="cpu", trainable=True),
                       topt.sgd(0.0).init({}), 0)
    seed, cl, got1, got2 = 77, None, [], []
    for t in range(4):
        toks, labs = _tokens(cfg, R, t)
        state, m, cl = step(state, torch.as_tensor(toks),
                            torch.as_tensor(labs), seed, cl)
        got1.append(m["slot_t1"].numpy())
        got2.append(m["slot_t2"].numpy())
    T1, T2 = montecarlo._capture_tables(proc, N, R, 4, seed,
                                        torch.zeros(1, dtype=torch.int64))
    np.testing.assert_array_equal(np.stack(got1), T1[:, 0])
    np.testing.assert_array_equal(np.stack(got2), T2[:, 0])


def test_autograd_never_reaches_the_swa_kernel_wrapper(monkeypatch):
    cfg = _cfgs("gemma")[1]
    calls = []
    real = TL.ops.swa_attention

    def counted(q, k, v, *, window):
        calls.append(q.requires_grad)
        return real(q, k, v, window=window)

    monkeypatch.setattr(TL.ops, "swa_attention", counted)
    model = tmodel.init_params(cfg, device="cpu", trainable=True)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (2, S)))
    train, _, _ = tmodel.forward(model, cfg, toks)
    assert calls == []                     # attention_core under autograd
    with torch.no_grad():
        infer, _, _ = tmodel.forward(model, cfg, toks)
    assert calls == [False, False]         # both swa layers, no grad
    assert (train.detach() - infer).abs().max() <= 1e-4
    serve = tmodel.init_params(cfg, device="cpu")
    assert not any(p.requires_grad for p in serve.parameters())


def test_remat_changes_no_gradient():
    cfg = _cfgs("gemma")[1]
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 512, (2, S)))
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = tmodel.init_params(c, seed=3, device="cpu", trainable=True)
        lm_loss(model, c, toks[:, :-1], toks[:, 1:])[0].backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0,
                                   atol=1e-6)


def test_train_state_carried_across_by_convert(models, traces, tmp_path):
    """A JAX TrainState after one AdamW step, in memory and through a JAX
    checkpoint, becomes the port's bit for bit; one more step on each side
    then agrees at the AdamW tolerance."""
    jc, params, tc, _ = models["gemma"]
    rc, T1, T2 = _round("static", traces)
    jo, to = jopt.adamw(1e-3), topt.adamw(1e-3)
    jstep = _jax_step("gemma", "static", rc, T1, T2, "adamw", jc, jo)
    jstate = jtrain.TrainState(params, jo.init(params),
                               jnp.zeros((), jnp.int32))
    toks, labs = _tokens(tc, R, 1)
    jstate, _, jcl = jstep(jstate, jnp.asarray(toks), jnp.asarray(labs),
                           jax.random.PRNGKey(0), None, None)
    path = jckpt.save_checkpoint(str(tmp_path / "j"), jstate, step=1)
    tree = ckpt.read_tree(path)
    as_np = jax.tree_util.tree_map(np.asarray, jstate)
    for st in (convert.train_state(tree["0"], tree["1"], tree["2"], tc,
                                   device="cpu"),
               convert.train_state(as_np.params, as_np.opt_state,
                                   as_np.step, tc, device="cpu")):
        assert st.step == 1 and int(st.opt_state["step"]) == 1
        for k, want in _jax_weights(jstate.params, tc).items():
            np.testing.assert_array_equal(
                dict(st.params.named_parameters())[k].detach().numpy(), want)
        for mom in ("m", "v"):
            for k, want in _jax_weights(jstate.opt_state[mom], tc).items():
                np.testing.assert_array_equal(st.opt_state[mom][k].numpy(),
                                              want)
        assert all(p.requires_grad for p in st.params.parameters())
    # resume: one more step on each side, the trace's round 1
    tstep = make_straggler_train_step(
        tc, to, RoundConfig(**rc),
        TraceProcess(DelayTrace(T1, T2), start_round=1))
    toks, labs = _tokens(tc, R, 2)
    jstate, jm, _ = jstep(jstate, jnp.asarray(toks), jnp.asarray(labs),
                          jax.random.PRNGKey(1), jcl, None)
    st, tm, _ = tstep(st, torch.as_tensor(toks), torch.as_tensor(labs), 0)
    assert float(tm["completion_time"]) == float(jm["completion_time"])
    assert rel_err(tm["loss"], jm["loss"]) <= 1e-5
    _check_weights(_port_weights(st.params), _jax_weights(jstate.params, tc),
                   "adamw")


def test_jax_checkpoint_with_bf16_leaves_read_by_port(tmp_path):
    gen = np.random.default_rng(4)
    a = gen.standard_normal((3, 5)).astype(np.float32)
    tree = {"w": jnp.asarray(a, jnp.bfloat16),
            "inner": {"f": jnp.asarray(a[0]), "i": jnp.asarray(7, jnp.int32)},
            "seq": [jnp.asarray(a[1:], jnp.bfloat16)]}
    path = jckpt.save_checkpoint(str(tmp_path / "t"), tree, step=2)
    assert path.endswith("t-00000002.npz")
    with np.load(path) as raw:
        assert raw["w"].dtype == np.dtype("V2")     # JAX's raw records
    template = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
                "inner": {"f": torch.zeros(5), "i": torch.zeros(
                    (), dtype=torch.int32)},
                "seq": [torch.zeros((2, 5), dtype=torch.bfloat16)]}
    got = ckpt.load_checkpoint(path, template)
    for g, w in ((got["w"], tree["w"]), (got["seq"][0], tree["seq"][0])):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
    np.testing.assert_array_equal(got["inner"]["f"].numpy(), a[0])
    assert int(got["inner"]["i"]) == 7
    # a bfloat16 JAX TrainState through read_tree and convert
    jc = dataclasses.replace(jconfigs.get_config("gemma3-4b").smoke(),
                             n_layers=2, param_dtype="bfloat16",
                             dtype="bfloat16")
    tc = tcfgmod.ModelConfig(**dataclasses.asdict(jc))
    jo = jopt.adamw(1e-3)
    jst = jtrain.init_train_state(jax.random.PRNGKey(3), jc, jo)
    p2 = jckpt.save_checkpoint(str(tmp_path / "s"), jst)
    tree2 = ckpt.read_tree(p2)
    st = convert.train_state(tree2["0"], tree2["1"], tree2["2"], tc,
                             device="cpu")
    want = _jax_weights(jst.params, tc)
    for k, p in st.params.named_parameters():
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.detach().view(torch.int16).numpy(),
                                      np.asarray(want[k]).view(np.int16))


def test_port_checkpoint_round_trip(tmp_path):
    tc = dataclasses.replace(_cfgs("gemma")[1], param_dtype="bfloat16",
                             dtype="bfloat16")
    opt = topt.adamw(1e-3)
    state = init_train_state(tc, opt, seed=1, device="cpu")
    step = make_straggler_train_step(tc, opt, RoundConfig(n=N, k=K, kind="ss",
                                                          r=R),
                                     MarkovRegimeProcess())
    toks, labs = _tokens(tc, R, 0)
    state, _, _ = step(state, torch.as_tensor(toks), torch.as_tensor(labs), 5)
    p1 = ckpt.save_checkpoint(str(tmp_path / "gemma"), state.tree(), step=1)
    p9 = ckpt.save_checkpoint(str(tmp_path / "gemma"), state.tree(), step=9)
    assert ckpt.latest_checkpoint(str(tmp_path), "gemma") == p9
    assert ckpt.latest_checkpoint(str(tmp_path / "none"), "gemma") is None
    with np.load(p1) as raw:
        assert "1|m|blocks.0.mixer.wq.w" in raw.files and "2" in raw.files
        assert raw["0|embed"].dtype == np.dtype("V2")
    other = init_train_state(tc, opt, seed=2, device="cpu")
    back = other.load_tree(ckpt.load_checkpoint(p1, other.tree()))
    assert back is other
    assert back.step == 1 and int(back.opt_state["step"]) == 1
    for (k, a), (_, b) in zip(state.params.named_parameters(),
                              back.params.named_parameters()):
        assert torch.equal(a, b) and b.dtype == torch.bfloat16, k
        assert torch.equal(state.opt_state["m"][k], back.opt_state["m"][k])
        assert torch.equal(state.opt_state["v"][k], back.opt_state["v"][k])
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.load_checkpoint(p1, {"nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_checkpoint(p1, {"2": 0, "0": {
            "embed": torch.zeros(3, dtype=torch.bfloat16)}})
