"""The port's dry run (``repro_torch.launch.dryrun``) and its readers on the
CPU, at the smoke configs and at small stand-ins of the four shapes (the
shapes' names kept, so the artifacts are named and read as at full size):

* the ``swa_attention`` op: on ``meta`` its fake output, under
  ``FlopCounterMode`` the band (equal to a brute-force count of the
  visible (query, key) pairs), the forward-only error kept under
  autograd, no launch counted;
* FLOPs of gemma3-4b's smoke config (every layer sliding-window) equal to
  the analytic count of the step's matmuls plus the swa band, for train,
  prefill and decode;
* for one MoE / MLA model (deepseek-v3), rwkv6, the hybrid (jamba, the
  CLIs' cut) and whisper: the prefill and the decode step (deepseek's
  train round too) on ``meta`` count the same FLOPs and peak bytes as the
  same step run on real tensors on the CPU, and the same bytes within a
  millionth; the argument bytes are the step's tensors' bytes;
* the peak read in a call of its own: a training step's peak under
  ``FlopCounterMode`` is higher (its module tracker keeps activations
  alive), and Python's cycle collector changes no peak
  (``benchmarks_torch/dryrun_breakdown.py``'s readings); the per-token
  loops' ``select_backward`` bytes grow as T²;
* the artifact read unchanged by the reference's
  ``repro.launch.roofline`` and ``repro.launch.perf_report`` (neither
  imports JAX) and by the port's, the ``absorb`` pair as a perf_report
  row, the ``--all`` loop, and the ``roofline`` benchmark job (its
  ``roofline/skipped`` row on an empty directory);
* the mesh dry run over the fake process group, in a process of its own
  (``torch_mesh_dryrun.py``): every mesh variant on the 16x16 mesh and
  the CLI's ``--multi-pod`` (a decode step) producing artifacts both
  packages' readers read, with collectives and ``collective_s`` = total
  bytes / ``LINK_BW``;
  per-device FLOPs times the devices equal to the one-card FLOPs for a
  divisible dense smoke config (train, prefill and decode on a 1 x 2
  mesh); a one-layer prefill's collective bytes by kind equal to the
  analytic count of the port's shardings; a decode's cache exchanged as
  one KV head a rank, in the baseline as in ``grouped``; the swa op's
  DTensor rule refusing placements it cannot shard."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import perf_report as jperf
from repro.launch import roofline as jroof
from benchmarks_torch import common, roofline_report
from benchmarks_torch import dryrun_breakdown as breakdown
from benchmarks_torch import run as bench_run
from repro_torch import configs as tconfigs
from repro_torch.configs import InputShape, cli_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, perf_report, roofline
from repro_torch.models import layer_specs
from repro_torch.models import model as tmodel
from repro_torch.train import steps as train_steps
from torch_parity import one_thread  # noqa: F401

#: small stand-ins of the four shapes: a train round of n = 16 workers
#: (b = 1), a prefill and a decode past the smoke configs' window of 32
SMALL = {"train_4k": InputShape("train_4k", 16, 16, "train"),
         "prefill_32k": InputShape("prefill_32k", 48, 2, "prefill"),
         "decode_32k": InputShape("decode_32k", 40, 2, "decode"),
         "long_500k": InputShape("long_500k", 56, 1, "decode")}
FAMILIES = ["deepseek-v3-671b", "rwkv6-1.6b", "jamba-v0.1-52b",
            "whisper-base"]


@pytest.fixture
def small(monkeypatch):
    """The small shapes in place of the four, and every arch at its CLIs'
    smoke config."""
    for name, shape in SMALL.items():
        monkeypatch.setitem(tconfigs.SHAPES, name, shape)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: cli_config(arch, smoke=True))


def _cfg(arch, shape):
    kind = tconfigs.SHAPES[shape].kind
    return dataclasses.replace(tconfigs.resolve(cli_config(arch, True), shape),
                               remat=kind == "train")


@pytest.mark.parametrize("T,W", [(1, 1), (5, 1), (7, 3), (32, 32), (48, 32),
                                 (20, 64), (130, 17)])
def test_swa_flops_are_the_visible_pairs(T, W):
    pos = torch.arange(T)
    visible = ((pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - W))
    B, H, dh = 2, 3, 16
    assert ops.swa_flops(B, T, H, dh, W) == 4 * B * H * dh * int(
        visible.sum())
    q = torch.empty((B, T, H, dh), device="meta")
    k = torch.empty((B, T, 1, dh), device="meta")
    ops.reset_launch_counts()
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx(), FlopCounterMode(display=False) as fc:
            out = ops.swa_attention(q, k, k, window=W)
        assert out.device.type == "meta" and out.shape == q.shape
        assert fc.get_total_flops() == ops.swa_flops(B, T, H, dh, W)
    assert ops.LAUNCHES["swa_attention"] == 0


def test_swa_meta_keeps_the_forward_only_error():
    q = torch.empty((1, 8, 2, 16), device="meta", requires_grad=True)
    k = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.swa_attention(q, k, k, window=4)
    with pytest.raises(ValueError, match="head dims"):
        ops.swa_attention(torch.empty((1, 8, 2, 24), device="meta"),
                          torch.empty((1, 8, 2, 24), device="meta"),
                          torch.empty((1, 8, 2, 24), device="meta"), window=4)


def _dense_flops(cfg, B, T, kind):
    """The matmuls of a dense model's step by hand: per token and layer
    the q, k, v, o projections and the SwiGLU; the LM head; per layer the
    attention: the swa band (prefill, through the kernel), a ring decode's
    scores and values over the ring and the new token, or (train, autograd
    route) QKᵀ and PV over every (query, key) pair.  Train: a block's
    backward is two matmuls a matmul, and remat runs its forward again
    but for ``w_down``, whose output backward does not need
    (``torch.utils.checkpoint`` stops recomputing there); the head runs
    forward and backward."""
    d, H, K, dh, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim, cfg.d_ff
    V, W, L = cfg.padded_vocab, cfg.sliding_window, cfg.n_layers
    per_token = 2 * d * dh * (2 * H + 2 * K) + 3 * 2 * d * ff
    head = 2 * B * T * d * V
    if kind == "prefill":
        return L * (per_token * B * T + ops.swa_flops(B, T, H, dh, W)) + head
    if kind == "decode":
        return L * (per_token * B + 4 * B * H * dh * (W + 1)) + head
    blocks = L * (per_token * B * T + 4 * B * H * T * T * dh)
    return 4 * blocks - L * 2 * B * T * ff * d + 3 * head


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dense_flops_are_the_analytic_count(small, shape):
    cfg = _cfg("gemma3-4b", shape)
    assert {s.mixer for s in layer_specs(cfg)} == {"swa"}
    fn, args, _ = dryrun.build(cfg, shape)
    res = dryrun.measure(fn, args)
    sh = SMALL[shape]
    B = sh.global_batch
    T = 1 if sh.kind == "decode" else sh.seq_len
    assert res["flops"] == _dense_flops(cfg, B, T, sh.kind)


def _zero_params(cfg, *, seed=0, device=None, trainable=False):
    """``init_params`` with zero weights: the counts do not read values,
    and no Philox draw is spent on them."""
    model = tmodel.init_params(cfg, device="meta").to_empty(device=device)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    return model.requires_grad_(trainable)


def _meta_against_real(arch, shape, monkeypatch):
    """The step of ``shape`` on ``meta`` against the same step on real CPU
    tensors (zero weights): the same FLOPs and peak bytes, the argument
    bytes those of the parameters, optimizer state, cache and inputs, and
    the bytes moved within a millionth (a constant the step makes on the
    host is a copy to ``meta``, none to the CPU)."""
    cfg = _cfg(arch, shape)
    fn, args, _ = dryrun.build(cfg, shape)
    got = dryrun.measure(fn, args)
    monkeypatch.setattr(dryrun, "init_params", _zero_params)
    monkeypatch.setattr(train_steps, "init_params", _zero_params)
    fn, args, _ = dryrun.build(cfg, shape, device="cpu")
    want = dryrun.measure(fn, args)
    assert got["flops"] == want["flops"] > 0, shape
    assert abs(got["bytes"] - want["bytes"]) <= 1e-6 * want["bytes"], shape
    assert got["mem"] == want["mem"], shape
    storages = {t.untyped_storage()._cdata: t.untyped_storage()
                for t in dryrun._tensors(args)}
    assert got["mem"]["argument_size_in_bytes"] == sum(
        st.nbytes() for st in storages.values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_counts_are_a_real_steps(small, arch, monkeypatch):
    for shape in ("prefill_32k", "decode_32k"):
        _meta_against_real(arch, shape, monkeypatch)


def test_meta_train_counts_are_a_real_steps(small, monkeypatch):
    """The straggler train round (an MoE and MLA model: routing, the aux
    loss, remat and AdamW) on ``meta`` against the CPU."""
    _meta_against_real("deepseek-v3-671b", "train_4k", monkeypatch)


@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-v3-671b"])
def test_train_peak_is_read_outside_the_flop_counter(small, arch):
    """``FlopCounterMode`` keeps a training step's activations alive into
    backward, so ``measure`` reads the peak in a call of its own; that
    peak is the step's as it runs (no dispatch mode but the tracking
    one), and the same with Python's cycle collector off."""
    cfg = _cfg(arch, "train_4k")
    temp = dryrun.measure(*dryrun.build(cfg, "train_4k")[:2])["mem"][
        "temp_size_in_bytes"]
    assert breakdown.trace(cfg, "train_4k").peak == temp
    assert breakdown.trace(cfg, "train_4k", cycles=False).peak == temp
    assert breakdown.trace(cfg, "train_4k",
                           flop_counter=True).peak > 1.2 * temp


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_per_token_slices_cost_t_squared_in_backward(small, monkeypatch,
                                                      arch):
    """A per-token loop's slice ``x[:, t]`` has as backward a zero tensor
    of the whole input (``select_backward``): twice the tokens, four
    times its bytes but for the slices it reads (a cost linear in T would
    read twice)."""
    moved = []
    for T in (16, 32):
        monkeypatch.setitem(tconfigs.SHAPES, "train_4k",
                            InputShape("train_4k", T, 16, "train"))
        mode = breakdown.trace(_cfg(arch, "train_4k"), "train_4k")
        moved.append(mode.by_op["aten.select_backward.default"])
    assert 3.5 * moved[0] < moved[1] < 4 * moved[0]


def test_decode_build_sits_at_the_deepest_position(small):
    cfg = _cfg("gemma3-4b", "decode_32k")
    fn, (params, cache, ins), meta = dryrun.build(cfg, "decode_32k")
    assert cache["pos"] == meta["decode_pos"] == 39
    assert all(layer["attn"]["pos"] == 39 for layer in cache["layers"])
    _, cache2, logits = fn()
    assert cache2["pos"] == 40 and logits.shape == (2, cfg.padded_vocab)
    wcfg = _cfg("whisper-base", "decode_32k")
    _, (_, wcache, _), _ = dryrun.build(wcfg, "decode_32k")
    assert wcache["layers"][0]["xk"].shape == (2, wcfg.n_heads,
                                               wcfg.encoder_seq,
                                               wcfg.head_dim)


def _artifacts(tmp_path):
    out = str(tmp_path)
    for arch, shape in (("gemma3-4b", "prefill_32k"),
                        ("gemma3-4b", "long_500k"),
                        ("deepseek-v3-671b", "decode_32k"),
                        ("rwkv6-1.6b", "train_4k")):
        dryrun.run_one(arch, shape, out_dir=out)
    dryrun.run_one("deepseek-v3-671b", "decode_32k", out_dir=out,
                   variant="absorb")
    assert dryrun.run_one("whisper-base", "long_500k", out_dir=out)[
        "skipped"]
    return out


def test_artifacts_are_read_by_both_packages_readers(small, tmp_path):
    out = _artifacts(tmp_path)
    doc = json.loads((tmp_path / "h100__gemma3-4b__long_500k.json")
                     .read_text())
    assert doc["mesh"] == "1xH100" and doc["n_devices"] == 1
    assert doc["config_name"] == "gemma3-4b-smoke+swa"
    assert doc["meta"]["accounting"] == "meta-exact"
    assert doc["roofline"]["collective_s"] == 0.0
    assert doc["roofline"]["compute_s"] == doc["flops_per_device"] / 989e12
    assert doc["roofline"]["memory_s"] == doc["bytes_per_device"] / 3.35e12
    assert doc["fits"] is True and doc["device"] is None
    assert doc["wall_s"] > 0
    rs = jroof.rows(out)
    assert [(r["arch"], r["shape"]) for r in rs] == [
        ("deepseek-v3-671b", "decode_32k"), ("gemma3-4b", "long_500k"),
        ("gemma3-4b", "prefill_32k"), ("rwkv6-1.6b", "train_4k")]
    want = jroof.to_markdown(rs)
    got = roofline.to_markdown(roofline.rows(out))
    assert got.replace("tensor-core", "MXU") == want
    assert len(want.splitlines()) == 6
    assert roofline.main(["--dir", out]) == got
    sized = roofline.sizing_markdown(roofline.rows(out)).splitlines()
    assert sized[0].endswith("| arg + temp GB | fits | wall s |")
    assert all(ln.startswith(old) and ln.count("|") == old.count("|") + 3
               for ln, old in zip(sized, got.splitlines()))
    pairs = jperf.rows(out, mesh="h100")
    assert [tag for _, _, tag in pairs] == ["absorb"]
    table = jperf.to_markdown(pairs)
    assert "| deepseek-v3-671b | decode_32k | absorb |" in table
    assert perf_report.to_markdown(perf_report.rows(out)) == table


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The artifacts of ``torch_mesh_dryrun.py``'s three groups, run in a
    process of their own on one thread (the fake process group is global
    state)."""
    here = pathlib.Path(__file__).resolve().parent
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), str(here), str(here.parent),
         os.environ.get("PYTHONPATH", "")]))
    p = subprocess.run([sys.executable, str(here / "torch_mesh_dryrun.py"),
                        str(out)], env=env, cwd=here,
                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return out


def _doc(out, name):
    return json.loads((out / name).read_text())


@pytest.mark.parametrize("variant", ["zero1", "grouped", "batchshard",
                                     "puredp", "ringdecode"])
def test_mesh_variants_raise(small, mesh_runs, variant):
    """Each mesh variant runs on the 16x16 mesh (the name is the one these
    cases had when the mesh variants raised): an artifact with its
    collectives, ``collective_s`` their bytes over ``LINK_BW``, and
    per-device counts; an unknown variant still raises, and a mesh variant
    refuses one card."""
    shape = "train_4k" if variant == "zero1" else "decode_32k"
    doc = _doc(mesh_runs, f"pod__mistral-nemo-12b__{shape}__{variant}.json")
    assert doc["mesh"] == "16x16" and doc["n_devices"] == 256
    assert doc["variant"] == variant
    coll = doc["collectives"]
    assert set(coll["bytes"]) == set(dryrun.COLLECTIVE_KINDS)
    assert coll["total_bytes"] == sum(coll["bytes"].values())
    # puredp replicates the weights, and its batch of 2 over 256 data
    # ranks: nothing to exchange
    assert (coll["total_bytes"] == 0) == (variant == "puredp")
    assert doc["roofline"]["collective_s"] == \
        coll["total_bytes"] / dryrun.LINK_BW
    assert doc["roofline"]["model_flops_per_device"] == \
        doc["roofline"]["model_flops_global"] / 256
    assert doc["flops_per_device"] > 0 and doc["bytes_per_device"] > 0
    if variant == "zero1":
        assert doc["meta"]["round"]["n"] == 16
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.run_one("gemma3-4b", "decode_32k", out_dir="",
                       variant="fused")
    if variant != "grouped":
        with pytest.raises(ValueError, match="needs a mesh"):
            dryrun.run_one("gemma3-4b", "decode_32k", out_dir="",
                           variant=variant, mesh="1xH100")


def test_cli_one_combo_multi_pod_and_the_all_loop(small, tmp_path, capsys,
                                                  mesh_runs):
    res = dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "prefill_32k",
                       "--out-dir", str(tmp_path)])
    assert res["file"] == str(tmp_path /
                              "h100__phi4-mini-3.8b__prefill_32k.json")
    pod = _doc(mesh_runs, "multipod__phi4-mini-3.8b__decode_32k.json")
    assert pod["mesh"] == "2x16x16" and pod["n_devices"] == 512
    assert pod["roofline"]["model_flops_per_device"] == \
        pod["roofline"]["model_flops_global"] / 512
    assert pod["collectives"]["total_bytes"] > 0
    for arch in tconfigs.ARCH_IDS:
        for shape in tconfigs.SHAPES:
            (tmp_path / f"h100__{arch}__{shape}.json").write_text("{}")
    capsys.readouterr()
    assert dryrun.main(["--all", "--skip-existing", "--out-dir",
                        str(tmp_path)]) == {}
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("EXISTS") for ln in lines) == 39
    assert lines.count("SKIP whisper-base long_500k (whisper-base "
                       "long_500k)") == 1


def test_roofline_job_of_the_harness(small, tmp_path):
    done = bench_run.main(["--device", "cpu", "--only", "roofline",
                           "--out", ""])
    assert [r["name"] for r in done["roofline"]["rows"]] == [
        "roofline/skipped"]
    out = _artifacts(tmp_path)
    common.drain_rows()
    roofline_report.run(out)
    names = [r["name"] for r in common.drain_rows()]
    assert names == [
        "roofline/1xH100/deepseek-v3-671b/decode_32k",
        "roofline/1xH100/deepseek-v3-671b/decode_32k/absorb",
        "roofline/1xH100/gemma3-4b/long_500k",
        "roofline/1xH100/gemma3-4b/prefill_32k",
        "roofline/1xH100/rwkv6-1.6b/train_4k"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_mesh_flops_per_device_times_devices_are_one_cards(small, shape,
                                                           mesh_runs):
    """mistral-nemo-12b's smoke config divides the 1 x 2 mesh (4 heads, 2
    KV heads, d_ff 512, vocabulary 512): the model axis splits every
    matmul, so rank 0's FLOPs (its local ops) times 2 are one card's.  The
    train round (n = 1 worker, the mesh's data size, on both) holds it too
    with its backward: the residual stream's gradient is reduced before a
    row-parallel product's backward, and a row-parallel weight's gradient
    is taken from its own rows of the input."""
    doc = _doc(mesh_runs, f"mesh1x2__mistral-nemo-12b__{shape}.json")
    if shape == "train_4k":
        cfg = dryrun.dryrun_config(dryrun.get_config("mistral-nemo-12b"),
                                   shape)
        fn, args, meta = dryrun.build_train(cfg, shape, n=1)
        res = dryrun.measure(fn, args)
        one = {"flops_per_device": res["flops"],
               "bytes_per_device": res["bytes"]}
        assert doc["meta"]["round"] == meta["round"]
    else:
        one = dryrun.run_one("mistral-nemo-12b", shape, out_dir="")
    assert doc["n_devices"] == 2 and doc["mesh"] == "1x2"
    assert doc["flops_per_device"] * 2 == one["flops_per_device"] > 0
    assert doc["bytes_per_device"] < one["bytes_per_device"]


@pytest.mark.parametrize("variant", ["baseline", "grouped"])
def test_mesh_decode_exchanges_one_kv_head_a_rank(small, mesh_runs,
                                                  variant):
    """One KV head, 4 query heads on the 1 x 2 mesh: the sequence-sharded
    cache goes to the two ranks' heads in one all-to-all a layer for k and
    one for v, each bringing a rank the one KV head its query heads read
    over the whole sequence, (B, 1, S, dh): the head repeated once, to one
    a rank, and the rest of GQA's repetition each rank's own, in the
    baseline decode as in the grouped one."""
    tag = "kv1" + ("" if variant == "baseline" else variant)
    doc = _doc(mesh_runs, f"mesh1x2__mistral-nemo-12b__decode_32k__{tag}"
                          f".json")
    cfg = cli_config("mistral-nemo-12b", True)
    B, S = SMALL["decode_32k"].global_batch, SMALL["decode_32k"].seq_len
    coll = doc["collectives"]
    assert coll["counts"]["all-to-all"] == 2 * cfg.n_layers
    assert coll["bytes"]["all-to-all"] == \
        2 * cfg.n_layers * B * S * cfg.head_dim * 4


def test_swa_rule_refuses_q_heads_sharded_alone(mesh_runs):
    """A sliding-window prefill with 4 query heads and one KV head on the
    1 x 2 mesh: q's heads are sharded, k's and v's cannot be, and the swa
    op's DTensor rule raises with the op's name instead of gathering q and
    running the whole band on both ranks."""
    text = (mesh_runs / "swa_refused.txt").read_text()
    assert text.startswith("repro_torch::swa_attention: DTensor cannot "
                           "shard q (Replicate(), Shard(dim=2)), k "
                           "(Replicate(), Replicate())")


def test_one_layer_collectives_are_the_analytic_count(small, mesh_runs):
    """One dense layer's prefill (B 2, T 48, float32) on the 1 x 2 mesh,
    Megatron's pattern as the port shards it: an all-reduce of (B, T, d)
    after the vocabulary-parallel embedding, after the row-parallel ``wo``
    and after ``w_down``; an all-gather of the heads' output (B, T, H dh)
    for the reference's "attn.o" constraint, and of the last position's
    logits (B, V) over the sharded vocabulary for the argmax; nothing
    else."""
    doc = _doc(mesh_runs,
               "mesh1x2__mistral-nemo-12b__prefill_32k__onelayer.json")
    cfg = cli_config("mistral-nemo-12b", True)
    B, T = SMALL["prefill_32k"].global_batch, SMALL["prefill_32k"].seq_len
    d, Hd, f32 = cfg.d_model, cfg.n_heads * cfg.head_dim, 4
    want = dict.fromkeys(dryrun.COLLECTIVE_KINDS, 0)
    want["all-reduce"] = 3 * B * T * d * f32
    want["all-gather"] = B * T * Hd * f32 + B * cfg.padded_vocab * f32
    coll = doc["collectives"]
    assert coll["bytes"] == want
    assert coll["counts"] == {**dict.fromkeys(dryrun.COLLECTIVE_KINDS, 0),
                              "all-reduce": 3, "all-gather": 2}


def test_mesh_artifacts_are_read_by_both_packages_readers(small,
                                                          mesh_runs):
    out = str(mesh_runs)
    want = jroof.rows(out, "16x16")      # the baselines; perf_report
    assert len(want) == 3                # reads the tagged variants
    assert roofline.to_markdown(roofline.rows(out, "16x16")).replace(
        "tensor-core", "MXU").replace("InfiniBand", "ICI") == \
        jroof.to_markdown(want)
    assert all(r["roofline"]["collective_s"] > 0 for r in want)
    pairs = jperf.rows(out, mesh="pod")
    assert sorted(tag for _, _, tag in pairs) == [
        "batchshard", "grouped", "puredp", "ringdecode", "zero1"]
    assert perf_report.to_markdown(perf_report.rows(out, mesh="pod")) == \
        jperf.to_markdown(pairs)
    assert jroof.rows(out, "2x16x16")[0]["arch"] == "phi4-mini-3.8b"
