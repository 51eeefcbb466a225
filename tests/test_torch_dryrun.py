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
  row, every mesh variant and ``--multi-pod`` raising, the ``--all`` loop,
  and the ``roofline`` benchmark job (its ``roofline/skipped`` row on an
  empty directory)."""
import dataclasses
import json

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


@pytest.mark.parametrize("variant", dryrun.MESH_VARIANTS)
def test_mesh_variants_raise(small, variant):
    with pytest.raises(NotImplementedError, match="item 8.8"):
        dryrun.run_one("gemma3-4b", "decode_32k", out_dir="",
                       variant=f"absorb,{variant}")
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.run_one("gemma3-4b", "decode_32k", out_dir="",
                       variant="fused")


def test_cli_one_combo_multi_pod_and_the_all_loop(small, tmp_path, capsys):
    res = dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "prefill_32k",
                       "--out-dir", str(tmp_path)])
    assert res["file"] == str(tmp_path /
                              "h100__phi4-mini-3.8b__prefill_32k.json")
    with pytest.raises(NotImplementedError, match="item 8.8"):
        dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "train_4k",
                     "--multi-pod"])
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
