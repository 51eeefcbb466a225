"""Single-device dry run with H100 roofline terms (counterpart of
``repro.launch.dryrun``).

For one (architecture x input shape) on one card:
  * builds the step (straggler train round / prefill / decode) with its
    model, optimizer state, KV cache and inputs on the ``meta`` device:
    shapes and dtypes only, nothing allocated (``build_train``,
    ``build_prefill``, ``build_decode``);
  * runs the step once under ``FlopCounterMode`` (``flops_per_device``:
    every matmul, and ``swa_attention`` by its registered formula, the
    band) and once under ``TrafficMode``
    (``bytes_per_device``: what every op reads and writes, ``op_bytes``,
    the analogue of XLA's "bytes accessed"; the peak of live
    bytes the step allocates, ``memory_analysis.temp_size_in_bytes``,
    beside the bytes of its arguments);
  * derives the roofline terms from an H100 SXM's published peaks (989e12
    dense bf16 FLOP/s on the tensor cores, 3.35e12 B/s of HBM) and the
    useful share MODEL_FLOPS / counted FLOPs.

The count is exact ("meta-exact"): every layer and every step of the SSM
time loops runs on ``meta``, where the reference compiles two probe depths
and extrapolates, and counts an SSM time scan's body once.  A decode step
runs at cache position seq_len - 1, the deepest the shape allows (MLA's
naive path decompresses the latents of [0, pos + 1), so its cost grows with
the position; the reference's compiled step costs the same at any depth).
Collectives are 0 on one card (``mesh`` "1xH100"); the mesh variants
(``zero1``, ``grouped``, ``batchshard``, ``puredp``, ``ringdecode``) and
``--multi-pod`` raise (ROADMAP.md queue 1, item 8.8); ``absorb`` runs.
``fits`` says whether the argument and temp bytes fit one card's 80 GB.
The same builds run on a card (``device="cuda"``: weights from ``seed``,
zero caches, zero tokens, normal extras), which is how ``chip_smoke.py``
holds the count to a real step.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch gemma3-4b --shape long_500k
  python -m repro_torch.launch.dryrun --all        # subprocess per combo
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import (ARCH_IDS, SHAPES, get_config, input_specs, resolve,
                       shape_supported)
from ..core import RoundConfig, scenario1
from ..models import active_params, init_cache, init_params
from ..models.model import forward
from ..optim import adamw
from ..train import init_train_state, make_serve_step, \
    make_straggler_train_step

__all__ = ["VARIANTS", "MESH_VARIANTS", "PEAK_FLOPS", "HBM_BW", "CARD_BYTES",
           "TrafficMode", "op_bytes", "build_train", "build_prefill",
           "build_decode", "build", "measure",
           "dryrun_config", "model_flops_global", "run_one",
           "artifact_name", "main"]

VARIANTS = ("zero1", "absorb", "grouped", "batchshard", "puredp",
            "ringdecode")
#: the variants that need a mesh of cards
MESH_VARIANTS = tuple(v for v in VARIANTS if v != "absorb")
_MESH = ("ROADMAP.md queue 1, item 8.8 (the mesh variants and collective "
         "accounting of the dry run)")

# --- H100 SXM published peaks (per card, NVIDIA data sheet) ---------------
PEAK_FLOPS = 989e12          # dense bf16 on the tensor cores
HBM_BW = 3.35e12             # bytes/s
#: one card's memory, for ``fits``
CARD_BYTES = 80e9
#: the data-parallel width of the reference's pod mesh, the straggler
#: round's n (a (16, 16) mesh's data axis)
ROUND_N = 16


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _writes(spec) -> bool:
    return spec.alias_info is not None and spec.alias_info.is_write


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes an op moves: its tensor inputs read and its outputs
    written.  A view, or an op that returns its input as it is (``to`` to
    its own dtype), moves nothing.  An in-place op reads its other inputs
    and writes, of its target, as many elements as its largest other
    input holds (a cache write, ``index_put_``, writes its values, not the
    cache), or all of it when it has no other tensor input."""
    if func.is_view:
        return 0
    kwargs = kwargs or {}
    specs = func._schema.arguments
    mutated = [a for spec, a in zip(specs, args) if _writes(spec)]
    mutated += [kwargs[spec.name] for spec in specs
                if spec.name in kwargs and _writes(spec)]
    written = {id(t) for t in _tensors(mutated)}
    ins = _tensors((args, kwargs))
    reads = [t for t in ins if id(t) not in written]
    if not written:
        outs = _tensors(out)
        if outs and {_storage(t) for t in outs} <= {_storage(t) for t in ins}:
            return 0
        return sum(_nbytes(t) for t in reads + outs)
    most = max((t.numel() for t in reads), default=None)
    return sum(_nbytes(t) for t in reads) + sum(
        (_nbytes(t) if most is None else
         min(t.numel(), most) * t.element_size())
        for t in ins if id(t) in written)


class TrafficMode(TorchDispatchMode):
    """Counts, over the ops dispatched under it: ``bytes``, what each op
    moves (``op_bytes``); ``peak``, the most bytes alive at once in
    storages that ops created (each storage counted from its creation
    until it is freed, through ``weakref.finalize``), storages of
    ``known`` tensors (the step's arguments) excluded; ``live``, those
    bytes alive now; ``ops``, the ops dispatched."""

    def __init__(self, known=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self._seen = {_storage(t) for t in known}

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        self.bytes += op_bytes(func, args, kwargs, out)
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def _inputs(cfg, shape: str, device, seed: int, **kw) -> dict:
    """``input_specs`` on ``device``; off ``meta`` with values: token ids
    0, float extras normal under ``seed``."""
    ins = input_specs(cfg, shape, device=device, **kw)
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device).manual_seed(seed)
        for t in ins.values():
            if t.is_floating_point():
                t.normal_(generator=gen)
            else:
                t.zero_()
    return ins


def _check_variant(variant: str) -> dict:
    """The config overrides of a comma list of ``VARIANTS``; a mesh
    variant raises."""
    overrides = {}
    for v in filter(None, variant.split(",")):
        if v == "absorb":
            overrides["mla_absorb"] = True
        elif v in MESH_VARIANTS:
            raise NotImplementedError(f"dry-run variant {v!r} needs a mesh "
                                      f"of cards: {_MESH}")
        else:
            raise ValueError(f"unknown variant {v!r}; have {VARIANTS}")
    return overrides


def build_train(cfg, shape: str, *, r: int = 1, k_frac: float = 1.0,
                schedule: str = "ss", n: int = ROUND_N, device="meta",
                seed: int = 0):
    """The straggler train round of ``shape`` (AdamW 1e-4, scenario 1's
    delays, n workers, k = round(k_frac n)): (step, arguments, meta)."""
    k = max(1, int(round(k_frac * n)))
    config = RoundConfig(n=n, k=k, kind=schedule, r=r)
    opt = adamw(1e-4)
    step = make_straggler_train_step(cfg, opt, config, scenario1())
    state = init_train_state(cfg, opt, seed=seed, device=device)
    ins = _inputs(cfg, shape, device, seed, n=n, r=r)
    extras = {}
    if "slot_embeds" in ins:
        extras["embeds"] = ins["slot_embeds"]
    if "slot_frames" in ins:
        extras["enc_frames"] = ins["slot_frames"]

    def fn():
        new_state, metrics, _cluster = step(
            state, ins["slot_tokens"], ins["slot_labels"], seed,
            extras=extras or None)
        return new_state, metrics

    args = (state.named_params(), state.opt_state, ins)
    meta = {"round": dict(n=n, r=r, k=k, schedule=schedule)}
    return fn, args, meta


def build_prefill(cfg, shape: str, *, device="meta", seed: int = 0):
    """The prefill of ``shape``: the forward without a cache and the argmax
    of the last position's logits."""
    params = init_params(cfg, seed=seed, device=device)
    ins = _inputs(cfg, shape, device, seed)

    @torch.inference_mode()
    def fn():
        logits, _, _ = forward(params, cfg, ins["tokens"],
                               embeds=ins.get("embeds"),
                               enc_frames=ins.get("enc_frames"))
        return logits[:, -1].argmax(dim=-1)

    return fn, (dict(params.named_parameters()), ins), {}


def build_decode(cfg, shape: str, *, device="meta", seed: int = 0):
    """One greedy decode step of ``shape``: B tokens against a cache of
    seq_len positions, at position seq_len - 1 (the cache's ``pos``); a
    decoder with cross-attention reads the encoder's keys and values from
    the cache, as after a prefill."""
    sh = SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    params = init_params(cfg, seed=seed, device=device)
    cache = init_cache(cfg, B, S, device=device)
    cache["pos"] = S - 1
    for layer in cache["layers"]:
        if "attn" in layer:               # each attention layer's own pos
            layer["attn"]["pos"] = S - 1
        if "xk" in layer:   # the encoder's keys and values a prefill left
            layer["xk"], layer["xv"] = (torch.zeros(
                (B, cfg.n_heads, cfg.encoder_seq, cfg.head_dim),
                dtype=getattr(torch, cfg.dtype), device=device)
                for _ in range(2))
    ins = _inputs(cfg, shape, device, seed)
    serve = make_serve_step(cfg)

    @torch.inference_mode()
    def fn():
        return serve(params, cache, ins["tokens"])

    return fn, (dict(params.named_parameters()), cache, ins), \
        {"decode_pos": S - 1}


def build(cfg, shape: str, *, device="meta", r: int = 1,
          k_frac: float = 1.0, schedule: str = "ss", seed: int = 0):
    """The build of ``shape``'s kind: (step, arguments, meta)."""
    kind = SHAPES[shape].kind
    if kind == "train":
        return build_train(cfg, shape, r=r, k_frac=k_frac,
                           schedule=schedule, device=device, seed=seed)
    if kind == "prefill":
        return build_prefill(cfg, shape, device=device, seed=seed)
    return build_decode(cfg, shape, device=device, seed=seed)


def measure(fn, args) -> dict:
    """Two calls of ``fn``: one under ``FlopCounterMode`` for the FLOPs,
    one under ``TrafficMode`` alone for the bytes, the ops and the bytes
    of the arguments, of what the step allocated at its peak and of what it
    leaves alive (its outputs).  The peak needs a call of its own:
    ``FlopCounterMode``'s module tracker hangs backward hooks on a training
    step's activations and keeps them alive (gemma3-4b's train_4k round
    peaks at 9 882 GB under it, 3 508 GB without it, by
    ``benchmarks_torch/dryrun_breakdown.py``)."""
    known = _tensors(args)
    arg_bytes = sum(st.nbytes() for st in
                    {_storage(t): t.untyped_storage()
                     for t in known}.values())
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    del out
    traffic = TrafficMode(known)
    with traffic:
        out = fn()
    live = traffic.live             # what the step returns, still held
    del out
    return {"flops": float(counter.get_total_flops()),
            "bytes": float(traffic.bytes), "ops": traffic.ops,
            "mem": {"argument_size_in_bytes": int(arg_bytes),
                    "output_size_in_bytes": int(live),
                    "temp_size_in_bytes": int(traffic.peak),
                    "generated_code_size_in_bytes": 0}}


def model_flops_global(cfg, shape: str, *, r: int = 1) -> float:
    """Useful MODEL_FLOPS for the step: 6*N_active*D train (x r redundancy
    excluded — that's the *useful* figure), 2*N*D prefill, 2*N*B decode."""
    sh = SHAPES[shape]
    N = active_params(cfg)
    if sh.kind == "train":
        return 6.0 * N * sh.global_batch * sh.seq_len
    if sh.kind == "prefill":
        return 2.0 * N * sh.global_batch * sh.seq_len
    return 2.0 * N * sh.global_batch


def _card() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None
    without a card."""
    if not torch.cuda.is_available():
        return None
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def artifact_name(out_dir: str, arch: str, shape: str, tag: str = "") -> str:
    """``<out_dir>/h100__<arch>__<shape>[__<tag>].json``: the reference's
    layout with the mesh word "h100", so its readers' globs take it."""
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out_dir, f"h100__{arch}__{shape}{suffix}.json")


def dryrun_config(cfg, shape: str, variant: str = ""):
    """The config the dry run of (``cfg``'s arch, ``shape``) traces:
    ``resolve``'s, with remat in training and ``variant``'s overrides."""
    return dataclasses.replace(resolve(cfg, shape), scan_layers=False,
                               remat=SHAPES[shape].kind == "train",
                               **_check_variant(variant))


def run_one(arch: str, shape: str, *, r: int = 1, k_frac: float = 1.0,
            schedule: str = "ss", out_dir: str = "experiments/dryrun_torch",
            tag: str = "", variant: str = "") -> dict:
    """The dry run of (arch, shape) on ``meta``; writes its JSON artifact
    into ``out_dir`` (none when empty) and returns it."""
    t0 = time.perf_counter()
    cfg0 = get_config(arch)
    if not shape_supported(cfg0, shape):
        return {"arch": arch, "shape": shape, "skipped": True,
                "reason": "whisper-base skips long_500k"}
    kind = SHAPES[shape].kind
    cfg = dryrun_config(cfg0, shape, variant)
    fn, args, meta = build(cfg, shape, r=r, k_frac=k_frac,
                           schedule=schedule)
    t_build = time.perf_counter() - t0
    res = measure(fn, args)
    t_trace = time.perf_counter() - t0 - t_build
    flops, bytes_acc, mem = res["flops"], res["bytes"], res["mem"]
    meta["accounting"] = "meta-exact"
    meta["meta_ops"] = res["ops"]
    if kind == "decode":
        meta["decode"] = (f"one step at cache pos {meta['decode_pos']} "
                          f"(seq_len - 1, the deepest step)")
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_acc / HBM_BW,
             "collective_s": 0.0}
    dominant = max(terms, key=terms.get)
    mf = model_flops_global(cfg, shape, r=r)
    zero = dict.fromkeys(("all-reduce", "all-gather", "reduce-scatter",
                          "all-to-all", "collective-permute"), 0)
    need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    if variant and not tag:
        tag = variant.replace(",", "+")
    result = {
        "arch": arch, "shape": shape, "mesh": "1xH100", "n_devices": 1,
        "kind": kind, "variant": variant or "baseline",
        "round_r": r, "round_k_frac": k_frac,
        "config_name": cfg.name,
        "active_params": active_params(cfg),
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "collectives": {"bytes": zero, "counts": dict(zero),
                        "total_bytes": 0},
        "memory_analysis": mem,
        "roofline": {**terms, "dominant": dominant,
                     "model_flops_global": mf,
                     "model_flops_per_device": mf,
                     "useful_ratio": (mf / flops) if flops else 0.0},
        "meta": meta,
        # the reference's keys: the build (no lowering) and the meta trace
        "timings": {"lower_s": t_build, "compile_s": t_trace},
        "fits": need <= CARD_BYTES,
        "device": _card(),
        "wall_s": time.perf_counter() - t0,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = artifact_name(out_dir, arch, shape, tag)
        with open(fname, "w") as f:
            json.dump(result, f, indent=1)
        result["file"] = fname
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="a mesh of cards (not in the port yet: raises)")
    ap.add_argument("--all", action="store_true",
                    help="run every supported combo in subprocesses")
    ap.add_argument("--r", type=int, default=1, help="computation load")
    ap.add_argument("--k-frac", type=float, default=1.0,
                    help="computation target as fraction of n")
    ap.add_argument("--schedule", default="ss")
    ap.add_argument("--variant", default="",
                    help="comma list of " + ",".join(VARIANTS))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(f"--multi-pod needs a mesh of cards: "
                                  f"{_MESH}")

    if args.all:
        failures, walls = [], {}
        for arch in ARCH_IDS:
            for shape in SHAPES:
                if not shape_supported(get_config(arch), shape):
                    print(f"SKIP {arch} {shape} (whisper-base long_500k)")
                    continue
                fname = artifact_name(args.out_dir, arch, shape, args.tag)
                if args.skip_existing and os.path.exists(fname):
                    print(f"EXISTS {fname}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--r", str(args.r), "--k-frac", str(args.k_frac),
                       "--schedule", args.schedule,
                       "--out-dir", args.out_dir]
                if args.variant:
                    cmd += ["--variant", args.variant]
                if args.tag:
                    cmd += ["--tag", args.tag]
                print(f"=== {arch} {shape} 1xH100 ===", flush=True)
                t0 = time.perf_counter()
                try:
                    rc = subprocess.run(cmd, timeout=args.timeout,
                                        stdout=subprocess.DEVNULL
                                        ).returncode
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                walls[f"{arch} {shape}"] = time.perf_counter() - t0
                print(f"    {walls[f'{arch} {shape}']:.1f} s, rc {rc}",
                      flush=True)
                if rc != 0:
                    failures.append((arch, shape))
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("ALL DRY-RUNS PASSED")
        return walls

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    res = run_one(args.arch, args.shape, r=args.r, k_frac=args.k_frac,
                  schedule=args.schedule, out_dir=args.out_dir, tag=args.tag,
                  variant=args.variant)
    print(json.dumps({k: res[k] for k in res if k != "meta"}, indent=1,
                     default=str))
    return res


if __name__ == "__main__":
    main()
