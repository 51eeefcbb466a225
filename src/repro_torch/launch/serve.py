"""Serving launcher of the port: batched greedy decode with a KV cache
(counterpart of ``repro.launch.serve``).  Prefill goes through
``forward(..., cache=...)``, then ``gen - 1`` greedy decode steps; prints
the prefill and decode times.  Weights are random, drawn on the device from
``--seed``; an encoder-decoder (whisper) also draws its encoder frames
(B, encoder_seq, frontend_dim) from it, for the prefill only.  Prompts
are text: a vision-stub model (llava-next-34b, llama4-maverick) runs
without patch embeddings, as the reference's serve CLI runs it.  A
hybrid (jamba-v0.1-52b) carries its Mamba layers' state in the cache;
under ``--smoke`` it runs the reference CLI's cut, attention every second
layer (``configs.cli_config``).  Runs on the CUDA card unless given
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
      --batch 2 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b \\
      --batch 1 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import ARCH_IDS, cli_config
from ..device import resolve_device
from ..kernels import ops
from ..models import forward, init_cache, init_params
from ..models.config import ModelConfig
from ..train import make_serve_step

__all__ = ["ServeResult", "run", "main"]


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, gen) generated tokens, on the CPU
    prefill_s: float              # wall seconds of the prefill forward
    decode_s: float               # wall seconds of the gen - 1 decode steps
    finite: bool                  # every prefill and decode logit finite
    launches_after_prefill: dict  # ops.LAUNCHES right after the prefill
    init_s: float                 # wall seconds of init_params


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def run(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int,
        seed: int = 0, device=None) -> ServeResult:
    """Prefill a random prompt of ``prompt_len`` tokens per request (with
    random encoder frames where the model has an encoder), then decode
    greedily to ``gen`` tokens.  Weights are drawn from ``seed`` (timed as
    ``init_s``).  Times end in a device synchronisation; the prefill time
    stops before the finiteness check, and each decode step adds one
    min/max reduction of its logits.  On a card, raises if the weights
    alone exceed its memory."""
    if min(batch, prompt_len, gen) < 1:
        raise ValueError("batch, prompt_len and gen must be >= 1")
    dev = resolve_device(device)
    if dev.type == "cuda":
        need = sum(p.numel() * p.element_size() for p in
                   init_params(cfg, device="meta").parameters())
        have = torch.cuda.get_device_properties(dev).total_memory
        if need > have:
            raise ValueError(f"{cfg.name}: {need} bytes of weights exceed the "
                             f"{have} bytes of one card (multi-GPU serving "
                             f"is a later slice, ROADMAP.md)")
    _sync(dev)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=seed, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    cache = init_cache(cfg, batch, prompt_len + gen + 8, device=dev)
    gen_ = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen_, device=dev)
    frames = (torch.randn((batch, cfg.encoder_seq, cfg.frontend_dim),
                          generator=gen_, device=dev)
              if cfg.encoder_layers else None)
    _sync(dev)
    t0 = time.perf_counter()
    logits, _, cache = forward(model, cfg, prompt, cache=cache,
                               enc_frames=frames)
    nxt = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # min and max carry any NaN or inf, with no full-size temporary
    extremes = [torch.stack(torch.aminmax(logits)).float()]
    del logits
    serve = make_serve_step(cfg)
    out = [nxt]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        nxt, cache, last = serve(model, cache, nxt)
        extremes.append(torch.stack(torch.aminmax(last)).float())
        out.append(nxt)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(torch.stack(extremes)).all())
    return ServeResult(torch.cat(out, dim=1).cpu(), prefill_s, decode_s,
                       finite, launches, init_s)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = cli_config(args.arch, args.smoke)
    res = run(cfg, batch=args.batch, prompt_len=args.prompt_len,
              gen=args.gen, seed=args.seed, device=args.device)
    B, steps = args.batch, args.gen - 1
    print(f"{cfg.name}: prefill {args.prompt_len} tok in "
          f"{res.prefill_s * 1e3:.1f} ms "
          f"({B * args.prompt_len / max(res.prefill_s, 1e-9):.1f} tok/s); "
          f"{steps} decode steps in {res.decode_s * 1e3:.1f} ms "
          f"({steps * B / max(res.decode_s, 1e-9):.1f} tok/s batch={B}); "
          f"weights drawn in {res.init_s:.2f} s")
    for b in range(min(B, 2)):
        print(f"  req{b}: {res.tokens[b, :16].tolist()}...")
    return res


if __name__ == "__main__":
    main()
