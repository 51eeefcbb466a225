"""The scale of an LM's gradient at initialisation and what the trainer's
global-norm clip does to it, on the CUDA card.

For each ``--arch`` at full size: one forward and backward of a slot of
the straggler trainer's batch (16 bigram sequences of 64 tokens, train
leg A of ``chip_smoke.py``) from ``init_params`` under the trainer's init
seed; the gradient's global norm and, by parameter group (the embedding,
each block, the final norm, the LM head), its norm and the share of its
elements that the clip to ``CLIP_NORM`` puts below AdamW's ``eps``, where
AdamW's update of an element shrinks in proportion (the embedding's rows
of tokens not in the batch have no gradient and count among them).  With
``--lrs``, the trainer CLI at each peak learning rate with leg A's other
flags for ``--steps`` steps on ``--arch``'s first: the first and the last
step's loss (each on its own fresh batch) and the loss on that slot
batch under the initial and the trained weights.

Run on a machine with a card, from the repository root:

    python3 benchmarks_torch/lm_grad_scale.py --arch rwkv6-1.6b gemma3-4b \\
        --lrs 3e-4 1e-3 3e-3

Prints one JSON object per measurement, and the card's name and power
limit first.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import staircase_to_matrix  # noqa: E402
from repro_torch.data import TaskPartition, lm_task_batches  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.cluster import derive_seeds  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.train import lm_loss_per_seq  # noqa: E402
from repro_torch.train.steps import CLIP_NORM  # noqa: E402

#: train leg A's flags after --arch and --steps (chip_smoke.TRAIN_ARGV)
LEG_A = ["--n", "8", "--r", "2", "--k", "6", "--batch", "16", "--seq", "64",
         "--schedule", "ss", "--cluster", "markov", "--persistence", "0.95",
         "--spread", "3", "--adaptive"]
#: AdamW's eps (``optim.adamw``'s default, the trainer's)
ADAM_EPS = 1e-8
DEV = torch.device("cuda")


def step0_batch(cfg, seed: int = 0):
    """The first slot of the trainer's step-0 data under ``--seed`` 0, on
    the static SS matrix: (16, 64) tokens and labels."""
    part = TaskPartition(n=8, global_batch=16, seq_len=64,
                         vocab=cfg.vocab_size, source="bigram",
                         seed=derive_seeds(seed)["data_seed"])
    toks, labs = lm_task_batches(part, staircase_to_matrix(8, 2), 0,
                                 device=DEV)
    return toks[0].reshape(16, 64), labs[0].reshape(16, 64)


def init_seed(seed: int = 0) -> int:
    return int(derive_seeds(seed)["init_key"][1])


def grad_scale(arch: str) -> dict:
    cfg = get_config(arch)
    model = init_params(cfg, seed=init_seed(), device=DEV, trainable=True)
    toks, labs = step0_batch(cfg)
    loss = lm_loss_per_seq(model, cfg, toks, labs)[0].mean()
    loss.backward()
    def group(name):
        parts = name.split(".")
        return ".".join(parts[:2]) if parts[0] == "blocks" else parts[0]

    grads = [(group(n), p.grad.float()) for n, p in model.named_parameters()]
    sq, count, below = {}, {}, {}
    for key, g in grads:
        sq[key] = sq.get(key, 0.0) + float((g * g).sum())
        count[key] = count.get(key, 0) + g.numel()
    norm = sum(sq.values()) ** 0.5
    clip = min(1.0, CLIP_NORM / norm)
    for key, g in grads:
        below[key] = below.get(key, 0) + int((g.abs() * clip < ADAM_EPS)
                                             .sum())
    out = {"arch": arch, "loss": float(loss.detach()), "grad_norm": norm,
           "clip_scale": clip, "groups": {
               key: {"norm": sq[key] ** 0.5,
                     "rms": (sq[key] / count[key]) ** 0.5,
                     "below_eps_after_clip": below[key] / count[key]}
               for key in sq}}
    return out


def train_at(arch: str, lr: str, steps: int) -> dict:
    res = train_cli.main(["--arch", arch, "--steps", str(steps)] + LEG_A
                         + ["--lr", lr])
    cfg = res.state.params.cfg
    toks, labs = step0_batch(cfg)
    with torch.no_grad():
        after = float(lm_loss_per_seq(res.state.params, cfg, toks,
                                      labs)[0].mean())
    losses = [h["loss"] for h in res.history]
    del res
    torch.cuda.empty_cache()
    model = init_params(cfg, seed=init_seed(), device=DEV)
    with torch.no_grad():
        before = float(lm_loss_per_seq(model, cfg, toks, labs)[0].mean())
    del model
    torch.cuda.empty_cache()
    return {"arch": arch, "lr": float(lr), "steps": steps,
            "loss_first": losses[0], "loss_last": losses[-1],
            "losses": losses, "step0_batch_before": before,
            "step0_batch_after": after}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", choices=ARCH_IDS,
                    default=["rwkv6-1.6b", "gemma3-4b"])
    ap.add_argument("--lrs", nargs="*", default=[],
                    help="peak learning rates to train --arch[0] at")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("lm_grad_scale: no CUDA device available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build_all()                # greedy_assign for --adaptive
    for arch in args.arch:
        print(json.dumps(grad_scale(arch)), flush=True)
        torch.cuda.empty_cache()
    for lr in args.lrs:
        print(json.dumps(train_at(args.arch[0], lr, args.steps)), flush=True)


if __name__ == "__main__":
    main()
