"""Where the port's time goes on the card: a short torch.profiler window
over each smoke workload, reporting wall time, the summed device time of
the CUDA kernels, the device's busy share (kernel time over wall time) and
the kernels that take the most device time.

Workloads (the ones ``chip_smoke.py`` drives):
  sweep   n=16, r=4 (RA r=16), scenario 1, CS/SS/RA/LB/PC/PCMM, all-k,
          10 chunks of 20 000 trials;
  rounds  one Fig. 8 cell (persistence 0.98, spread 3: N=12, R=3, K=9,
          24 rounds, CS/SS/adapt/LB), 8 000 trials in 2 000-trial chunks,
          with launches per chunk-round;
  dgd     RegressionConfig() (N=900, d=400, n=15, r=3, k=15), 20 iterations
          of each of CS/SS/RA/ADAPT/PC/PCMM on the iid cluster;
  dgd-markov  the same on the Markov cluster;
  serve-prefill  gemma3-4b at full width and depth, bf16, random weights:
          one prefill of 2 x 2048 tokens into an empty cache (29
          swa_attention launches, all on the tensor-core kernel);
  serve-decode   8 greedy decode steps of that batch after the prefill,
          with launches per step;
  train   gemma3-4b at full width and depth, bf16, AdamW: 2 straggler-
          scheduled training steps of the smoke's round (n = 8, r = 2,
          k = 6, SS, 16 x 64 tokens a slot, the Markov cluster, adaptive
          rows: one greedy_assign launch a step), with launches per step;
  train-optimizer  the in-place AdamW step alone over the same weights.

Run on a machine with a card, from the repository root:

    python3 benchmarks_torch/profile_port.py [--only train,serve-decode]

Prints one JSON object per workload.  Where the profiler records no device
time, the device numbers read null (not measured).
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import dgd  # noqa: E402
from repro_torch.configs import RegressionConfig, get_config  # noqa: E402
from repro_torch.models import forward, init_cache, init_params  # noqa: E402
from repro_torch.train import make_serve_step  # noqa: E402
sys.path.insert(0, str(Path(__file__).resolve().parent))
import fig8_convergence as fig8  # noqa: E402
from repro_torch.core import sweep_rounds  # noqa: E402
from repro_torch.core import (AdaptiveScheduler, RoundConfig,  # noqa: E402
                              cyclic_to_matrix, ec2_cluster, lb_spec,
                              pc_spec, pcmm_spec,
                              random_assignment_to_matrix, scenario1,
                              staircase_to_matrix, sweep, to_spec)
from repro_torch.data import TaskPartition, lm_task_batches  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.train import (init_train_state,  # noqa: E402
                               make_straggler_train_step)


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0)))


def window(name, fn, card, units=None):
    fn()                                   # warm: kernel build, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    print(json.dumps({
        "workload": name, "card": card, "wall_s": wall,
        "device_kernel_s": dev_us / 1e6 if dev_us else None,
        "busy_share": dev_us / 1e6 / wall if dev_us else None,
        "kernel_launches": int(sum(e.count for e in kernels)) or None,
        "launches_per_unit": (int(sum(e.count for e in kernels)) / units[1]
                              if units else None),
        "unit": units[0] if units else None,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_ms": _device_us(e) / 1e3} for e in top]}))


WORKLOADS = ("sweep", "rounds", "dgd", "dgd-markov", "serve-prefill",
             "serve-decode", "train", "train-optimizer")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated workloads (default: all of "
                         f"{', '.join(WORKLOADS)})")
    only = ap.parse_args(argv).only
    want = set(WORKLOADS if only is None else only.split(","))
    if want - set(WORKLOADS):
        sys.exit(f"profile_port: unknown workloads "
                 f"{sorted(want - set(WORKLOADS))}")
    if not torch.cuda.is_available():
        sys.exit("profile_port: no CUDA device available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    n, r = 16, 4
    specs = [to_spec("cs", cyclic_to_matrix(n, r)),
             to_spec("ss", staircase_to_matrix(n, r)),
             to_spec("ra", random_assignment_to_matrix(n)),
             lb_spec(r), pc_spec(r), pcmm_spec(r)]
    if "sweep" in want:
        window("sweep", lambda: sweep(specs, scenario1(), n, trials=200_000,
                                      chunk=20_000, devices="cuda"), card)
    proc = fig8.cell_process(0.98, 3.0)
    if "rounds" in want:
        window("rounds", lambda: sweep_rounds(
            fig8.specs(), proc, fig8.N, rounds=fig8.ROUNDS, k=fig8.K,
            trials=8000, chunk=fig8.CHUNK, devices="cuda"), card,
            units=("chunk-round", 4 * fig8.ROUNDS))
    if "dgd" in want:
        window("dgd", lambda: dgd.run_paper(RegressionConfig(), 20,
                                            device="cuda"), card)
    if "dgd-markov" in want:
        window("dgd-markov", lambda: dgd.run_paper(
            RegressionConfig(), 20, device="cuda", cluster="markov"), card)
    if want & {"serve-prefill", "serve-decode"}:
        serve_windows(card)
    if want & {"train", "train-optimizer"}:
        train_windows(card, want)


@torch.inference_mode()
def serve_windows(card, batch=2, prompt_len=2048, steps=8):
    cfg = get_config("gemma3-4b")
    model = init_params(cfg, seed=0, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    max_len = prompt_len + 2 * steps + 8
    window("serve-prefill", lambda: forward(
        model, cfg, prompt, cache=init_cache(cfg, batch, max_len)), card)
    _, _, cache = forward(model, cfg, prompt,
                          cache=init_cache(cfg, batch, max_len))
    state = {"cache": cache, "tok": prompt[:, -1:].to(torch.int32)}
    step = make_serve_step(cfg)

    def decode():
        for _ in range(steps):
            state["tok"], state["cache"], _ = step(model, state["cache"],
                                                   state["tok"])

    window("serve-decode", decode, card, units=("decode step", steps))



def train_windows(card, want, steps=2):
    cfg = get_config("gemma3-4b")
    n, r, k = 8, 2, 6
    rc = RoundConfig(n=n, k=k, kind="ss", r=r)
    opt = adamw(cosine_schedule(3e-4, 20, warmup=5))
    state = init_train_state(cfg, opt, seed=0, device="cuda")
    step_fn = make_straggler_train_step(
        cfg, opt, rc, ec2_cluster(n, spread=3.0, persistence=0.95))
    sched = AdaptiveScheduler(rc.to_matrix(), device="cuda")
    part = TaskPartition(n=n, global_batch=16, seq_len=64,
                         vocab=cfg.vocab_size, source="bigram")
    run = {"state": state, "cluster": None}

    def train():
        for _ in range(steps):
            st = run["state"]
            toks, labs = lm_task_batches(part, sched.matrix(), st.step,
                                         device="cuda")
            run["state"], m, run["cluster"] = step_fn(
                st, toks, labs, 0, run["cluster"], sched.row_of_worker())
            sched.observe(m["worker_t1"].cpu().numpy())

    if "train" in want:
        window("train", train, card, units=("train step", steps))
    if "train-optimizer" in want:
        params = run["state"].named_params()
        # the weights stand in for the gradients: the same shapes and
        # dtypes, no extra memory (the values do not change the work)
        scale = torch.ones((), device="cuda")
        window("train-optimizer", lambda: opt.step_(
            params, params, run["state"].opt_state, scale), card)


if __name__ == "__main__":
    main()
