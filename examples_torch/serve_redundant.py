"""The first-k-distinct selection rule applied to serving, on the PyTorch
port: redundant speculative dispatch of decode requests (counterpart of
``examples/serve_redundant.py``).

A batch of requests is replicated r times across n model replicas with a
CS TO matrix; each replica serves its requests in order; a request
completes when its first copy finishes.  That is the paper's
completion-time machinery with tasks = requests (eq. 6 with k = n).
Replica latency follows the bimodal straggler model; the example reports
p50/p99 request latency for r = 1, 2, 3, then decodes the requests with a
tiny LM to show the plumbing end to end.

Run:  PYTHONPATH=src python examples_torch/serve_redundant.py
          [--device cuda|cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (BimodalStragglerDelays, RoundConfig, scenario1,
                              slot_arrival_times, task_arrival_times)
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, init_cache, init_params
from repro_torch.train import make_serve_step


def dispatch_matrix(n: int, r: int) -> np.ndarray:
    """Redundant dispatch as one ``RoundConfig`` round: tasks = requests,
    k = n (every request must finish), redundancy = load r."""
    return RoundConfig(n=n, k=n, kind="cs", r=r).to_matrix()


def tail_latency(C, model, device, trials=4000, seed=0):
    n, r = C.shape
    tids = torch.arange(trials, device=device)
    T1, T2 = model.sample(seed, tids, n, r)
    tau = task_arrival_times(C, slot_arrival_times(T1, T2), n)
    tau = tau.double().cpu().numpy()                       # per request
    return np.percentile(tau, 50), np.percentile(tau, 99)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; no CPU fallback) or cpu")
    dev = resolve_device(ap.parse_args().device)
    n = 16
    model = BimodalStragglerDelays(base=scenario1(), p_straggle=0.25,
                                   slow=10.0)
    for r in (1, 2, 3):
        p50, p99 = tail_latency(dispatch_matrix(n, r), model, dev)
        print(f"r={r}: request p50={p50 * 1e3:.3f} ms   "
              f"p99={p99 * 1e3:.3f} ms")
    p50_1, p99_1 = tail_latency(dispatch_matrix(n, 1), model, dev)
    p50_2, p99_2 = tail_latency(dispatch_matrix(n, 2), model, dev)
    print(f"\nredundancy r=2 cuts p99 by "
          f"{100 * (p99_1 - p99_2) / p99_1:.1f}% "
          f"(p50 by {100 * (p50_1 - p50_2) / p50_1:.1f}%)")

    # end to end: decode the 16 requests with a tiny LM
    cfg = ModelConfig(name="tiny-serve", arch_type="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=256, param_dtype="float32",
                      dtype="float32", remat=False)
    lm = init_params(cfg, seed=0, device=dev)
    serve = make_serve_step(cfg)
    cache = init_cache(cfg, n, 32, device=dev)
    tok = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for _ in range(8):
            tok, cache, _ = serve(lm, cache, tok)
    print(f"decoded final tokens for {n} requests:",
          tok.cpu().numpy().ravel()[:8], "...")


if __name__ == "__main__":
    main()
