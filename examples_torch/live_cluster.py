"""Running a live cluster on the PyTorch port: real async master-worker
rounds end-to-end (counterpart of ``examples/live_cluster.py``).

Builds one canonical ``RoundConfig``, round-trips it through JSON (the
same document the live master/worker handshake ships, readable by either
package), then:

1. runs a 4-worker in-process live cluster to ``k`` distinct results per
   round (``run_live``);
2. shows the run's recorded delay trace replaying BIT-EXACTLY through the
   Monte Carlo engine (``sweep_rounds`` over ``TraceProcess``) — the live
   layer and the simulator are the same arithmetic;
3. re-runs with a deadline under ``close_partial`` to show partial rounds
   and miss accounting;
4. demonstrates the same run over the TCP transport (ephemeral port).

Run:  PYTHONPATH=src python examples_torch/live_cluster.py
          [--device cuda|cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (RoundConfig, TraceProcess, ec2_cluster,
                              sweep_rounds)
from repro_torch.device import resolve_device
from repro_torch.live import run_live

ROUNDS = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; no CPU fallback) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = RoundConfig(n=4, k=3, kind="cs", r=2, seed=42)
    cfg = RoundConfig.from_json(cfg.to_json())       # JSON round-trip
    print(f"config: {cfg.kind} n={cfg.n} k={cfg.k} r={cfg.width} "
          f"seed={cfg.seed} device={dev}")

    process = ec2_cluster(cfg.n, spread=3.0, persistence=0.9, seed=1)

    # 1. live in-process cluster ------------------------------------------
    res = run_live(cfg, process, ROUNDS, device=dev)
    print(f"\nlive:   mean={res.mean:.5f}  per_round[:4]="
          f"{np.round(res.per_round[:4], 5)}")

    # 2. the recorded trace replays bit-exactly through the MC engine -----
    spec = cfg.to_scheme_spec("live")
    replay = sweep_rounds([spec], TraceProcess(res.trace), cfg.n,
                          rounds=ROUNDS, trials=1, k=cfg.k, seed=cfg.seed,
                          devices=dev)
    rp = replay.per_round["live"]
    if not np.array_equal(res.per_round.astype(np.float32),
                          rp.astype(np.float32)):
        raise SystemExit("replay mismatch")
    print(f"replay: mean={float(rp.mean()):.5f}  (bit-exact: True)")

    # ... and matches the engine run on the process directly (same seed)
    direct = sweep_rounds([spec], process, cfg.n, rounds=ROUNDS, trials=1,
                          k=cfg.k, seed=cfg.seed, devices=dev)
    print(f"MC:     mean={float(direct.per_round['live'].mean()):.5f}  "
          f"(same shared-seed realization)")

    # 3. deadline rounds: close partial, count misses ---------------------
    dl = float(np.quantile(res.per_round, 0.5))
    cfg_dl = RoundConfig(n=4, k=3, kind="cs", r=2, seed=42, deadline=dl,
                         deadline_policy="close_partial")
    res_dl = run_live(cfg_dl, process, ROUNDS, device=dev)
    print(f"\ndeadline={dl:.5f} close_partial: "
          f"missed {int(res_dl.missed.sum())}/{ROUNDS} rounds, "
          f"mean realized k = {res_dl.realized.mean():.2f} "
          f"(target {cfg_dl.k})")

    # 4. the same run over TCP (ephemeral port) ---------------------------
    res_tcp = run_live(cfg, process, ROUNDS, address="tcp://127.0.0.1:0",
                       device=dev)
    if not np.array_equal(res_tcp.per_round, res.per_round):
        raise SystemExit("tcp run differs from inproc")
    print(f"\ntcp:    mean={res_tcp.mean:.5f}  (identical to inproc: True)")


if __name__ == "__main__":
    main()
