"""The paper's Section VI scenario on the PyTorch port: distributed linear
regression with DGD under straggler scheduling, CS / SS / RA / ADAPT / PC /
PCMM on the EC2-like iid cluster or, with ``--cluster markov``, on a
heterogeneous persistent-straggler cluster.  The uncoded schemes' workers
compute h(X_i) = X_i X_i^T theta with the gram_matvec CUDA kernel; the
ADAPT row re-assigns the CS matrix's rows every iteration from delay
feedback with the greedy_assign CUDA kernel.  Prints per-scheme
loss-vs-wall-clock rows (``curve,<scheme>,<iter>,<wallclock_ms>,<loss>``)
and the final table, as ``examples/linear_regression_dgd.py`` does.

Run:  PYTHONPATH=src python examples_torch/linear_regression_dgd.py
          [--iters 100] [--device cuda|cpu]
          [--cluster markov --persistence 0.95 --spread 3]
"""
import argparse

from repro_torch.configs import regression_config
from repro_torch.dgd import loss_of, paper_problem, run_paper


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; no CPU fallback) or cpu")
    ap.add_argument("--cluster", default="iid", choices=("iid", "markov"))
    ap.add_argument("--persistence", type=float, default=0.95)
    ap.add_argument("--spread", type=float, default=3.0)
    args = ap.parse_args()
    rc = regression_config()
    print(f"paper scenario: N={rc.N} d={rc.d} n={rc.n} r={rc.r} k={rc.k} "
          f"iters={args.iters} cluster={args.cluster} device={args.device}")
    runs = run_paper(rc, args.iters, device=args.device, cluster=args.cluster,
                     persistence=args.persistence, spread=args.spread)
    prob = paper_problem(rc, device=args.device)
    for name, run in runs.items():
        for it, c, loss in run.curve:
            print(f"curve,{name},{it},{c * 1e3:.4f},{loss:.5f}")
    print(f"{'scheme':8s} {'final loss':>12s} {'virtual time':>14s}")
    for name, run in runs.items():
        print(f"{name:8s} {loss_of(run.theta, prob.X, prob.y):12.5f} "
              f"{run.clock * 1e3:11.3f} ms")


if __name__ == "__main__":
    main()
