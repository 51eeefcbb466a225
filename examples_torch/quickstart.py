"""Quickstart on the PyTorch port: the paper's scheduling core in a minute
(counterpart of ``examples/quickstart.py``).

Builds CS/SS/RA TO matrices, simulates completion times under the paper's
truncated-Gaussian delay model, compares against the oracle lower bound,
and runs one straggler-scheduled SGD round of a tiny LM.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
          [--trials 8000]
"""
import argparse

from repro_torch.core import (RoundConfig, adaptive_spec, cyclic_to_matrix,
                              ec2_cluster, lb_spec, mean_completion_time,
                              random_assignment_to_matrix, scenario1,
                              simulate_lower_bound, staircase_to_matrix,
                              sweep, sweep_rounds, to_spec)
from repro_torch.data import TaskPartition, lm_task_batches
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import init_train_state, make_straggler_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--trials", type=int, default=8000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    trials = args.trials

    n, r, k = 8, 3, 6
    model = scenario1()
    print(f"== completion times (n={n}, r={r}, k={k}) on {dev} ==")
    print("CS TO matrix:\n", cyclic_to_matrix(n, r))
    print("SS TO matrix:\n", staircase_to_matrix(n, r))
    for name, C in (("CS", cyclic_to_matrix(n, r)),
                    ("SS", staircase_to_matrix(n, r)),
                    ("RA", random_assignment_to_matrix(n, seed=0))):
        t = mean_completion_time(C, model, k, trials=trials, devices=dev)
        print(f"  {name}: {t * 1e3:.4f} ms")
    lb = float(simulate_lower_bound(model, n, r, k, trials=trials,
                                    devices=dev).double().mean())
    print(f"  LB: {lb * 1e3:.4f} ms  (oracle, eq. 46)")

    print(f"\n== message budget (paper Sec. V-C, SS, n={n}, r={r}, k={k}) ==")
    ss = staircase_to_matrix(n, r)
    res = sweep([to_spec(f"ss_m{m}", ss, messages=m) for m in (1, 2, r)],
                model, n, trials=trials, ks=k, devices=dev)
    for m in (1, 2, r):
        label = {1: "one-shot", r: "per-slot (default)"}.get(m, "grouped")
        print(f"  m={m}: {res.at_k(f'ss_m{m}', k) * 1e3:.4f} ms  ({label})")

    print(f"\n== ragged per-worker loads (n={n}, budget {r}/worker) ==")
    # slow workers carry fewer tasks, fast ones more — same total budget
    loads = (5, 1, 3, 5, 1, 3, 5, 1)
    ragged = staircase_to_matrix(n, loads=loads)    # trailing slots MASKED
    res = sweep([to_spec("ss_ragged", ragged), lb_spec(loads=loads)],
                model, n, trials=trials, ks=k, devices=dev)
    print(f"  static ragged SS:  {res.at_k('ss_ragged', k) * 1e3:.4f} ms  "
          f"(loads {loads})")
    print(f"  ragged oracle LB:  {res.at_k('lb', k) * 1e3:.4f} ms")
    # adaptive re-balancing learns that allocation from censored feedback:
    # dense CS grid of width 5 = load cap, 3 slots/worker initial budget
    proc = ec2_cluster(n, spread=3.0, persistence=0.95, slow=8.0)
    rres = sweep_rounds(
        [adaptive_spec("perm", cyclic_to_matrix(n, r)),
         adaptive_spec("rebal", cyclic_to_matrix(n, 5), loads=(r,) * n,
                       rebalance=True)],
        proc, n, rounds=12, k=k, trials=max(trials // 4, 1),
        censored_feedback=True, devices=dev)
    print(f"  heterogeneous cluster, permutation-only adaptation: "
          f"{rres.mean_round('perm') * 1e3:.4f} ms/round")
    print(f"  ... + load re-balancing (same budget):              "
          f"{rres.mean_round('rebal') * 1e3:.4f} ms/round")

    print("\n== one straggler-scheduled SGD round (tiny LM) ==")
    cfg = ModelConfig(name="tiny", arch_type="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                      param_dtype="float32", dtype="float32", remat=False)
    opt = adamw(1e-3)
    state = init_train_state(cfg, opt, seed=0, device=dev)
    rc = RoundConfig(n=n, k=k, kind="ss", r=r)
    part = TaskPartition(n=n, global_batch=n, seq_len=32, vocab=256,
                         source="bigram")
    step = make_straggler_train_step(cfg, opt, rc, model)
    toks, labs = lm_task_batches(part, rc.to_matrix(), 0, device=dev)
    state, m, _ = step(state, toks, labs, 1)
    print(f"  loss={float(m['loss']):.3f}  "
          f"completion={float(m['completion_time']) * 1e3:.4f} ms  "
          f"winners={int(m['winners'])}/{n} tasks")
    return m


if __name__ == "__main__":
    main()
