"""Wall time of the paper's DGD legs on the card: ``dgd.run_paper`` at
``RegressionConfig()`` (CS/SS/RA/ADAPT/PC/PCMM, 100 iterations each, N=900,
d=400, n=15) on the iid and on the Markov cluster, as ``chip_smoke.py``
drives them, after a warm-up leg of each; the legs alternate, iid then
Markov, ``--repeats`` times.  ``--src`` names the tree whose
``repro_torch`` is timed (default: this checkout's ``src``), so that two
trees can be timed in turns on one card.

Run on a machine with a card, from the repository root:

    python3 benchmarks_torch/dgd_legs.py [--src DIR] [--repeats 3]

Prints the card's name and power limit, then one JSON object with the
seconds of every leg and the kernel launches of the last one.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch import dgd
    from repro_torch.configs import RegressionConfig
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        sys.exit("dgd_legs: no CUDA device available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {card}")
    build.build_all()
    cfg = RegressionConfig()
    clusters = ("iid", "markov")
    for cluster in clusters:                    # warm-up: allocator, caches
        dgd.run_paper(cfg, 5, device="cuda", cluster=cluster)
    torch.cuda.synchronize()
    seconds = {cluster: [] for cluster in clusters}
    for _ in range(args.repeats):
        for cluster in clusters:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            dgd.run_paper(cfg, args.iters, device="cuda", cluster=cluster)
            torch.cuda.synchronize()
            seconds[cluster].append(time.perf_counter() - t0)
    print(json.dumps({"src": args.src, "card": card, "iters": args.iters,
                      "seconds": seconds, "launches": dict(ops.LAUNCHES)}))


if __name__ == "__main__":
    main()
