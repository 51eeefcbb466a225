"""Fig. 3 on the PyTorch port: delay-model calibration -- the
truncated-Gaussian model's computation and communication delays per worker;
counterpart of ``benchmarks/fig3_delays.py`` (same rows).  Reports the
moments and the comm/comp ratio the paper observes (communication
dominates)."""
import torch

from repro_torch.core import ec2_like
from repro_torch.device import resolve_device

from .common import Timer, emit


def run(trials: int = 20000, device=None):
    n = 3
    model = ec2_like(n, seed=0, comm_over_comp=5.0)
    tids = torch.arange(trials, device=resolve_device(device))
    with Timer() as t:
        T1, T2 = model.sample(0, tids, n, 1)
        T1, T2 = T1.cpu().numpy(), T2.cpu().numpy()
    for i in range(n):
        emit(f"fig3/worker{i+1}", t.us / n,
             f"comp_mean={T1[:, i].mean():.2e};comm_mean={T2[:, i].mean():.2e};"
             f"comm_over_comp={T2[:, i].mean() / T1[:, i].mean():.2f}")
    ratio = T2.mean() / T1.mean()
    emit("fig3/summary", t.us, f"comm_dominates={ratio > 2.0};ratio={ratio:.2f}")
    return ratio
