"""Table I on the PyTorch port: one DGD iteration of the linear-regression
scenario (N = 240, d = 60, n = 6, r = 2) per scheme, executed for real
(data encoded, workers' h() computed, the master decodes where
applicable); counterpart of ``benchmarks/table1_e2e.py`` (same rows and
bounds).  Every scheme's parameter update must equal the exact
full-gradient update it should equal at k = n: uncoded CS through
``ops.batched_gram_matvec`` (the one-pass gram_matvec kernel on the card,
one launch at (6, 60, 40) float32), max error 1e-4; PC 1e-4; PCMM 1e-2,
with the PC/PCMM decodes timed.  The arithmetic is ``dgd.table1_check``'s,
with the legs timed one by one."""
import time

import numpy as np
import torch

from repro_torch import dgd
from repro_torch.configs import RegressionConfig
from repro_torch.core import (pc_decode, pc_encode, pc_threshold,
                              pc_worker_compute, pcmm_decode, pcmm_encode,
                              pcmm_threshold, pcmm_worker_compute)
from repro_torch.kernels.ops import batched_gram_matvec

from .common import Timer, emit

#: the scenario's sizes and the bounds on each scheme's update error
CFG = RegressionConfig(N=240, d=60, n=6, r=2, k=6)
BOUNDS = {"cs_uncoded": 1e-4, "pc": 1e-4, "pcmm": 1e-2}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device=None):
    prob = dgd.paper_problem(CFG, device=device)
    dev, n, N, r = prob.X.device, prob.n, prob.N, CFG.r
    d = prob.Xs_cols.shape[1]
    theta = torch.as_tensor(np.random.default_rng(7).standard_normal(d)
                            * 0.1, device=dev)
    eta = 0.01
    Xf = prob.X.to(torch.float64)
    Xty = Xf.T @ prob.y.to(torch.float64)
    want = theta - eta * 2 / N * (Xf.T @ (Xf @ theta) - Xty)

    def err(xxt):
        return float((theta - eta * 2 / N * (xxt - Xty) - want).abs().max())

    errs = {}
    # --- uncoded CS (k = n) via the gram_matvec kernel ---------------------
    with Timer() as t:
        hs = batched_gram_matvec(prob.Xs_cols, theta.to(torch.float32))
        errs["cs_uncoded"] = err(hs.sum(dim=0).to(torch.float64))
    e = errs["cs_uncoded"]
    emit("table1/cs_uncoded", t.us,
         f"update_err={e:.2e};ok={e < BOUNDS['cs_uncoded']}")

    # --- PC ----------------------------------------------------------------
    with Timer() as t:
        Xt, alphas, _ = pc_encode(prob.Xs_cols, r)
        res = pc_worker_compute(Xt, theta)
        kth = pc_threshold(n, r)
        _sync(dev)
        dec0 = time.perf_counter()
        xxtheta = pc_decode(res[:kth], alphas[:kth], n, r)
        _sync(dev)
        dec_us = (time.perf_counter() - dec0) * 1e6
        errs["pc"] = err(xxtheta)
    e = errs["pc"]
    emit("table1/pc", t.us,
         f"update_err={e:.2e};ok={e < BOUNDS['pc']};decode_us={dec_us:.0f}")

    # --- PCMM --------------------------------------------------------------
    with Timer() as t:
        Xh, betas = pcmm_encode(prob.Xs_cols, r)
        res = pcmm_worker_compute(Xh.reshape(n * r, d, -1), theta)
        need = pcmm_threshold(n)
        _sync(dev)
        dec0 = time.perf_counter()
        xxtheta = pcmm_decode(res[:need], betas.reshape(-1)[:need], n)
        _sync(dev)
        dec_us = (time.perf_counter() - dec0) * 1e6
        errs["pcmm"] = err(xxtheta)
    e = errs["pcmm"]
    emit("table1/pcmm", t.us,
         f"update_err={e:.2e};ok={e < BOUNDS['pcmm']};decode_us={dec_us:.0f}")
    return errs
