"""The port's counter-based generator: its bits against a small numpy
Philox-4x32-10 written here, and the chunk invariance of per-trial samples
through the engine."""
import numpy as np
import pytest
import torch

from repro_torch.core import montecarlo as tmc
from repro_torch.core import rng
from repro_torch.core import scheduling as ts
from repro_torch.core.delays import (BimodalStragglerDelays,
                                     ShiftedExponentialDelays,
                                     TruncatedGaussianDelays, scenario1)
from torch_parity import one_thread  # noqa: F401

M32 = np.uint64(0xFFFFFFFF)


def philox_np(ctr, key):
    """Philox-4x32-10 in numpy uint64 (reference for the torch version)."""
    c = [np.uint64(v) for v in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for rnd in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        hi0, lo0 = p0 >> np.uint64(32), p0 & M32
        hi1, lo1 = p1 >> np.uint64(32), p1 & M32
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        if rnd < 9:
            k0 = (k0 + np.uint64(0x9E3779B9)) & M32
            k1 = (k1 + np.uint64(0xBB67AE85)) & M32
    return [int(v) for v in c]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_philox_known_answers(ctr, key, want):
    """Random123's published Philox-4x32-10 test vectors."""
    words = rng.philox4x32(*[torch.tensor([v]) for v in ctr], *key)
    assert tuple(int(w) for w in words) == want
    assert tuple(philox_np(ctr, key)) == want


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 40 + 3])
@pytest.mark.parametrize("stream", [0, 3])
@pytest.mark.parametrize("count", [1, 4, 7, 10])
def test_bits_match_numpy_reference(seed, stream, count):
    tids = np.array([0, 1, 5, 999, 2 ** 32 + 7])
    got = rng.random_bits(seed, torch.as_tensor(tids), stream, count).numpy()
    for row, t in zip(got, tids):
        want = []
        for blk in range(-(-count // 4)):
            want += philox_np((blk, t & 0xFFFFFFFF, stream, t >> 32),
                              (seed & 0xFFFFFFFF, seed >> 32))
        assert row.tolist() == want[:count]


def test_uniform_range_and_bits():
    u = rng.uniform(3, torch.arange(2000), 1, (4, 5))
    assert u.shape == (2000, 4, 5) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    bits = rng.random_bits(3, torch.arange(2000), 1, 20)
    want = (bits >> 8).to(torch.float32) * 2.0 ** -24
    assert torch.equal(u.reshape(2000, 20), want)


@pytest.mark.parametrize("model", [
    scenario1(), TruncatedGaussianDelays(rho=0.4),
    ShiftedExponentialDelays(), BimodalStragglerDelays()])
def test_per_trial_samples_depend_only_on_trial_id(model):
    tids = torch.arange(40)
    T1, T2 = model.sample(5, tids, 6, 3)
    sub = torch.tensor([3, 17, 39, 0])
    S1, S2 = model.sample(5, sub, 6, 3)
    assert torch.equal(S1, T1[sub]) and torch.equal(S2, T2[sub])
    O1, _ = model.sample(6, tids, 6, 3)
    assert not torch.equal(O1, T1)          # the seed matters


SPECS = {
    "to": lambda n: tmc.to_spec("cs", ts.cyclic_to_matrix(n, 3)),
    "lb": lambda n: tmc.lb_spec(3),
    "pc": lambda n: tmc.pc_spec(3),
    "pcmm": lambda n: tmc.pcmm_spec(3, messages=2),
    "ragged": lambda n: tmc.to_spec("rg", ts.staircase_to_matrix(n, 3),
                                    loads=[3, 1, 2, 3, 2, 1]),
}


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("k", [None, 4])
def test_samples_chunk_invariant(kind, k):
    """Per-trial samples are identical for chunk = trials, 7 and 1."""
    n, trials = 6, 30
    spec = SPECS[kind](n)
    runs = [tmc.completion_samples(spec, scenario1(), n, trials=trials,
                                   seed=11, chunk=c, k=k, devices="cpu")
            for c in (trials, 7, 1)]
    assert runs[0].shape[0] == trials
    for other in runs[1:]:
        assert torch.equal(other, runs[0])


def test_sweep_chunked_means_agree():
    n = 6
    specs = [SPECS[k](n) for k in ("to", "lb", "pc")]
    a = tmc.sweep(specs, scenario1(), n, trials=64, chunk=64, devices="cpu")
    b = tmc.sweep(specs, scenario1(), n, trials=64, chunk=5, devices="cpu")
    for name in a.means:
        np.testing.assert_allclose(b.means[name], a.means[name], rtol=1e-6)
