"""The greedy_assign kernel's routes and shared-memory arithmetic
(``ops.greedy_route``, ``ops.greedy_smem``), checked on the CPU against the
constants of ``csrc/greedy_assign.cu``: n <= 128 takes the warp route (W in
shared memory), n up to 8192 the wide route (one block a trial, W through
L2).  tests/test_torch_card.py holds ``greedy_smem`` to the kernel's own
count (``greedy_assign_smem``) on the card."""
import re

import pytest

from repro_torch.kernels import build, ops
from torch_parity import one_thread  # noqa: F401

SRC = (build.CSRC / "greedy_assign.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])


def test_constants_mirror_the_source():
    assert ops.GREEDY_WARP_MAX_N == _const("kMaxN") == 128
    assert ops.GREEDY_MAX_N == _const("kWideMaxN")
    assert ops.GREEDY_CAP == _const("kCap")
    assert ops.GREEDY_WIDE_WARPS == _const("kWideWarps")
    assert ops.GREEDY_TILE_STRIDE == _const("kTileStride")
    assert ops.GREEDY_MAX_N >= 1024


@pytest.mark.parametrize("n,route", [(1, "warp_smem"), (32, "warp_smem"),
                                     (33, "warp_smem"), (128, "warp_smem"),
                                     (129, "wide"), (200, "wide"),
                                     (238, "wide"), (257, "wide"),
                                     (8192, "wide")])
def test_route(n, route):
    assert ops.greedy_route(n) == route


@pytest.mark.parametrize("n", [0, -1, 8193])
def test_route_refuses_n_out_of_range(n):
    with pytest.raises(ValueError):
        ops.greedy_route(n)


@pytest.mark.parametrize("n,want", [
    (1, (1 * 1 + 2 * 16 * 1 + 1) * 4),          # W, then the lists
    (12, (12 * 13 + 2 * 16 * 12 + 12) * 4),
    (32, (32 * 33 + 2 * 16 * 32 + 32) * 4),
    (33, 33 * 33 * 4),                           # odd n: stride n
    (128, 128 * 129 * 4),
    (129, 256 + 5 * 32 * 33 * 4 + 129 * 18),     # 5 warps, 18 B a task
    (200, 256 + 7 * 32 * 33 * 4 + 200 * 18),
    (257, 256 + 9 * 32 * 33 * 4 + 257 * 18),
    (8192, 256 + 16 * 32 * 33 * 4 + 8192 * 18)])
def test_smem(n, want):
    assert ops.greedy_smem(n) == want


def test_smem_fits_an_h100_block_on_every_n():
    """Every n the wrapper takes fits the 227 KB (232 448 bytes) a block
    may opt into, while W alone at the warp route's stride passes it from
    n = 242: the warp route could not reach far past 128, so the wide route
    reads W through L2."""
    limit = 232448
    assert max(ops.greedy_smem(n) for n in range(1, ops.GREEDY_MAX_N + 1,
                                                 7)) <= limit
    assert ops.greedy_smem(ops.GREEDY_MAX_N) <= limit
    assert 241 * (241 | 1) * 4 <= limit < 242 * (242 | 1) * 4

