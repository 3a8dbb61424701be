"""The exact width tiling's kernels on the card against their plain
versions, bit for bit: `sgm_tile_scan` (csrc/sgm_tile.cu) on a launch of
every direction with random carries, and K3's output column window
(csrc/sgm_cost.cu) against the full volume's slice. Marked `cuda`: they
skip without a card. No JAX here, so they run on the card's machine:
`python3 -m pytest --noconftest -q tests/test_torch_sgm_tile_cuda.py`."""

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import plane_stack, sgm_cost_volume
from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import (
    ScanJob,
    sgm_tile_scan,
    sgm_tile_scan_plain,
)
from torch_helpers import cuda_or_skip

P1, P2 = 72, 288
DIRS = [(0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)]


def _planes(seed, H, W):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (H, W), dtype=np.uint8)
    right = np.roll(left, 4, axis=1)
    return left, right


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(100, torch.int16), (128, torch.int16), (256, torch.int32), (20, torch.int16)])
def test_scan_kernel_matches_plain_on_cuda(D, dtype):
    dev = cuda_or_skip()
    H, W = 40, 37
    C = torch.from_numpy(np.random.default_rng(5).integers(0, 3000, (H, W, D))
                         .astype(np.int16)).to(dtype)
    rng = np.random.default_rng(6)

    def strip(shape):
        return torch.from_numpy(rng.integers(-200, 2000, shape).astype(np.int32))

    jobs = [ScanJob(1, 0, 0, H), ScanJob(-1, 0, 0, H)]
    jobs += [ScanJob(dy, dx, 10, 8, strip((9, D)), strip((9, D)), strip((W, D)))
             for dy, dx in DIRS]
    S = torch.zeros((H, W, D), dtype=torch.int32)
    ref = sgm_tile_scan_plain(C, S, jobs, P1, P2)
    on = lambda t: None if t is None else t.to(dev)  # noqa: E731
    Sc = torch.zeros((H, W, D), dtype=torch.int32, device=dev)
    got = sgm_tile_scan(C.to(dev), Sc, [ScanJob(j.dy, j.dx, j.row0, j.rows,
                                                on(j.inbox), on(j.outbox), on(j.prev))
                                        for j in jobs], P1, P2)
    torch.cuda.synchronize()
    assert torch.equal(Sc.cpu(), S)
    for (go, gp), (ro, rp) in zip(got, ref):
        assert (go is None) == (ro is None) and (gp is None) == (rp is None)
        if ro is not None:
            assert torch.equal(go.cpu(), ro)
        if rp is not None:
            assert torch.equal(gp.cpu(), rp)


@pytest.mark.cuda
def test_cost_window_kernel_matches_slice_on_cuda():
    dev = cuda_or_skip()
    left, right = _planes(11, 70, 300)
    lpl = plane_stack(torch.from_numpy(left).to(dev), 0)
    rpl = plane_stack(torch.from_numpy(right).to(dev), 0)
    C, _, W1 = sgm_cost_volume(lpl, rpl, 64, 5, torch.int16)
    for x_begin, width in [(0, 59), (59, 59), (118, 118), (7, 1), (W1 - 3, 3)]:
        Cw = sgm_cost_volume(lpl, rpl, 64, 5, torch.int16, cols=(x_begin, width))[0]
        assert torch.equal(Cw, C[:, x_begin: x_begin + width])
