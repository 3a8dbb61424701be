"""The exact width tiling's kernels on the card against their plain
versions, bit for bit: `sgm_tile_scan` (csrc/sgm_tile.cu) on a launch of
every direction with random carries, on each direction alone, on wavefront
steps, on launches with jobs on the same rows in opposite senses (as at
n = 1), on an odd tile whose D-vectors are not whole 16-byte pieces (the
register path), its refusal of vertical jobs, and a step captured in a
CUDA graph and replayed; `sgm_tile_final` (the vertical paths and the
winner-take-all) in both of its modes; and K3's output column window
(csrc/sgm_cost.cu) against the full volume's slice. Marked `cuda`: they
skip without a card. No JAX here, so they run on the card's machine:
`python3 -m pytest --noconftest -q tests/test_torch_sgm_tile_cuda.py`."""

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import plane_stack, sgm_cost_volume
from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import (
    ScanJob,
    sgm_tile_final,
    sgm_tile_final_plain,
    sgm_tile_scan,
    sgm_tile_scan_plain,
)
from torch_helpers import cuda_or_skip

P1, P2 = 72, 288
DIRS = [(0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)]
#: the volumes of the card checks: D in lanes of 1, 2, 4 and 8 elements
SHAPES = [(D, dt) for D in (32, 48, 128, 256) for dt in (torch.int16, torch.int32)]


def _planes(seed, H, W):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (H, W), dtype=np.uint8)
    right = np.roll(left, 4, axis=1)
    return left, right


def _volume(seed, H, W, D, dtype):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 3000, (H, W, D))
                            .astype(np.int16)).to(dtype)


def _strips(seed):
    rng = np.random.default_rng(seed)

    def strip(shape):
        return torch.from_numpy(rng.integers(-200, 2000, shape).astype(np.int32))
    return strip


def _job(strip, dy, dx, row0, rows, W, D):
    return ScanJob(dy, dx, row0, rows, strip((rows + 1, D)), strip((rows + 1, D)),
                   strip((W, D)))


def _wavefront(strip, H, W, D, rb, kf=2, kb=1):
    """A wavefront step of 8 paths: every cross-tile direction on its block
    of rb rows (k = kf from the left, kb from the right), random carries;
    at kf = kb + 1 a block holds jobs of both horizontal senses."""
    jobs = []
    for dy, dx in [(0, 1), (1, 1), (-1, 1), (0, -1), (1, -1), (-1, -1)]:
        k = kf if dx == 1 else kb
        start = H - (k + 1) * rb if dy == -1 else k * rb
        jobs.append(_job(strip, dy, dx, start, rb, W, D))
    return jobs


def _same_on_card(C, jobs, dev, S0=None):
    """One launch of `jobs` on the card against the plain jobs: S, every
    outbox and prev."""
    S = torch.zeros(C.shape, dtype=torch.int32) if S0 is None else S0.clone()
    ref = sgm_tile_scan_plain(C, S, jobs, P1, P2)
    on = lambda t: None if t is None else t.to(dev)  # noqa: E731
    Sc = (torch.zeros(C.shape, dtype=torch.int32) if S0 is None else S0).to(dev)
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
@pytest.mark.parametrize("D,dtype", [(100, torch.int16), (128, torch.int16), (256, torch.int32), (20, torch.int16)])
def test_scan_kernel_matches_plain_on_cuda(D, dtype):
    """Every cross-tile direction in one launch on overlapping rows: all
    six on one block, a diagonal and a horizontal job over rows that meet
    theirs (their atomic adds land on the same pixels)."""
    dev = cuda_or_skip()
    H, W = 40, 37
    C = _volume(5, H, W, D, dtype)
    strip = _strips(6)
    jobs = [_job(strip, 1, 1, 4, 20, W, D), _job(strip, 0, -1, 0, H, W, D)]
    jobs += [_job(strip, dy, dx, 10, 8, W, D) for dy, dx in DIRS]
    _same_on_card(C, jobs, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", SHAPES)
def test_scan_each_direction_on_cuda(D, dtype):
    """Each direction alone over 22 rows of a 37-column tile (diagonals
    that enter from the inbox, from prev, and leave through the edge
    column)."""
    dev = cuda_or_skip()
    H, W = 40, 37
    C = _volume(D, H, W, D, dtype)
    strip = _strips(D + 1)
    for dy, dx in DIRS:
        _same_on_card(C, [_job(strip, dy, dx, 10, 22, W, D)], dev)


@pytest.mark.cuda
def test_scan_refuses_vertical_jobs_and_replays_in_a_graph_on_cuda():
    """The vertical paths are `sgm_tile_final`'s: the scan kernel refuses
    them. A wavefront step captured in a CUDA graph and replayed twice, on
    S reset between the replays, equals the eager call bit for bit (S, the
    outboxes, the prevs): a launch keeps nothing between calls."""
    dev = cuda_or_skip()
    C = _volume(3, 8, 9, 32, torch.int16).to(dev)
    S = torch.zeros(C.shape, dtype=torch.int32, device=dev)
    for dy in (1, -1):
        with pytest.raises(ValueError, match="vertical"):
            sgm_tile_scan(C, S, [ScanJob(0, 1, 0, 8), ScanJob(dy, 0, 0, 8)], P1, P2)
    H, W, D = 48, 37, 128
    C = _volume(11, H, W, D, torch.int16).to(dev)
    on = lambda t: None if t is None else t.to(dev)  # noqa: E731
    jobs = [ScanJob(j.dy, j.dx, j.row0, j.rows, on(j.inbox), on(j.outbox), on(j.prev))
            for j in _wavefront(_strips(12), H, W, D, 12)]
    S0 = torch.from_numpy(np.random.default_rng(2).integers(-5000, 5000, (H, W, D))
                          .astype(np.int32)).to(dev)
    S_eager = S0.clone()
    eager = sgm_tile_scan(C, S_eager, jobs, P1, P2)
    S_graph = S0.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sgm_tile_scan(C, S_graph, jobs, P1, P2)
    for _ in range(2):
        S_graph.copy_(S0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(S_graph, S_eager)
        for (go, gp), (eo, ep) in zip(captured, eager):
            assert torch.equal(go, eo)
            assert (gp is None) == (ep is None)
            if ep is not None:
                assert torch.equal(gp, ep)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [36, 37])
@pytest.mark.parametrize("D,dtype", SHAPES)
def test_scan_wavefront_step_on_cuda(W, D, dtype):
    """A steady wavefront step of 8 paths (k = 2 from the left, 1 from the
    right on 4 blocks of 12 rows): the top-down jobs of one family and the
    bottom-up job of the other add into the same block, at even and odd W;
    S starts nonzero."""
    dev = cuda_or_skip()
    H, rb = 48, 12
    C = _volume(W + D, H, W, D, dtype)
    S0 = torch.from_numpy(np.random.default_rng(1).integers(-5000, 5000, (H, W, D))
                          .astype(np.int32))
    _same_on_card(C, _wavefront(_strips(W), H, W, D, rb), dev, S0)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(0, 0, 0, 0, 30, 30), (15, 15, 15, 15, 15, 15)])
@pytest.mark.parametrize("D,dtype", [(128, torch.int16), (256, torch.int32),
                                     (48, torch.int32), (100, torch.int32),
                                     (7, torch.int16)])
def test_scan_opposite_senses_on_cuda(blocks, D, dtype):
    """Jobs on the same rows in opposite senses, as at n = 1 (the top-down
    families on one block, the bottom-up on another), and all six on one
    block."""
    dev = cuda_or_skip()
    H, W, R = 60, 41, 30
    C = _volume(7, H, W, D, dtype)
    strip = _strips(8)
    jobs = [_job(strip, dy, dx, a, R, W, D) for (dy, dx), a in zip(DIRS, blocks)]
    _same_on_card(C, jobs, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(100, torch.int16), (30, torch.int32), (7, torch.int16)])
def test_odd_tile_register_path_on_cuda(D, dtype):
    """An odd tile (W = 97, 7-row blocks) whose pixels' D-vectors are not
    whole 16-byte pieces, so the register path runs: a wavefront step, each
    diagonal alone, and the final entry in both modes."""
    dev = cuda_or_skip()
    H, W, rb = 28, 97, 7
    C = _volume(D, H, W, D, dtype)
    strip = _strips(D)
    _same_on_card(C, _wavefront(strip, H, W, D, rb), dev)
    for dy, dx in DIRS:
        _same_on_card(C, [_job(strip, dy, dx, 0, H, W, D)], dev)
    for dirs in (((1, 0),), ((1, 0), (-1, 0))):
        _final_on_card(C, dirs, dev)


def _final_on_card(C, dirs, dev, seed=0):
    S0 = torch.from_numpy(np.random.default_rng(seed).integers(0, 40000, C.shape)
                          .astype(np.int32))
    ref = sgm_tile_final_plain(C, S0.clone(), P1, P2, 10, dirs)
    got = sgm_tile_final(C.to(dev), S0.to(dev), P1, P2, 10, dirs)
    torch.cuda.synchronize()
    for g, r, name in zip(got, ref, ("best", "minS", "dval", "uniq")):
        assert torch.equal(g.cpu(), r), name


@pytest.mark.cuda
@pytest.mark.parametrize("H", [40, 41, 1])
@pytest.mark.parametrize("D,dtype", SHAPES)
def test_final_matches_plain_on_cuda(H, D, dtype):
    """The vertical paths and the winner-take-all in one launch, both
    senses meeting in the middle row (even and odd H) and the top-down
    sense alone, against the plain scans and `wta_uniq_subpix`."""
    dev = cuda_or_skip()
    C = _volume(H + D, H, 37, D, dtype)
    for dirs in (((1, 0),), ((1, 0), (-1, 0))):
        _final_on_card(C, dirs, dev, H)


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
