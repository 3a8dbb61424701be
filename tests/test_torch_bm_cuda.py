"""K8 and K6 on the card: the BM cost + winner-take-all kernel
(`csrc/bm_kernel.cu`) and the LR resolve kernel's three entries (the
general one, the SGBM check and the BM check) against their plain
versions, bit for bit on every output; K8 and both checks also at
min_disparity != 0. The tests need a CUDA device and
skip without one; the file imports no JAX, so it also runs on a machine with
the card (whose Python has no JAX, hence no conftest):

    python -m pytest --noconftest tests/test_torch_bm_cuda.py -q -p no:randomly
"""

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_cost_wta, bm_cost_wta_plain
from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import (
    lr_resolve,
    lr_resolve_bm,
    lr_resolve_bm_plain,
    lr_resolve_plain,
    lr_resolve_sgbm,
    lr_resolve_sgbm_plain,
)
from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter
from torch_helpers import cuda_or_skip, stereo_pair, t

#: (H, W, D, bs, inputs): full-range random bytes over every D and block
#: size on a ragged frame (D = 288 and 384: 12 d a lane, a 9-bit key);
#: prefiltered stereo pairs; W < D; H < bs; and a view that starts one row
#: into its tensor (rows not on 16 bytes)
CASES = (
    [(97, 301, D, bs, "random") for D in (1, 16, 100, 128, 192, 256, 288, 384)
     for bs in (1, 5, 13, 21)]
    + [(40, 200, 32, 13, "prefiltered"), (120, 400, 128, 13, "prefiltered"),
       (50, 64, 100, 13, "random"), (50, 64, 100, 5, "prefiltered"),
       (5, 200, 64, 13, "random"), (3, 90, 16, 21, "random"),
       (1, 33, 8, 5, "random"), (97, 301, 128, 13, "view"),
       (60, 500, 288, 13, "prefiltered"), (97, 301, 384, 13, "view")]
)


def _inputs(seed, H, W, kind, dev):
    if kind == "prefiltered":
        left, right = stereo_pair(seed, H, W, 9)
        return (xsobel_prefilter(t(left), 31).to(dev),
                xsobel_prefilter(t(right), 31).to(dev))
    rng = np.random.default_rng(seed)
    if kind == "view":
        return tuple(t(rng.integers(0, 256, size=(H + 1, W), dtype=np.uint8),
                       dev)[1:] for _ in range(2))
    return tuple(t(rng.integers(0, 256, size=(H, W), dtype=np.uint8), dev)
                 for _ in range(2))


def _lr_inputs(seed, H, W, D):
    rng = np.random.default_rng(seed)
    d_match = rng.integers(-1, D + 2, size=(H, W)).astype(np.int32)
    key = rng.integers(0, 2**20, size=(H, W)).astype(np.int32) * 8192 \
        + rng.integers(0, 8192, size=(H, W)).astype(np.int32)
    key = np.where(rng.random((H, W)) < 0.1, 2**31 - 1, key).astype(np.int32)
    return d_match, key


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D,bs,kind", CASES)
def test_bm_kernel_matches_plain_on_cuda(H, W, D, bs, kind):
    dev = cuda_or_skip()
    lp, rp = _inputs(H * W + D + bs, H, W, kind, dev)
    if kind == "view":
        assert lp.is_contiguous() and lp.data_ptr() % 16 != 0
    before = bm_cost_wta.launches
    got = bm_cost_wta(lp, rp, D, bs)
    assert bm_cost_wta.launches == before + 1
    ref = bm_cost_wta_plain(lp, rp, D, bs)
    names = ("best_d", "best_cost", "c_m1", "c_p1", "min_outside")
    for name, g, r in zip(names, got, ref):
        assert g.dtype == r.dtype == torch.int32, name
        assert torch.equal(g, r), (name, int((g != r).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D", [(40, 200, 32), (97, 301, 128)])
def test_lr_kernel_matches_plain_on_cuda(H, W, D):
    dev = cuda_or_skip()
    d_match, key = _lr_inputs(5, H, W, D)
    kw = dict(n_w=D + 1, r_lo=0, n_r=D + 1, Dpow=8192, c0=-2048, invalid=-16)
    dm, k = t(d_match, dev), t(key, dev)
    for g, r in zip(lr_resolve(dm, k, (dm,), **kw),
                    lr_resolve_plain(dm, k, (dm,), **kw)):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D", [(40, 200, 32), (97, 301, 128)])
def test_lr_kernel_two_planes_match_plain_on_cuda(H, W, D):
    dev = cuda_or_skip()
    d_match, key = _lr_inputs(6, H, W, D)
    rm2 = np.clip(d_match + 1, -3, D + 3).astype(np.int32)
    kw = dict(n_w=D - 3, r_lo=-2, n_r=D - 5, Dpow=4096, c0=-5, invalid=-7)
    dm, k, r2 = t(d_match, dev), t(key, dev), t(rm2, dev)
    for g, r in zip(lr_resolve(dm, k, (dm, r2), **kw),
                    lr_resolve_plain(dm, k, (dm, r2), **kw)):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D", [(24, 184, 64), (45, 300, 128), (9, 1920, 256),
                                   (3, 3840, 128), (5, 130, 128)])
def test_lr_check_sgbm_kernel_matches_plain_on_cuda(H, W, D):
    dev = cuda_or_skip()
    rng = np.random.default_rng(H * W + D)
    W1 = W - D
    best = t(rng.integers(0, D, size=(H, W1)).astype(np.int32), dev)
    minS = t(rng.integers(-2000, 60000, size=(H, W1)).astype(np.int32), dev)
    dval = best.cpu().numpy() * 16 + rng.integers(-8, 9, size=(H, W1))
    dval[rng.random((H, W1)) < 0.15] = -16
    disp = np.full((H, W), -16, np.int16)
    disp[:, D:] = dval
    disp = t(disp, dev)
    for max_diff in (0, 1, 3):
        before = lr_resolve_sgbm.launches
        got = lr_resolve_sgbm(disp, best, minS, D, W1, D, max_diff)
        assert lr_resolve_sgbm.launches == before + 1
        assert torch.equal(got, lr_resolve_sgbm_plain(disp, best, minS, D, W1, D,
                                                      max_diff))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D", [(40, 200, 32), (97, 301, 128), (9, 1920, 288),
                                   (5, 700, 384)])
def test_lr_check_bm_kernel_matches_plain_on_cuda(H, W, D):
    dev = cuda_or_skip()
    rng = np.random.default_rng(H * W + D)
    disp = rng.integers(-16, D * 16, size=(H, W)).astype(np.int16)
    disp[rng.random((H, W)) < 0.2] = -16
    cost = t(rng.integers(0, 60000, size=(H, W)).astype(np.int32), dev)
    disp = t(disp, dev)
    for max_diff in (0, 1, 3):
        before = lr_resolve_bm.launches
        got = lr_resolve_bm(disp, cost, D, max_diff)
        assert lr_resolve_bm.launches == before + 1
        assert torch.equal(got, lr_resolve_bm_plain(disp, cost, D, max_diff))


#: (H, W, D, bs, inputs, min_disparity): K8 at -(D - 1), -8 and +8 on random
#: bytes (D = 288: 12 d a lane), the WLS right matcher's -127 on a
#: prefiltered pair swapped (its disparities negative), and a range that
#: meets no column of a narrow image
MIN_DISP_CASES = (
    [(97, 301, D, 13, "random", m) for D in (16, 128, 288)
     for m in (-(D - 1), -8, 8)]
    + [(120, 400, 128, 13, "swapped", -127), (97, 301, 128, 5, "view", -127),
       (50, 64, 100, 5, "random", -99), (40, 90, 16, 21, "random", -300)])


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D,bs,kind,min_disp", MIN_DISP_CASES)
def test_bm_kernel_min_disparity_matches_plain_on_cuda(H, W, D, bs, kind, min_disp):
    """At minD < 0 the right border x - dd >= W falls inside the frame: the
    kernel's vertical slide must drop those d, not take |L - 0|."""
    dev = cuda_or_skip()
    if kind == "swapped":
        rp, lp = _inputs(H + W, H, W, "prefiltered", dev)
    else:
        lp, rp = _inputs(H * W + D + bs - min_disp, H, W, kind, dev)
    before = bm_cost_wta.launches
    got = bm_cost_wta(lp, rp, D, bs, min_disp)
    assert bm_cost_wta.launches == before + 1
    ref = bm_cost_wta_plain(lp, rp, D, bs, min_disp)
    names = ("best_d", "best_cost", "c_m1", "c_p1", "min_outside")
    for name, g, r in zip(names, got, ref):
        assert torch.equal(g, r), (name, int((g != r).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D,min_disp", [(24, 184, 64, -63), (45, 300, 128, -8),
                                            (45, 300, 128, 8), (9, 1920, 128, -127),
                                            (5, 400, 128, 16)])
def test_lr_check_sgbm_kernel_min_disparity_matches_plain_on_cuda(H, W, D, min_disp):
    dev = cuda_or_skip()
    rng = np.random.default_rng(H * W + D - min_disp)
    minX1 = max(min_disp + D, 0)
    W1 = W + min(min_disp, 0) - minX1
    invalid = (min_disp - 1) * 16
    best = t(rng.integers(0, D, size=(H, W1)).astype(np.int32), dev)
    minS = t(rng.integers(-2000, 60000, size=(H, W1)).astype(np.int32), dev)
    dval = (best.cpu().numpy() + min_disp) * 16 + rng.integers(-8, 9, size=(H, W1))
    dval[rng.random((H, W1)) < 0.15] = invalid
    disp = np.full((H, W), invalid, np.int16)
    disp[:, minX1: minX1 + W1] = dval
    disp = t(disp, dev)
    for max_diff in (0, 1, 3):
        got = lr_resolve_sgbm(disp, best, minS, minX1, W1, D, max_diff, min_disp)
        ref = lr_resolve_sgbm_plain(disp, best, minS, minX1, W1, D, max_diff, min_disp)
        assert torch.equal(got, ref)
        assert not torch.equal(got, disp)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D,min_disp", [(40, 200, 32, -31), (97, 301, 128, -127),
                                            (97, 301, 128, 8), (9, 1920, 288, -287),
                                            (20, 300, 16, -140), (20, 500, 16, 376)])
def test_lr_check_bm_kernel_min_disparity_matches_plain_on_cuda(H, W, D, min_disp):
    """Windows from minD; below -127 and above 383 - D the packed key's
    d + 2048 leaves [0, 8192) and wraps as in the reference."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(H * W + D - min_disp)
    disp = rng.integers(min_disp * 16 - 16, (min_disp + D) * 16,
                        size=(H, W)).astype(np.int16)
    disp[rng.random((H, W)) < 0.2] = (min_disp - 1) * 16
    cost = t(rng.integers(0, 60000, size=(H, W)).astype(np.int32), dev)
    disp = t(disp, dev)
    for max_diff in (0, 1, 3):
        got = lr_resolve_bm(disp, cost, D, max_diff, min_disp)
        assert torch.equal(got, lr_resolve_bm_plain(disp, cost, D, max_diff, min_disp))
        assert not torch.equal(got, disp)
