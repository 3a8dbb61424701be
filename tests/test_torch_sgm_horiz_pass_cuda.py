"""K9a/K9b on the card: the chained route's horizontal SGM pass
(`csrc/sgm_hdw.cu` `rtdm_sgm_horiz_pass`, a warp a row fed from a ring of
asynchronous copies in shared memory, or the register path where a pixel's
D elements are not whole 16-byte pieces) against its plain version, bit for
bit; and its launch plan, a pure function of the shape, on the CPU. The
kernel tests need a CUDA device and skip without one; the file imports no
JAX, so it also runs on a machine with the card (whose Python has no JAX,
hence no conftest):

    python -m pytest --noconftest tests/test_torch_sgm_horiz_pass_cuda.py -q -p no:randomly
"""

import ctypes

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cuda import _build
from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import (
    HORIZ_IN_FLIGHT_SM,
    HORIZ_RING_BYTES,
    HORIZ_RINGS,
    HORIZ_ROWS,
    _fn,
    horiz_pass_plan,
    sgm_horiz_pass,
    sgm_horiz_pass_plain,
)
from torch_helpers import cuda_or_skip

P1, P2 = 600, 2400
DTYPES = {"int16": torch.int16, "int32": torch.int32}


# (D, c_bytes, with_partial, H, ring, ring_path) on 132 SMs (an H100): the
# frame programs' calls (int16 at 1920x1080 D=256 and 1280x720 D=128, each
# sense), the int32 route, D = 100 at int16 (200-byte pixels: the register
# path) and at int32, a short volume (one warp an SM: the deepest ring), and
# one whose share would want 16 slots of 1600 bytes (capped at 8)
SMS = 132
PLANS = [
    (256, 2, False, 1080, 4, True),
    (256, 2, True, 1080, 4, True),
    (128, 2, False, 720, 16, True),
    (128, 2, True, 720, 8, True),
    (256, 4, True, 1080, 4, True),
    (100, 2, False, 700, 16, False),
    (100, 4, True, 700, 4, True),
    (16, 2, True, 9, 16, True),
    (200, 4, True, 9, 8, True),
]


@pytest.mark.parametrize("D,c_bytes,with_partial,H,ring,ring_path", PLANS)
def test_horiz_pass_plan(D, c_bytes, with_partial, H, ring, ring_path):
    """The fewest slots that keep a warp's share of HORIZ_IN_FLIGHT_SM (one
    warp a row, ceil(H / SMs) on an SM) ahead of its step, within
    HORIZ_RING_BYTES a warp, and the ring path exactly where a pixel is
    whole 16-byte pieces."""
    plan = horiz_pass_plan(D, c_bytes, with_partial, H, SMS)
    slot = D * c_bytes * (2 if with_partial else 1)
    per_warp = HORIZ_IN_FLIGHT_SM / -(-H // SMS)
    assert (plan.ring, plan.ring_path) == (ring, ring_path)
    assert plan.ring in HORIZ_RINGS and plan.rows == HORIZ_ROWS
    assert plan.ring * slot <= HORIZ_RING_BYTES
    deeper = [r for r in HORIZ_RINGS if r > plan.ring and r * slot <= HORIZ_RING_BYTES]
    assert (plan.ring - 1) * slot >= per_warp or not deeper
    smaller = [r for r in HORIZ_RINGS if r < plan.ring]
    assert all((r - 1) * slot < per_warp for r in smaller)
    assert plan.smem == (plan.rows * plan.ring * slot if ring_path else 0)
    # a block's ring fits the H100's 227 KB of shared memory at any D <= 256
    assert plan.smem <= 232_448


def _vol(seed, shape, dtype, dev, lo=0, hi=2300):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, shape)).to(dtype).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [16, 64, 100, 128, 200, 256])
@pytest.mark.parametrize("x_major", [False, True])
def test_horiz_pass_matches_plain(D, dtype, x_major):
    """Both senses, with and without a partial, at W1 shorter than the ring
    (1, 3), odd (37) and long (130), and H that leaves the last block of
    rows short; D = 100 at int16 takes the register path."""
    dev = cuda_or_skip()
    for W1, H in ((1, 3), (3, 5), (37, 9), (130, 7)):
        C = _vol(W1 * 1000 + D, (H, W1, D), DTYPES[dtype], dev)
        C = C.transpose(0, 1).contiguous() if x_major else C
        part = _vol(W1 + D, C.shape, DTYPES[dtype], dev, -3000, 5000)
        for rev in (False, True):
            for p in (None, part):
                got = sgm_horiz_pass(C, P1, P2, rev, p, x_major)
                ref = sgm_horiz_pass_plain(C, P1, P2, rev, p, x_major)
                assert got.dtype == ref.dtype and torch.equal(got, ref), (W1, H, rev)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 256])
def test_horiz_pass_large_p2(D):
    """P2 large against C: the carries fall far below zero; int16 sums are
    truncations of the int32 ones."""
    dev = cuda_or_skip()
    C = _vol(D, (6, 41, D), torch.int16, dev, hi=40)
    for p1, p2 in ((8, 6000), (0, 6553), (3000, 3001)):
        hf = sgm_horiz_pass(C, p1, p2)
        assert torch.equal(hf, sgm_horiz_pass_plain(C, p1, p2)), (p1, p2)
        assert torch.equal(sgm_horiz_pass(C, p1, p2, True, hf),
                           sgm_horiz_pass_plain(C, p1, p2, True, hf)), (p1, p2)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(4, 1), (8, 2), (16, 4)])
def test_horiz_pass_every_plan_and_an_unaligned_volume(plan):
    """The library entry point at every ring depth and block shape, and on
    volumes that do not start on 16 bytes (the kernel's own register path;
    the wrapper would copy them aligned): each one CUDA launch."""
    dev = cuda_or_skip()
    ring, rows = plan
    H, W1, D = 11, 29, 128
    flat = _vol(3, (2 * H * W1 * D + 1,), torch.int16, dev)
    count = ctypes.c_int.in_dll(_build.load("sgm_hdw"),
                                "rtdm_sgm_horiz_pass_kernel_launches")
    lib, fn = _fn("rtdm_sgm_horiz_pass", [_build.P, _build.I] + [_build.P] * 2
                  + [_build.I] * 9 + [_build.P])
    for off in (0, 1):
        C = flat[off: off + H * W1 * D].view(H, W1, D)
        part = flat[off + H * W1 * D: off + 2 * H * W1 * D].view(H, W1, D)
        assert (C.data_ptr() % 16 == 0) == (off == 0)
        for rev, p in ((False, None), (True, part)):
            out = torch.empty_like(C)
            before = count.value
            err = fn(C.data_ptr(), 2, None if p is None else p.data_ptr(),
                     out.data_ptr(), H, W1, D, 0, int(rev), P1, P2, ring, rows,
                     _build.stream_of(C))
            _build.check(lib, err, "rtdm_sgm_horiz_pass")
            assert count.value - before == 1
            assert torch.equal(out, sgm_horiz_pass_plain(C, P1, P2, rev, p)), (off, rev)


@pytest.mark.cuda
def test_horiz_pass_refuses_a_plan_it_does_not_hold():
    dev = cuda_or_skip()
    C = _vol(4, (4, 8, 64), torch.int16, dev)
    lib, fn = _fn("rtdm_sgm_horiz_pass", [_build.P, _build.I] + [_build.P] * 2
                  + [_build.I] * 9 + [_build.P])
    out = torch.empty_like(C)
    for ring, rows in ((6, 2), (8, 5)):
        err = fn(C.data_ptr(), 2, None, out.data_ptr(), 4, 8, 64, 0, 0, P1, P2,
                 ring, rows, _build.stream_of(C))
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(lib, err, "rtdm_sgm_horiz_pass")
    # 16 slots of int32 pixels with a partial at D = 256: 32 KB a warp
    Ci = _vol(5, (4, 8, 256), torch.int32, dev)
    outi = torch.empty_like(Ci)
    err = fn(Ci.data_ptr(), 4, Ci.data_ptr(), outi.data_ptr(), 4, 8, 256, 0, 1,
             P1, P2, 16, 2, _build.stream_of(Ci))
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(lib, err, "rtdm_sgm_horiz_pass")
