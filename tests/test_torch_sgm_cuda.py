"""K4 and K3 on the card: the horizontal SGM paths (`csrc/sgm_horiz.cu`, both
chains meeting in the middle on a ring of asynchronous copies) and the cost
volume (`csrc/sgm_cost.cu`, packed 16x2 BT costs, row staging with
cp.async; also at min_disparity != 0), each against its plain version, bit
for bit. Every test but the
numpy emulation of K3's packed arithmetic needs a CUDA device and skips
without one; the file imports no JAX, so it also runs on a machine with the
card (whose Python has no JAX, hence no conftest):

    python -m pytest --noconftest tests/test_torch_sgm_cuda.py -q -p no:randomly
"""

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (
    cost_geometry,
    plane_stack,
    sgm_cost_volume,
    sgm_cost_volume_plain,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import sgm_horiz, sgm_horiz_plain
from torch_helpers import cuda_or_skip, t

P1, P2 = 600, 2400
DTYPES = {"int16": torch.int16, "int32": torch.int32}


def _ct(seed, W1, H, D, dtype, dev, hi=3000):
    rng = np.random.default_rng(seed)
    return t(rng.integers(0, hi, (W1, H, D)).astype(np.int32), dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [32, 64, 100, 128, 200, 256])
def test_horiz_meets_in_the_middle(D, dtype):
    """Odd and even W1 (1 and 2 included: the middle column, a one-step
    half) and H that leaves the last block of rows short."""
    dev = cuda_or_skip()
    for W1, H in ((1, 3), (2, 5), (37, 9), (64, 6), (75, 13)):
        Ct = _ct(W1 * 1000 + D, W1, H, D, DTYPES[dtype], dev)
        assert torch.equal(sgm_horiz(Ct, P1, P2), sgm_horiz_plain(Ct, P1, P2)), (W1, H)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 100, 256])
def test_horiz_large_p2(D):
    """P2 large against C: the carries fall far below zero and the d +- 1
    neighbours and the P2 jump trade places."""
    dev = cuda_or_skip()
    Ct = _ct(D, 41, 7, D, torch.int16, dev, hi=40)
    for p1, p2 in ((8, 30000), (0, 20000), (3000, 3001)):
        assert torch.equal(sgm_horiz(Ct, p1, p2), sgm_horiz_plain(Ct, p1, p2)), (p1, p2)


@pytest.mark.cuda
def test_horiz_unaligned_volume():
    """A volume that does not start on 16 bytes takes the register path."""
    dev = cuda_or_skip()
    base = _ct(5, 1, 1, 21 * 8 * 64 + 1, torch.int16, dev).reshape(-1)
    Ct = base[1:].reshape(21, 8, 64)
    assert Ct.data_ptr() % 16 != 0 and Ct.is_contiguous()
    assert torch.equal(sgm_horiz(Ct, P1, P2), sgm_horiz_plain(Ct, P1, P2))


def test_packed_bt_cost_matches_the_formula():
    """K3's inner loop (`sc_pack`, `sc_cost` in csrc/sgm_cost.cu) emulated
    in numpy: the packed words with their 256 biases, 32-bit wrapping
    subtractions, u16x2 max3/min, and the +320 a pixel cost carries, give
    BT(sobel) + (BT(raw) >> 2) for any plane bytes, and 0 against a right
    column outside the image (planes 0, 0, 255)."""
    rng = np.random.default_rng(0)
    n, mask, bias = 400_000, 0xFFFFFFFF, 0x01000100
    lp = rng.integers(0, 256, (n, 6), dtype=np.int64)
    rp = rng.integers(0, 256, (n, 6), dtype=np.int64)
    outside = rng.random(n) < 0.1

    def pack(p):  # bytes: sobel, its min, its max, raw, its min, its max
        word = [p[:, i] | (p[:, i + 3] << 16) for i in range(3)]
        return word[0], (word[2] - bias) & mask, (word[1] + bias) & mask

    def halves(a):
        return a & 0xFFFF, a >> 16

    def u16x2(f, *args):
        lo, hi = zip(*(halves(a) for a in args))
        return f.reduce(lo) | (f.reduce(hi) << 16)

    l0, l1, l2 = pack(lp)
    r0, r1, r2 = pack(rp)
    r0 = np.where(outside, 0, r0)
    r1 = np.where(outside, (0x00FF00FF - bias) & mask, r1)
    r2 = np.where(outside, bias, r2)
    full = np.full(n, bias, dtype=np.int64)
    c0 = u16x2(np.maximum, (l0 - r1) & mask, (r2 - l0) & mask, full)
    c1 = u16x2(np.maximum, (r0 - l1) & mask, (l2 - r0) & mask, full)
    bt = u16x2(np.minimum, c0, c1)
    got = (bt & 0xFFFF) + (bt >> 18) - 320

    def ref_bt(u, u0, u1, v, v0, v1):
        return np.minimum(np.maximum(0, np.maximum(u - v1, v0 - u)),
                          np.maximum(0, np.maximum(v - u1, u0 - v)))

    ref = ref_bt(*lp[:, :3].T, *rp[:, :3].T) + (ref_bt(*lp[:, 3:].T, *rp[:, 3:].T) >> 2)
    np.testing.assert_array_equal(got, np.where(outside, 0, ref))


def _stacks(seed, H, W, dev, cap=0):
    rng = np.random.default_rng(seed)
    imgs = [t(rng.integers(0, 256, (H, W)).astype(np.uint8), dev) for _ in range(2)]
    return [plane_stack(im, cap) for im in imgs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [16, 100, 128, 256])
@pytest.mark.parametrize("bs", [1, 3, 5, 7, 9, 11])
def test_cost_volume_ragged_tiles(bs, D, dtype):
    """W1 = 75 gives a clamped first tile, an interior one and a ragged
    last one; H = 70 a short last stripe; D = 256 two disparity blocks."""
    dev = cuda_or_skip()
    H, W1 = 70, 75
    lpl, rpl = _stacks(bs * 1000 + D, H, D + W1, dev)
    got = sgm_cost_volume(lpl, rpl, D, bs, DTYPES[dtype])
    ref = sgm_cost_volume_plain(lpl, rpl, D, bs, DTYPES[dtype])
    assert got[1:] == ref[1:]
    assert torch.equal(got[0], ref[0])


@pytest.mark.cuda
@pytest.mark.parametrize("H,W1", [(1, 1), (3, 31), (64, 33), (130, 200)])
def test_cost_volume_shapes(H, W1):
    """A single pixel, a window taller and wider than the image, one stripe
    exactly, several; planes of a high pre_filter_cap in an int32 volume."""
    dev = cuda_or_skip()
    D = 64
    lpl, rpl = _stacks(H + W1, H, D + W1, dev, cap=63)
    for bs in (5, 11):
        got = sgm_cost_volume(lpl, rpl, D, bs, torch.int32)[0]
        assert torch.equal(got, sgm_cost_volume_plain(lpl, rpl, D, bs, torch.int32)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [5, 11])
@pytest.mark.parametrize("D", [16, 128, 256])
@pytest.mark.parametrize("which", ["-(D-1)", "-8", "+8", "+16"])
def test_cost_volume_min_disparity(which, D, bs):
    """K3 at min_disparity != 0: the right columns offset by -minD over the
    cropped range (minX1, W1) = cost_geometry; 75 + 1 output columns with a
    ragged last tile, a short last stripe, two disparity blocks at D=256."""
    dev = cuda_or_skip()
    min_disp = {"-(D-1)": -(D - 1), "-8": -8, "+8": 8, "+16": 16}[which]
    H = 70
    W = D + abs(min_disp) + 76
    lpl, rpl = _stacks(bs * 1000 + D + min_disp, H, W, dev)
    got = sgm_cost_volume(lpl, rpl, D, bs, torch.int16, min_disp)
    ref = sgm_cost_volume_plain(lpl, rpl, D, bs, torch.int16, min_disp)
    assert got[1:] == ref[1:] == cost_geometry(W, D, min_disp)
    assert torch.equal(got[0], ref[0])
