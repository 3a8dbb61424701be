"""The WLS smoother kernel on the card (`csrc/wls.cu`): one sweep along the
rows and along the columns against `tridiag_smooth_plain`, on random planes
and on a plane with long zero-confidence runs (the ill-conditioned case),
within 1e-5 of the input's range (the two follow the same float32
operations; they can part only where the card's `expf` or the plain
version's float64-emulated fused multiply-add rounds otherwise); and the
chain's divisions one pair at a time against `__fdiv_rn`, bit for bit, over
the range the kernel divides in (the evidence that they are correctly
rounded: the hardware's reciprocal estimate runs only on the card). The tests
need a CUDA device and skip without one; the file imports no JAX, so it
also runs on a machine with the card:

    python -m pytest --noconftest tests/test_torch_wls_cuda.py -q -p no:randomly
"""

import ctypes

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cuda import _build
from rt_depth_map_tpu_torch.ops.cuda.wls import tridiag_smooth, tridiag_smooth_plain
from torch_helpers import cuda_or_skip, t


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(1, 1), (3, 70), (45, 300), (97, 33), (720, 1280)])
@pytest.mark.parametrize("holes", [False, True])
def test_smoother_kernel_matches_plain_on_cuda(H, W, holes):
    dev = cuda_or_skip()
    rng = np.random.default_rng(H * W + holes)
    x = (rng.normal(size=(H, W)) * 100).astype(np.float32)
    conf = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    if holes:  # long runs at the confidence floor
        conf[:, W // 4: 3 * W // 4] = 0.0
        conf[H // 3: 2 * H // 3] = 0.0
    conf = np.maximum(conf, 1e-2)
    guide = rng.integers(0, 256, (H, W)).astype(np.uint8)
    guide[:, : W // 2] = 128  # flat guide: the strongest coupling
    xs, cs, gs = t(x, dev), t(conf, dev), t(guide, dev)
    tol = 1e-5 * max(float(np.ptp(x)), 1.0)
    for lam in (3047.6190476190477, 47.61904761904762):
        for dim in (1, 0):
            before = tridiag_smooth.launches
            got = tridiag_smooth(xs, cs, gs, lam, 1.5, dim)
            assert tridiag_smooth.launches == before + 1
            ref = tridiag_smooth_plain(xs, cs, gs, lam, 1.5, dim)
            assert got.shape == (H, W) and got.dtype == torch.float32
            assert float((got - ref).abs().max()) <= tol, (lam, dim)


def _floats(rng, n, e_lo, e_hi):
    """n float32 of random sign and mantissa with exponents e_lo..e_hi
    (the exponent field's range: 0 gives subnormals)."""
    bits = (rng.integers(e_lo, e_hi + 1, n).astype(np.uint32) << 23) | \
        rng.integers(0, 1 << 23, n).astype(np.uint32) | \
        (rng.integers(0, 2, n).astype(np.uint32) << 31)
    return bits.view(np.float32)


def _division_pairs(seed=0, n=1 << 22):
    """(a, b) over the chain's range: b in [1e-12, 2^20], a zero or up to
    2^60; random operands of every exponent, numerators below 2^-100 (the
    scaled path) and subnormal ones, quotients that tie between two
    subnormals or lie at the subnormal-normal boundary, and the range's
    ends."""
    rng = np.random.default_rng(seed)
    b = _floats(rng, 4 * n, 87, 146)  # 2^-40 .. 2^20
    a = np.concatenate([
        _floats(rng, n, 0, 186),       # subnormal .. 2^60
        _floats(rng, n, 0, 26),        # below 2^-100
        _floats(rng, n, 0, 0),         # subnormal
    ])
    # ties: a / b = (2i + 1) * 2^-150 with b = (2j + 1) * 2^k
    bt = ((2 * rng.integers(0, 64, n) + 1) * 2.0 ** rng.integers(-20, 14, n))
    at = (2 * rng.integers(0, 1 << 16, n) + 1) * 2.0 ** -150 * bt
    exact = at.astype(np.float32) == at
    at, bt = at[exact], bt[exact]
    # quotients around 2^-126, the last subnormal and the first normal
    bq = _floats(rng, n, 100, 146).astype(np.float64)
    aq = bq * 2.0 ** -126 * (1 + rng.uniform(-2 ** -21, 2 ** -21, n))
    a = np.concatenate([a, at.astype(np.float32), aq.astype(np.float32)])
    b = np.concatenate([b[: 3 * n], bt.astype(np.float32), bq.astype(np.float32)])
    ends_a = np.array([0.0, -0.0, 2.0 ** -149, 2.0 ** -126, np.nextafter(
        np.float32(2.0 ** -100), np.float32(0)), 2.0 ** -100, 2.0 ** 60, 1.0, 3.0],
        np.float32)
    ends_b = np.array([1e-12, 2.0 ** 20, 1.0, 3.0, -1e-12, np.nextafter(
        np.float32(2.0 ** 20), np.float32(0))], np.float32)
    a = np.concatenate([a, np.repeat(ends_a, ends_b.size), -np.repeat(ends_a, ends_b.size)])
    b = np.concatenate([b, np.tile(ends_b, 2 * ends_a.size)])
    keep = (np.abs(b) >= np.float32(1e-12)) & (np.abs(b) <= 2.0 ** 20) & \
        (np.abs(a) <= 2.0 ** 60)
    return a[keep], b[keep]


@pytest.mark.cuda
def test_smoother_divisions_match_ieee_on_cuda():
    """Every quotient the chain stores equals `__fdiv_rn`'s bit for bit over
    ~18 M pairs of its range (the card's `rtdm_wls_div_pairs`)."""
    dev = cuda_or_skip()
    a, b = _division_pairs()
    at, bt = t(a, dev), t(b, dev)
    q, ieee = torch.empty_like(at), torch.empty_like(at)
    lib = _build.load("wls")
    fn = lib.rtdm_wls_div_pairs
    fn.argtypes = [_build.P, _build.P, _build.I, _build.P, _build.P, _build.P]
    fn.restype = _build.I
    _build.check(lib, fn(at.data_ptr(), bt.data_ptr(), a.size, q.data_ptr(),
                         ieee.data_ptr(), _build.stream_of(at)), "wls_div_pairs")
    torch.cuda.synchronize()
    diff = q.view(torch.int32) != ieee.view(torch.int32)
    assert a.size > 18_000_000
    assert int(diff.sum()) == 0, (a[diff.cpu().numpy()][:5], b[diff.cpu().numpy()][:5])
