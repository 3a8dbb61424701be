"""K9c, K9d and K11 on the card: the chained route's vertical passes, one
cooperative launch each of K5's row-synchronous kernel (`csrc/sgm_vert.cuh`
through `csrc/sgm_hdw.cu`), against their plain versions, bit for bit.
Every test needs a CUDA device and skips without one; the file imports no
JAX, so it also runs on a machine with the card (whose Python has no JAX,
hence no conftest):

    python -m pytest --noconftest tests/test_torch_sgm_vert_cuda.py -q -p no:randomly
"""

import ctypes

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cuda import _build
from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import (
    chained_plan,
    sgm_final_wta,
    sgm_final_wta_plain,
    sgm_vert_pass,
    sgm_vert_pass_plain,
)
from torch_helpers import cuda_or_skip

P1, P2, UR = 600, 2400, 10
#: (H, W1, D): the stretch point's volume (1920x1080, D = 256), its D = 100
#: cut (pixels that are not whole 16-byte pieces: the register path), and
#: volumes wider than 16 one-column warps on each SM (W1 = 3712 is the
#: 3840x2160 frame at D = 128; at D = 64 two blocks fit an SM, at D = 128
#: the warps take several columns)
STRETCH = (1080, 1664, 256)
REGISTER = (200, 500, 100)
WIDE = (48, 3712, 64)
WIDE128 = (12, 3712, 128)
SHAPES = [(STRETCH, torch.int16), (STRETCH, torch.int32), (REGISTER, torch.int16),
          (WIDE, torch.int16), (WIDE128, torch.int16)]


def _volumes(seed, shape, dtype, dev):
    """A cost volume and a partial that five directions' sums keep inside
    int16."""
    rng = np.random.default_rng(seed)
    C = torch.from_numpy(rng.integers(0, 2300, shape)).to(dtype).to(dev)
    partial = torch.from_numpy(rng.integers(-3000, 5000, shape)).to(dtype).to(dev)
    return C, partial


def _equal(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_vert_pass_matches_plain(shape, dtype, reverse):
    """K9c (top-down with the partial: the route's call), K11 (int32, either
    sense) and the other senses, with and without a partial."""
    dev = cuda_or_skip()
    C, partial = _volumes(sum(shape), shape, dtype, dev)
    for part in (partial, None):
        _equal(sgm_vert_pass(C, P1, P2, reverse, part),
               sgm_vert_pass_plain(C, P1, P2, reverse, part))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", SHAPES)
@pytest.mark.parametrize("reverse", [True, False])
def test_final_wta_matches_plain(shape, dtype, reverse):
    """K9d bottom-up (the 8-path finish) and top-down (MODE_SGBM's and the
    4-path finish) on a partial and on a zero one."""
    dev = cuda_or_skip()
    C, partial = _volumes(sum(shape) + 1, shape, dtype, dev)
    for part in (partial, torch.zeros_like(partial)):
        _equal(sgm_final_wta(C, part, P1, P2, UR, reverse),
               sgm_final_wta_plain(C, part, P1, P2, UR, reverse))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [WIDE, WIDE128])
def test_wide_volumes_pass_the_old_band_limit(shape):
    """More columns than 16 one-column warps on each SM, which the bands of
    one block an SM refused: more blocks resident an SM, or several columns
    a warp."""
    dev = cuda_or_skip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    H, W1, D = shape
    assert W1 > 16 * sms
    for wta in (False, True):
        plan = chained_plan(W1, D, 2, wta, dev)
        assert plan.m > 1 or plan.bands > sms
    assert chained_plan(*WIDE128[1:], 2, True, dev).m > 1


@pytest.mark.cuda
def test_one_cuda_launch_a_call():
    """Each of K9c, K11 and K9d is one launch of the vertical kernel, with
    no scratch volume."""
    dev = cuda_or_skip()
    C, partial = _volumes(3, (40, 300, 64), torch.int16, dev)
    count = ctypes.c_int.in_dll(_build.load("sgm_hdw"),
                                "rtdm_sgm_vert_kernel_launches")
    calls = (lambda: sgm_vert_pass(C, P1, P2, False, partial),
             lambda: sgm_vert_pass(C.int(), P1, P2, True, partial.int()),
             lambda: sgm_final_wta(C, partial, P1, P2, UR, True))
    for call in calls:
        call()
        before = count.value
        call()
        assert count.value - before == 1
