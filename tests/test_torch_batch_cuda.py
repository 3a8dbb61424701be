"""The batched entries on the card against their plain versions, bit for
bit: K1 (`rectify_pair_batch`), K3 (`sgm_cost_volume_batch`), K5
(`sgm_vert_wta_batch`, on int16 and int32 volumes, on a batch whose edge
columns differ sharply from the neighbouring frame's, and on one the band
plan splits into several launches), `stereo_sgbm_batch` against
`stereo_sgbm` frame by frame, and the Engine's batch program against
`frame_program` frame by frame. Every test needs a CUDA device and skips
without one; the file imports no JAX:

    python -m pytest --noconftest tests/test_torch_batch_cuda.py -q -p no:randomly -n 0
"""

import ctypes

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch import Engine
from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
from rt_depth_map_tpu_torch.ops import sgbm as tsg
from rt_depth_map_tpu_torch.ops.cuda import _build
from rt_depth_map_tpu_torch.ops.cuda.remap import (
    rectify_pair_batch,
    rectify_pair_batch_plain,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (
    plane_stack,
    sgm_cost_volume_batch,
    sgm_cost_volume_batch_plain,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import (
    k5_batch_plan,
    sgm_vert_wta_batch,
    sgm_vert_wta_batch_plain,
)
from rt_depth_map_tpu_torch.ops.remap import remap_table
from rt_depth_map_tpu_torch.pipeline.engine import _to_host
from torch_helpers import cuda_or_skip, remap_grid

P1, P2, UR = 600, 2400, 10


def _equal(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape and torch.equal(g, r)


def _lib_launches(lib, name):
    """A library's own count of its kernel's CUDA launches."""
    return ctypes.c_int.in_dll(_build.load(lib), name).value


def _vert_launches():
    return _lib_launches("sgm_vert_wta", "rtdm_sgm_vert_kernel_launches")


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,w,n", [(4, 720, 1280, 1), (3, 37, 61, 1),
                                     (2, 40, 56, 2)])
def test_rectify_pair_batch_matches_plain(B, h, w, n):
    """720p, and outputs whose frames do not start on a word (Ho * Wo odd)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)).to(dev)
    gray = torch.from_numpy(rng.integers(0, 256, (B, h, w), dtype=np.uint8)).to(dev)
    ho, wo = h - n, w - n
    tabs = [remap_table(remap_grid(c, ho, wo, h, w), (h, w), dev)
            for c in ("shear", "random")]
    before = rectify_pair_batch.launches
    n0 = _lib_launches("remap", "rtdm_remap_kernel_launches")
    got = rectify_pair_batch(gray, rgb, gray.flip(0).contiguous(), *tabs)
    assert rectify_pair_batch.launches == before + 1
    assert _lib_launches("remap", "rtdm_remap_kernel_launches") == n0 + 1
    _equal(got, rectify_pair_batch_plain(gray, rgb, gray.flip(0).contiguous(), *tabs))


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,w,d,bs,dtype", [(4, 720, 1280, 128, 5, torch.int16),
                                              (3, 70, 300, 64, 11, torch.int32)])
def test_cost_volume_batch_matches_plain(B, h, w, d, bs, dtype):
    dev = cuda_or_skip()
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, B, h, w), dtype=np.uint8)).to(dev)
    lpl, rpl = plane_stack(imgs[0], 0), plane_stack(imgs[1], 0)
    n0 = _lib_launches("sgm_cost", "rtdm_sgm_cost_kernel_launches")
    got = sgm_cost_volume_batch(lpl, rpl, d, bs, dtype)
    assert _lib_launches("sgm_cost", "rtdm_sgm_cost_kernel_launches") == n0 + 1
    ref = sgm_cost_volume_batch_plain(lpl, rpl, d, bs, dtype)
    assert got[1:] == ref[1:]
    _equal(got[:1], ref[:1])


def _k5_batch(shape, dtype, dev, seed=2):
    """B volumes with sharp edge columns and an all-equal frame beside a
    textured one."""
    B, h, w1, d = shape
    rng = np.random.default_rng(seed)
    C = rng.integers(0, 2300, shape)
    C[0, :, -1] = 2300
    C[1 % B, :, 0] = 0
    C[-1] = 1000
    Sh = rng.integers(0, 1 << 14, shape)
    Sh[-1] = 0
    return (torch.from_numpy(C).to(dtype).to(dev),
            torch.from_numpy(Sh).to(torch.int32).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((4, 720, 1152, 128), torch.int16),
                                         ((4, 720, 1152, 128), torch.int32),
                                         ((3, 64, 900, 100), torch.int16),
                                         ((4, 16, 3712, 128), torch.int16)])
def test_vert_wta_batch_matches_plain(shape, dtype):
    dev = cuda_or_skip()
    C, Sh = _k5_batch(shape, dtype, dev)
    B, _, w1, d = shape
    bp = k5_batch_plan(B, w1, d, C.element_size(), dev)
    before, n0 = sgm_vert_wta_batch.launches, _vert_launches()
    got = sgm_vert_wta_batch(C, Sh, P1, P2, UR)
    pairs = -(-B // bp.frames)
    assert sgm_vert_wta_batch.launches - before == pairs
    assert _vert_launches() - n0 == 2 * pairs  # two cooperative launches each
    if w1 == 3712:  # the plan splits this batch
        assert bp.frames < B
    _equal(got, sgm_vert_wta_batch_plain(C, Sh, P1, P2, UR))


@pytest.mark.cuda
def test_stereo_sgbm_batch_matches_per_frame():
    dev = cuda_or_skip()
    rng = np.random.default_rng(3)
    B, h, w = 3, 96, 400
    base = rng.integers(0, 256, (B, h, w + 40), dtype=np.uint8)
    lefts = torch.from_numpy(np.ascontiguousarray(base[:, :, 20: 20 + w])).to(dev)
    rights = torch.from_numpy(np.ascontiguousarray(
        np.roll(base, 7, axis=2)[:, :, 20: 20 + w])).to(dev)
    cfg = MatcherConfig(kind="sgm", num_disparities=64, block_size=5, num_paths=8)
    assert tsg.uses_batch_route(cfg, h, w)
    got = tsg.stereo_sgbm_batch(lefts, rights, cfg)
    for b in range(B):
        assert torch.equal(got[b], tsg.stereo_sgbm(lefts[b], rights[b], cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sgm", "bm"])
def test_batch_program_matches_frame_program(kind):
    dev = cuda_or_skip()
    W, H, B = 320, 96, 3
    m = MatcherConfig(kind=kind, num_disparities=64,
                      block_size=5 if kind == "sgm" else 13)
    cfg = EngineConfig(width=W, height=H, number_of_disparities=64, matcher=m,
                       batch=B)
    eng = Engine(cfg, device=dev)
    src = eng.source
    pairs = [src.render(i)[:2] for i in range(B)]
    lefts = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    rights = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    got = _to_host(eng.batch_program(lefts, rights))
    for b in range(B):
        ref = _to_host(eng.frame_program(lefts[b], rights[b]))
        for k, v in ref.items():
            if v.dtype.kind == "f":
                np.testing.assert_allclose(got[k][b], v, rtol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k][b], v, err_msg=k)
