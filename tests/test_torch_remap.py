"""Port parity: K1 remap (ops/remap.py + ops/cuda/remap.py) vs the JAX
uint8 path of rt_depth_map_tpu/ops/remap.py. Outputs are uint8 and must be
bit-exact, including windows that straddle or leave the image. The packed
table words the kernel reads are checked against the unpacked fields."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rt_depth_map_tpu.ops.remap import remap_bilinear as jremap
from rt_depth_map_tpu_torch.ops.cuda.remap import (
    rectify_pair,
    rectify_pair_plain,
    remap_u8,
    remap_u8_plain,
)
from rt_depth_map_tpu_torch.ops.remap import quantize_map, remap_bilinear, remap_table
from torch_helpers import t
from torch_helpers import remap_grid as _grid
from test_torch_remap_cuda import CASES, H, W, pair_planes as _pair_planes


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("channels", [1, 4])
def test_remap_matches_jax(case, channels):
    rng = np.random.default_rng(7)
    shape = (H, W) if channels == 1 else (H, W, channels)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    grid = _grid(case)
    ref = np.asarray(jremap(jnp.asarray(img), jnp.asarray(grid)))
    got = remap_bilinear(t(img), remap_table(grid, (H, W)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_remap_roi_crop_equals_crop_of_full_remap():
    """The engine slices the map to the ROI before quantizing."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, size=(H, W, 4), dtype=np.uint8)
    grid = _grid("shear")
    full = np.asarray(jremap(jnp.asarray(img), jnp.asarray(grid)))
    y0, x0, h, w = 5, 7, 24, 31
    got = remap_bilinear(t(img), remap_table(grid[y0:y0 + h, x0:x0 + w], (H, W)))
    np.testing.assert_array_equal(got.numpy(), full[y0:y0 + h, x0:x0 + w])


@pytest.mark.parametrize("case", CASES)
def test_quantize_map_matches_jax_arithmetic(case):
    """The host tables equal remap.py:39-48 evaluated by JAX."""
    g = jnp.asarray(_grid(case))
    mx, my = g[..., 0], g[..., 1]
    ix = jnp.floor(mx).astype(jnp.int32)
    iy = jnp.floor(my).astype(jnp.int32)
    fx = jnp.round((mx - ix) * 32.0).astype(jnp.int32)
    fy = jnp.round((my - iy) * 32.0).astype(jnp.int32)
    ix, iy, fx, fy = ix + (fx >> 5), iy + (fy >> 5), fx & 31, fy & 31
    valid = (ix >= -1) & (ix <= W - 1) & (iy >= -1) & (iy <= H - 1)
    q = quantize_map(_grid(case), (H, W))
    for name, ref in (("ix", ix), ("iy", iy), ("fx", fx), ("fy", fy),
                      ("valid", valid)):
        np.testing.assert_array_equal(q[name], np.asarray(ref), err_msg=name)


def test_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(9)
    img = t(rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8))
    tab = remap_table(_grid("random"), (H, W))
    before = remap_u8.launches
    a = remap_u8(img, tab)
    b = remap_u8_plain(img, tab)
    assert remap_u8.launches == before  # no kernel launch on the CPU
    assert (a == b).all()
    planes = _pair_planes(9)
    before = rectify_pair.launches
    got = rectify_pair(*planes, tab, tab)
    assert rectify_pair.launches == before
    for g, r in zip(got, rectify_pair_plain(*planes, tab, tab)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("case", CASES + ["far"])
def test_packed_table_unpacks_to_fields(case):
    """The kernel's 8-byte words give back ix, iy, fx, fy and valid on every
    valid pixel (ix and iy are 0 where the window is fully outside), also for
    a grid far outside the frame, where ix and iy do not fit in int16."""
    if case == "far":
        rng = np.random.default_rng(4)
        grid = rng.uniform(-70000, 70000, (H, W, 2)).astype(np.float32)
        grid[::3, ::5] = rng.uniform(-1, W, (len(range(0, H, 3)),
                                              len(range(0, W, 5)), 2))
    else:
        grid = _grid(case)
    tab = remap_table(grid, (H, W))
    assert tab.packed.dtype == torch.int64 and tab.packed.shape == (H, W)
    word = tab.packed.numpy().view(np.uint64)
    low, high = word & 0xFFFFFFFF, word >> 32
    ix = (low & 0xFFFF).astype(np.uint16).view(np.int16)
    iy = (low >> 16).astype(np.uint16).view(np.int16)
    fx, fy, valid = high & 31, (high >> 5) & 31, (high >> 10) & 1
    assert (high >> 11 == 0).all()
    q = quantize_map(grid, (H, W))
    np.testing.assert_array_equal(valid, q["valid"])
    v = q["valid"] == 1
    assert v.any() and (case != "far" or (~v).any())
    for name, got in (("ix", ix), ("iy", iy), ("fx", fx), ("fy", fy)):
        np.testing.assert_array_equal(got[v], q[name][v], err_msg=name)
    np.testing.assert_array_equal(ix[~v], 0)
    np.testing.assert_array_equal(iy[~v], 0)


@pytest.mark.parametrize("case", CASES)
def test_rectify_pair_plain_matches_jax_stack(case):
    """The pair without the 4-channel stack the JAX engine builds: each plane
    equals its channel of JAX remap_bilinear over the stack (left) and JAX
    remap_bilinear of the right gray."""
    lg, lrgb, rg = (p.numpy() for p in _pair_planes(11))
    lgrid, rgrid = _grid(case), _grid("shear" if case != "shear" else "rotation")
    stack = np.concatenate([lg[..., None], lrgb], axis=-1)
    ref4 = np.asarray(jremap(jnp.asarray(stack), jnp.asarray(lgrid)))
    ref_r = np.asarray(jremap(jnp.asarray(rg), jnp.asarray(rgrid)))
    got = rectify_pair_plain(t(lg), t(lrgb), t(rg), remap_table(lgrid, (H, W)),
                             remap_table(rgrid, (H, W)))
    for g, r in zip(got, (ref4[..., 0], ref4[..., 1:], ref_r)):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), r)
