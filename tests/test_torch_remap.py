"""Port parity: K1 remap (ops/remap.py + ops/cuda/remap.py) vs the JAX
uint8 path of rt_depth_map_tpu/ops/remap.py. Outputs are uint8 and must be
bit-exact, including windows that straddle or leave the image."""

import numpy as np
import pytest

import jax.numpy as jnp

from rt_depth_map_tpu.ops.remap import remap_bilinear as jremap
from rt_depth_map_tpu_torch.ops.cuda.remap import remap_u8, remap_u8_plain
from rt_depth_map_tpu_torch.ops.remap import quantize_map, remap_bilinear, remap_table
from torch_helpers import cuda_or_skip, t

H, W = 40, 56


def _grid(case, Ho=H, Wo=W):
    oy, ox = np.mgrid[0:Ho, 0:Wo].astype(np.float32)
    rng = np.random.default_rng(3)
    if case == "identity":
        mx, my = ox, oy
    elif case == "shear":  # fractional shift + vertical stretch past the border
        mx = ox + 0.3 + 0.05 * oy
        my = oy * (H + 8.0) / H - 4.0
    elif case == "random":  # anywhere, including fully outside the image
        mx = rng.uniform(-4, W + 4, (Ho, Wo))
        my = rng.uniform(-4, H + 4, (Ho, Wo))
    elif case == "ties":  # exact 1/64-px offsets: round half to even
        mx = ox + (2 * rng.integers(0, 32, (Ho, Wo)) + 1) / 64.0
        my = oy - (2 * rng.integers(0, 32, (Ho, Wo)) + 1) / 64.0
    elif case == "rotation":
        a = 0.05
        cx, cy = Wo / 2, Ho / 2
        mx = np.cos(a) * (ox - cx) - np.sin(a) * (oy - cy) + cx
        my = np.sin(a) * (ox - cx) + np.cos(a) * (oy - cy) + cy
    return np.stack([mx, my], axis=-1).astype(np.float32)


CASES = ["identity", "shear", "random", "ties", "rotation"]


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
    a = remap_u8(img, tab.ix, tab.iy, tab.fx, tab.fy, tab.valid)
    b = remap_u8_plain(img, tab.ix, tab.iy, tab.fx, tab.fy, tab.valid)
    assert remap_u8.launches == before  # no kernel launch on the CPU
    assert (a == b).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_remap_kernel_matches_plain_on_cuda(case):
    dev = cuda_or_skip()
    rng = np.random.default_rng(10)
    img = t(rng.integers(0, 256, size=(H, W, 4), dtype=np.uint8), dev)
    tab = remap_table(_grid(case), (H, W), dev)
    got = remap_bilinear(img, tab)
    ref = remap_bilinear(img, tab, plain=True)
    assert (got == ref).all()
