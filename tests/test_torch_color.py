"""Port parity: ops/color.py (gray, HSV, inRange) vs the JAX reference.

All outputs are uint8 and must be bit-exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rt_depth_map_tpu.config import PREDEFINED_OBJECT_COLORS
from rt_depth_map_tpu.ops import color as jcolor
from rt_depth_map_tpu_torch.ops import color as tcolor
from torch_helpers import t


def _rgb_cases():
    """Random triples plus every (v, diff) combination in all three channel
    orders, so every sdiv/hdiv entry and every hue branch is exercised."""
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 256, size=(4096, 3), dtype=np.uint8)
    v, d = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    keep = d <= v
    v, d = v[keep], d[keep]
    mid = v - d // 2
    lo = v - d
    rows = [rand]
    for order in ((0, 1, 2), (1, 2, 0), (2, 0, 1), (0, 2, 1)):
        tri = np.stack([v, mid, lo], axis=-1)[:, order]
        rows.append(tri.astype(np.uint8))
    return np.concatenate(rows)


def test_hsv_divisor_tables_match_jax():
    n = jnp.maximum(jnp.arange(256), 1).astype(jnp.float32)
    sdiv = np.asarray(jnp.round((255 << 12) / n).astype(jnp.int32))
    hdiv = np.asarray(jnp.round((180 << 12) / (6.0 * n)).astype(jnp.int32))
    np.testing.assert_array_equal(tcolor.SDIV_TABLE, sdiv)
    np.testing.assert_array_equal(tcolor.HDIV_TABLE, hdiv)


def test_rgb_to_gray_matches_jax():
    rgb = _rgb_cases()
    ref = np.asarray(jcolor.rgb_to_gray(jnp.asarray(rgb)))
    np.testing.assert_array_equal(tcolor.rgb_to_gray(t(rgb)).numpy(), ref)


def test_rgb_to_hsv_matches_jax():
    rgb = _rgb_cases()
    ref = np.asarray(jcolor.rgb_to_hsv(jnp.asarray(rgb)))
    np.testing.assert_array_equal(tcolor.rgb_to_hsv(t(rgb)).numpy(), ref)


@pytest.mark.parametrize("name", sorted(PREDEFINED_OBJECT_COLORS))
def test_in_range_matches_jax(name):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
    hsv_range = PREDEFINED_OBJECT_COLORS[name]
    lo = np.asarray(hsv_range.low, np.uint8)
    hi = np.asarray(hsv_range.high, np.uint8)
    hsv = jcolor.rgb_to_hsv(jnp.asarray(img))
    ref = np.asarray(jcolor.in_range(hsv, lo, hi))
    got = tcolor.in_range(tcolor.rgb_to_hsv(t(img)), t(lo), t(hi))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
