"""Port parity: ops/morphology.py (ellipse footprint, erode/dilate,
open+close) vs rt_depth_map_tpu/ops/morphology.py. uint8, bit-exact."""

import numpy as np
import pytest

import jax.numpy as jnp

from rt_depth_map_tpu.ops import morphology as jm
from rt_depth_map_tpu_torch.ops import morphology as tm
from torch_helpers import blob_mask, t


@pytest.mark.parametrize("size", [(10, 10), (3, 3), (7, 5), (12, 9)])
def test_ellipse_kernel_and_segments_match_jax(size):
    k = tm.ellipse_kernel(*size)
    np.testing.assert_array_equal(k, jm.ellipse_kernel(*size))
    assert tm.row_segments(k) == jm._row_segments(k)


@pytest.mark.parametrize("op", ["erode", "dilate", "morph_open_close"])
@pytest.mark.parametrize("seed", [0, 1])
def test_morphology_matches_jax(op, seed):
    kernel = jm.ellipse_kernel(10, 10)
    mask = blob_mask(seed, 60, 80, n_blobs=8, noise=0.02)
    ref = np.asarray(getattr(jm, op)(jnp.asarray(mask), kernel))
    got = getattr(tm, op)(t(mask), tm.row_segments(kernel))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_morphology_graylevel_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, size=(33, 47), dtype=np.uint8)
    kernel = jm.ellipse_kernel(10, 10)
    ref = np.asarray(jm.morph_open_close(jnp.asarray(img), kernel))
    got = tm.morph_open_close(t(img), tm.row_segments(kernel))
    np.testing.assert_array_equal(got.numpy(), ref)
