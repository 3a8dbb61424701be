"""Port parity: ops/reproject.py vs rt_depth_map_tpu/ops/reproject.py.

The /16 rounding and `count` are exact. XYZ, mean_z and depth_cm agree to
rtol 1e-5: float32 arithmetic, with sums taken in another order."""

import numpy as np
import pytest

import jax.numpy as jnp

from rt_depth_map_tpu.ops import reproject as jr
from rt_depth_map_tpu_torch.ops import reproject as tr
from torch_helpers import blob_mask, t

RTOL = 1e-5


def _q(W, H):
    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3], Q[1, 3], Q[2, 3] = -W / 2.0, -H / 2.0, 0.9 * W
    Q[3, 2] = 1.0 / 4.8
    Q[3, 3] = 0.01  # W != 0 even at d = 0
    return Q


def _disp16(seed, H, W):
    rng = np.random.default_rng(seed)
    d = rng.integers(-16, 64 * 16, size=(H, W)).astype(np.int16)
    d[rng.random((H, W)) < 0.2] = -16
    d[0, :6] = [8, 24, 40, -8, 56, 72]  # exact halves: round to even
    return d


def test_disparity_fixed_to_float_exact():
    d = _disp16(0, 24, 40)
    ref = np.asarray(jr.disparity_fixed_to_float(jnp.asarray(d)))
    got = tr.disparity_fixed_to_float(t(d))
    assert got.dtype == t(ref).dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_reproject_to_3d_matches_jax():
    H, W = 24, 40
    dint = np.asarray(jr.disparity_fixed_to_float(jnp.asarray(_disp16(1, H, W))))
    Q = _q(W, H)
    ref = np.asarray(jr.reproject_to_3d(jnp.asarray(dint), Q, 0, True))
    got = tr.reproject_to_3d(t(dint), t(Q.astype(np.float32)), 0, True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_calc_depth_matches_jax(seed):
    H, W = 48, 64
    dint = np.asarray(jr.disparity_fixed_to_float(jnp.asarray(_disp16(seed, H, W))))
    xyz = np.asarray(jr.reproject_to_3d(jnp.asarray(dint), _q(W, H), 0, True))
    mask = blob_mask(seed, H, W, n_blobs=5)
    boxes = np.array([[2, 3, 30, 20, 1], [10, 10, 40, 30, 1],
                      [0, 0, 64, 48, 0], [50, 40, 10, 5, 1],
                      [0, 0, 0, 0, 0]], np.int32)
    ref = jr.calc_depth(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(boxes), 25.0)
    got = tr.calc_depth(t(xyz), t(mask), t(boxes), 25.0)
    depth_ref, mean_ref, count_ref = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(got[2].numpy(), count_ref)
    np.testing.assert_allclose(got[1].numpy(), mean_ref, rtol=RTOL)
    np.testing.assert_allclose(got[0].numpy(), depth_ref, rtol=RTOL)
    assert np.isnan(got[1].numpy()[2]) and np.isnan(got[1].numpy()[4])
