"""Port parity: BM matcher. The prefilter and stereo_bm against the JAX XLA
path (rt_depth_map_tpu/ops/bm.py); the plain K8 (cost + winner) and K6 (LR
resolve) against the Pallas kernels themselves in interpret mode, as
tests/test_pallas_kernels.py runs them. Integer, bit-exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rt_depth_map_tpu.config import MatcherConfig
from rt_depth_map_tpu.golden import golden_stereo_bm
from rt_depth_map_tpu.ops import bm as jbm
from rt_depth_map_tpu.ops.pallas.bm_kernel import bm_cost_wta as pallas_bm
from rt_depth_map_tpu.ops.pallas.lr_resolve import lr_resolve_pallas
from rt_depth_map_tpu.ops.prefilter import xsobel_prefilter as jprefilter
from rt_depth_map_tpu_torch.ops import bm as tbm
from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_cost_wta, bm_cost_wta_plain
from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import lr_resolve, lr_resolve_plain
from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter
from torch_helpers import cuda_or_skip, stereo_pair, t


def _prefiltered(seed, H, W, shift, cap=31):
    left, right = stereo_pair(seed, H, W, shift)
    return (np.asarray(jprefilter(jnp.asarray(left), cap)),
            np.asarray(jprefilter(jnp.asarray(right), cap)))


@pytest.mark.parametrize("cap", [31, 63, 5])
def test_prefilter_matches_jax(cap):
    rng = np.random.default_rng(cap)
    img = rng.integers(0, 256, size=(24, 40), dtype=np.uint8)
    ref = np.asarray(jprefilter(jnp.asarray(img), cap))
    np.testing.assert_array_equal(xsobel_prefilter(t(img), cap).numpy(), ref)


def test_bm_cost_wta_plain_matches_pallas_in_valid_region():
    H, W, D, bs = 16, 128, 16, 13
    lp, rp = _prefiltered(11, H, W, 7)
    ref = [np.asarray(a) for a in
           pallas_bm(jnp.asarray(lp), jnp.asarray(rp), D, bs, interpret=True)]
    got = [a.numpy() for a in bm_cost_wta_plain(t(lp), t(rp), D, bs)]
    w2 = bs // 2
    region = (slice(w2, H - w2), slice(D - 1 + w2, W - w2))
    best = got[0][region]
    names = ("best_d", "best_cost", "c_m1", "c_p1", "min_outside")
    for name, g, r in zip(names, got, ref):
        g, r = g[region], r[region]
        # the Pallas kernel leaves c_m1 / c_p1 unspecified where best -+ 1
        # is outside [0, D); the port defines them as 0 there
        keep = {"c_m1": best > 0, "c_p1": best < D - 1}.get(name, np.ones_like(g, bool))
        np.testing.assert_array_equal(g[keep], r[keep], err_msg=name)


@pytest.mark.parametrize("D,bs", [(16, 13), (24, 5), (8, 9)])
def test_bm_cost_wta_plain_matches_xla_volume_everywhere(D, bs):
    """The port's contract holds on every pixel: the XLA cost volume of
    ops/bm.py and its winner, ties to the largest d."""
    H, W = 20, 72
    lp, rp = _prefiltered(5, H, W, 4)
    cost = np.asarray(jbm._cost_volume(jnp.asarray(lp), jnp.asarray(rp), D, 0, bs))
    di = np.arange(D)[:, None, None]
    kmin = (cost * D + (D - 1 - di)).min(0)
    best = D - 1 - kmin % D
    got = [a.numpy() for a in bm_cost_wta_plain(t(lp), t(rp), D, bs)]
    np.testing.assert_array_equal(got[0], best)
    np.testing.assert_array_equal(got[1], kmin // D)
    at = lambda d: np.take_along_axis(cost, np.clip(d, 0, D - 1)[None], 0)[0]  # noqa: E731
    np.testing.assert_array_equal(got[2], np.where(best > 0, at(best - 1), 0))
    np.testing.assert_array_equal(got[3], np.where(best < D - 1, at(best + 1), 0))
    outside = np.abs(di - best[None]) > 1
    np.testing.assert_array_equal(got[4], np.where(outside, cost, 2**28).min(0))


def _lr_inputs(seed, H, W, D):
    rng = np.random.default_rng(seed)
    d_match = rng.integers(-1, D + 2, size=(H, W)).astype(np.int32)
    key = rng.integers(0, 2**20, size=(H, W)).astype(np.int32) * 8192 \
        + rng.integers(0, 8192, size=(H, W)).astype(np.int32)
    key = np.where(rng.random((H, W)) < 0.1, 2**31 - 1, key).astype(np.int32)
    return d_match, key


@pytest.mark.parametrize("kw", [
    dict(n_w=17, r_lo=0, n_r=17, Dpow=8192, c0=-2048, invalid=-16),  # BM
    dict(n_w=12, r_lo=-2, n_r=9, Dpow=4096, c0=-5, invalid=-7),
])
def test_lr_resolve_plain_matches_pallas(kw):
    H, W, D = 16, 128, 16
    d_match, key = _lr_inputs(3, H, W, D)
    rm2 = np.clip(d_match + 1, -3, D + 3).astype(np.int32)
    ref = lr_resolve_pallas(jnp.asarray(d_match), jnp.asarray(key),
                            (jnp.asarray(d_match), jnp.asarray(rm2)),
                            interpret=True, **kw)
    got = lr_resolve_plain(t(d_match), t(key), (t(d_match), t(rm2)), **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_lr_check_matches_jax():
    H, W, D = 24, 96, 16
    rng = np.random.default_rng(12)
    disp = rng.integers(-16, D * 16 + 1, size=(H, W)).astype(np.int16)
    disp[rng.random((H, W)) < 0.2] = -16
    cost = rng.integers(0, 5000, size=(H, W)).astype(np.int32)
    for max_diff in (0, 1, 3):
        ref = np.asarray(jbm._lr_check(jnp.asarray(disp), jnp.asarray(cost),
                                       0, D, max_diff))
        got = tbm.lr_check(t(disp), t(cost), D, max_diff)
        np.testing.assert_array_equal(got.numpy(), ref)


ROIS = {
    "none": None,
    "box": (30, 4, 70, 26),
    "empty": (0, 0, 0, 0),
}


PARAMS = [
    dict(num_disparities=16, block_size=13),
    dict(num_disparities=32, block_size=9, uniqueness_ratio=15,
         texture_threshold=40, pre_filter_cap=15),
    dict(num_disparities=16, block_size=7, disp12_max_diff=-1,
         uniqueness_ratio=0, texture_threshold=0),
]


@pytest.mark.parametrize("roi,p", [("none", 0), ("box", 0), ("box", 1),
                                   ("empty", 1), ("box", 2), ("none", 2)])
def test_stereo_bm_matches_jax(roi, p):
    params = PARAMS[p]
    H, W = 32, 112
    left, right = stereo_pair(21, H, W, 6)
    cfg = MatcherConfig(kind="bm", speckle_window_size=0, backend="xla", **params)
    r = ROIS[roi]
    ref = np.asarray(jbm.stereo_bm(jnp.asarray(left), jnp.asarray(right), cfg,
                                   roi1=r))
    got = tbm.stereo_bm(t(left), t(right), cfg, roi1=r)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != -16).any()  # the case keeps some valid matches


@pytest.mark.parametrize("H,W,D,bs", [(64, 160, 32, 9), (48, 200, 64, 13)])
def test_stereo_bm_matches_numpy_golden(H, W, D, bs):
    """A JAX-free reference: the numpy golden that pins cv2.StereoBM."""
    left, right = stereo_pair(0, H, W, D // 3)
    ref = golden_stereo_bm(left, right, D, bs, speckle_window_size=0)
    cfg = MatcherConfig(num_disparities=D, block_size=bs, speckle_window_size=0)
    got = tbm.stereo_bm(t(left), t(right), cfg)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != -16).any()


def test_stereo_bm_refuses_speckle_and_min_disparity():
    left, right = stereo_pair(1, 16, 64, 3)
    with pytest.raises(NotImplementedError):
        tbm.stereo_bm(t(left), t(right), MatcherConfig(num_disparities=16))
    with pytest.raises(NotImplementedError):
        tbm.stereo_bm(t(left), t(right), MatcherConfig(
            num_disparities=16, speckle_window_size=0, min_disparity=2))


@pytest.mark.cuda
def test_bm_and_lr_kernels_match_plain_on_cuda():
    dev = cuda_or_skip()
    H, W, D, bs = 40, 200, 32, 13
    lp, rp = _prefiltered(4, H, W, 9)
    got = bm_cost_wta(t(lp, dev), t(rp, dev), D, bs)
    ref = bm_cost_wta_plain(t(lp, dev), t(rp, dev), D, bs)
    for g, r in zip(got, ref):
        assert (g == r).all()
    d_match, key = _lr_inputs(5, H, W, D)
    kw = dict(n_w=D + 1, r_lo=0, n_r=D + 1, Dpow=8192, c0=-2048, invalid=-16)
    dm, k = t(d_match, dev), t(key, dev)
    for g, r in zip(lr_resolve(dm, k, (dm,), **kw),
                    lr_resolve_plain(dm, k, (dm,), **kw)):
        assert (g == r).all()
