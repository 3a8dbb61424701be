"""Port parity: BM matcher. The prefilter and stereo_bm against the JAX XLA
path (rt_depth_map_tpu/ops/bm.py), at min_disparity 0 and at -(D - 1), -8
and +8 (with the plain K8 volume and the LR check there, and the LR key's
wrap below -127); the plain K8 (cost + winner) and K6 (LR resolve) against
the Pallas kernels themselves in interpret mode, as
tests/test_pallas_kernels.py runs them. Integer, bit-exact."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rt_depth_map_tpu.config import MatcherConfig as JMatcherConfig
from rt_depth_map_tpu.golden import golden_stereo_bm
from rt_depth_map_tpu.ops import bm as jbm
from rt_depth_map_tpu.ops.pallas.bm_kernel import bm_cost_wta as pallas_bm
from rt_depth_map_tpu.ops.pallas.lr_resolve import lr_resolve_pallas
from rt_depth_map_tpu.ops.prefilter import xsobel_prefilter as jprefilter
from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops import bm as tbm
from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import (
    MAX_D,
    MAX_WARPS,
    PIXELS_PER_WARP,
    SMEM_RESERVED,
    bm_cost_wta_plain,
    bm_plan,
    bm_smem,
)
from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import (
    LR_PX,
    LR_PXS,
    lr_plan,
    lr_resolve_bm,
    lr_resolve_plain,
)
from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter
from torch_helpers import stereo_pair, t


def jax_config(cfg: MatcherConfig, **kw) -> JMatcherConfig:
    """The JAX package's MatcherConfig with the port config's fields."""
    return JMatcherConfig(**{**dataclasses.asdict(cfg), **kw})


#: shared memory of one H100 SM (bytes), as the card reports it
H100_SMEM_PER_SM = 228 * 1024


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


def _check_plain_against_xla_volume(D, bs, H, W, shift, min_disp=0):
    """bm_cost_wta_plain's five outputs against the XLA cost volume of
    ops/bm.py and its winner (the reference's key cost * D + (D - 1 - d),
    ties to the largest index d), on every pixel; returns the winners."""
    lp, rp = _prefiltered(5, H, W, shift)
    cost = np.asarray(jbm._cost_volume(jnp.asarray(lp), jnp.asarray(rp), D,
                                       min_disp, bs))
    di = np.arange(D)[:, None, None]
    kmin = (cost * D + (D - 1 - di)).min(0)
    best = D - 1 - kmin % D
    got = [a.numpy() for a in bm_cost_wta_plain(t(lp), t(rp), D, bs, min_disp)]
    np.testing.assert_array_equal(got[0], best)
    np.testing.assert_array_equal(got[1], kmin // D)
    at = lambda d: np.take_along_axis(cost, np.clip(d, 0, D - 1)[None], 0)[0]  # noqa: E731
    np.testing.assert_array_equal(got[2], np.where(best > 0, at(best - 1), 0))
    np.testing.assert_array_equal(got[3], np.where(best < D - 1, at(best + 1), 0))
    outside = np.abs(di - best[None]) > 1
    np.testing.assert_array_equal(got[4], np.where(outside, cost, 2**28).min(0))
    return best


@pytest.mark.parametrize("D,bs", [(16, 13), (24, 5), (8, 9)])
def test_bm_cost_wta_plain_matches_xla_volume_everywhere(D, bs):
    """The port's contract holds on every pixel: the XLA cost volume of
    ops/bm.py and its winner, ties to the largest d."""
    _check_plain_against_xla_volume(D, bs, 20, 72, 4)


@pytest.mark.parametrize("min_disp", [-23, -8, 8, -300])
def test_bm_cost_wta_plain_min_disparity_matches_xla(min_disp):
    """The plain K8 at min_disparity != 0 (index i is disparity minD + i)
    on every pixel: at minD < 0 the right border x - dd >= W lies inside
    the frame, where the reference's term is 0, not |L - 0|; at -300 no
    right column of any disparity lies in the 72-wide image (every cost
    0)."""
    _check_plain_against_xla_volume(24, 5, 20, 72, 4, min_disp)


@pytest.mark.parametrize("D,bs", [(288, 9), (320, 5)])
def test_bm_cost_wta_plain_matches_xla_above_256(D, bs):
    """Above D = 256 the d field of a key packed into 8 bits would keep every
    winner at or above D - 256: a 20 px shift puts the true ones below it."""
    best = _check_plain_against_xla_volume(D, bs, 20, 420, 20)
    w2 = bs // 2
    inner = best[w2:-w2, D - 1 + w2: -w2]
    assert (inner == 20).mean() > 0.5


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


@pytest.mark.parametrize("D", [128, 288])
def test_lr_check_bm_plain_matches_jax(D):
    """The plain BM check and its entry on a CPU tensor against the
    reference's `_lr_check` (XLA path) at the D of the BM point and of the
    default BM matcher on a 1920x1080 camera (a 9-bit d in the key)."""
    H, W = 20, D + 140
    rng = np.random.default_rng(D)
    disp = rng.integers(-16, D * 16, size=(H, W)).astype(np.int16)
    disp[rng.random((H, W)) < 0.2] = -16
    cost = rng.integers(0, 60000, size=(H, W)).astype(np.int32)
    j_lr = jax.jit(jbm._lr_check, static_argnums=(2, 3, 4))
    for max_diff in (0, 1, 3):
        ref = np.asarray(j_lr(jnp.asarray(disp), jnp.asarray(cost), 0, D, max_diff))
        got = tbm.lr_check(t(disp), t(cost), D, max_diff, plain=True)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert torch.equal(lr_resolve_bm(t(disp), t(cost), D, max_diff), got)
        assert (ref != disp).any() and (ref != -16).any()


#: (D, min_disparity): -(D - 1), -8, +8; -140 and 376 put d + 2048 outside
#: [0, 8192), where the packed key wraps as the reference's int32 arithmetic
LR_MIN_DISP_CASES = [(16, -15), (16, -8), (16, 8), (128, -127), (16, -140),
                     (16, 376)]


@pytest.mark.parametrize("D,min_disp", LR_MIN_DISP_CASES)
def test_lr_check_bm_min_disparity_matches_jax(D, min_disp):
    """The plain BM check and its entry on a CPU tensor at min_disparity
    != 0 against the reference's `_lr_check`: winner and read-back windows
    over [minD, minD + D], the invalid value (minD - 1) * 16, and where
    d + 2048 leaves [0, 8192) (minD < -127, minD + D > 383) the wrapped key
    and its floor-mod decode."""
    H, W = 20, D + abs(min_disp) + 60
    rng = np.random.default_rng(D + min_disp + 1000)
    invalid = (min_disp - 1) * 16
    disp = rng.integers(min_disp * 16 - 16, (min_disp + D) * 16,
                        size=(H, W)).astype(np.int16)
    disp[rng.random((H, W)) < 0.2] = invalid
    cost = rng.integers(0, 60000, size=(H, W)).astype(np.int32)
    j_lr = jax.jit(jbm._lr_check, static_argnums=(2, 3, 4))
    for max_diff in (0, 1, 3):
        ref = np.asarray(j_lr(jnp.asarray(disp), jnp.asarray(cost), min_disp, D,
                              max_diff))
        got = tbm.lr_check(t(disp), t(cost), D, max_diff, min_disp, plain=True)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert torch.equal(lr_resolve_bm(t(disp), t(cost), D, max_diff, min_disp),
                           got)
        assert (ref != disp).any() and (ref != invalid).any()


@pytest.mark.parametrize("W", [1, 61, 1280, 1920, 3840, 4096, 4097, 8192, 8193])
def test_lr_plan(W):
    """K6's launch plan: whole warps of at most 1024 threads covering the
    row, LR_PX pixels a thread where that fits, more where it does not."""
    if W > 1024 * LR_PXS[-1]:
        with pytest.raises(ValueError):
            lr_plan(W)
        return
    px, tx, rows = lr_plan(W)
    assert px in LR_PXS and px >= LR_PX and tx % 32 == 0 and tx * px >= W
    assert tx * rows <= 1024 and rows >= 1
    assert px == LR_PX or -(-W // (px // 2)) > 1024  # the fewest that fit


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
    cfg = MatcherConfig(kind="bm", speckle_window_size=0, **params)
    r = ROIS[roi]
    ref = np.asarray(jbm.stereo_bm(jnp.asarray(left), jnp.asarray(right),
                                   jax_config(cfg, backend="xla"), roi1=r))
    got = tbm.stereo_bm(t(left), t(right), cfg, roi1=r)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != -16).any()  # the case keeps some valid matches


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("roi", ["none", "box"])
def test_stereo_bm_min_disparity_matches_jax(roi, i):
    """stereo_bm at min_disparity -(D - 1), -8 and +8, with and without a
    ROI, the LR check on (speckle filter off: the speckle case is
    test_stereo_bm_refuses_speckle_and_min_disparity's), bit-exact against
    the reference's XLA path. The pair's true disparity lies inside each
    range (the pair swapped at minD < 0)."""
    D, bs = 16, 9
    min_disp = (-(D - 1), -8, 8)[i]
    true_d = {-(D - 1): -6, -8: -4, 8: 14}[min_disp]
    H, W = 32, 112
    left, right = stereo_pair(21 + i, H, W, abs(true_d))
    if true_d < 0:
        left, right = right, left
    cfg = MatcherConfig(kind="bm", num_disparities=D, block_size=bs,
                        speckle_window_size=0, min_disparity=min_disp)
    assert cfg.disp12_max_diff >= 0
    r = ROIS[roi]
    ref = np.asarray(jbm.stereo_bm(jnp.asarray(left), jnp.asarray(right),
                                   jax_config(cfg, backend="xla"), roi1=r))
    got = tbm.stereo_bm(t(left), t(right), cfg, roi1=r)
    np.testing.assert_array_equal(got.numpy(), ref)
    valid = ref != (min_disp - 1) * 16
    assert valid.mean() > (0.2 if r is None else 0.1)
    assert abs(np.median(ref[valid]) / 16 - true_d) < 1


@pytest.mark.parametrize("D", [288, 320])
def test_stereo_bm_matches_jax_above_256(D):
    """D above 256 (the default BM matcher on a 1920-wide camera runs at
    D = 288) with true disparities below D - 256, bit-exact against the XLA
    path."""
    H, W = 32, 420
    left, right = stereo_pair(23, H, W, 20)
    cfg = MatcherConfig(kind="bm", num_disparities=D, block_size=9,
                        speckle_window_size=0)
    ref = np.asarray(jax.jit(jbm.stereo_bm, static_argnums=2)(
        jnp.asarray(left), jnp.asarray(right), jax_config(cfg, backend="xla")))
    got = tbm.stereo_bm(t(left), t(right), cfg)
    np.testing.assert_array_equal(got.numpy(), ref)
    valid = ref != -16
    assert valid.any()
    assert (ref[valid] < (D - 256) * 16).any()


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
    """Neither is refused any more: the speckle filter runs (also
    tests/test_torch_speckle.py) and so does min_disparity != 0 (also
    test_stereo_bm_min_disparity_matches_jax), here at +2 with the speckle
    filter on its invalid value (minD - 1) * 16; both against the JAX
    package, bit-exact."""
    left, right = stereo_pair(1, 16, 64, 3)
    # the reference as one compiled program (no eager per-op dispatch)
    j_bm = jax.jit(jbm.stereo_bm, static_argnums=2)
    for min_disp in (0, 2):
        cfg = MatcherConfig(num_disparities=16, min_disparity=min_disp)
        assert cfg.speckle_window_size > 0
        got = tbm.stereo_bm(t(left), t(right), cfg)
        ref = j_bm(jnp.asarray(left), jnp.asarray(right),
                   jax_config(cfg, backend="xla"))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert (np.asarray(ref) != (min_disp - 1) * 16).any()


@pytest.mark.parametrize("bs", [5, 13, 21])
@pytest.mark.parametrize("D", [1, 64, 100, 128, 192, 256, 288, 320, 384])
def test_bm_plan(D, bs):
    """K8's plan: whole warps, a block that fits with at least two resident
    on an SM, the halo and priming overheads bounded on full frames (above
    D = 256 the halo bound yields where a wider tile leaves fewer than two
    blocks an SM), and narrow frames served by narrower tiles. (The kernel
    itself against its plain version: tests/test_torch_bm_cuda.py, on the
    card.)"""
    for H, W in ((720, 1280), (1080, 1920), (97, 301), (50, 64), (5, 200)):
        plan = bm_plan(H, W, D, bs, H100_SMEM_PER_SM)
        assert plan.tx == PIXELS_PER_WARP * plan.warps and 1 <= plan.warps <= MAX_WARPS
        assert plan.smem == bm_smem(plan.tx, D, bs) <= H100_SMEM_PER_SM - SMEM_RESERVED
        assert plan.resident >= 2
        assert plan.resident * (plan.smem + SMEM_RESERVED) <= H100_SMEM_PER_SM
        assert 1 <= plan.ty <= H
        if W >= 1280:
            halo_ok = (plan.tx + bs - 1) / plan.tx <= 1.2
            if D > 256:
                wider = bm_smem(plan.tx + PIXELS_PER_WARP, D, bs) + SMEM_RESERVED
                halo_ok = halo_ok or 2 * wider > H100_SMEM_PER_SM
            assert halo_ok
            assert (plan.ty + bs - 1) / plan.ty <= 1.5
            # enough blocks to spread over the H100's 132 SMs
            assert -(-W // plan.tx) * -(-H // plan.ty) >= 132
    # an SM that holds less than the narrowest block: nothing fits
    with pytest.raises(ValueError):
        bm_plan(720, 1280, D, bs, bm_smem(PIXELS_PER_WARP, D, bs))
    # the widest window the wrapper takes, on an SM of half the H100's
    with pytest.raises(ValueError):
        bm_plan(720, 1280, 256, 181, H100_SMEM_PER_SM // 2)
    for bad_d, bad_bs in ((0, bs), (MAX_D + 1, bs), (D, bs + 1)):
        with pytest.raises(ValueError):
            bm_plan(720, 1280, bad_d, bad_bs, H100_SMEM_PER_SM)
    # above D = 256 the key's d field takes 9 bits: bs^2 * 255 * 512 < 2^31
    # holds up to bs = 127
    if D > 256:
        assert bm_plan(720, 1280, D, 127, H100_SMEM_PER_SM).resident >= 1
        with pytest.raises(ValueError, match="block_size"):
            bm_plan(720, 1280, D, 129, H100_SMEM_PER_SM)
