"""Port parity: the SGM matcher. The elementwise preprocessing, the cost
volume, the path sums and the whole `stereo_sgbm` (8, 5 and 4 paths, on
both 8-path routes) against the JAX XLA path (rt_depth_map_tpu/ops/sgbm.py);
the plain K3, K4 and K5 against the Pallas kernels themselves in interpret
mode, as tests/test_sgm_bidir.py runs them (the chained passes K9a-K9d and
K11: tests/test_torch_sgm_hdw.py). Integer, bit-exact."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rt_depth_map_tpu.config import MatcherConfig as JMatcherConfig
from rt_depth_map_tpu.ops import sgbm as jsg
from rt_depth_map_tpu.ops.pallas.sgm_bidir import (
    sgm_horiz_bidir_dh,
    sgm_vert_bidir_wta_hdw,
)
from rt_depth_map_tpu.ops.pallas.sgm_cost import sgm_cost_volume_pallas
from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops import sgbm as tsg
from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (
    plane_stack,
    sgm_cost_volume,
    sgm_cost_volume_plain,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import sgm_horiz, sgm_horiz_plain
from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import (
    sgm_vert_wta,
    sgm_vert_wta_plain,
)
from torch_helpers import cuda_or_skip, stereo_pair, t

P1, P2 = 200, 801

# the JAX references as one compiled program each: the same computation,
# without the eager per-op dispatch that dominates their CPU time
j_stereo_sgbm = jax.jit(jsg.stereo_sgbm, static_argnums=2)
j_aggregate_cost = jax.jit(jsg.aggregate_cost, static_argnums=(1, 2, 3))
j_sgbm_cost_volume = jax.jit(jsg.sgbm_cost_volume, static_argnums=(2, 3, 4, 5))


def jax_config(cfg: MatcherConfig, **kw) -> JMatcherConfig:
    """The JAX package's MatcherConfig with the port config's fields."""
    return JMatcherConfig(**{**dataclasses.asdict(cfg), **kw})


def _cost(seed, H, W1, D, dtype=torch.int16):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2300, (H, W1, D))).to(dtype)


@pytest.mark.parametrize("ftzero", [15, 31, 63])
def test_preprocess_matches_jax(ftzero):
    rng = np.random.default_rng(ftzero)
    img = rng.integers(0, 256, size=(12, 30), dtype=np.uint8)
    ref = jsg.sgbm_preprocess(jnp.asarray(img), ftzero)
    got = tsg.sgbm_preprocess(t(img), ftzero)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        for rr, gg in zip(jsg._halfpix(r), tsg.halfpix(g)):
            np.testing.assert_array_equal(gg.numpy(), np.asarray(rr))


@pytest.mark.parametrize("H,W,D,bs,cap", [(20, 96, 32, 5, 0), (13, 70, 16, 3, 63),
                                          (17, 80, 48, 7, 31)])
def test_cost_volume_matches_xla(H, W, D, bs, cap):
    left, right = stereo_pair(H * W, H, W, D // 4)
    C, minX1, W1 = j_sgbm_cost_volume(jnp.asarray(left), jnp.asarray(right),
                                      D, bs, 0, cap)
    got, gx, gw = tsg.sgbm_cost_volume(t(left), t(right), D, bs, cap)
    assert (gx, gw) == (int(minX1), int(W1))
    assert got.dtype == (torch.int16 if 5 * bs * bs * (2 * (max(cap, 15) | 1) + 63)
                         <= 32767 else torch.int32)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), np.asarray(C))


def test_cost_volume_plain_matches_pallas():
    """K3's plain version against the Pallas kernel (H=16, W1=128, D=16)."""
    H, W1, D = 16, 128, 16
    left, right = stereo_pair(7, H, W1 + D, 5)
    ref, minX1, W1r = sgm_cost_volume_pallas(
        jnp.asarray(left), jnp.asarray(right), D, 5, 0, layout="hwd",
        dtype=jnp.int16, interpret=True)
    got, gx, gw = sgm_cost_volume_plain(plane_stack(t(left), 0),
                                        plane_stack(t(right), 0), D, 5,
                                        torch.int16)
    assert (gx, gw) == (minX1, W1r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_horiz_plain_matches_pallas():
    """K4's plain version against sgm_horiz_bidir_dh, both on x-major
    volumes: the TPU's (W1, D, H), the port's (W1, H, D)."""
    H, W1, D = 32, 128, 16
    C = _cost(1, H, W1, D)
    Ct = jnp.asarray(C.permute(1, 2, 0).contiguous().numpy())  # (W1, D, H)
    ref = np.asarray(sgm_horiz_bidir_dh(Ct, P1, P2, interpret=True))
    got = sgm_horiz_plain(tsg.swap_pixel_axes(C), P1, P2)  # (W1, H, D)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 1).numpy(), ref)


def test_vert_wta_plain_matches_pallas():
    """K5's plain version against sgm_vert_bidir_wta_hdw ((H, D, W1))."""
    H, W1, D = 32, 128, 16
    C = _cost(2, H, W1, D)
    Sh = _cost(3, H, W1, D)  # stand-in horizontal sum
    to_hdw = lambda a: jnp.asarray(a.permute(0, 2, 1).contiguous().numpy())  # noqa: E731
    ref = sgm_vert_bidir_wta_hdw(to_hdw(C), to_hdw(Sh), P1, P2, 10,
                                 interpret=True)
    got = sgm_vert_wta_plain(C, Sh.to(torch.int32), P1, P2, 10)
    for name, g, r in zip(("best", "minS", "dval", "uniq"), got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


def test_aggregate_and_wta_match_xla():
    H, W1, D = 9, 24, 16
    C = _cost(4, H, W1, D, torch.int32)
    S_ref = j_aggregate_cost(jnp.asarray(C.numpy()), 600, 2400, 8)
    S = tsg.aggregate_cost(C, 600, 2400, 8)
    np.testing.assert_array_equal(S.numpy(), np.asarray(S_ref))
    for name, g, r in zip(("best", "minS", "dval", "uniq"),
                          tsg.wta_uniq_subpix(S, 10),
                          jsg.wta_uniq_subpix(S_ref, 10)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int32),
                                      err_msg=name)


@pytest.mark.parametrize("num_paths", [4, 5])
def test_aggregate_cost_path_counts_match_xla(num_paths):
    C = _cost(14, 7, 20, 16, torch.int32)
    S_ref = j_aggregate_cost(jnp.asarray(C.numpy()), 600, 2400, num_paths)
    np.testing.assert_array_equal(tsg.aggregate_cost(C, 600, 2400, num_paths).numpy(),
                                  np.asarray(S_ref))


# (H, W, D): the second misses both the TPU's H % 16 and W1 % 128 grids, so
# the port takes its chained 8-path route there
SHAPES = [(32, 192, 64), (37, 200, 48)]


@pytest.mark.parametrize("H,W,D", SHAPES)
def test_stereo_sgbm_matches_jax(H, W, D):
    """8 paths, LR check and speckle filter on, the MatcherConfig defaults."""
    left, right = stereo_pair(H + D, H, W, D // 3)
    cfg = MatcherConfig(kind="sgm", num_disparities=D, block_size=5,
                        pre_filter_cap=0, num_paths=8)
    assert cfg.speckle_window_size > 0 and cfg.disp12_max_diff >= 0
    ref = np.asarray(j_stereo_sgbm(jnp.asarray(left), jnp.asarray(right),
                                   jax_config(cfg, backend="xla")))
    reset_launch_counts()
    got = tsg.stereo_sgbm(t(left), t(right), cfg)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != -16).sum() > H * (W - D) // 4  # the case keeps many matches
    assert all(w.launches == 0 for w, _, _ in KERNELS)  # plain versions on CPU


def test_stereo_sgbm_lr_and_uniqueness_variants_match_jax():
    H, W, D = 24, 150, 32
    left, right = stereo_pair(9, H, W, 7)
    # the last: 5 * P2 overflows int16, so the chained route widens the volume
    for kw in (dict(disp12_max_diff=-1, speckle_window_size=0),
               dict(uniqueness_ratio=0, disp12_max_diff=3, p1=100, p2=50),
               dict(num_paths=5, p2=8000)):
        cfg = MatcherConfig(kind="sgm", num_disparities=D, block_size=3,
                            pre_filter_cap=31, **kw)
        ref = np.asarray(j_stereo_sgbm(jnp.asarray(left), jnp.asarray(right),
                                       jax_config(cfg, backend="xla")))
        got = tsg.stereo_sgbm(t(left), t(right), cfg)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(kw))


@pytest.mark.parametrize("num_paths", [5, 4])
def test_stereo_sgbm_path_counts_match_jax(num_paths):
    """cv2 MODE_SGBM (5) and the causal 4 paths, with the MatcherConfig's
    default checks, at a shape where the bidir gate's shape test holds
    (test_stereo_sgbm_matches_jax covers the chained 8 paths)."""
    H, W, D = 32, 160, 32
    left, right = stereo_pair(40 + num_paths, H, W, D // 3)
    cfg = MatcherConfig(kind="sgm", num_disparities=D, block_size=5,
                        pre_filter_cap=0, num_paths=num_paths)
    assert tsg.uses_bidir(num_paths, H, W, D) is False
    ref = np.asarray(j_stereo_sgbm(jnp.asarray(left), jnp.asarray(right),
                                   jax_config(cfg, backend="xla")))
    got = tsg.stereo_sgbm(t(left), t(right), cfg)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != -16).sum() > H * (W - D) // 4


def test_kernel_wrappers_run_plain_on_cpu():
    left, right = stereo_pair(2, 12, 60, 4)
    lpl, rpl = plane_stack(t(left), 0), plane_stack(t(right), 0)
    reset_launch_counts()
    C, _, _ = sgm_cost_volume(lpl, rpl, 16, 5, torch.int16)
    assert (C == sgm_cost_volume_plain(lpl, rpl, 16, 5, torch.int16)[0]).all()
    Ct = tsg.swap_pixel_axes(C)
    assert torch.equal(Ct, tsg.swap_pixel_axes(C, plain=True))
    Sh = tsg.swap_pixel_axes(sgm_horiz(Ct, P1, P2))
    assert torch.equal(Sh, tsg.swap_pixel_axes(sgm_horiz_plain(Ct, P1, P2)))
    for g, r in zip(sgm_vert_wta(C, Sh, P1, P2, 10),
                    sgm_vert_wta_plain(C, Sh, P1, P2, 10)):
        assert (g == r).all()
    assert all(w.launches == 0 for w, _, _ in KERNELS)


@pytest.mark.cuda
def test_sgm_kernels_match_plain_on_cuda():
    dev = cuda_or_skip()
    H, W, D = 45, 300, 64
    left, right = stereo_pair(5, H, W, 11)
    lpl, rpl = plane_stack(t(left, dev), 0), plane_stack(t(right, dev), 0)
    C = sgm_cost_volume(lpl, rpl, D, 5, torch.int16)[0]
    assert (C == sgm_cost_volume_plain(lpl, rpl, D, 5, torch.int16)[0]).all()
    Ct = tsg.swap_pixel_axes(C)
    assert torch.equal(Ct, tsg.swap_pixel_axes(C, plain=True))
    Sh_t = sgm_horiz(Ct, 600, 2400)
    assert (Sh_t == sgm_horiz_plain(Ct, 600, 2400)).all()
    Sh = tsg.swap_pixel_axes(Sh_t)
    for g, r in zip(sgm_vert_wta(C, Sh, 600, 2400, 10),
                    sgm_vert_wta_plain(C, Sh, 600, 2400, 10)):
        assert (g == r).all()
