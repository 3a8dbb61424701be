"""Port parity: the WLS post-filter (rt_depth_map_tpu_torch/ops/wls.py and
the smoother's plain version in ops/cuda/wls.py) against
rt_depth_map_tpu/ops/wls.py on the CPU: `right_matcher_config` field by
field, `lr_confidence` exactly, one sweep against the reference's
`_tridiag_smooth_rows` and against a dense solve, `fast_global_smoother`
and `wls_filter` within the stated tolerances; and the reference's
behaviour tests (tests/test_wls.py) on the port: the right matcher's
negative disparities, confidence gating, noise smoothed with the guide's
edge kept, a hole filled. The kernel itself against its plain version:
tests/test_torch_wls_cuda.py, on the card."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rt_depth_map_tpu.config import MatcherConfig as JMatcherConfig
from rt_depth_map_tpu.ops import bm as jbm
from rt_depth_map_tpu.ops import wls as jwls
from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops import wls as twls
from rt_depth_map_tpu_torch.ops.bm import stereo_bm
from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from rt_depth_map_tpu_torch.ops.cuda.wls import tridiag_smooth, tridiag_smooth_plain
from torch_helpers import stereo_pair, t

j_rows = jax.jit(jwls._tridiag_smooth_rows, static_argnums=(3, 4))
j_fgs = jax.jit(jwls.fast_global_smoother)
# as the JAX engine runs it: compiled, where XLA fuses the coefficient
# plane b's multiply-add too (run eagerly, b is rounded twice)
j_wls = jax.jit(jwls.wls_filter, static_argnums=3)


def jax_config(cfg: MatcherConfig) -> JMatcherConfig:
    return JMatcherConfig(**dataclasses.asdict(cfg))


def _plane(seed, H, W):
    """(x, confidence, guide): a disparity-like float plane with noise, a
    confidence of 0 (floored) on half the pixels, and a random guide."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(H, W)) * 100).astype(np.float32)
    conf = np.maximum(rng.uniform(0, 1, (H, W)) > 0.5, 1e-2).astype(np.float32)
    guide = rng.integers(0, 256, (H, W)).astype(np.uint8)
    return x, conf, guide


@pytest.mark.parametrize("kw", [dict(kind="sgm", num_disparities=128, block_size=5),
                                dict(kind="bm", num_disparities=32, min_disparity=5),
                                dict(kind="bm", num_disparities=288, min_disparity=-3,
                                     speckle_window_size=0, disp12_max_diff=-1)])
def test_right_matcher_config_matches_jax(kw):
    cfg = MatcherConfig(**kw)
    got = dataclasses.asdict(twls.right_matcher_config(cfg))
    ref = dataclasses.asdict(jwls.right_matcher_config(jax_config(cfg)))
    assert got == ref
    assert got["min_disparity"] == -(cfg.min_disparity + cfg.num_disparities) + 1


@pytest.mark.parametrize("invalid", [False, True])
def test_lr_confidence_matches_jax(invalid):
    """Exact, with and without the invalid markers, on maps whose matches
    leave the image at both ends."""
    rng = np.random.default_rng(3)
    H, W, D = 16, 90, 32
    dl = rng.integers(-16, D * 16, (H, W)).astype(np.int16)
    dr = (-dl + rng.integers(-40, 41, (H, W))).astype(np.int16)
    dl[rng.random((H, W)) < 0.1] = -16
    dr[rng.random((H, W)) < 0.1] = -D * 16
    dl[0, :4] = -32768
    kw = dict(invalid_left=-16, invalid_right=-D * 16) if invalid else {}
    ref = np.asarray(jwls.lr_confidence(jnp.asarray(dl), jnp.asarray(dr), 24, **kw))
    got = twls.lr_confidence(t(dl), t(dr), 24, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.mean() < 1


@pytest.mark.parametrize("lam", [37.5, 3047.6190476190477])
def test_tridiag_plain_matches_jax_rows(lam):
    """One sweep along the rows against `_tridiag_smooth_rows`, within 1e-4
    of the input's range (measured: 0, bit for bit, at both lambdas; XLA
    fuses the recurrence's multiply-adds and the plain version does too);
    dim 0 against the reference's call on the transposes."""
    x, conf, g = _plane(int(lam), 24, 80)
    tol = 1e-4 * np.ptp(x)
    ref = np.asarray(j_rows(jnp.asarray(x), jnp.asarray(conf), jnp.asarray(g), lam, 1.5))
    got = tridiag_smooth_plain(t(x), t(conf), t(g), lam, 1.5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
    ref0 = np.asarray(j_rows(jnp.asarray(x.T), jnp.asarray(conf.T), jnp.asarray(g.T),
                             lam, 1.5)).T
    got0 = tridiag_smooth_plain(t(x), t(conf), t(g), lam, 1.5, dim=0)
    np.testing.assert_allclose(got0.numpy(), ref0, rtol=0, atol=tol)


@pytest.mark.parametrize("dim", [1, 0])
def test_tridiag_plain_matches_dense_solve(dim, rng):
    """The oracle of tests/test_wls.py: the same (W_conf + lam * L) u =
    W_conf x system solved densely per scanline with numpy, at its
    tolerance (rtol = atol = 2e-3), along the rows and along the columns."""
    H, W = 6, 40
    lam, sigma = 37.5, 1.5
    x = rng.normal(size=(H, W)).astype(np.float32) * 10
    conf = rng.uniform(0.01, 1.0, size=(H, W)).astype(np.float32)
    guide = rng.integers(0, 256, (H, W)).astype(np.uint8)
    got = tridiag_smooth_plain(t(x), t(conf), t(guide), lam, sigma, dim).numpy()
    if dim == 0:
        x, conf, guide, got = x.T, conf.T, guide.T, got.T
    g = guide.astype(np.float64)
    wgt = np.exp(-np.abs(g[:, 1:] - g[:, :-1]) / sigma)
    for y in range(x.shape[0]):
        n = x.shape[1]
        A = np.zeros((n, n))
        for j in range(n):
            A[j, j] = conf[y, j]
            if j > 0:
                A[j, j] += lam * wgt[y, j - 1]
                A[j, j - 1] = -lam * wgt[y, j - 1]
            if j < n - 1:
                A[j, j] += lam * wgt[y, j]
                A[j, j + 1] = -lam * wgt[y, j]
        u = np.linalg.solve(A, conf[y] * x[y])
        np.testing.assert_allclose(got[y], u, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("H,W", [(24, 80), (48, 64)])
def test_fgs_matches_jax(H, W):
    """fast_global_smoother (3 iterations of a row and a column sweep at
    the reference's lambda and sigma) within 1e-4 of the input's range of
    the reference (measured: 0, bit for bit)."""
    x, conf, g = _plane(H * W, H, W)
    ref = np.asarray(j_fgs(jnp.asarray(x), jnp.asarray(g), jnp.asarray(conf)))
    reset_launch_counts()
    got = twls.fast_global_smoother(t(x), t(g), t(conf))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.ptp(x))
    assert all(w.launches == 0 for w, _, _ in KERNELS)  # plain versions on CPU
    assert torch.equal(got, twls.fast_global_smoother(t(x), t(g), t(conf), plain=True))


def _synthetic_wls_inputs(D=32):
    """The left and the mirrored right BM disparities of a seeded pair (the
    JAX matchers'), and the left guide."""
    left, right = stereo_pair(17, 48, 160, 9)
    cfg = JMatcherConfig(kind="bm", num_disparities=D, block_size=9,
                         speckle_window_size=0, backend="xla")
    j_bm = jax.jit(jbm.stereo_bm, static_argnums=2)
    dl = np.asarray(j_bm(jnp.asarray(left), jnp.asarray(right), cfg))
    dr = np.asarray(j_bm(jnp.asarray(right), jnp.asarray(left),
                         jwls.right_matcher_config(cfg)))
    return dl, dr, left, cfg


def test_wls_filter_matches_jax():
    """wls_filter's int16 output within 1 (1/16 px) of the reference's on
    at least 99.9% of the pixels and within 16 (1 px) everywhere, on a
    seeded synthetic pair (measured: 0 everywhere, bit for bit); the
    confidence exactly."""
    dl, dr, guide, jcfg = _synthetic_wls_inputs()
    cfg = MatcherConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()})
    ref, ref_conf = j_wls(jnp.asarray(dl), jnp.asarray(dr), jnp.asarray(guide),
                          jcfg)
    got, conf = twls.wls_filter(t(dl), t(dr), t(guide), cfg)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(conf.numpy(), np.asarray(ref_conf))
    err = np.abs(got.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert (err <= 1).mean() >= 0.999 and err.max() <= 16
    assert 0.2 < float(np.asarray(ref_conf).mean()) < 1


def test_right_matcher_produces_negative_disparities():
    """tests/test_wls.py's case on the port's BM: the right view's
    disparities are negative (~ -8 for a shift of 8)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (48, 128 + 16), dtype=np.uint8).astype(float)
    k = np.ones(5) / 5
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = base.astype(np.uint8)
    left, right = base[:, :128], base[:, 8:136]
    cfg = MatcherConfig(num_disparities=32, block_size=9,
                        speckle_window_size=0, disp12_max_diff=-1)
    rcfg = twls.right_matcher_config(cfg)
    dr = stereo_bm(t(right), t(left), rcfg).numpy()
    valid = dr != (rcfg.min_disparity - 1) * 16
    assert valid.mean() > 0.3
    assert abs(np.median(dr[valid]) / 16.0 + 8.0) < 1.0


def test_lr_confidence_gates_consistency():
    H, W = 8, 64
    dl = np.full((H, W), 8 * 16, np.int16)
    conf = twls.lr_confidence(t(dl), t(np.full((H, W), -8 * 16, np.int16))).numpy()
    assert (conf[:, 8:] == 1.0).all() and (conf[:, :8] == 0.0).all()
    conf2 = twls.lr_confidence(t(dl), t(np.full((H, W), -20 * 16, np.int16))).numpy()
    assert (conf2 == 0.0).all()


def test_fgs_smooths_noise_but_keeps_guide_edges():
    rng = np.random.default_rng(1)
    H, W = 48, 64
    guide = np.zeros((H, W), np.uint8)
    guide[:, W // 2:] = 200  # a hard edge in the guide
    x = np.broadcast_to(np.where(np.arange(W)[None, :] < W // 2, 10.0, 30.0),
                        (H, W))
    noisy = (x + rng.normal(0, 2.0, (H, W))).astype(np.float32)
    out = twls.fast_global_smoother(t(noisy), t(guide),
                                    torch.ones((H, W))).numpy()
    # noise within each flat region is reduced
    assert out[:, 5: W // 2 - 5].std() < noisy[:, 5: W // 2 - 5].std() * 0.5
    # the disparity step across the guide edge survives
    assert out[:, W // 2 + 3:].mean() - out[:, : W // 2 - 3].mean() > 15.0


def test_wls_fills_invalid_from_confident_neighbors():
    H, W = 32, 64
    dl = np.full((H, W), 12 * 16, np.int16)
    dl[10:20, 20:40] = -16  # an invalid hole
    dr = np.full((H, W), -12 * 16, np.int16)
    guide = np.full((H, W), 128, np.uint8)
    out, conf = twls.wls_filter(t(dl), t(dr), t(guide),
                                MatcherConfig(num_disparities=32))
    assert abs(out.numpy()[15, 30] / 16.0 - 12.0) < 2.0
    assert (conf.numpy()[10:20, 20:40] == 0).all()


def test_smoother_wrapper_runs_plain_on_cpu():
    x, conf, g = _plane(5, 12, 30)
    reset_launch_counts()
    for dim in (0, 1):
        assert torch.equal(tridiag_smooth(t(x), t(conf), t(g), 500.0, 1.5, dim),
                           tridiag_smooth_plain(t(x), t(conf), t(g), 500.0, 1.5, dim))
    assert tridiag_smooth.launches == 0
    with pytest.raises(ValueError):
        tridiag_smooth(t(x), t(conf), t(g), 500.0, 1.5, dim=2)
