"""Port parity: the batched matcher and its batched kernels.

`stereo_sgbm_batch` (plain kernels on the CPU) against the JAX package's
`stereo_sgbm_batch` with backend="pallas" (its lane-stacked path: the
batched K3, K4 on frames stacked along H, K5 with `seg`, the row-stacked
LR check, in interpret mode) and against the port's `stereo_sgbm` frame by
frame, at B = 2 and 3; off the batched route (5 paths, min_disparity != 0)
against the JAX XLA path frame by frame. The plain batched K3 against
JAX's batched `sgm_cost_volume_pallas`, the plain batched K5 against
`sgm_vert_bidir_wta_hdw(..., seg=W1)`, both in interpret mode, K5 on frames
whose edge columns differ sharply from their neighbours' and on a frame of
all-equal costs beside a textured one. The batched glue (plane stacks,
morphology, K1, the depth stage) against the same stages frame by frame,
and the batch plan of K5 (`vert_batch_plan`, `split_batch`).

RTDM_HBIDIR_KB=2 sets the JAX K4's columns a trip (a TPU tuning knob that
does not change its output; the default of 32 takes ~30 s to trace in
interpret mode). Integer outputs bit-exact; the depth stage's floats to
rtol 1e-5."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rt_depth_map_tpu.config import MatcherConfig as JMatcherConfig
from rt_depth_map_tpu.ops import sgbm as jsg
from rt_depth_map_tpu.ops.pallas.sgm_bidir import sgm_vert_bidir_wta_hdw
from rt_depth_map_tpu.ops.pallas.sgm_cost import sgm_cost_volume_pallas
from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops import sgbm as tsg
from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from rt_depth_map_tpu_torch.ops.cuda.remap import rectify_pair, rectify_pair_batch
from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (
    plane_stack,
    sgm_cost_volume,
    sgm_cost_volume_batch,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import (
    MAX_BAND_COLS,
    sgm_vert_wta,
    sgm_vert_wta_batch,
    split_batch,
    vert_plan,
)
from rt_depth_map_tpu_torch.ops.morphology import (
    ellipse_kernel,
    morph_open_close,
    row_segments,
)
from rt_depth_map_tpu_torch.ops.remap import remap_table
from rt_depth_map_tpu_torch.ops.reproject import calc_depth, reproject_to_3d
from torch_helpers import blob_mask, remap_grid, t

H, D, W1 = 16, 16, 128
W = W1 + D

j_stereo_sgbm_batch = jax.jit(jsg.stereo_sgbm_batch, static_argnums=2)


def _pairs(B, seed=0, h=H, w=W):
    """tests/test_batch_lane_stack.py's pairs: random texture, each right
    view shifted by a frame's own disparity."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (B, h, w + 24), dtype=np.uint8)
    lefts = np.ascontiguousarray(base[:, :, 12: 12 + w])
    rights = np.stack([np.roll(base[i], 3 + i, axis=1)[:, 12: 12 + w]
                       for i in range(B)])
    return lefts, rights


def _cfg(**kw):
    return MatcherConfig(**{**dict(kind="sgm", num_disparities=D, block_size=5,
                                   num_paths=8), **kw})


def _jcfg(cfg, **kw):
    return JMatcherConfig(**{**dataclasses.asdict(cfg), **kw})


def _no_launches():
    return all(w.launches == 0 for w, _, _ in KERNELS)


@pytest.mark.parametrize("B", [2, 3])
def test_stereo_sgbm_batch_matches_jax_lane_stacked(B, monkeypatch):
    monkeypatch.setenv("RTDM_HBIDIR_KB", "2")
    lefts, rights = _pairs(B)
    cfg = _cfg()
    assert tsg.uses_batch_route(cfg, H, W)
    ref = np.asarray(j_stereo_sgbm_batch(jnp.asarray(lefts), jnp.asarray(rights),
                                         _jcfg(cfg, backend="pallas")))
    batched = []
    monkeypatch.setattr(tsg, "sgm_cost_volume_batch",
                        lambda *a, **k: batched.append(1) or sgm_cost_volume_batch(*a, **k))
    reset_launch_counts()
    got = tsg.stereo_sgbm_batch(t(lefts), t(rights), cfg)
    assert _no_launches() and batched == [1]  # the batched route, plain
    assert got.dtype == torch.int16 and got.shape == (B, H, W)
    np.testing.assert_array_equal(got.numpy(), ref)
    for i in range(B):
        one = tsg.stereo_sgbm(t(lefts[i]), t(rights[i]), cfg)
        np.testing.assert_array_equal(got[i].numpy(), one.numpy(), err_msg=f"frame {i}")
    assert (ref != -16).mean() > 0.5


@pytest.mark.parametrize("kw", [dict(num_paths=5), dict(min_disparity=-8)],
                         ids=["5-paths", "minD-8"])
def test_stereo_sgbm_batch_off_route_matches_jax(kw):
    """Shapes off the batched route run `stereo_sgbm` frame by frame, as
    the reference's `stereo_sgbm_batch` does there."""
    B = 2
    lefts, rights = _pairs(B, seed=4)
    cfg = _cfg(**kw)
    assert not tsg.uses_batch_route(cfg, H, W)
    ref = np.asarray(j_stereo_sgbm_batch(jnp.asarray(lefts), jnp.asarray(rights),
                                         _jcfg(cfg, backend="xla")))
    got = tsg.stereo_sgbm_batch(t(lefts), t(rights), cfg)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_batched_cost_volume_matches_jax_lane_stacked():
    B = 2
    lefts, rights = _pairs(B, seed=1)
    C, minX1, w1 = sgm_cost_volume_pallas(
        jnp.asarray(lefts), jnp.asarray(rights), D, 5, 0, layout="hdw",
        dtype=jnp.int16, interpret=True)
    C = np.asarray(C)
    lpl = plane_stack(t(lefts), 0)
    rpl = plane_stack(t(rights), 0)
    for i in range(B):  # the batched planes: each frame's own borders
        assert torch.equal(lpl[i], plane_stack(t(lefts[i]), 0))
    reset_launch_counts()
    got, gx, gw = sgm_cost_volume_batch(lpl, rpl, D, 5, torch.int16)
    assert _no_launches()
    assert (gx, gw) == (minX1, w1) == (D, W1) and got.shape == (B, H, W1, D)
    for i in range(B):
        np.testing.assert_array_equal(
            got[i].numpy(), C[:, :, i * W1:(i + 1) * W1].transpose(0, 2, 1),
            err_msg=f"frame {i}")
        np.testing.assert_array_equal(
            got[i].numpy(), sgm_cost_volume(lpl[i], rpl[i], D, 5, torch.int16)[0].numpy())


def _k5_frames():
    """Three frames: a textured one whose last column holds the highest
    costs, one whose first column holds zeros and last column the highest
    costs (a leaked carry would show at the neighbouring frame's edge
    column), and one of all-equal costs."""
    rng = np.random.default_rng(2)
    C = rng.integers(0, 3000, (3, H, W1, D))
    C[0, :, -1] = 3000
    C[1, :, 0] = 0
    C[1, :, -1] = 3000
    C[2] = 1234
    Sh = rng.integers(0, 6000, (3, H, W1, D))
    Sh[2] = 0
    return C.astype(np.int16), Sh.astype(np.int16)


def test_batched_vert_wta_matches_jax_seg():
    C, Sh = _k5_frames()
    B = len(C)
    # lane-stacked (H, D, B * W1), as the reference's batch path feeds it
    Cs = jnp.asarray(np.concatenate(list(C.transpose(0, 1, 3, 2)), axis=2))
    Shs = jnp.asarray(np.concatenate(list(Sh.transpose(0, 1, 3, 2)), axis=2))
    ref = [np.asarray(o) for o in sgm_vert_bidir_wta_hdw(
        Cs, Shs, 600, 2400, 10, interpret=True, seg=W1)]
    Ct, Sht = t(C), t(Sh).to(torch.int32)
    reset_launch_counts()
    got = sgm_vert_wta_batch(Ct, Sht, 600, 2400, 10)
    assert _no_launches()
    for name, g, r in zip(("best", "minS", "dval", "uniq"), got, ref):
        assert g.shape == (B, H, W1) and g.dtype == torch.int32
        for i in range(B):
            np.testing.assert_array_equal(g[i].numpy(), r[:, i * W1:(i + 1) * W1],
                                          err_msg=f"frame {i} {name}")
    for i in range(B):
        one = sgm_vert_wta(Ct[i], Sht[i], 600, 2400, 10)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)
    assert (got[0][2] == 0).all()  # all-equal costs: the winner is d = 0


def vert_batch_plan(B, W1, D, resident, c_bytes=2):
    """`batch_plan_on_card`'s split over `vert_plan` for a card that holds
    `resident` blocks at once: F frames give each frame resident // F."""
    def plan_for(F):
        if resident // F < 1:
            raise ValueError(f"{F} frames over {resident} blocks")
        return vert_plan(W1, D, resident // F, c_bytes)
    return split_batch(B, plan_for)


def test_vert_batch_plan_splits_evenly():
    # 720p D=128 on 132 resident blocks: four frames in one launch, each on
    # a quarter of the blocks
    bp = vert_batch_plan(4, 1152, 128, 132)
    assert bp.frames == 4 and 4 * bp.plan.bands <= 132
    assert bp.plan.warps * bp.plan.m * bp.plan.bands >= 1152
    assert vert_batch_plan(1, 1152, 128, 132).plan == vert_plan(1152, 128, 132)
    # 3712 columns: two frames fit a launch, four go in two launches of two
    bp = vert_batch_plan(4, 3712, 128, 132)
    assert bp.frames == 2 and 2 * bp.plan.bands <= 132
    # five frames where at most three fit: launches of 3 and 2
    assert vert_batch_plan(5, 3712, 128, 132).frames == 3

    def fits(F):
        if F > 2:
            raise ValueError("too many")
        return vert_plan(64, 32, 100 // F)
    assert split_batch(7, fits).frames == 2
    with pytest.raises(ValueError):
        vert_batch_plan(2, MAX_BAND_COLS * 10 * 64, 256, 10)


def test_batched_glue_matches_frame_by_frame():
    """The stages the batch program runs over B frames at once: each frame
    equals the single-frame stage (morphology's vertical taps and the plane
    stacks' Sobel rows stop at each frame's own border)."""
    B, h, w = 3, 24, 40
    masks = np.stack([blob_mask(s, h, w, noise=0.02) for s in range(B)])
    masks[0, -3:] = 255  # a frame full at its bottom rows above an empty one
    masks[1] = 0
    segs = row_segments(ellipse_kernel(10, 10))
    got = morph_open_close(t(masks), segs)
    for i in range(B):
        assert torch.equal(got[i], morph_open_close(t(masks[i]), segs))

    rng = np.random.default_rng(3)
    disp = t(rng.integers(-1, 40, (B, h, w)).astype(np.int16))
    Q = t(np.array([[1, 0, 0, -20], [0, 1, 0, -12], [0, 0, 0, 36],
                    [0, 0, 0.2, 0]], np.float32))
    boxes = t(np.array([[[2, 3, 10, 8, 1], [20, 5, 15, 12, 1], [0, 0, 0, 0, 0]]] * B,
                       np.int32))
    xyz = reproject_to_3d(disp, Q, 0, True)
    outs = calc_depth(xyz, t(masks), boxes, 10.0, extra=disp.float())
    for i in range(B):
        assert torch.equal(xyz[i], reproject_to_3d(disp[i], Q, 0, True))
        for g, o in zip(outs, calc_depth(xyz[i], t(masks[i]), boxes[i], 10.0,
                                         extra=disp[i].float())):
            np.testing.assert_allclose(g[i].numpy(), o.numpy(), rtol=1e-5)


def test_rectify_pair_batch_matches_frame_by_frame():
    """The batched K1's plain version on maps that sample outside the frame
    (tests/test_engine_batch.py's out-of-image case): each frame reads only
    its own planes."""
    B, h, w = 3, 40, 56
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (B, h, w), dtype=np.uint8)
    tables = [remap_table(remap_grid(case, h, w, h, w), (h, w))
              for case in ("shear", "random")]
    reset_launch_counts()
    got = rectify_pair_batch(t(gray), t(rgb), t(gray[::-1].copy()), *tables)
    assert _no_launches()
    for i in range(B):
        one = rectify_pair(t(gray[i]), t(rgb[i]), t(gray[B - 1 - i]), *tables)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)
