"""Port parity: the engine's batch program.

`Engine.batch_program` against the JAX engine's fused `_step_batch` (which
the JAX package's own tests, tests/test_engine_batch.py, hold to its
single-frame `_step` frame by frame): SGM-8 and BM at 192x64 with B = 2,
the out-of-image maps of tests/test_engine_batch.py with B = 3, and SGM-8
with the WLS post filter. `process_batch` and `step_batch` against
`process_pair` on each rig's pair. Integer fields bit-exact,
depth_cm and mean_z to rtol 1e-5, filtered_disparity within 1 on 99.9% of
the pixels and 16 everywhere (tests/test_torch_engine.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from rt_depth_map_tpu import config as jconfig
from rt_depth_map_tpu.pipeline import Engine as JEngine
from rt_depth_map_tpu.sources import SyntheticStereoSource as JSynthetic
from rt_depth_map_tpu_torch import Engine
from rt_depth_map_tpu_torch.calib import RectificationResult
from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from rt_depth_map_tpu_torch.pipeline.engine import FrameResult, _to_host
from rt_depth_map_tpu_torch.sources import MultiStreamSource, SyntheticStereoSource
from rt_depth_map_tpu_torch.sources.synthetic import SyntheticObject
from torch_helpers import profiled_spans

W, H = 192, 64
EXACT = ("disparity", "boxes", "mask", "count", "rgb_rect")
FLOAT = ("depth_cm", "mean_z")


def _cfg(kind, B, post_filter=False):
    """tests/test_engine_batch.py's matchers."""
    mcfg = MatcherConfig(kind=kind, num_disparities=32,
                         block_size=9 if kind == "bm" else 5,
                         speckle_window_size=20, speckle_range=32,
                         disp12_max_diff=1)
    return EngineConfig(width=W, height=H, number_of_disparities=32,
                        matcher=mcfg, batch=B, enable_post_filter=post_filter)


def _jcfg(cfg):
    fields = dataclasses.asdict(cfg)
    fields["matcher"] = jconfig.MatcherConfig(**fields["matcher"])
    return jconfig.EngineConfig(**fields)


def _oob_rectification():
    """tests/test_engine_batch.py:57: source rows from -4 to H + 4 (the top
    rows fully outside, rows near 0 and H - 1 straddling the border) and a
    fractional x shift."""
    oy, ox = np.mgrid[0:H, 0:W].astype(np.float32)
    grid = np.stack([ox + 0.3, oy * (H + 8.0) / H - 4.0], axis=-1).astype(np.float32)
    return RectificationResult(map_left=grid, map_right=grid.copy(),
                               Q=np.diag([1.0, 1.0, 1.0, 1.0]), roi=(0, 0, W, H),
                               image_size=(W, H), rectify=None)


def _source(cls, seed, rect=None):
    """Two objects (the detection, ROI and depth stages see boxes); with
    maps, the engines apply them."""
    objects = [SyntheticObject(x=30, y=14, w=60, h=30, z_units=40.0, vx=1.0),
               SyntheticObject(x=110, y=20, w=45, h=28, z_units=60.0, vy=0.5)]
    src = cls(W, H, seed=seed, objects=objects)
    src.rectified = rect is None
    return src


def _frames(B, seed, rect=None):
    src = _source(SyntheticStereoSource, seed, rect)
    pairs = [src.render(i)[:2] for i in range(B)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def _jax_outputs(cfg, lefts, rights, seed, rect=None):
    """The JAX engine's `_step_batch` outputs."""
    jeng = JEngine(_jcfg(cfg), rectification=rect,
                   source=_source(JSynthetic, seed, rect))
    args = (np.asarray(jeng.hsv_low), np.asarray(jeng.hsv_high),
            np.int32(jeng.min_object_size))
    return {k: np.asarray(v) for k, v in jeng._step_batch(lefts, rights, *args).items()}


def _assert_frame(got: dict, ref: dict, what: str, b=None):
    for k in EXACT:
        r = ref[k] if b is None else ref[k][b]
        np.testing.assert_array_equal(got[k], r, err_msg=f"{what} {k}")
    for k in FLOAT:
        r = ref[k] if b is None else ref[k][b]
        np.testing.assert_allclose(got[k], r, rtol=1e-5, err_msg=f"{what} {k}")
    if ref.get("filtered_disparity") is not None:
        r = ref["filtered_disparity"] if b is None else ref["filtered_disparity"][b]
        err = np.abs(got["filtered_disparity"].astype(np.int32) - r.astype(np.int32))
        assert (err <= 1).mean() >= 0.999 and err.max() <= 16, what


def _port_batch(cfg, lefts, rights, seed, rect=None):
    eng = Engine(cfg, rectification=rect, source=_source(SyntheticStereoSource,
                                                         seed, rect),
                 device="cpu")
    reset_launch_counts()
    out, spans = profiled_spans(lambda: eng.batch_program(torch.from_numpy(lefts),
                                                          torch.from_numpy(rights)))
    assert all(w.launches == 0 for w, _, _ in KERNELS)  # the plain versions
    return _to_host(out), [e.name for e in spans], eng


@pytest.mark.parametrize("kind", ["sgm", "bm"])
def test_batch_program_matches_jax(kind):
    B, seed = 2, 3
    cfg = _cfg(kind, B)
    lefts, rights = _frames(B, seed)
    jbatch = _jax_outputs(cfg, lefts, rights, seed)
    got, marks, eng = _port_batch(cfg, lefts, rights, seed)
    assert got["disparity"].shape == (B, H, W)
    for b in range(B):
        _assert_frame({k: v[b] for k, v in got.items()}, jbatch,
                      f"{kind} frame {b} vs _step_batch", b)
    assert got["boxes"][:, :, 4].any()
    assert "rtdm.stage.rectify" in marks  # the batched stages, named
    if kind == "sgm":
        assert "rtdm.match.vert_wta" in marks


def test_batch_program_out_of_image_maps():
    """Maps that sample outside the frame: each frame's K1 taps stop at its
    own border (the reference needs a guard row and a sentinel for this)."""
    B, seed, rect = 3, 5, _oob_rectification()
    cfg = _cfg("bm", B)
    lefts, rights = _frames(B, seed, rect)
    jbatch = _jax_outputs(cfg, lefts, rights, seed, rect)
    got, _, _ = _port_batch(cfg, lefts, rights, seed, rect)
    for b in range(B):
        _assert_frame({k: v[b] for k, v in got.items()}, jbatch,
                      f"oob frame {b} vs _step_batch", b)


def test_batch_program_post_filter_matches_jax():
    B, seed = 2, 3
    cfg = _cfg("sgm", B, post_filter=True)
    lefts, rights = _frames(B, seed)
    jbatch = _jax_outputs(cfg, lefts, rights, seed)
    got, marks, _ = _port_batch(cfg, lefts, rights, seed)
    assert got["filtered_disparity"].shape == (B, H, W)
    for b in range(B):
        _assert_frame({k: v[b] for k, v in got.items()}, jbatch,
                      f"post filter frame {b}", b)
    assert "rtdm.stage.match_right" in marks and "rtdm.stage.wls" in marks


def test_process_and_step_batch_match_process_pair():
    B = 2
    cfg = _cfg("sgm", B)
    rigs = lambda: MultiStreamSource([_source(SyntheticStereoSource, s)  # noqa: E731
                                      for s in (7, 8)])
    eng = Engine(cfg, source=rigs(), device="cpu")
    single = Engine(cfg.replace(batch=1), source=rigs(), device="cpu")
    pairs = [r.render(0)[:2] for r in rigs().sources]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    refs = [single.process_pair(*p) for p in pairs]
    for res in (eng.process_batch(lefts, rights),
                eng.process_batch([p[0] for p in pairs], [p[1] for p in pairs]),
                eng.step_batch()):
        assert len(res) == B and all(isinstance(r, FrameResult) for r in res)
        for b in range(B):
            _assert_frame(dataclasses.asdict(res[b]), dataclasses.asdict(refs[b]),
                          f"rig {b}")
    with pytest.raises(ValueError, match="batch 2"):
        eng.process_batch(lefts[:1], rights[:1])
