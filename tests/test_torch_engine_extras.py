"""Port parity of the engine's extras against the JAX Engine on the CPU:
show_disparity_value (SGM-8 and BM), the HSV and object-size setters,
run_preloaded, and the pipelined batch mode (B=2, one rig a frame).
Integer fields are exact; depth_cm, mean_z and disparity_mean agree to rtol
1e-5 (float32 sums in another order); count is exact; the labels are equal
strings."""

import numpy as np
import pytest
import torch

from rt_depth_map_tpu.pipeline import Engine as JEngine
from rt_depth_map_tpu.sources.multi import MultiStreamSource as JMultiStreamSource
from rt_depth_map_tpu.sources import SyntheticStereoSource as JSyntheticStereoSource
from rt_depth_map_tpu_torch import Engine
from rt_depth_map_tpu_torch.sources import MultiStreamSource, SyntheticStereoSource
from test_torch_engine import (
    FLOAT,
    H,
    W,
    _assert_same,
    _cfg,
    _jsource,
    _rectification,
    _sgm_cfg,
    _source,
    jax_config,
)


def _pair(i=1):
    return _source().render(i)[:2]


def _engines(cfg, source=None, jsource=None):
    rect = _rectification()
    return (JEngine(jax_config(cfg), rectification=rect,
                    source=jsource if jsource is not None else _jsource()),
            Engine(cfg, rectification=rect,
                   source=source if source is not None else _source(), device="cpu"))


@pytest.mark.parametrize("kind", ["sgm", "bm"])
def test_show_disparity_value_matches_jax(kind):
    cfg = (_sgm_cfg(8) if kind == "sgm" else _cfg()).replace(show_disparity_value=True)
    jeng, teng = _engines(cfg)
    ref = jeng.process_pair(*_pair())
    got = teng.process_pair(*_pair())
    _assert_same(ref, got, f"{kind} show_disparity_value")
    np.testing.assert_allclose(got.disparity_mean, ref.disparity_mean, rtol=1e-5)
    assert got.disparity_mean.dtype == np.float32
    assert got.labels() == ref.labels()
    assert any("disparity = " in txt for _, _, txt in got.labels())
    # the same frame without the option: no fourth output, plain labels
    plain = Engine(cfg.replace(show_disparity_value=False),
                   rectification=_rectification(), source=_source(),
                   device="cpu").process_pair(*_pair())
    assert plain.disparity_mean is None
    assert [t.split(" disparity")[0] for _, _, t in got.labels()] == [
        t for _, _, t in plain.labels()]


def test_setters_match_jax():
    """Each setter call changes the next frame as the JAX engine's does; the
    state gets new tensors and the old ones stay as they were."""
    jeng, teng = _engines(_cfg())
    pair = _pair()
    old_low = teng.state.hsv_low
    low0 = old_low.clone()
    steps = [("hsv", ([0, 120, 60], [12, 255, 255])),
             ("size", 2500),
             ("hsv", ([0, 0, 255], [180, 255, 255])),  # nothing passes
             ("size", 1)]
    seen = set()
    for what, arg in steps:
        for eng in (jeng, teng):
            if what == "hsv":
                eng.set_hsv_thresholds(np.array(arg[0]), np.array(arg[1]))
            else:
                eng.set_min_object_size(arg)
        ref, got = jeng.process_pair(*pair), teng.process_pair(*pair)
        _assert_same(ref, got, f"after {what} {arg}")
        seen.add(int(got.boxes[:, 4].sum()))
        np.testing.assert_array_equal(teng.state.hsv_low.numpy(), jeng.hsv_low)
        np.testing.assert_array_equal(teng.state.hsv_high.numpy(), jeng.hsv_high)
        assert teng.state.min_object_size == teng.min_object_size == jeng.min_object_size
    assert len(seen) >= 2  # the setters changed the detection
    assert teng.state.hsv_low is not old_low
    assert torch.equal(old_low, low0)
    # the next frame equals a fresh engine's built with those values
    fresh = Engine(_cfg(), rectification=_rectification(), source=_source(),
                   device="cpu")
    fresh.set_hsv_thresholds(teng.hsv_low, teng.hsv_high)
    fresh.set_min_object_size(1)
    _assert_same(fresh.process_pair(*pair), teng.process_pair(*pair), "fresh")


def test_run_preloaded_matches_jax():
    """frames dispatched, the stages it records (preload once, dispatch a
    frame, d2h on backpressure and at the final barrier), as the JAX
    engine's."""
    jeng, teng = _engines(_cfg())
    for eng in (jeng, teng):
        assert eng.run_preloaded(frames=10, n_inputs=3, pipeline_depth=3) == 10
        assert eng.run_preloaded(frames=0) == 0
    for eng in (jeng, teng):
        assert eng.stats.wall_frames == 10 and eng.stats.wall_seconds > 0
    counts = [{n: a.count for n, a in e.stats._stages.items()} for e in (jeng, teng)]
    assert counts[0] == counts[1]
    assert counts[1]["preload (grab+decode+h2d)"] == 1
    assert counts[1]["dispatch"] == 10
    assert teng.stats._overlapped == jeng.stats._overlapped == {"d2h"}
    assert teng.stats.iterations == jeng.stats.iterations == 10
    # the grabbed pairs are the source's first three
    assert teng.source._idx == jeng.source._idx == 3


def _rigs(cls, n=2):
    """n rigs: the test's objects on textures of seeds 5, 6, ..."""
    rigs = []
    for b in range(n):
        src = cls(W, H, seed=5 + b, objects=_source(cls).objects)
        src.rectified = False  # the engines apply the rectification maps
        rigs.append(src)
    return rigs


@pytest.mark.parametrize("kind", ["sgm", "bm"])
def test_process_batch_matches_jax_and_step(kind):
    """B=2 with a MultiStreamSource: process_batch (the batch program)
    equals the JAX engine's pipelined process_batch, and step_batch equals
    `step` on each rig."""
    cfg = (_sgm_cfg(8) if kind == "sgm" else _cfg()).replace(batch=2)
    jeng, teng = _engines(cfg, MultiStreamSource(_rigs(SyntheticStereoSource)),
                          JMultiStreamSource(_rigs(JSyntheticStereoSource)))
    assert jeng.batch_mode == "pipelined"
    frames = [rig.render(1)[:2] for rig in _rigs(SyntheticStereoSource)]
    lefts = np.stack([f[0] for f in frames])
    rights = np.stack([f[1] for f in frames])
    refs = jeng.process_batch(lefts, rights)
    gots = teng.process_batch(lefts, rights)
    assert len(gots) == 2
    for b in range(2):
        _assert_same(refs[b], gots[b], f"{kind} batch frame {b}")
    assert not np.array_equal(gots[0].rgb_rect, gots[1].rgb_rect)

    results = teng.step_batch()
    assert teng._frames_done == 2
    for b, rig in enumerate(_rigs(SyntheticStereoSource)):
        single = Engine(cfg.replace(batch=1), rectification=_rectification(),
                        source=rig, device="cpu")
        ref = single.step()
        for k in ("disparity", "boxes", "mask", "count", "rgb_rect"):
            np.testing.assert_array_equal(getattr(results[b], k), getattr(ref, k),
                                          err_msg=f"step_batch rig {b} {k}")
        for k in FLOAT:
            np.testing.assert_array_equal(getattr(results[b], k), getattr(ref, k))


def test_batch_needs_b_pairs_and_batch_over_one():
    teng = Engine(_cfg().replace(batch=2), rectification=_rectification(),
                  source=_source(), device="cpu")
    left, right = _pair()
    with pytest.raises(ValueError, match="batch 2"):
        teng.process_batch([left], [right])
    single = Engine(_cfg(), source=_source(), device="cpu")
    with pytest.raises(ValueError, match="batch > 1"):
        single.process_batch([left], [right])
    # a single source gives consecutive frames to the B slots
    results = teng.step_batch()
    assert len(results) == 2 and teng.source._idx == 2
