"""The port's copies of metrics.py and utils/ against the JAX package's:
the disparity metrics and the visualizations on the same inputs, exactly;
AdjustState driving the port's Engine.set_hsv_thresholds; the headless
viewer fallback; the logger."""

import types

import numpy as np
import pytest

from rt_depth_map_tpu import metrics as jmetrics
from rt_depth_map_tpu.utils import vis as jvis
from rt_depth_map_tpu_torch import Engine, metrics
from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
from rt_depth_map_tpu_torch.sources import SyntheticStereoSource
from rt_depth_map_tpu_torch.utils import log, vis
from rt_depth_map_tpu_torch.utils.viewer import TRACKBARS, AdjustState, make_viewer


def _disparities(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-16, 64 * 16, (48, 64)).astype(np.int16)
    b = (a + rng.integers(-40, 40, a.shape)).astype(np.int16)
    a[rng.random(a.shape) < 0.2] = -16
    b[rng.random(a.shape) < 0.2] = -16
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    a, b = _disparities(seed)
    assert metrics.disparity_report(a, b) == jmetrics.disparity_report(a, b)
    for thr in (0.5, 1.0, 2.0):
        assert (metrics.bad_pixel_fraction(a, b, threshold_px=thr)
                == jmetrics.bad_pixel_fraction(a, b, threshold_px=thr))
    none = np.full_like(a, -16)
    assert metrics.bad_pixel_fraction(none, b) == jmetrics.bad_pixel_fraction(none, b) == 0.0


def test_vis_matches_jax():
    a, _ = _disparities(2)
    for scale in (1.0, 2.5):
        np.testing.assert_array_equal(vis.disparity_vis(a, scale),
                                      jvis.disparity_vis(a, scale))
    rng = np.random.default_rng(3)
    result = types.SimpleNamespace(
        rgb_rect=rng.integers(0, 255, (48, 64, 3)).astype(np.uint8),
        boxes=np.array([[2, 3, 10, 8, 1], [50, 40, 30, 30, 1], [0, 0, 5, 5, 0],
                        [10, 10, 4, 4, 1]], np.int32),
        depth_cm=np.array([120.0, 80.0, 50.0, np.nan], np.float32))
    got, ref = vis.draw_depth_overlay(result), jvis.draw_depth_overlay(result)
    np.testing.assert_array_equal(got, ref)
    assert (got != result.rgb_rect).any()


@pytest.fixture(scope="module")
def engine():
    W, H = 128, 96
    cfg = EngineConfig(width=W, height=H, number_of_disparities=16,
                       minimal_object_size=10,
                       matcher=MatcherConfig(num_disparities=16, block_size=9))
    return Engine(cfg, source=SyntheticStereoSource(W, H, seed=1, num_objects=1),
                  device="cpu")


def test_adjuststate_drives_the_port_setter(engine):
    left, right = engine.source.render(0)[:2]
    st = AdjustState(engine)
    assert [t[0] for t in TRACKBARS][0] == "hue low"
    assert st.get("hue high") == engine.hsv_high[0]
    assert engine.process_pair(left, right).has_objects
    st.set("saturation low", 42)
    assert engine.hsv_low[1] == 42 and int(engine.state.hsv_low[1]) == 42
    st.set("value low", 255)  # nothing passes
    assert int(engine.state.hsv_low[2]) == 255
    assert not engine.process_pair(left, right).has_objects
    st.set("value low", 0)
    assert engine.process_pair(left, right).has_objects
    with pytest.raises(KeyError):
        st.set("bogus", 1)


def test_headless_viewer_and_logger(engine, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert make_viewer(engine, True, True) is None
    assert log.get_logger().name == "rt_depth_map_tpu_torch"
