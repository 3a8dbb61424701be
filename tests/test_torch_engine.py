"""Port parity: the single-frame Engine of rt_depth_map_tpu_torch against the
JAX Engine, frame by frame, on a non-identity rectification: the BM matcher
with the speckle filter off, and 8- and 5-path SGM with the speckle filter
on.
Integer fields are exact; depth_cm and mean_z agree to rtol 1e-5 (float32
sums in another order). The port's configs build the JAX ones field by
field."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rt_depth_map_tpu import config as jconfig
from rt_depth_map_tpu.pipeline import Engine as JEngine
from rt_depth_map_tpu.pipeline.stats import ExecTimeStats as JStats
from rt_depth_map_tpu.sources import SyntheticStereoSource as JSyntheticStereoSource
from rt_depth_map_tpu_torch import Engine
from rt_depth_map_tpu_torch.calib import RectificationResult
from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
from rt_depth_map_tpu_torch.convert import engine_state_from_numpy
from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from rt_depth_map_tpu_torch.ops.remap import quantize_map
from rt_depth_map_tpu_torch.pipeline.stats import ExecTimeStats
from rt_depth_map_tpu_torch.sources import SyntheticStereoSource
from rt_depth_map_tpu_torch.sources.synthetic import SyntheticObject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, D = 256, 96, 32
EXACT = ("disparity", "boxes", "mask", "count", "rgb_rect")
FLOAT = ("depth_cm", "mean_z")


def _cfg():
    mcfg = MatcherConfig(kind="bm", num_disparities=D, block_size=13,
                         speckle_window_size=0)
    return EngineConfig(width=W, height=H, number_of_disparities=D, matcher=mcfg)


def _sgm_cfg(num_paths=8):
    """SGM at the flagship's matcher settings, speckle filter on."""
    mcfg = MatcherConfig(kind="sgm", num_disparities=D, block_size=5,
                         num_paths=num_paths, pre_filter_cap=0)
    return EngineConfig(width=W, height=H, number_of_disparities=D, matcher=mcfg)


def jax_config(cfg: EngineConfig) -> jconfig.EngineConfig:
    """The JAX package's EngineConfig with the port config's fields."""
    fields = dataclasses.asdict(cfg)
    fields["matcher"] = jconfig.MatcherConfig(**fields["matcher"])
    return jconfig.EngineConfig(**fields)


def _rectification():
    """Vertical stretch past the frame border plus a fractional x shift
    (tests/test_engine_batch.py), and a ROI crop."""
    oy, ox = np.mgrid[0:H, 0:W].astype(np.float32)
    grid = np.stack([ox + 0.3, oy * (H + 8.0) / H - 4.0], axis=-1).astype(np.float32)
    Q = SyntheticStereoSource(W, H).q_matrix()
    return RectificationResult(map_left=grid, map_right=grid.copy(), Q=Q,
                               roi=(4, 2, W - 8, H - 6), image_size=(W, H),
                               rectify=None)


def _source(cls=SyntheticStereoSource):
    objects = [SyntheticObject(x=40, y=20, w=100, h=50, z_units=60.0, vx=1.0),
               SyntheticObject(x=160, y=30, w=70, h=40, z_units=80.0, vy=0.5)]
    src = cls(W, H, seed=5, objects=objects)
    src.rectified = False  # the engines apply the rectification maps
    return src


def _jsource():
    """The JAX package's synthetic source (same frames as the port's copy)."""
    return _source(JSyntheticStereoSource)


def _assert_same(a, b, what=""):
    for k in EXACT:
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=f"{what} {k}")
    for k in FLOAT:
        np.testing.assert_allclose(getattr(b, k), getattr(a, k), rtol=1e-5,
                                   err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def engines():
    rect = _rectification()
    return (JEngine(jax_config(_cfg()), rectification=rect, source=_jsource()),
            Engine(_cfg(), rectification=rect, source=_source(), device="cpu"))


def test_engine_frames_match_jax(engines):
    jeng, teng = engines
    src = _source()
    for i in range(2):
        left, right, _, _ = src.render(i)
        ref = jeng.process_pair(left, right)
        got = teng.process_pair(left, right)
        _assert_same(ref, got, f"frame {i}")
        assert got.has_objects and (got.count > 0).any()  # valid depth in boxes
        assert got.labels() == ref.labels()


def test_engine_run_with_prefetch_matches_jax():
    rect = _rectification()
    jeng = JEngine(jax_config(_cfg()), rectification=rect, source=_jsource())
    teng = Engine(_cfg(), rectification=rect, source=_source(), device="cpu")
    ref, got = {}, {}
    assert jeng.run(frames=3, on_frame=lambda i, r: ref.__setitem__(i, r),
                    print_stats_on_sigint=False) == 3
    assert teng.run(frames=3, on_frame=lambda i, r: got.__setitem__(i, r),
                    print_stats_on_sigint=False) == 3
    assert sorted(got) == sorted(ref) == [0, 1, 2]
    for i in ref:
        _assert_same(ref[i], got[i], f"run frame {i}")
    assert teng.stats.wall_frames == 3
    # step() without prefetch goes through the same program
    _assert_same(jeng.step(), teng.step(), "step")


def _check_sgm_engine(num_paths):
    rect = _rectification()
    jeng = JEngine(jax_config(_sgm_cfg(num_paths)), rectification=rect,
                   source=_jsource())
    teng = Engine(_sgm_cfg(num_paths), rectification=rect, source=_source(),
                  device="cpu")
    assert dataclasses.asdict(teng.matcher_config) == dataclasses.asdict(
        jeng.matcher_config)
    src = _source()
    left, right, _, _ = src.render(1)
    ref = jeng.process_pair(left, right)
    got = teng.process_pair(left, right)
    _assert_same(ref, got, f"sgm-{num_paths} frame")
    assert got.has_objects and (got.count > 0).any()
    assert (got.disparity != -16).mean() > 0.3


def test_engine_sgm_frames_match_jax():
    """The flagship frame program (8-path SGM, speckle filter on) at a small
    size: the port's frames equal the JAX engine's. The ROI crop leaves 90
    rows, so the port takes its chained 8-path route."""
    _check_sgm_engine(8)


def test_engine_sgm5_frames_match_jax():
    """cv2 MODE_SGBM (5 paths) through the same frame program."""
    _check_sgm_engine(5)


def test_engine_runs_plain_versions_on_cpu(engines):
    _, teng = engines
    reset_launch_counts()
    teng.warmup()
    assert all(w.launches == 0 for w, _, _ in KERNELS)


def test_engine_state_from_numpy(engines):
    jeng, teng = engines
    st = engine_state_from_numpy(
        jeng.map_left, jeng.map_right, jeng.roi, jeng.Q, jeng.hsv_low,
        jeng.hsv_high, jeng.matcher_config, jeng.min_object_size, "cpu")
    rx, ry, rw, rh = jeng.roi
    for name, table, grid in (("left", st.left, jeng.map_left),
                              ("right", st.right, jeng.map_right)):
        q = quantize_map(grid[ry:ry + rh, rx:rx + rw], grid.shape[:2])
        mine = getattr(teng.state, name)
        for field, ref in q.items():
            np.testing.assert_array_equal(getattr(table, field).numpy(), ref)
            np.testing.assert_array_equal(getattr(mine, field).numpy(), ref)
    np.testing.assert_array_equal(st.Q.numpy(), np.asarray(jeng.Q, np.float32))
    assert st.Q.dtype == torch.float32
    np.testing.assert_array_equal(st.hsv_low.numpy(), jeng.hsv_low)
    np.testing.assert_array_equal(st.hsv_high.numpy(), jeng.hsv_high)
    assert (dataclasses.asdict(st.matcher) == dataclasses.asdict(jeng.matcher_config)
            == dataclasses.asdict(teng.matcher_config))
    assert st.min_object_size == jeng.min_object_size
    assert st.morph_segments == teng.state.morph_segments
    assert st.roi == teng.roi == jeng.roi


def test_engine_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(_cfg(), source=_source(), device="cuda")


def test_engine_refuses_unported_configs():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(_cfg().replace(enable_post_filter=True), device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(_cfg().replace(batch=2), device="cpu")


def test_port_imports_and_runs_with_jax_blocked():
    code = """
import sys
for m in ("jax", "jaxlib", "cv2", "yaml", "rt_depth_map_tpu"):
    sys.modules[m] = None
import pkgutil, importlib
import rt_depth_map_tpu_torch
for m in pkgutil.walk_packages(rt_depth_map_tpu_torch.__path__, "rt_depth_map_tpu_torch."):
    importlib.import_module(m.name)
from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
for kind in ("bm", "sgm"):
    cfg = EngineConfig(width=128, height=64, number_of_disparities=16,
                       matcher=MatcherConfig(kind=kind, num_disparities=16))
    res = rt_depth_map_tpu_torch.Engine(cfg, device="cpu").step()
    assert res.disparity.shape == (64, 128)
loaded = [k for k, v in sys.modules.items()
          if v is not None and k.split(".")[0] in ("jax", "jaxlib", "rt_depth_map_tpu")]
assert not loaded, loaded
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_port_sources_never_import_jax():
    pkg = os.path.join(REPO, "rt_depth_map_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        assert not (s.startswith("import jax") or s.startswith("from jax")), (f, s)


def test_stats_copy_reports_like_the_reference():
    a, b = JStats(True), ExecTimeStats(True)
    for st in (a, b):
        st.mark_overlapped("d2h")
        for i in range(3):
            st.start_iteration()
            st.add("grabOneFrame", 0.001 * (i + 1))
            st.add("d2h", 0.002)
        st.note_wall(3, 0.5)
    assert a.report() == b.report()
