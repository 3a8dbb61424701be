"""The margin-mode tiled SGM (`parallel/tiled_sgbm.py`) on a world of 2
gloo ranks at device "cpu" against the JAX package's margin mode at 2
tiles, bit for bit, and within the overlap budget of the single-device
matcher (tests/test_tiled_sgbm.py's shape and bound). Its halo guard is in
tests/test_torch_parallel.py. Marked `slow` (not in tier-1): the same at
1280x720 D=128 on chip_smoke.py phase 12's pair, with the pixels off by
more than 1 px from the single device in each band of 64 columns."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_depth_map_tpu.config import MatcherConfig as JMatcherConfig
from rt_depth_map_tpu.ops.sgbm import stereo_sgbm as jstereo_sgbm
from rt_depth_map_tpu.parallel import make_mesh as jmake_mesh
from rt_depth_map_tpu.parallel.tiled_sgbm import tiled_stereo_sgbm as jtiled_stereo_sgbm
from torch_helpers import row_blur_pair as stereo_pair
from torch_parallel_workers import run_ranks

SGM = dict(kind="sgm", num_disparities=32, block_size=5, num_paths=8,
           pre_filter_cap=0)


def test_tiled_sgbm_margin_equals_jax_margin_mode():
    left, right = stereo_pair(0, 64, 512, 9)
    ranks = run_ranks(2, [("b", (1, 2))], [
        ("tiled_sgbm", dict(mesh="b", left=left, right=right, cfg=SGM, margin=48))])
    jcfg = JMatcherConfig(backend="xla", **SGM)
    mesh = jmake_mesh((1, 2), devices=jax.devices()[:2])
    ref = np.asarray(jtiled_stereo_sgbm(jnp.asarray(left), jnp.asarray(right), jcfg,
                                        mesh, margin=48))
    for (got,) in ranks:
        np.testing.assert_array_equal(got["disp"], ref)
    # and the overlap approximation stays inside its budget
    single = np.asarray(jax.jit(lambda a, b: jstereo_sgbm(a, b, jcfg))(
        jnp.asarray(left), jnp.asarray(right)))
    out = ranks[0][0]["disp"]
    both = (single != -16) & (out != -16)
    bad = (np.abs(single.astype(int) - out.astype(int)) > 16) & both
    assert bad.sum() / max(both.sum(), 1) < 0.002
    assert ((single != -16) != (out != -16)).mean() < 0.01


def _phase12_pair(w, h):
    """chip_smoke.py phase 12's gray planes of the synthetic frame, on the
    CPU."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                   "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray

    lf, rf, _, _ = cs._source(w, h).render(0)
    return tuple(rgb_to_gray(torch.from_numpy(f)).numpy() for f in (lf, rf))


def _off_by_band(disp, single):
    """Pixels off by more than 1 px (16) from the single device, in each
    band of 64 columns (chip_smoke.py phase 12's count)."""
    off = np.abs(disp.astype(int) - single.astype(int)) > 16
    cols = off.sum(0)
    return [int(cols[i: i + 64].sum()) for i in range(0, disp.shape[1], 64)]


@pytest.mark.slow
def test_margin_mode_at_720p_equals_jax_margin_mode():
    """The margin mode at 1280x720 D=128 on 2 gloo ranks at device "cpu"
    against JAX's `tiled_stereo_sgbm` on 2 CPU devices, bit for bit, and the
    same band counts against each package's single device."""
    w, h = 1280, 720
    left, right = _phase12_pair(w, h)
    cfg = dict(SGM, num_disparities=128)
    ranks = run_ranks(2, [("b", (1, 2))], [
        ("tiled_sgbm", dict(mesh="b", left=left, right=right, cfg=cfg, margin=64))],
        deadline=1800)
    jcfg = JMatcherConfig(backend="xla", **cfg)
    mesh = jmake_mesh((1, 2), devices=jax.devices()[:2])
    ref = np.asarray(jtiled_stereo_sgbm(jnp.asarray(left), jnp.asarray(right), jcfg,
                                        mesh, margin=64))
    for (got,) in ranks:
        np.testing.assert_array_equal(got["disp"], ref)
    jsingle = np.asarray(jax.jit(lambda a, b: jstereo_sgbm(a, b, jcfg))(
        jnp.asarray(left), jnp.asarray(right)))
    from rt_depth_map_tpu_torch.config import MatcherConfig
    from rt_depth_map_tpu_torch.ops.sgbm import stereo_sgbm

    single = stereo_sgbm(torch.from_numpy(left), torch.from_numpy(right),
                         MatcherConfig(**cfg)).numpy()
    np.testing.assert_array_equal(single, jsingle)
    bands = _off_by_band(ranks[0][0]["disp"], single)
    assert bands == _off_by_band(ref, jsingle)
    print(f"margin mode 1280x720 D=128 (1, 2): port == JAX bit for bit; off by "
          f"> 1 px from the single device: {sum(bands)} pixels "
          f"({sum(bands) / (w * h):.6f} of all), by band of 64 columns {bands}")
