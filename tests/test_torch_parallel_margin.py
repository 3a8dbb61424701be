"""The margin-mode tiled SGM (`parallel/tiled_sgbm.py`) on a world of 2
gloo ranks at device "cpu" against the JAX package's margin mode at 2
tiles, bit for bit, and within the overlap budget of the single-device
matcher (tests/test_tiled_sgbm.py's shape and bound). Its halo guard is in
tests/test_torch_parallel.py."""

import jax
import jax.numpy as jnp
import numpy as np

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
