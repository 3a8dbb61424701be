"""The exact width-tiled SGM (`parallel/exact_sgbm.py`) on a world of 4
gloo ranks at device "cpu" against the JAX package's single-device
`stereo_sgbm`, bit for bit: 8, 5 and 4 paths at 2 and 4 tiles, explicit and
default row blocks, narrow tiles, and 8 paths at min_disparity -8 (where
the JAX package's own exact tiling equals its single device too). The
shapes and parameters are tests/test_exact_tiled.py's.

One spawned world runs every case on two meshes: "a" (1, 4), four tiles,
and "b" (2, 2), two space groups of two tiles running the case side by
side (`tests/torch_parallel_workers.py`: no JAX in the ranks, a deadline).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rt_depth_map_tpu.config import MatcherConfig as JMatcherConfig
from rt_depth_map_tpu.ops.sgbm import stereo_sgbm as jstereo_sgbm
from torch_parallel_workers import run_ranks

MESHES = [("a", (1, 4)), ("b", (2, 2))]


def _pair(seed, H, W):
    """tests/test_exact_tiled.py's pair: a shifted texture plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W + 24), np.uint8)
    left = base[:, 12: 12 + W].copy()
    right = base[:, 7: 7 + W].copy()
    right = np.clip(right.astype(np.int32) + rng.integers(-4, 5, right.shape),
                    0, 255).astype(np.uint8)
    return left, right


def _cfg(num_paths, **kw):
    base = dict(kind="sgm", num_disparities=16, block_size=5, num_paths=num_paths,
                pre_filter_cap=0, p1=200, p2=800, uniqueness_ratio=10,
                disp12_max_diff=1, speckle_window_size=50, speckle_range=2)
    base.update(kw)
    return base


#: name -> (pair seed, (H, W), matcher config, row_block)
SPECS = {
    "8-path rb 6": (1, (48, 80), _cfg(8), 6),
    "5-path rb 6": (2, (48, 80), _cfg(5), 6),
    "4-path default rb": (3, (32, 64), _cfg(4, p1=120, p2=500, uniqueness_ratio=0,
                                             disp12_max_diff=-1,
                                             speckle_window_size=0), None),
    # W1 = 12: 3 columns a tile at 4 tiles, far below margin + D + 2
    "4-path narrow": (4, (24, 28), _cfg(4, block_size=3, pre_filter_cap=31, p1=72,
                                         p2=288, uniqueness_ratio=5,
                                         disp12_max_diff=-1,
                                         speckle_window_size=0), 3),
    "8-path minD -8": (5, (48, 80), _cfg(8, min_disparity=-8), 6),
    "8-path D=128 default rb": (6, (16, 256), _cfg(8, num_disparities=128,
                                                   pre_filter_cap=63, p1=600,
                                                   p2=2400, speckle_range=32), None),
}
INPUTS = {name: _pair(seed, *hw) for name, (seed, hw, _, _) in SPECS.items()}
CASES = [("exact", dict(mesh=mesh, left=INPUTS[name][0], right=INPUTS[name][1],
                        cfg=cfg, row_block=rb))
         for name, (_, _, cfg, rb) in SPECS.items() for mesh in ("a", "b")]


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(4, MESHES, CASES)


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("mesh", ["a", "b"])
def test_exact_tiled_equals_single_device(ranks, name, mesh):
    left, right = INPUTS[name]
    jcfg = JMatcherConfig(backend="xla", **SPECS[name][2])
    ref = np.asarray(jax.jit(lambda a, b: jstereo_sgbm(a, b, jcfg))(
        jnp.asarray(left), jnp.asarray(right)))
    i = [k for k, (_, kw) in enumerate(CASES)
         if kw["mesh"] == mesh and kw["left"] is left][0]
    for r in ranks:
        got = r[i]
        assert got["disp"].dtype == ref.dtype and got["disp"].shape == ref.shape
        np.testing.assert_array_equal(got["disp"], ref)
        # on the CPU the scans run their plain version: no kernel launch
        assert got["card_launches"] == 0
