"""The port's `parallel/` on a world of 4 gloo ranks at device "cpu"
against the JAX package on the 8 virtual CPU devices (tests/conftest.py):
the rank mesh and the RTDM_* bootstrap, width-tiled BM at 2 and 4 tiles and
its halo guard, and the margin-mode tiled SGM's halo guard. Bit for bit:
tiled BM against JAX `stereo_bm` (and JAX's own `tiled_stereo_bm` at 2
tiles). The margin mode itself: tests/test_torch_parallel_margin.py.

One spawned world runs every case (`tests/torch_parallel_workers.py`: the
ranks import no JAX, and a deadline kills a world that hangs); the shapes
and inputs are those of tests/test_parallel.py and tests/test_tiled_sgbm.py.
Meshes: "a" is (1, 4), four tiles; "b" is (2, 2), two space groups of two
tiles that run the same case side by side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_depth_map_tpu.config import MatcherConfig as JMatcherConfig
from rt_depth_map_tpu.ops.bm import stereo_bm as jstereo_bm
from rt_depth_map_tpu.parallel import make_mesh as jmake_mesh
from rt_depth_map_tpu.parallel import tiled_stereo_bm as jtiled_stereo_bm
from rt_depth_map_tpu_torch.parallel import make_mesh
from rt_depth_map_tpu_torch.parallel.launch import distributed_init
from rt_depth_map_tpu_torch.parallel.tiled_bm import (
    _all_gather_cols,
    _halo_from_left,
    _halo_from_right,
)
from torch_helpers import row_blur_pair as stereo_pair
from torch_parallel_workers import run_ranks

MESHES = [("a", (1, 4)), ("b", (2, 2))]


BM = dict(num_disparities=32, block_size=9)
BM_LR = dict(num_disparities=16, block_size=9, disp12_max_diff=1,
             speckle_window_size=50, speckle_range=32)
INPUTS = {
    "bm": stereo_pair(0, 64, 256, 7),
    "bm_lr": stereo_pair(3, 16, 256, 7),
    "bm_guard": stereo_pair(1, 32, 128, 5),
    "sgm_guard": stereo_pair(1, 32, 256, 5),
}
CASES = [
    ("world", dict(mesh="b")),
    ("tiled_bm", dict(mesh="a", left=INPUTS["bm"][0], right=INPUTS["bm"][1], cfg=BM)),
    ("tiled_bm", dict(mesh="b", left=INPUTS["bm"][0], right=INPUTS["bm"][1], cfg=BM)),
    ("tiled_bm", dict(mesh="b", left=INPUTS["bm_lr"][0], right=INPUTS["bm_lr"][1],
                      cfg=BM_LR)),
    ("halo_guard", dict(mesh="a", kind="bm", left=INPUTS["bm_guard"][0],
                        right=INPUTS["bm_guard"][1],
                        cfg=dict(num_disparities=64, block_size=9))),
    ("halo_guard", dict(mesh="a", kind="sgm", left=INPUTS["sgm_guard"][0],
                        right=INPUTS["sgm_guard"][1],
                        cfg=dict(kind="sgm", num_disparities=64, block_size=5,
                                 num_paths=4, pre_filter_cap=0))),
]


@pytest.fixture(scope="module")
def ranks():
    """Each rank's case results, in CASES order."""
    return run_ranks(4, MESHES, CASES)


def _results(ranks, i):
    return [r[i] for r in ranks]


def _jax_bm(left, right, cfg):
    return np.asarray(jax.jit(lambda a, b: jstereo_bm(a, b, cfg))(
        jnp.asarray(left), jnp.asarray(right)))


def test_distributed_init_single_process(monkeypatch):
    for var in ("RTDM_COORDINATOR", "RTDM_NUM_PROCESSES", "RTDM_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_init(device="cpu") is False
    monkeypatch.setenv("RTDM_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("RTDM_NUM_PROCESSES", "1")
    assert distributed_init(device="cpu") is False
    assert distributed_init("127.0.0.1:1", 1, 0, device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_one_rank_mesh_without_process_group():
    """A world of one rank with no process group: a (1, 1) mesh whose
    collectives are the identity (and the edge's zeros)."""
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "space": 1}
    assert mesh.axis_index("space") == 0 and mesh.group("space") is None
    x = torch.arange(12, dtype=torch.int16).reshape(3, 4)
    assert torch.equal(_all_gather_cols(x, mesh, "space"), x)
    assert torch.equal(_halo_from_left(x, 2, mesh, "space"), torch.zeros((3, 2), dtype=torch.int16))
    assert torch.equal(_halo_from_right(x, 3, mesh, "space"), torch.zeros((3, 3), dtype=torch.int16))
    with pytest.raises(ValueError, match="ranks"):
        make_mesh((2, 1))


def test_world_from_rtdm_environment(ranks):
    """The ranks came up through RTDM_COORDINATOR / _NUM_PROCESSES /
    _PROCESS_ID on gloo; rank = data index * 2 + space index."""
    for r, got in enumerate(_results(ranks, 0)):
        assert got == {"rank": r, "world": 4, "backend": "gloo",
                       "index": (r // 2, r % 2), "shape": (2, 2)}


@pytest.mark.parametrize("case,n", [(1, 4), (2, 2)])
def test_tiled_bm_bit_exact(ranks, case, n):
    left, right = INPUTS["bm"]
    ref = _jax_bm(left, right, JMatcherConfig(**BM))
    for got in _results(ranks, case):
        np.testing.assert_array_equal(got["disp"], ref)
    if n == 2:
        mesh = jmake_mesh((1, 2), devices=jax.devices()[:2])
        np.testing.assert_array_equal(np.asarray(jtiled_stereo_bm(
            jnp.asarray(left), jnp.asarray(right), JMatcherConfig(**BM), mesh)), ref)


def test_tiled_bm_lr_check_and_speckle(ranks):
    """The gathered LR check (K6's BM entry) and speckle filter keep the
    tile-vs-single parity (tests/test_parallel.py's Pallas-shape case)."""
    left, right = INPUTS["bm_lr"]
    ref = _jax_bm(left, right, JMatcherConfig(**BM_LR))
    for got in _results(ranks, 3):
        np.testing.assert_array_equal(got["disp"], ref)


def test_tiled_bm_halo_guard(ranks):
    for got in _results(ranks, 4):
        assert "halo" in got["raised"]


def test_tiled_sgbm_halo_guard(ranks):
    for got in _results(ranks, 5):
        assert "halo" in got["raised"]
