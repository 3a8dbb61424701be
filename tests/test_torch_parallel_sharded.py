"""The sharded frame step (`parallel/pipeline_sharded.py`) on a (2, 2) mesh
of 4 gloo ranks at device "cpu": two data groups of two frames each, each
frame's matcher tiled over a space group of two. With SGM-8 in exact tile
mode (the dryrun_multichip counterpart) and with BM, against the port's
single-device `Engine.process_pair` and the JAX package's
`make_sharded_step` on a (2, 2) mesh of its virtual CPU devices (the shapes
of tests/test_parallel.py). Disparity, boxes, mask and count bit for bit;
depth_cm and mean_z to rtol 1e-5 (float32 sums in another order).

The engine's BM matches inside the boxes' region (`matching_region`) where
the sharded step, as the reference's, matches the whole frame: the BM
step's disparity is held against the port's `stereo_bm` on the rectified
frames (no ROI) and the JAX step, its boxes against the engine.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rt_depth_map_tpu import config as jconfig
from rt_depth_map_tpu.parallel import make_mesh as jmake_mesh
from rt_depth_map_tpu.parallel.pipeline_sharded import (
    make_sharded_step as jmake_sharded_step,
)
from rt_depth_map_tpu_torch import Engine
from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
from rt_depth_map_tpu_torch.ops.bm import stereo_bm
from rt_depth_map_tpu_torch.ops.color import rgb_to_gray
from rt_depth_map_tpu_torch.sources import SyntheticStereoSource
from torch_parallel_workers import run_ranks

W, H, D, B = 320, 32, 32, 4
EXACT = ("disparity", "boxes", "mask", "count")
FLOAT = ("depth_cm", "mean_z")


def _cfg(kind):
    mcfg = MatcherConfig(kind=kind, num_disparities=D,
                         block_size=5 if kind == "sgm" else 13, num_paths=8,
                         pre_filter_cap=0 if kind == "sgm" else 31,
                         speckle_window_size=25, speckle_range=32,
                         disp12_max_diff=1, tile_mode="exact")
    return EngineConfig(width=W, height=H, number_of_disparities=D,
                        minimal_object_size=10, matcher=mcfg)


SRC = SyntheticStereoSource(W, H, seed=5, num_objects=1)
FRAMES = [SRC.render(i)[:2] for i in range(B)]
LEFTS = np.stack([f[0] for f in FRAMES])
RIGHTS = np.stack([f[1] for f in FRAMES])
Q = SRC.q_matrix()
KINDS = ("sgm", "bm")


@pytest.fixture(scope="module")
def ranks():
    cases = [("sharded_step", dict(mesh="m", lefts=LEFTS, rights=RIGHTS, Q=Q,
                                   engine_cfg=dataclasses.asdict(_cfg(kind))))
             for kind in KINDS]
    return run_ranks(4, [("m", (2, 2))], cases)


def _jax_step(kind):
    fields = dataclasses.asdict(_cfg(kind))
    fields["matcher"] = jconfig.MatcherConfig(**fields["matcher"])
    mesh = jmake_mesh((2, 2), devices=jax.devices()[:4])
    step, sharding = jmake_sharded_step(mesh, jconfig.EngineConfig(**fields), (W, H),
                                        Q=Q)
    out = step(jax.device_put(LEFTS, sharding), jax.device_put(RIGHTS, sharding))
    return {k: np.asarray(v) for k, v in out.items()}


def _rank_frames(ranks, i):
    """frame index -> its outputs, from every rank that holds it."""
    got = {}
    for r, res in enumerate(ranks):
        out = res[i]
        assert list(out["frames"]) == [2 * (r // 2), 2 * (r // 2) + 1]
        for j, f in enumerate(out["frames"]):
            got.setdefault(int(f), []).append({k: out[k][j] for k in EXACT + FLOAT})
    assert sorted(got) == list(range(B)) and all(len(v) == 2 for v in got.values())
    return got


@pytest.mark.parametrize("i,kind", list(enumerate(KINDS)))
def test_sharded_step_matches_engine_and_jax(ranks, i, kind):
    jout = _jax_step(kind)
    engine = Engine(_cfg(kind), source=SRC, device="cpu")
    for f, outs in _rank_frames(ranks, i).items():
        ref = engine.process_pair(*FRAMES[f])
        for got in outs:
            for k in EXACT:
                np.testing.assert_array_equal(got[k], jout[k][f], err_msg=k)
            for k in FLOAT:
                np.testing.assert_allclose(got[k], jout[k][f], rtol=1e-5, err_msg=k)
            for k in ("boxes", "mask"):
                np.testing.assert_array_equal(got[k], getattr(ref, k), err_msg=k)
            if kind == "sgm":
                np.testing.assert_array_equal(got["disparity"], ref.disparity)
                np.testing.assert_array_equal(got["count"], ref.count)
                for k in FLOAT:
                    np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5)
            else:
                l, r = (rgb_to_gray(torch.from_numpy(x)) for x in FRAMES[f])
                np.testing.assert_array_equal(
                    got["disparity"], stereo_bm(l, r, engine.matcher_config).numpy())
