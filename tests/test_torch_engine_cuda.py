"""The batch program on the card (`Engine.process_batch`): four rigs a
step, each FrameResult equal to `process_pair` of its rig's pair on a
single-rig engine, field by field (the float fields to rtol 1e-5, as
tests/test_torch_batch_cuda.py holds the batch program to the frame
program). Both matchers; SGM-8 on its bidir route. The batch program runs
eagerly and `process_pair` replays its captured graphs from the second
frame on, so this is also a check of the replay against eager launches,
the setters' new capture included; K2's launches are counted on the batch
program, the eager path (a replay calls no wrapper). Needs the card: run
with `python3 -m pytest --noconftest` there (no JAX)."""

import numpy as np
import pytest

from rt_depth_map_tpu_torch import Engine
from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from rt_depth_map_tpu_torch.sources import MultiStreamSource, SyntheticStereoSource
from torch_helpers import cuda_or_skip

W, H, D, B = 640, 192, 64, 4
FIELDS = ("disparity", "boxes", "mask", "count", "rgb_rect", "depth_cm",
          "mean_z", "disparity_mean")


def _cfg(kind, batch):
    m = (MatcherConfig(kind="sgm", num_disparities=D, block_size=5,
                       pre_filter_cap=0) if kind == "sgm"
         else MatcherConfig(kind="bm", num_disparities=D))
    return EngineConfig(width=W, height=H, number_of_disparities=D, matcher=m,
                        batch=batch, show_disparity_value=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sgm", "bm"])
def test_four_rigs_process_batch_equals_process_pair(kind):
    cuda_or_skip()
    rigs = [SyntheticStereoSource(W, H, seed=s) for s in range(B)]
    eng = Engine(_cfg(kind, B), source=MultiStreamSource(rigs), device="cuda")
    single = Engine(_cfg(kind, 1), source=SyntheticStereoSource(W, H),
                    device="cuda")
    for step in range(3):
        pairs = [rig.render(step)[:2] for rig in rigs]
        reset_launch_counts()
        got = eng.process_batch([p[0] for p in pairs], [p[1] for p in pairs])
        launches = {w.__name__: w.launches for w, _, _ in KERNELS}
        assert launches["seg_min_propagate"] == 3 * B
        for b, (left, right) in enumerate(pairs):
            ref = single.process_pair(left, right)
            for k in FIELDS:
                a, r = getattr(got[b], k), getattr(ref, k)
                what = f"step {step} rig {b} {k}"
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(a, r, rtol=1e-5, err_msg=what)
                else:
                    np.testing.assert_array_equal(a, r, err_msg=what)
        if step == 1:  # a setter between steps reaches the batch program
            for e in (eng, single):
                e.set_hsv_thresholds([0, 100, 50], [15, 255, 255])
                e.set_min_object_size(400)
    assert any(r.has_objects for r in got)
