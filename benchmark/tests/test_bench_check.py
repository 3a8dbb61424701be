"""The check that decides `correct`, on the CPU at small sizes: a sound run
of each cell passes it, the control fails it, and so does a run whose timed
path is broken underneath (the harness's look for a card skipped)."""

import time

import numpy as np
import pytest
import torch

from benchmark.control import CONTROLS, control_numbers
from benchmark.harness import cell as cells
from benchmark.harness import check
from benchmark.tests.small import manifest, overrides

SECONDS = {"sgbm-720p-d192.rig1": 6.0, "bm-1080p-d288.rig1": 6.0, "sgbm-720p-d192.rigs4": 12.0}


def _run(workload: str, seed: int) -> dict:
    return cells.run_cell(workload, seed, SECONDS[workload], False, time.perf_counter(),
                          device="cpu", manifest=manifest(), overrides=overrides(workload))


@pytest.mark.parametrize("workload", sorted(SECONDS))
def test_sound_run_is_correct(workload):
    r = _run(workload, 2**31 + 11)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert sum(r["timing"]["frames_each_s"]) == r["attempted"]
    assert list(r)[-1] == "checks"
    assert all(c["value"] is not None for c in r["checks"].values())


@pytest.mark.parametrize("workload", ["sgbm-720p-d192.rig1", "bm-1080p-d288.rig1"])
def test_control_fails_the_check(workload):
    for seed in (1, 2**31 + 3, 987654321):
        readings, limits = control_numbers(workload, seed, "cpu", manifest=manifest(),
                                           controls=CONTROLS, overrides=overrides(workload))
        for c, numbers in readings.items():
            assert not check.verdict(numbers, limits)[0], (c, numbers)
        assert readings[("whole_pixels",)]["disparity_px"] > 0
        assert readings[("bfloat16",)]["disparity_px"] == 0
        assert readings[("bfloat16",)]["depth_rel"] > limits["depth_rel"]


def _stale(monkeypatch, name):
    from rt_depth_map_tpu_torch.pipeline.engine import Engine

    real = getattr(Engine, name)
    first = {}

    def stale(self, *a, **k):
        out = real(self, *a, **k)
        return first.setdefault("out", out)

    monkeypatch.setattr(Engine, name, stale)


def _half_batch(monkeypatch):
    from rt_depth_map_tpu_torch.pipeline.engine import Engine

    real = Engine.batch_program

    def half(self, lefts, rights, *a, **k):
        n = len(lefts) // 2
        out = real(self, lefts[:n].contiguous(), rights[:n].contiguous(), *a, **k)
        return {key: None if v is None else torch.cat([v, v])[: len(lefts)]
                for key, v in out.items()}

    monkeypatch.setattr(Engine, "batch_program", half)


def _altered(monkeypatch):
    import rt_depth_map_tpu_torch.pipeline.engine as engine

    def alter(fn):
        def altered(*a, **k):
            d = fn(*a, **k).clone()
            d[..., d.shape[-2] // 2, d.shape[-1] // 2] += 16
            return d
        return altered

    for name in ("stereo_sgbm", "stereo_sgbm_batch", "stereo_bm"):
        monkeypatch.setattr(engine, name, alter(getattr(engine, name)))


FAULTS = {
    "state_unchanged": lambda mp, wl: _stale(
        mp, "batch_program" if wl.endswith("rigs4") else "frame_program"),
    "half_batch": lambda mp, wl: _half_batch(mp),
    "answer_altered": lambda mp, wl: _altered(mp),
}
CASES = [("sgbm-720p-d192.rig1", "state_unchanged"), ("sgbm-720p-d192.rig1", "answer_altered"),
         ("bm-1080p-d288.rig1", "answer_altered"), ("sgbm-720p-d192.rigs4", "state_unchanged"),
         ("sgbm-720p-d192.rigs4", "half_batch"), ("sgbm-720p-d192.rigs4", "answer_altered")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch, workload)
    r = _run(workload, 2**31 + 11)
    assert r["attempted"] > 0
    assert not r["correct"], r["checks"]


def test_compare_counts_each_kind_of_difference():
    ref = {"disparity": np.zeros((4, 5), np.int16), "mask": np.zeros((4, 5), np.uint8),
           "rgb_rect": np.zeros((4, 5, 3), np.uint8),
           "boxes": np.array([[1, 2, 3, 4, 1], [0, 0, 0, 0, 0]], np.int32),
           "count": np.array([10, 0], np.int32),
           "depth_cm": np.array([100.0, np.nan], np.float32),
           "mean_z": np.array([40.0, np.nan], np.float32)}
    prog = {k: v.copy() for k, v in ref.items()}
    assert check.compare(prog, ref) == dict(disparity_px=0, mask_px=0, rgb_rect_px=0,
                                            boxes=0, count=0, depth_nan=0, depth_rel=0.0)
    prog["disparity"][1, 2] = 16
    prog["rgb_rect"][0, 0, 2] = 1
    prog["rgb_rect"][0, 1, :] = 1
    prog["boxes"][0, 0] = 2
    prog["count"][0] = 12
    prog["depth_cm"][0] = 100.5
    prog["mean_z"][1] = 3.0
    got = check.compare(prog, ref)
    assert got == dict(disparity_px=1, mask_px=0, rgb_rect_px=2, boxes=1, count=2,
                       depth_nan=1, depth_rel=pytest.approx(0.005))
    ok, rows = check.verdict(got, {"disparity_px": 0, "depth_rel": 0.01})
    assert not ok and rows[0] == ("disparity_px", 1, 0)
