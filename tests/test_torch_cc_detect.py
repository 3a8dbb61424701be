"""Port parity: K2 propagation (ops/cuda/cc_sweep.py), component boxes
(ops/cc.py) and detection (ops/detect.py) vs the JAX XLA path of
rt_depth_map_tpu/ops/cc.py and ops/detect.py. Integer, bit-exact, both where
the propagation converges and where the 16-sweep cap stops it short."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rt_depth_map_tpu.ops.cc import connected_components_bbox as jbbox
from rt_depth_map_tpu.ops.cc import connected_components_scan as jscan
from rt_depth_map_tpu.ops.detect import detect_objects as jdetect
from rt_depth_map_tpu.ops.detect import matching_region as jregion
from rt_depth_map_tpu_torch.ops.cc import CC_MAX_ROUNDS, connected_components_bbox
from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import (
    seg_min_propagate,
    seg_min_propagate_plain,
)
from rt_depth_map_tpu_torch.ops.detect import detect_objects, matching_region
from torch_helpers import blob_mask, cuda_or_skip, snake, t


def _masks():
    return {
        "blobs": blob_mask(0, 48, 64, n_blobs=7),
        "noisy": blob_mask(1, 48, 64, n_blobs=5, noise=0.08),
        "diagonal": np.eye(40, 56, dtype=np.uint8) * 255,
        "snake": snake(96, 48, 24),
    }


def _assert_bbox_equal(got, ref):
    for name, g, r in zip(("labels", "maxidx", "minx", "maxx"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("name,rounds", [
    ("blobs", CC_MAX_ROUNDS), ("blobs", None), ("noisy", CC_MAX_ROUNDS),
    ("noisy", 2), ("diagonal", CC_MAX_ROUNDS), ("snake", CC_MAX_ROUNDS),
    ("snake", 2), ("snake", None),
])
def test_bbox_matches_jax(name, rounds):
    active = _masks()[name] != 0
    ref = jbbox(jnp.asarray(active), 8, max_rounds=rounds)
    got = connected_components_bbox(t(active), 8, max_rounds=rounds)
    _assert_bbox_equal(got, ref)


def test_snake_cap_binds():
    """The snake does not converge within the cap: the capped labels differ
    from the fixed point, and the port still equals JAX (test above)."""
    active = t(snake(96, 48, 24) != 0)
    capped = connected_components_bbox(active, 8)[0]
    full = connected_components_bbox(active, 8, max_rounds=None)[0]
    assert not (capped == full).all()
    assert len(set(full[active].tolist())) == 1


@pytest.mark.parametrize("name", ["blobs", "snake"])
def test_four_connected_scan_matches_jax(name):
    """4-connectivity (no hop) through the general propagation entry point,
    with value edges, against connected_components_scan."""
    rng = np.random.default_rng(2)
    active = _masks()[name] != 0
    values = rng.integers(0, 3, size=active.shape).astype(np.int32)
    for rounds in (2, None):
        ref = np.asarray(jscan(jnp.asarray(values), jnp.asarray(active), 1, 4,
                               max_rounds=rounds))
        a, v = t(active), t(values)
        ah = a[:, :-1] & a[:, 1:] & ((v[:, :-1] - v[:, 1:]).abs() <= 1)
        av = a[:-1] & a[1:] & ((v[:-1] - v[1:]).abs() <= 1)
        H, W = active.shape
        idx = t(np.arange(H * W, dtype=np.int32).reshape(H, W))
        got = seg_min_propagate(idx, a, ah, av, max_rounds=rounds)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed,max_objects", [(0, 8), (1, 3), (2, 8)])
def test_detect_objects_matches_jax(seed, max_objects):
    mask = blob_mask(seed, 64, 96, n_blobs=10, noise=0.01)
    for min_size in (1, 40):
        ref = np.asarray(jdetect(jnp.asarray(mask), min_size, max_objects))
        got = detect_objects(t(mask), min_size, max_objects)
        np.testing.assert_array_equal(got.numpy(), ref)
        ref_roi = [int(v) for v in jregion(jnp.asarray(ref))]
        got_roi = [int(v) for v in matching_region(got)]
        assert got_roi == ref_roi


def _detect_case(name):
    """(mask, max_objects) for the top-k's edge cases."""
    if name == "more_roots":  # 64 dots, 8 kept; H*W = 4096, a multiple of 2048
        m = np.zeros((64, 64), np.uint8)
        m[2::8, 3::8] = 255
        return m, 8
    if name == "none":
        return np.zeros((48, 64), np.uint8), 8
    if name == "last_row":  # roots only in the last row, H*W = 2745
        m = np.zeros((45, 61), np.uint8)
        m[-1, 1::6] = 255
        return m, 4
    m = blob_mask(4, 45, 61, n_blobs=9, noise=0.02)  # H*W not a multiple of 2048
    return m, 5


@pytest.mark.parametrize("name", ["more_roots", "none", "last_row", "odd_size"])
def test_detect_objects_topk_cases_match_jax(name):
    mask, max_objects = _detect_case(name)
    valid = []
    for min_size in (1, 3):
        ref = np.asarray(jdetect(jnp.asarray(mask), min_size, max_objects))
        got = detect_objects(t(mask), min_size, max_objects)
        assert got.dtype == torch.int32 and got.shape == (max_objects, 5)
        np.testing.assert_array_equal(got.numpy(), ref)
        valid.append(int(got[:, 4].sum()))
    # one-pixel roots pass min_size 1 only
    assert valid == {"more_roots": [8, 0], "none": [0, 0],
                     "last_row": [4, 0]}.get(name, valid)


def test_matching_region_empty():
    boxes = np.zeros((8, 5), np.int32)
    assert [int(v) for v in matching_region(t(boxes))] == [0, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["blobs", "noisy", "snake"])
def test_cc_kernel_matches_plain_on_cuda(name):
    dev = cuda_or_skip()
    active = t(_masks()[name] != 0, dev)
    for rounds in (CC_MAX_ROUNDS, 2, None):
        got = connected_components_bbox(active, 8, max_rounds=rounds)
        ref = connected_components_bbox(active, 8, max_rounds=rounds, plain=True)
        for g, r in zip(got, ref):
            assert (g == r).all()


def test_plain_propagation_is_the_cpu_path():
    active = t(_masks()["blobs"] != 0)
    H, W = active.shape
    f = t(np.arange(H * W, dtype=np.int32).reshape(H, W))
    ah, av = active[:, :-1] & active[:, 1:], active[:-1] & active[1:]
    before = seg_min_propagate.launches
    a = seg_min_propagate(f, active, ah, av)
    b = seg_min_propagate_plain(f, active, ah, av)
    assert seg_min_propagate.launches == before
    assert (a == b).all()
