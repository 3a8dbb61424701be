"""Port parity: the speckle filter. The value-edge components against the JAX
XLA loop (capped and not), the plain K7 and K10 against the Pallas
histograms in interpret mode (K7: the count <= max_size decision; K10: exact
counts), the plain speckle decision, K2 broadcast and apply against the
reference's forced TPU path, `component_small` against it on a snake where
the round cap binds, and `filter_speckles` (alone and inside stereo_bm)
against the JAX CPU path on converging inputs. Integer, bit-exact."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rt_depth_map_tpu.config import MatcherConfig as JMatcherConfig
from rt_depth_map_tpu.ops import bm as jbm
from rt_depth_map_tpu.ops.cc import component_small as j_component_small
from rt_depth_map_tpu.ops.cc import connected_components_scan as j_cc_scan
from rt_depth_map_tpu.ops.pallas.histogram import (
    label_histogram_banded as pallas_banded,
)
from rt_depth_map_tpu.ops.pallas.histogram import (
    label_histogram_pallas as pallas_hist,
)
from rt_depth_map_tpu.ops.speckle import filter_speckles as j_filter_speckles
from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops import bm as tbm
from rt_depth_map_tpu_torch.ops.cc import (
    CC_MAX_ROUNDS,
    component_small,
    connected_components_scan,
    value_edges,
)
from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import seg_min_propagate_plain
from rt_depth_map_tpu_torch.ops.cuda.histogram import (
    label_histogram,
    label_histogram_banded,
    label_histogram_plain,
    speckle_apply,
    speckle_apply_plain,
    speckle_decision,
    speckle_decision_plain,
)
from rt_depth_map_tpu_torch.ops.speckle import filter_speckles
from torch_helpers import cuda_or_skip, snake, stereo_pair, t


def _blob_disparity(seed, H, W, n=10):
    """Rectangles of constant disparity (x16) over an invalid background,
    plus isolated valid specks: every component converges in a few sweeps."""
    rng = np.random.default_rng(seed)
    disp = np.full((H, W), -16, np.int16)
    for _ in range(n):
        y, x = rng.integers(0, H - 4), rng.integers(0, W - 4)
        h, w = rng.integers(2, 14, 2)
        disp[y: y + h, x: x + w] = rng.integers(0, 64) * 16
    specks = rng.random((H, W)) < 0.03
    disp[specks] = rng.integers(0, 64 * 16, specks.sum())
    return disp


def _snake_disp(H, W, arms):
    """A one-pixel serpentine of one disparity: each turn costs a sweep, so
    `arms` > CC_MAX_ROUNDS turns defeat the round cap."""
    return np.where(snake(H, W, arms) > 0, 32, -16).astype(np.int16)


@pytest.mark.parametrize("max_rounds", [2, CC_MAX_ROUNDS, None])
def test_value_edge_labels_match_xla(max_rounds):
    disp = _snake_disp(64, 96, 12)
    disp[40:50, 20:30] = 48  # a second component, joined to none
    act = disp != -16
    ref = np.asarray(j_cc_scan(jnp.asarray(disp), jnp.asarray(act), 16, 4,
                               max_rounds=max_rounds))
    got = connected_components_scan(t(disp), t(act), 16, max_rounds=max_rounds)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed,max_size", [(0, 6), (1, 25), (2, 100)])
def test_k7_plain_decides_like_pallas_banded(seed, max_size):
    H, W = 40, 256
    disp = _blob_disparity(seed, H, W)
    act = disp != -16
    labels = connected_components_scan(t(disp), t(act), 16)
    ref = np.asarray(pallas_banded(jnp.asarray(labels.numpy()),
                                   jnp.asarray(act), max_size, interpret=True))
    got = label_histogram_banded(labels, t(act), max_size).numpy()
    roots = act & (labels.numpy() == np.arange(H * W).reshape(H, W))
    np.testing.assert_array_equal(got[roots] <= max_size, ref[roots] <= max_size)
    small = roots & (got <= max_size)
    np.testing.assert_array_equal(got[small], ref[small])  # exact when small
    assert (roots & (got > max_size)).any() and small.any()


def test_k10_plain_counts_like_pallas():
    H, W = 32, 128
    disp = _blob_disparity(5, H, W)
    act = disp != -16
    labels = connected_components_scan(t(disp), t(act), 16)
    ref = np.asarray(pallas_hist(jnp.asarray(labels.numpy()), jnp.asarray(act),
                                 interpret=True))
    got = label_histogram(labels, t(act))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(got.sum()) == int(act.sum())


def test_component_small_matches_forced_pallas_path_under_the_cap():
    """On a snake the 16-sweep cap stops both propagations short of their
    fixed point; the port follows the reference's TPU path exactly there.
    The fragment holding the snake's root counts 2097 of its 3141 pixels,
    so with max_size 2500 the root is small, and its decision reaches only
    the pixels the capped broadcast gets to."""
    H, W = 96, 128
    disp = _snake_disp(H, W, 24)
    act = disp != -16
    labels = connected_components_scan(t(disp), t(act), 16)
    full = connected_components_scan(t(disp), t(act), 16, max_rounds=None)
    assert not torch.equal(labels, full)  # the cap binds
    ref = np.asarray(j_component_small(
        jnp.asarray(labels.numpy()), jnp.asarray(act), jnp.asarray(disp), 16,
        2500, 4, interpret=True, force_pallas=True, max_rounds=CC_MAX_ROUNDS))
    got = component_small(labels, t(act), value_edges(t(disp), t(act), 16), 2500)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.any() and (act & ~got.numpy()).any()


def _decision_case(case):
    """(disp, max_diff) of a decision case: blobs from a seed, or one
    component covering the frame (a single root)."""
    if case == "one component":
        return np.full((40, 128), 48, np.int16), 16
    return _blob_disparity(int(case[-1]), 40, 128), 16


@pytest.mark.parametrize("case,max_size", [
    ("seed 0", 6), ("seed 1", 25), ("seed 2", 100), ("seed 3", 0),
    ("one component", 100), ("one component", 40 * 128),
])
def test_speckle_decision_and_apply_plain_match_forced_pallas(case, max_size):
    """`speckle_decision_plain`, the plain K2 broadcast and
    `speckle_apply_plain` against the reference's TPU path
    (`component_small` with the Pallas histogram and sweep in interpret
    mode) and the filter's final select."""
    disp, max_diff = _decision_case(case)
    act = disp != -16
    labels = connected_components_scan(t(disp), t(act), max_diff)
    field = speckle_decision_plain(labels, t(act), max_size)
    allowed_h, allowed_v = value_edges(t(disp), t(act), max_diff)
    field = seg_min_propagate_plain(field, t(act), allowed_h, allowed_v,
                                    max_rounds=CC_MAX_ROUNDS)
    ref = np.asarray(j_component_small(
        jnp.asarray(labels.numpy()), jnp.asarray(act), jnp.asarray(disp), max_diff,
        max_size, 4, interpret=True, force_pallas=True, max_rounds=CC_MAX_ROUNDS))
    np.testing.assert_array_equal(act & (field.numpy() == 0), ref)
    got = speckle_apply_plain(t(disp), field, -16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jnp.where(jnp.asarray(ref), jnp.int16(-16), jnp.asarray(disp))))
    # the entries run their plain versions on CPU tensors
    assert torch.equal(speckle_decision(labels, t(act), max_size),
                       speckle_decision_plain(labels, t(act), max_size))
    assert torch.equal(speckle_apply(t(disp), field, -16), got)
    if case == "one component":
        assert ref.all() == (max_size >= disp.size)


@pytest.mark.parametrize("seed,max_size,max_diff", [(0, 40, 512), (3, 20, 16),
                                                    (4, 6, 0)])
def test_filter_speckles_matches_jax(seed, max_size, max_diff):
    disp = _blob_disparity(seed, 48, 160)
    ref = np.asarray(j_filter_speckles(jnp.asarray(disp), -16, max_size,
                                       max_diff))
    got = filter_speckles(t(disp), -16, max_size, max_diff)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != disp).any() and (ref != -16).any()


def test_stereo_bm_with_speckle_matches_jax():
    """The BM matcher at its defaults: the speckle filter is on."""
    H, W = 40, 160
    left, right = stereo_pair(17, H, W, 9)
    cfg = MatcherConfig(kind="bm", num_disparities=32, block_size=9)
    assert cfg.speckle_window_size > 0
    jcfg = JMatcherConfig(**{**dataclasses.asdict(cfg), "backend": "xla"})
    # the reference as one compiled program (no eager per-op dispatch)
    j_stereo_bm = jax.jit(jbm.stereo_bm, static_argnums=2)
    ref = np.asarray(j_stereo_bm(jnp.asarray(left), jnp.asarray(right), jcfg))
    got = tbm.stereo_bm(t(left), t(right), cfg)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != -16).any()


def test_speckle_runs_plain_on_cpu():
    disp = _blob_disparity(7, 24, 64)
    reset_launch_counts()
    got = filter_speckles(t(disp), -16, 10, 16)
    assert torch.equal(got, filter_speckles(t(disp), -16, 10, 16, plain=True))
    assert all(w.launches == 0 for w, _, _ in KERNELS)


@pytest.mark.cuda
def test_histogram_and_speckle_kernels_match_plain_on_cuda():
    dev = cuda_or_skip()
    disp = t(_blob_disparity(8, 120, 300), dev)
    act = disp != -16
    labels = connected_components_scan(disp, act, 16)
    ref = label_histogram_plain(labels, act)
    assert torch.equal(label_histogram(labels, act), ref)
    assert torch.equal(label_histogram_banded(labels, act, 100), ref)
    assert torch.equal(filter_speckles(disp, -16, 100, 16),
                       filter_speckles(disp, -16, 100, 16, plain=True))
