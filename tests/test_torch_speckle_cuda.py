"""K7 on the card: the speckle filter's size decision (`speckle_decision`,
count + decision in place), the counts (`label_histogram_banded`,
`label_histogram`) and the final apply (`speckle_apply`) against their
plain versions, bit for bit, on the counts' hard cases (one root covering
the frame, every pixel a root, a cap-bound snake), frames whose width is
not a multiple of 4 and tensors that do not start on 16 bytes. The tests
need a CUDA device and skip without one; the file imports no JAX:

    python -m pytest --noconftest tests/test_torch_speckle_cuda.py -q -p no:randomly
"""

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cc import connected_components_scan
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
from torch_helpers import cuda_or_skip, snake, t

#: (case, H, W): disparity maps for the counts
CASES = [("blobs", 120, 300), ("blobs", 97, 301), ("constant", 720, 1280),
         ("constant", 33, 70), ("checkerboard", 64, 130), ("snake", 96, 128),
         ("blobs", 5, 3)]


def _disp(case, H, W, seed=0):
    rng = np.random.default_rng(seed + H * W)
    if case == "constant":
        return np.full((H, W), 48, np.int16)
    if case == "checkerboard":  # neighbours differ by more than max_diff
        return np.where(np.indices((H, W)).sum(0) % 2 == 0, 16, 1040).astype(np.int16)
    if case == "snake":
        return np.where(snake(H, W, 24) > 0, 32, -16).astype(np.int16)
    disp = np.full((H, W), -16, np.int16)
    for _ in range(max(1, H * W // 400)):
        y, x = rng.integers(0, H), rng.integers(0, W)
        h, w = rng.integers(1, 20, 2)
        disp[y: y + h, x: x + w] = rng.integers(0, 64) * 16
    specks = rng.random((H, W)) < 0.05
    disp[specks] = rng.integers(0, 64 * 16, specks.sum())
    return disp


def _offset(x, dev):
    """x on the card in a tensor that starts one element past its storage."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    view = flat[1:].view(x.shape)
    view.copy_(x.to(dev))
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("case,H,W", CASES)
@pytest.mark.parametrize("offset", [False, True])
def test_speckle_kernels_match_plain_on_cuda(case, H, W, offset):
    dev = cuda_or_skip()
    disp = t(_disp(case, H, W), dev)
    act = disp != -16
    labels = connected_components_scan(disp, act, 16)
    if offset:
        labels, act, disp = (_offset(x, dev) for x in (labels, act, disp))
        assert labels.data_ptr() % 16 != 0
    counts = label_histogram_plain(labels, act)
    assert torch.equal(label_histogram(labels, act), counts)
    assert torch.equal(label_histogram_banded(labels, act, 100), counts)
    for max_size in (0, 1, 20, H * W):
        before = speckle_decision.launches
        field = speckle_decision(labels, act, max_size)
        assert speckle_decision.launches == before + 1
        assert torch.equal(field, speckle_decision_plain(labels, act, max_size)), max_size
    rng = np.random.default_rng(H + W)
    fld = t(rng.choice(np.array([0, 1, 2**30], np.int32), size=(H, W)), dev)
    if offset:
        fld = _offset(fld, dev)
    assert torch.equal(speckle_apply(disp, fld, -16), speckle_apply_plain(disp, fld, -16))


@pytest.mark.cuda
@pytest.mark.parametrize("case,H,W", CASES[:4])
def test_filter_speckles_kernels_match_plain_on_cuda(case, H, W):
    dev = cuda_or_skip()
    disp = t(_disp(case, H, W, seed=1), dev)
    for max_size in (10, 100):
        assert torch.equal(filter_speckles(disp, -16, max_size, 16),
                           filter_speckles(disp, -16, max_size, 16, plain=True))
