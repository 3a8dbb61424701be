"""K2 and K5 on the card: the cooperative-launch kernels against their plain
versions. K2 (`csrc/cc_sweep.cu`) loops over the trips on the device; K5
(`csrc/sgm_vert_wta.cu`) hands diagonal carries between bands of columns.
Every test needs a CUDA device and skips without one; the file imports no
JAX, so it also runs on a machine with the card (whose Python has no JAX,
hence no conftest):

    python -m pytest --noconftest tests/test_torch_cooperative.py -q -p no:randomly
"""

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cc import CC_MAX_ROUNDS, connected_components_bbox
from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import seg_min_propagate
from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import (
    MAX_BAND_COLS,
    band_cols,
    sgm_vert_wta,
    sgm_vert_wta_plain,
)
from torch_helpers import blob_mask, cuda_or_skip, snake, t

P1, P2, UR = 600, 2400, 10


def _volumes(seed, H, W1, D, dtype, dev):
    rng = np.random.default_rng(seed)
    C = t(rng.integers(0, 3000, (H, W1, D)).astype(np.int32), dev).to(dtype)
    Sh = t(rng.integers(-5000, 20000, (H, W1, D)).astype(np.int32), dev)
    return C, Sh


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(32, torch.int16), (64, torch.int16),
                                     (128, torch.int16), (200, torch.int16),
                                     (256, torch.int16), (256, torch.int32)])
def test_vert_wta_band_edges_and_ragged_band(D, dtype):
    """More columns than SMs, so bands hold several columns and hand carries
    across their edges; W1 leaves the last band ragged."""
    dev = cuda_or_skip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    W1 = 2 * sms + 1
    cols = band_cols(W1, dev)
    assert cols > 1 and W1 % cols != 0
    C, Sh = _volumes(D, 12, W1, D, dtype, dev)
    got = sgm_vert_wta(C, Sh, P1, P2, UR)
    ref = sgm_vert_wta_plain(C, Sh, P1, P2, UR)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("W1", [1, 5, 31])
def test_vert_wta_one_column_bands(W1):
    """Fewer columns than SMs: one-column bands, whose warp is both edges."""
    dev = cuda_or_skip()
    assert band_cols(W1, dev) == 1
    C, Sh = _volumes(W1, 9, W1, 64, torch.int16, dev)
    for g, r in zip(sgm_vert_wta(C, Sh, P1, P2, UR),
                    sgm_vert_wta_plain(C, Sh, P1, P2, UR)):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_vert_wta_refuses_bands_that_cannot_be_resident():
    """More bands than any card could hold at once: the cooperative launch is
    refused and the wrapper raises."""
    dev = cuda_or_skip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    W1 = MAX_BAND_COLS * 4 * sms + 1  # at most 2048 threads per SM
    C, Sh = _volumes(0, 2, W1, 32, torch.int16, dev)
    with pytest.raises(RuntimeError, match="sgm_vert_wta"):
        sgm_vert_wta(C, Sh, P1, P2, UR)
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [CC_MAX_ROUNDS, 2, None])
def test_cc_capped_trip_on_the_device(rounds):
    """A snake that needs more than the cap: the sweep count, read from the
    device after a synchronise, stops at the cap, and the labels equal the
    plain loop's."""
    dev = cuda_or_skip()
    active = t(snake(96, 48, 24) != 0, dev)
    got = connected_components_bbox(active, 8, max_rounds=rounds)
    torch.cuda.synchronize()
    sweeps = int(seg_min_propagate.last_rounds)
    ref = connected_components_bbox(active, 8, max_rounds=rounds, plain=True)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if rounds is None:
        assert sweeps > CC_MAX_ROUNDS
    else:
        assert sweeps == rounds


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(48, 64), (37, 200), (720, 1280)])
def test_cc_four_fields_and_value_edges(H, W):
    """The frame mask's four fields (8-connected) and one 4-connected field,
    against the plain loop, at a width of several column tiles."""
    dev = cuda_or_skip()
    active = t(blob_mask(H, H, W, n_blobs=9, noise=0.02) != 0, dev)
    for g, r in zip(connected_components_bbox(active, 8),
                    connected_components_bbox(active, 8, plain=True)):
        assert torch.equal(g, r)
    idx = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(H, W)
    ah, av = active[:, :-1] & active[:, 1:], active[:-1] & active[1:]
    assert torch.equal(seg_min_propagate(idx, active, ah, av, max_rounds=4),
                       seg_min_propagate(idx.cpu(), active.cpu(), ah.cpu(),
                                         av.cpu(), max_rounds=4).to(dev))


@pytest.mark.cuda
def test_cc_refuses_a_field_too_tall_for_a_block():
    """A column tile of 2000 rows needs more shared memory than a block may
    have: the launch is refused and the wrapper raises."""
    dev = cuda_or_skip()
    with pytest.raises(RuntimeError, match="seg_min_propagate"):
        connected_components_bbox(torch.ones((2000, 8), dtype=torch.bool,
                                             device=dev), 8)
        torch.cuda.synchronize()
