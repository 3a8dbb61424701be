"""K2 and K5, the cooperative-launch kernels: their plans on the CPU, and on
the card against their plain versions. K2 (`csrc/cc_sweep.cu`) loops over
the trips on the device, in chunks of a row or column where one does not
fit a block; K5 (`csrc/sgm_vert_wta.cu` on `csrc/sgm_vert.cuh`) hands
diagonal carries between bands of columns. The plans are pure functions
and run everywhere; every kernel test needs a CUDA device and skips without
one. The file imports no JAX, so it also runs on a machine with the card
(whose Python has no JAX, hence no conftest):

    python -m pytest --noconftest tests/test_torch_cooperative.py -q -p no:randomly
"""

import ctypes

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cc import (
    CC_MAX_ROUNDS,
    connected_components_bbox,
    connected_components_scan,
)
from rt_depth_map_tpu_torch.ops.cuda import _build
from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import (
    BIG,
    CC_MAX_CHUNKS,
    _run_min,
    cc_chunks,
    cc_col_bytes,
    cc_row_bytes,
    seg_min_propagate,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import (
    MAX_BAND_COLS,
    SMEM_LIMIT,
    VertPlan,
    k5_plan,
    sgm_vert_wta,
    sgm_vert_wta_plain,
    vert_plan,
    vert_smem_bytes,
)
from torch_helpers import blob_mask, cuda_or_skip, snake, t

P1, P2, UR = 600, 2400, 10


def _volumes(seed, H, W1, D, dtype, dev):
    rng = np.random.default_rng(seed)
    C = t(rng.integers(0, 3000, (H, W1, D)).astype(np.int32), dev).to(dtype)
    Sh = t(rng.integers(-5000, 20000, (H, W1, D)).astype(np.int32), dev)
    return C, Sh


# -- K5's band plan (a pure function) ---------------------------------------

@pytest.mark.parametrize("resident", [132, 114])
@pytest.mark.parametrize("W1", [1, 9, 1152, 1664, 2112, 2113, 3584, 3712])
@pytest.mark.parametrize("D,c_bytes,s_bytes", [(128, 2, 4), (256, 2, 2)])
def test_vert_plan_owns_every_column_once(resident, W1, D, c_bytes, s_bytes):
    """One resident block an SM on a 132- and a 114-SM card: the bands of
    warps * m contiguous columns cover 0..W1-1 once each (no band empty),
    every band is resident, a band holds at most 16 warps and fits a
    block's shared memory, and a warp takes one column while the width
    allows it."""
    plan = vert_plan(W1, D, resident, c_bytes, s_bytes)
    cols = plan.warps * plan.m
    owner = np.full(W1, -1)
    for band in range(plan.bands):
        for w in range(plan.warps):
            x = band * cols + w * plan.m + np.arange(plan.m)
            x = x[x < W1]
            assert (owner[x] == -1).all()
            owner[x] = band * plan.warps + w
    assert (owner >= 0).all()
    assert (plan.bands - 1) * cols < W1 <= plan.bands * cols
    assert plan.bands <= resident and 1 <= plan.warps <= MAX_BAND_COLS
    assert vert_smem_bytes(plan.warps, plan.m, D, c_bytes, s_bytes) <= SMEM_LIMIT
    assert (plan.m == 1) == (W1 <= MAX_BAND_COLS * resident)


def test_vert_plan_keeps_the_one_column_bands_of_k5():
    """Where one column a warp suffices the plan is K5's earlier one: the
    columns spread over every resident block (1280x720 at D = 128 on 132
    SMs: 128 bands of 9)."""
    assert vert_plan(1152, 128, 132) == VertPlan(m=1, warps=9, bands=128)
    assert vert_plan(5, 64, 132).bands == 5


def test_vert_plan_refuses_bands_beyond_shared_memory():
    """A band's carries live in shared memory: a width whose bands cannot
    hold them raises instead of launching."""
    with pytest.raises(ValueError, match="shared memory"):
        vert_plan(40000, 256, 132, 4, 4)


# -- K2's chunks (pure functions) ---------------------------------------------

@pytest.mark.parametrize("H,W", [(720, 1280), (1080, 1920), (2160, 3840),
                                 (1428, 8), (8, 2881), (1401, 2880),
                                 (1427, 2880)])
def test_cc_chunks_fit_a_block(H, W):
    """Whole rows and columns where they fit a block's 227 KiB (today's
    code path), else the longest chunks that do: rows in multiples of 32
    pixels, at most CC_MAX_CHUNKS of each."""
    wc, hc = cc_chunks(H, W, SMEM_LIMIT)
    fits_row = cc_row_bytes(W) <= SMEM_LIMIT
    fits_col = cc_col_bytes(H, False) <= SMEM_LIMIT
    assert (wc == W) == fits_row and (hc == H) == fits_col
    assert cc_row_bytes(wc) <= SMEM_LIMIT
    assert cc_col_bytes(hc, hc < H) <= SMEM_LIMIT
    if not fits_row:
        assert wc % 32 == 0 and cc_row_bytes(wc + 32) > SMEM_LIMIT
    if not fits_col:
        assert cc_col_bytes(hc + 1, True) > SMEM_LIMIT
    assert -(-W // wc) <= CC_MAX_CHUNKS and -(-H // hc) <= CC_MAX_CHUNKS
    assert fits_row == (W <= 2880) and fits_col == (H <= 1427)


def test_cc_chunks_refuse_more_than_the_carries_hold():
    with pytest.raises(ValueError, match="chunks"):
        cc_chunks(8, 33 * 2880, SMEM_LIMIT)


def _chunked_run_min(f, allowed, wc):
    """numpy emulation of K2's chunked row scan (`row_phase`): a first pass
    from the last chunk back builds the carry into each chunk from its
    right, then each chunk's backward scan starts from that carry and its
    forward scan from the forward value left of the chunk."""
    L = f.shape[0]
    right = np.append(allowed, False)        # edge (x, x + 1)
    left = np.insert(allowed, 0, False)      # edge (x - 1, x)
    starts = range(0, L, wc)
    carry_r, into = {}, BIG
    for x0 in reversed(starts):
        carry_r[x0] = into
        m = into
        for x in range(min(L, x0 + wc) - 1, x0 - 1, -1):
            m = f[x] if not right[x] else min(m, f[x])
        into = m
    out, carry_l = f.copy(), BIG
    for x0 in starts:
        x1 = min(L, x0 + wc)
        m = carry_r[x0]
        for x in range(x1 - 1, x0 - 1, -1):
            m = out[x] if not right[x] else min(m, out[x])
            out[x] = m
        m = carry_l
        for x in range(x0, x1):
            m = out[x] if not left[x] else min(m, out[x])
            out[x] = m
        carry_l = m
    return out


@pytest.mark.parametrize("wc", [1, 3, 32, 64, 95])
def test_chunked_run_min_emulation_matches_the_whole_row(wc):
    """The chunk carries give each pixel its run's minimum, as the
    unchunked scan does (`_run_min`), whatever the chunk width."""
    rng = np.random.default_rng(wc)
    L = 190
    f = rng.integers(0, 1000, L).astype(np.int32)
    allowed = rng.random(L - 1) < 0.8
    ref = _run_min(torch.from_numpy(f)[None, None],
                   torch.from_numpy(allowed)[None]).numpy()[0, 0]
    np.testing.assert_array_equal(_chunked_run_min(f, allowed, wc), ref)


# -- K5 on the card --------------------------------------------------------------

def _vert_launches(lib_name):
    return ctypes.c_int.in_dll(_build.load(lib_name), "rtdm_sgm_vert_kernel_launches")


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
    plan = k5_plan(W1, D, torch.empty((), dtype=dtype).element_size(), dev)
    cols = plan.warps * plan.m
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
    plan = k5_plan(W1, 64, 2, dev)
    assert plan.warps * plan.m == 1
    C, Sh = _volumes(W1, 9, W1, 64, torch.int16, dev)
    for g, r in zip(sgm_vert_wta(C, Sh, P1, P2, UR),
                    sgm_vert_wta_plain(C, Sh, P1, P2, UR)):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W1,D,dtype", [(48, 3712, 64, torch.int16),
                                          (12, 3712, 128, torch.int16),
                                          (6, 3584, 256, torch.int32),
                                          (2, 16 * 4 * 132 + 1, 32, torch.int16)])
def test_vert_wta_takes_widths_beyond_a_warp_a_column(H, W1, D, dtype):
    """W1 beyond 16 one-column warps on each SM, which the bands of one
    block an SM refused: more blocks resident an SM (D = 32, 64) or several
    columns a warp (3840x2160 at D = 128 and 256), and the result equals the
    plain version's."""
    dev = cuda_or_skip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = k5_plan(W1, D, torch.empty((), dtype=dtype).element_size(), dev)
    assert plan.m > 1 or plan.bands > sms
    C, Sh = _volumes(W1, H, W1, D, dtype, dev)
    for g, r in zip(sgm_vert_wta(C, Sh, P1, P2, UR),
                    sgm_vert_wta_plain(C, Sh, P1, P2, UR)):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_vert_wta_two_cuda_launches_a_call():
    dev = cuda_or_skip()
    C, Sh = _volumes(1, 8, 300, 64, torch.int16, dev)
    sgm_vert_wta(C, Sh, P1, P2, UR)
    count = _vert_launches("sgm_vert_wta")
    before = count.value
    sgm_vert_wta(C, Sh, P1, P2, UR)
    assert count.value - before == 2


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
@pytest.mark.parametrize("H,W", [(2160, 3840), (64, 2881), (1428, 96),
                                 (2000, 8)])
@pytest.mark.parametrize("rounds", [CC_MAX_ROUNDS, 2, None])
def test_cc_chunked_rows_and_columns(H, W, rounds):
    """Rows or columns longer than a block holds (W > 2880, H > 1427): the
    chunked phases give the plain loop's labels and sweep count, under the
    cap and at the fixed point, on the frame mask's four 8-connected fields
    and on one 4-connected field."""
    dev = cuda_or_skip()
    active = t(blob_mask(W + H, H, W, n_blobs=12, noise=0.02) != 0, dev)
    for g, r in zip(connected_components_bbox(active, 8, max_rounds=rounds),
                    connected_components_bbox(active, 8, max_rounds=rounds,
                                              plain=True)):
        assert torch.equal(g, r)
    idx = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(H, W)
    ah, av = active[:, :-1] & active[:, 1:], active[:-1] & active[1:]
    got = seg_min_propagate(idx, active, ah, av, max_rounds=rounds)
    torch.cuda.synchronize()
    sweeps = int(seg_min_propagate.last_rounds)
    ref = seg_min_propagate(idx.cpu(), active.cpu(), ah.cpu(), av.cpu(),
                            max_rounds=rounds).to(dev)
    assert torch.equal(got, ref)
    if rounds is not None:
        assert sweeps <= rounds


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(2160, 3840), (64, 2881), (1428, 96)])
def test_cc_chunked_snake_under_the_cap(H, W):
    """A snake whose turns cross chunk boundaries: the capped labels depend
    on every sweep's result, and equal the plain loop's."""
    dev = cuda_or_skip()
    active = t(snake(H, W, 24) != 0, dev)
    for rounds in (CC_MAX_ROUNDS, None):
        for g, r in zip(connected_components_bbox(active, 8, max_rounds=rounds),
                        connected_components_bbox(active, 8, max_rounds=rounds,
                                                  plain=True)):
            assert torch.equal(g, r)
    disp = torch.where(active, 32, -16).to(torch.int16)
    assert torch.equal(connected_components_scan(disp, active, 512),
                       connected_components_scan(disp, active, 512, plain=True))
