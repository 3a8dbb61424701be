"""The exact width tiling's kernels, plain versions against the JAX
package: `sgm_tile_scan` (ops/cuda/sgm_tile.py) against the reference's
`_diag_core` and `_horiz_core` (rt_depth_map_tpu/parallel/exact_sgbm.py)
and `_aggregate_dir` (ops/sgbm.py) on random blocks and carries, in every
direction; `sgm_tile_final` against `_aggregate_dir` over the tile's
vertical directions and `wta_uniq_subpix`; K3's output column window
(`sgm_cost_volume(..., cols=...)`) against the sliced full volume and the
JAX cost volume. Every comparison is bit for bit. The kernels themselves
are held against these plain versions on the card (`chip_smoke.py` phase
3; tests/test_torch_sgm_tile_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_depth_map_tpu.ops import sgbm as jsgbm
from rt_depth_map_tpu.parallel.exact_sgbm import _diag_core, _horiz_core
from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (
    plane_stack,
    sgm_cost_volume,
    sgm_cost_volume_plain,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import (
    ScanJob,
    sgm_tile_final,
    sgm_tile_final_plain,
    sgm_tile_scan,
    sgm_tile_scan_plain,
)

P1, P2 = 72, 288
DIRS = [(0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)]

_jdiag = jax.jit(_diag_core, static_argnums=(3, 4))
_jhoriz = jax.jit(_horiz_core, static_argnums=(2, 3))


def _block(seed, R, W, D, dtype=np.int16):
    rng = np.random.default_rng(seed)
    C = rng.integers(0, 2000, (R, W, D)).astype(dtype)
    inbox = rng.integers(-300, 3000, (R + 1, D)).astype(np.int32)
    outbox = rng.integers(-300, 3000, (R + 1, D)).astype(np.int32)
    prev = rng.integers(-300, 3000, (W, D)).astype(np.int32)
    return C, inbox, outbox, prev


def _reference(C, inbox, outbox, prev, dy, dx):
    """The reference's step for direction (dy, dx) on a block: the block
    flipped into core space, its core scan, the results flipped back
    (exact_sgbm.py:255-284); prev in the core's column order."""
    up = dy == -1
    blk = C[::-1] if up else C
    if dx == -1:
        blk = blk[:, ::-1]
    blk = jnp.asarray(np.ascontiguousarray(blk))
    if dy == 0:
        Ls = np.asarray(_jhoriz(blk, jnp.asarray(inbox[1:]), P1, P2))
        new_prev = None
    else:
        inrows = inbox[1:][::-1] if up else inbox[:-1]
        core_prev = prev[::-1] if dx == -1 else prev
        Ls = np.asarray(_jdiag(blk, jnp.asarray(np.ascontiguousarray(inrows)),
                               jnp.asarray(np.ascontiguousarray(core_prev)), P1, P2))
        new_prev = Ls[-1][::-1] if dx == -1 else Ls[-1]
    brows = Ls[:, -1, :]
    out = (np.concatenate([brows[::-1], outbox[:1]]) if up
           else np.concatenate([outbox[-1:], brows]))
    Lg = Ls[:, ::-1] if dx == -1 else Ls
    Lg = Lg[::-1] if up else Lg
    return Lg, out, new_prev


@pytest.mark.parametrize("dy,dx", DIRS)
# int16 volumes, and an int32 one at D = 48 (on the card: C's pixels are
# whole 16-byte pieces, the ring path, 2 elements a lane)
@pytest.mark.parametrize("shape", [(6, 9, 16, np.int16), (5, 3, 40, np.int16),
                                   (4, 1, 7, np.int16), (5, 8, 48, np.int32)])
def test_scan_matches_reference_cores(dy, dx, shape):
    R, W, D, dtype = shape
    C, inbox, outbox, prev = _block(R * 100 + W, R, W, D, dtype)
    Lg, out_ref, prev_ref = _reference(C, inbox, outbox, prev, dy, dx)
    # the block sits at rows [2, 2 + R) of a taller tile, S starts nonzero
    rng = np.random.default_rng(7)
    S0 = rng.integers(-1000, 1000, (R + 4, W, D)).astype(np.int32)
    Ct = torch.from_numpy(np.zeros((R + 4, W, D), dtype))
    Ct[2: 2 + R] = torch.from_numpy(C)
    S = torch.from_numpy(S0.copy())
    job = ScanJob(dy, dx, 2, R, torch.from_numpy(inbox), torch.from_numpy(outbox),
                  torch.from_numpy(prev))
    (out, new_prev), = sgm_tile_scan(Ct, S, [job], P1, P2)
    expect = S0.copy()
    expect[2: 2 + R] += Lg
    np.testing.assert_array_equal(S.numpy(), expect)
    np.testing.assert_array_equal(out.numpy(), out_ref)
    if dy == 0:
        assert new_prev is None
    else:
        np.testing.assert_array_equal(new_prev.numpy(), prev_ref)


@pytest.mark.parametrize("dy,dx", DIRS + [(1, 0), (-1, 0)])
def test_scan_over_the_tile_matches_aggregate_dir(dy, dx):
    """One job over all rows with no carries is the reference's
    single-device direction (zero border), int32 volume."""
    H, W, D = 11, 13, 24
    C = np.random.default_rng((dy + 1) * 3 + dx + 1).integers(0, 5000, (H, W, D)).astype(np.int32)
    ref = np.asarray(jax.jit(jsgbm._aggregate_dir, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(C), P1, P2, dy, dx))
    S = torch.zeros((H, W, D), dtype=torch.int32)
    sgm_tile_scan(torch.from_numpy(C), S, [ScanJob(dy, dx, 0, H)], P1, P2)
    np.testing.assert_array_equal(S.numpy(), ref)


def test_jobs_of_one_launch_add_up():
    """Several jobs of one launch over overlapping rows: S is their sum,
    whatever the order."""
    H, W, D = 12, 10, 8
    C = torch.from_numpy(np.random.default_rng(3).integers(0, 900, (H, W, D))
                         .astype(np.int16))
    jobs = [ScanJob(1, 0, 0, H), ScanJob(0, 1, 2, 4), ScanJob(-1, -1, 4, 6),
            ScanJob(1, 1, 0, 3)]
    S = torch.zeros((H, W, D), dtype=torch.int32)
    sgm_tile_scan(C, S, jobs, P1, P2)
    S2 = torch.zeros((H, W, D), dtype=torch.int32)
    for job in jobs[::-1]:
        sgm_tile_scan_plain(C, S2, [job], P1, P2)
    assert torch.equal(S, S2)


def _jfinal(C, S, dirs, ur):
    ref = np.asarray(S).copy()
    for dy, dx in dirs:
        ref += np.asarray(jax.jit(jsgbm._aggregate_dir, static_argnums=(1, 2, 3, 4))(
            jnp.asarray(C), P1, P2, dy, dx))
    return [np.asarray(t) for t in jax.jit(jsgbm.wta_uniq_subpix, static_argnums=1)(
        jnp.asarray(ref), ur)]


@pytest.mark.parametrize("dirs", [((1, 0),), ((1, 0), (-1, 0))])
@pytest.mark.parametrize("D,dtype", [(16, np.int16), (48, np.int16), (16, np.int32),
                                     (48, np.int32)])
def test_final_matches_aggregate_dir_and_wta(dirs, D, dtype):
    """The tile's vertical paths (the top-down one alone for 5 and 4 paths)
    and the winner-take-all: `sgm_tile_final`'s plain version against the
    reference's `_aggregate_dir` and `wta_uniq_subpix`."""
    H, W = 13, 11
    rng = np.random.default_rng(D + len(dirs))
    C = rng.integers(0, 2000, (H, W, D)).astype(dtype)
    S0 = rng.integers(0, 20000, (H, W, D)).astype(np.int32)
    ref = _jfinal(C, S0, dirs, 10)
    got = sgm_tile_final(torch.from_numpy(C), torch.from_numpy(S0.copy()), P1, P2, 10,
                         dirs)
    for g, r, name in zip(got, ref, ("best", "minS", "dval", "uniq")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), r.astype(np.int32), err_msg=name)


def test_final_refuses_other_directions_and_devices():
    C = torch.zeros((4, 3, 8), dtype=torch.int16)
    S = torch.zeros((4, 3, 8), dtype=torch.int32)
    for dirs in [((-1, 0),), ((1, 1),), ((1, 0), (1, 0))]:
        with pytest.raises(ValueError, match="directions"):
            sgm_tile_final_plain(C, S, P1, P2, 10, dirs)
    with pytest.raises(ValueError, match="unsupported device"):
        sgm_tile_final(C.to("meta"), S.to("meta"), P1, P2, 10, ((1, 0),))
    with pytest.raises(ValueError, match="unsupported device"):
        sgm_tile_scan(C.to("meta"), S.to("meta"), [ScanJob(0, 1, 0, 4)], P1, P2)


def _planes(seed, H, W):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (H, W), dtype=np.uint8)
    right = np.roll(left, 4, axis=1)
    return left, right


@pytest.mark.parametrize("D,bs,pcap,min_disp", [(16, 5, 0, 0), (8, 3, 31, -4),
                                                (12, 7, 15, 3)])
def test_cost_window_equals_sliced_volume(D, bs, pcap, min_disp):
    """Every tile of K3's window, edge tiles (the W1-space replicate border)
    included, equals the sliced full volume and the JAX volume."""
    H, W = 17, 60
    left, right = _planes(D + bs, H, W)
    lpl = plane_stack(torch.from_numpy(left), pcap)
    rpl = plane_stack(torch.from_numpy(right), pcap)
    C, minX1, W1 = sgm_cost_volume_plain(lpl, rpl, D, bs, torch.int32, min_disp)
    ref, jminX1, jW1 = jax.jit(jsgbm.sgbm_cost_volume, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(left), jnp.asarray(right), D, bs, min_disp, pcap)
    assert (minX1, W1) == (jminX1, jW1)
    np.testing.assert_array_equal(C.numpy(), np.asarray(ref))
    for x_begin, width in [(0, W1), (0, 1), (W1 - 1, 1), (0, 5), (W1 - 6, 6),
                           (3, W1 // 2)]:
        Cw, m, w1 = sgm_cost_volume(lpl, rpl, D, bs, torch.int32, min_disp,
                                    cols=(x_begin, width))
        assert (m, w1) == (minX1, W1)
        np.testing.assert_array_equal(Cw.numpy(), C[:, x_begin: x_begin + width].numpy())


def test_cost_window_refuses_columns_outside():
    lpl = plane_stack(torch.zeros((8, 40), dtype=torch.uint8), 0)
    for cols in [(-1, 4), (0, 0), (20, 9)]:  # W1 = 40 - 16 = 24
        with pytest.raises(ValueError, match="columns"):
            sgm_cost_volume(lpl, lpl, 16, 5, torch.int16, 0, cols=cols)
