"""Port parity: the chained SGM passes (K9a-K9d, K11). The plain versions of
`sgm_horiz_pass`, `sgm_vert_pass` and `sgm_final_wta` against the Pallas
kernels they replace, in interpret mode as tests/test_sgm_bidir.py and
tests/test_pallas_kernels.py run them; the route `stereo_sgbm` takes for
each path count and shape; the port's copy of the SGBM golden against the
original. Integer, bit-exact."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rt_depth_map_tpu.golden.sgbm import golden_stereo_sgbm as jgolden_stereo_sgbm
from rt_depth_map_tpu.ops import sgbm as jsg
from rt_depth_map_tpu.ops.pallas.sgm_hdw import (
    sgm_down_pass_hdw,
    sgm_final_wta_hdw,
    sgm_horiz_pass_dh,
    sgm_horiz_pass_hdw,
)
from rt_depth_map_tpu.ops.pallas.sgm_scan import sgm_aggregate_vertical
from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.golden import golden_stereo_sgbm
from rt_depth_map_tpu_torch.ops import sgbm as tsg
from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import (
    sgm_final_wta,
    sgm_final_wta_plain,
    sgm_horiz_pass,
    sgm_horiz_pass_plain,
    sgm_vert_pass,
    sgm_vert_pass_plain,
)
from torch_helpers import cuda_or_skip, stereo_pair, t

P1, P2 = 200, 801
DTYPES = {"int16": torch.int16, "int32": torch.int32}


def _cost(seed, shape, dtype, hi=2300):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, hi, shape)).to(dtype)


def _j(a: torch.Tensor, *perm):
    """The torch tensor as a JAX array, axes permuted."""
    return jnp.asarray(a.permute(*perm).contiguous().numpy())


# K9a: the TPU's x-major (W1, D, H); W1 = 24 keeps the kernel's interpret
# trace short (8 columns a block). The port scans the row-major volume.
@pytest.mark.parametrize("dtype,reverse,with_partial", [
    ("int16", False, False), ("int32", True, True)])
def test_horiz_pass_plain_matches_dh(dtype, reverse, with_partial):
    tdt = DTYPES[dtype]
    H, W1, D = 32, 24, 16
    C = _cost(1, (H, W1, D), tdt)
    partial = _cost(2, (H, W1, D), tdt) if with_partial else None
    ref = sgm_horiz_pass_dh(
        _j(C, 1, 2, 0), P1, P2, reverse=reverse, interpret=True,
        partial=None if partial is None else _j(partial, 1, 2, 0))
    got = sgm_horiz_pass_plain(C, P1, P2, reverse, partial)  # (H, W1, D)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), np.asarray(ref))


# K9b: (W1, H, D) on both sides, the shape of tests/test_pallas_kernels.py
@pytest.mark.parametrize("dtype,reverse,with_partial", [
    ("int16", False, False), ("int16", True, True), ("int32", False, True),
    ("int32", True, False)])
def test_horiz_pass_plain_matches_hdw(dtype, reverse, with_partial):
    tdt = DTYPES[dtype]
    W1, H, D = 64, 16, 128
    Ct = _cost(3, (W1, H, D), tdt, hi=1500)
    partial = _cost(4, (W1, H, D), tdt, hi=1500) if with_partial else None
    ref = sgm_horiz_pass_hdw(
        jnp.asarray(Ct.numpy()), 600, 2400, reverse=reverse, interpret=True,
        partial=None if partial is None else jnp.asarray(partial.numpy()))
    got = sgm_horiz_pass_plain(Ct, 600, 2400, reverse, partial, x_major=True)
    assert got.dtype == tdt and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_down_pass_plain_matches_pallas():
    """K9c: top-down with an int16 partial, (H, D, W1) on the TPU."""
    H, W1, D = 8, 128, 16
    C = _cost(5, (H, W1, D), torch.int16)
    Sh = _cost(6, (H, W1, D), torch.int16)
    ref = sgm_down_pass_hdw(_j(C, 0, 2, 1), P1, P2, partial=_j(Sh, 0, 2, 1),
                            interpret=True)
    got = sgm_vert_pass_plain(C, P1, P2, partial=Sh)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.permute(0, 2, 1).numpy(), np.asarray(ref))


@pytest.mark.parametrize("reverse", [False, True])
def test_vert_pass_plain_matches_aggregate_vertical(reverse):
    """K11: int32 (H, W1, D) with D % 128 == 0, both senses; with a partial
    bottom-up, without one top-down."""
    H, W1, D = 8, 16, 128
    C = _cost(7, (H, W1, D), torch.int32)
    partial = _cost(8, (H, W1, D), torch.int32) if reverse else None
    ref = sgm_aggregate_vertical(
        jnp.asarray(C.numpy()), P1, P2, reverse, interpret=True,
        partial=None if partial is None else jnp.asarray(partial.numpy()))
    got = sgm_vert_pass_plain(C, P1, P2, reverse, partial)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype,reverse", [("int16", True), ("int32", False)])
def test_final_wta_plain_matches_pallas(dtype, reverse):
    """K9d in both senses (H % 8 == 0, H >= 16, W1 = 128)."""
    tdt = DTYPES[dtype]
    H, W1, D = 16, 128, 16
    C = _cost(9, (H, W1, D), tdt)
    Sp = _cost(10, (H, W1, D), tdt)  # stand-in partial
    ref = sgm_final_wta_hdw(_j(C, 0, 2, 1), _j(Sp, 0, 2, 1), P1, P2, 10,
                            reverse=reverse, interpret=True)
    got = sgm_final_wta_plain(C, Sp, P1, P2, 10, reverse)
    for name, g, r in zip(("best", "minS", "dval", "uniq"), got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _j_vert3(C, partial, p1, p2, dy):
    """The JAX package's three directions of a sense (its XLA
    `_aggregate_dir`) added to a partial."""
    return partial + sum(jsg._aggregate_dir(C, p1, p2, dy, dx) for dx in (0, 1, -1))

_j_wta = jax.jit(jsg.wta_uniq_subpix, static_argnums=1)


# a volume wider than it is tall, so that the diagonals leave through the
# bottom row and enter through the side columns; D = 40 leaves lanes idle
WIDE = (6, 70, 40)


@pytest.mark.parametrize("dtype", ["int16", "int32"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_partial", [False, True])
def test_vert_pass_matches_jax_on_a_wide_volume(dtype, reverse, with_partial):
    """K9c/K11: `sgm_vert_pass` (on the CPU its plain version) against the
    JAX package's directions, both senses, with and without a partial."""
    tdt = DTYPES[dtype]
    C = _cost(14, WIDE, tdt)
    partial = _cost(15, WIDE, tdt, hi=5000) if with_partial else None
    base = partial if with_partial else torch.zeros(WIDE, dtype=tdt)
    ref = _j_vert3(jnp.asarray(C.numpy(), jnp.int32),
                   jnp.asarray(base.numpy(), jnp.int32), P1, P2,
                   -1 if reverse else 1).astype(C.numpy().dtype)
    got = sgm_vert_pass(C, P1, P2, reverse, partial)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got, sgm_vert_pass_plain(C, P1, P2, reverse, partial))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_partial", [False, True])
def test_final_wta_matches_jax_on_a_wide_volume(reverse, with_partial):
    """K9d: `sgm_final_wta` against the JAX package's directions and
    `wta_uniq_subpix`, both senses, on a partial and on a zero one."""
    C = _cost(16, WIDE, torch.int16)
    Sp = (_cost(17, WIDE, torch.int16, hi=5000) if with_partial
          else torch.zeros(WIDE, dtype=torch.int16))
    S = _j_vert3(jnp.asarray(C.numpy(), jnp.int32),
                 jnp.asarray(Sp.numpy(), jnp.int32), P1, P2,
                 -1 if reverse else 1)
    ref = _j_wta(S, 10)
    got = sgm_final_wta(C, Sp, P1, P2, 10, reverse)
    for name, g, r in zip(("best", "minS", "dval", "uniq"), got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int32),
                                      err_msg=name)


def test_chained_wrappers_run_plain_on_cpu():
    H, W1, D = 6, 10, 16
    C = _cost(11, (H, W1, D), torch.int16)
    reset_launch_counts()
    hf = sgm_horiz_pass(C, P1, P2)
    assert torch.equal(hf, sgm_horiz_pass_plain(C, P1, P2))
    Ct = C.transpose(0, 1).contiguous()
    assert torch.equal(sgm_horiz_pass(Ct, P1, P2, True, hf.transpose(0, 1).contiguous(),
                                      x_major=True).transpose(0, 1),
                       sgm_horiz_pass_plain(C, P1, P2, True, hf))
    Sa = sgm_vert_pass(C, P1, P2, partial=hf)
    assert torch.equal(Sa, sgm_vert_pass_plain(C, P1, P2, partial=hf))
    for g, r in zip(sgm_final_wta(C, Sa, P1, P2, 10),
                    sgm_final_wta_plain(C, Sa, P1, P2, 10)):
        assert torch.equal(g, r)
    assert all(w.launches == 0 for w, _, _ in KERNELS)


def test_chained_wrappers_refuse_what_they_cannot_hold():
    C = _cost(12, (4, 8, 16), torch.int16)
    with pytest.raises(ValueError, match="overflows"):
        sgm_horiz_pass(C, 600, 7000)  # 5 * 7000 > 32768
    with pytest.raises(ValueError, match="partial"):
        sgm_vert_pass(C, P1, P2, partial=C.to(torch.int32))
    with pytest.raises(ValueError, match="D <= 256"):
        sgm_final_wta(_cost(12, (2, 2, 300), torch.int16),
                      _cost(12, (2, 2, 300), torch.int16), P1, P2, 10)
    with pytest.raises(ValueError, match="device"):
        sgm_vert_pass(C.to("meta"), P1, P2)
    # an int32 volume takes any P2
    assert sgm_horiz_pass(C.to(torch.int32), 600, 7000).dtype == torch.int32


# (num_paths, H, W, D, route): the bidir gate needs 8 paths, (W - D) % 8 == 0
# and H % 16 == 0
ROUTES = [
    (8, 16, 64, 16, "bidir"),
    (16, 16, 64, 16, "bidir"),
    (8, 17, 64, 16, "chained-8"),
    (8, 16, 62, 16, "chained-8"),
    (5, 16, 64, 16, "chained-5"),
    (4, 16, 64, 16, "chained-4"),
    (6, 16, 64, 16, "chained-4"),
]
EXPECTED = {
    "bidir": [("vol_transpose",), ("sgm_horiz",), ("vol_transpose",),
              ("sgm_vert_wta",)],
    "chained-8": [("sgm_horiz_pass", False, False), ("sgm_horiz_pass", True, True),
                  ("sgm_vert_pass", False, True), ("sgm_final_wta", True, True)],
    "chained-5": [("sgm_horiz_pass", False, False), ("sgm_horiz_pass", True, True),
                  ("sgm_final_wta", False, True)],
    "chained-4": [("sgm_horiz_pass", False, False), ("sgm_final_wta", False, True)],
}


@pytest.mark.parametrize("num_paths,H,W,D,route", ROUTES)
def test_stereo_sgbm_routes(monkeypatch, num_paths, H, W, D, route):
    """Each path count and shape reaches the reference's route: the
    wrappers, their sense (reverse) and whether they get a partial."""
    calls = []

    def record(name, fn):
        def wrapper(*a, **kw):
            if name in ("vol_transpose", "sgm_horiz", "sgm_vert_wta"):
                calls.append((name,))
            elif name == "sgm_final_wta":  # (C, S_partial, ...)
                calls.append((name, bool(kw["reverse"]), a[1] is not None))
            else:
                calls.append((name, bool(kw.get("reverse", False)),
                              kw.get("partial") is not None))
            return fn(*a, **kw)
        return wrapper

    for name in ("vol_transpose", "sgm_horiz", "sgm_vert_wta", "sgm_horiz_pass",
                 "sgm_vert_pass", "sgm_final_wta"):
        monkeypatch.setattr(tsg, name, record(name, getattr(tsg, name)))
    left, right = stereo_pair(num_paths, H, W, 4)
    cfg = MatcherConfig(kind="sgm", num_disparities=D, block_size=5,
                        pre_filter_cap=0, num_paths=num_paths,
                        speckle_window_size=0)
    disp = tsg.stereo_sgbm(t(left), t(right), cfg)
    assert disp.shape == (H, W)
    assert calls == EXPECTED[route]
    assert tsg.uses_bidir(num_paths, H, W, D) == (route == "bidir")


@pytest.mark.parametrize("mode", ["sgbm", "sgbm4", "hh"])
def test_golden_sgbm_copy_matches_original(mode):
    left, right = stereo_pair(21, 12, 64, 5)
    kw = dict(num_disparities=16, block_size=5, speckle_window_size=20)
    ref = jgolden_stereo_sgbm(left, right, mode=mode, **kw)
    np.testing.assert_array_equal(golden_stereo_sgbm(left, right, mode=mode, **kw), ref)
    assert (ref != -16).mean() > 0.3


def test_golden_sgbm_copy_refuses_unknown_modes():
    left, right = stereo_pair(22, 8, 40, 3)
    with pytest.raises(ValueError, match="mode"):
        golden_stereo_sgbm(left, right, 16, mode="sgbm8")


@pytest.mark.cuda
def test_chained_kernels_match_plain_on_cuda():
    dev = cuda_or_skip()
    H, W1, D = 45, 236, 64  # H % 16 != 0, W1 % 128 != 0
    for dtype in (torch.int16, torch.int32):
        C = _cost(13, (H, W1, D), dtype).to(dev)
        for reverse in (False, True):
            hf = sgm_horiz_pass(C, 600, 2400, reverse)
            assert torch.equal(hf, sgm_horiz_pass_plain(C, 600, 2400, reverse))
            Ct = C.transpose(0, 1).contiguous()
            ht = hf.transpose(0, 1).contiguous()
            assert torch.equal(sgm_horiz_pass(Ct, 600, 2400, reverse, ht, True),
                               sgm_horiz_pass_plain(Ct, 600, 2400, reverse, ht, True))
            for partial in (None, hf):
                assert torch.equal(sgm_vert_pass(C, 600, 2400, reverse, partial),
                                   sgm_vert_pass_plain(C, 600, 2400, reverse, partial))
            for g, r in zip(sgm_final_wta(C, hf, 600, 2400, 10, reverse),
                            sgm_final_wta_plain(C, hf, 600, 2400, 10, reverse)):
                assert torch.equal(g, r)
