"""K8 and K6 on the card: the BM cost + winner-take-all kernel
(`csrc/bm_kernel.cu`) and the LR resolve kernel against their plain
versions, bit for bit on every output. The tests need a CUDA device and
skip without one; the file imports no JAX, so it also runs on a machine with
the card (whose Python has no JAX, hence no conftest):

    python -m pytest --noconftest tests/test_torch_bm_cuda.py -q -p no:randomly
"""

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_cost_wta, bm_cost_wta_plain
from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import lr_resolve, lr_resolve_plain
from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter
from torch_helpers import cuda_or_skip, stereo_pair, t

#: (H, W, D, bs, inputs): full-range random bytes over every D and block
#: size on a ragged frame (D = 288 and 384: 12 d a lane, a 9-bit key);
#: prefiltered stereo pairs; W < D; H < bs; and a view that starts one row
#: into its tensor (rows not on 16 bytes)
CASES = (
    [(97, 301, D, bs, "random") for D in (1, 16, 100, 128, 192, 256, 288, 384)
     for bs in (1, 5, 13, 21)]
    + [(40, 200, 32, 13, "prefiltered"), (120, 400, 128, 13, "prefiltered"),
       (50, 64, 100, 13, "random"), (50, 64, 100, 5, "prefiltered"),
       (5, 200, 64, 13, "random"), (3, 90, 16, 21, "random"),
       (1, 33, 8, 5, "random"), (97, 301, 128, 13, "view"),
       (60, 500, 288, 13, "prefiltered"), (97, 301, 384, 13, "view")]
)


def _inputs(seed, H, W, kind, dev):
    if kind == "prefiltered":
        left, right = stereo_pair(seed, H, W, 9)
        return (xsobel_prefilter(t(left), 31).to(dev),
                xsobel_prefilter(t(right), 31).to(dev))
    rng = np.random.default_rng(seed)
    if kind == "view":
        return tuple(t(rng.integers(0, 256, size=(H + 1, W), dtype=np.uint8),
                       dev)[1:] for _ in range(2))
    return tuple(t(rng.integers(0, 256, size=(H, W), dtype=np.uint8), dev)
                 for _ in range(2))


def _lr_inputs(seed, H, W, D):
    rng = np.random.default_rng(seed)
    d_match = rng.integers(-1, D + 2, size=(H, W)).astype(np.int32)
    key = rng.integers(0, 2**20, size=(H, W)).astype(np.int32) * 8192 \
        + rng.integers(0, 8192, size=(H, W)).astype(np.int32)
    key = np.where(rng.random((H, W)) < 0.1, 2**31 - 1, key).astype(np.int32)
    return d_match, key


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D,bs,kind", CASES)
def test_bm_kernel_matches_plain_on_cuda(H, W, D, bs, kind):
    dev = cuda_or_skip()
    lp, rp = _inputs(H * W + D + bs, H, W, kind, dev)
    if kind == "view":
        assert lp.is_contiguous() and lp.data_ptr() % 16 != 0
    before = bm_cost_wta.launches
    got = bm_cost_wta(lp, rp, D, bs)
    assert bm_cost_wta.launches == before + 1
    ref = bm_cost_wta_plain(lp, rp, D, bs)
    names = ("best_d", "best_cost", "c_m1", "c_p1", "min_outside")
    for name, g, r in zip(names, got, ref):
        assert g.dtype == r.dtype == torch.int32, name
        assert torch.equal(g, r), (name, int((g != r).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D", [(40, 200, 32), (97, 301, 128)])
def test_lr_kernel_matches_plain_on_cuda(H, W, D):
    dev = cuda_or_skip()
    d_match, key = _lr_inputs(5, H, W, D)
    kw = dict(n_w=D + 1, r_lo=0, n_r=D + 1, Dpow=8192, c0=-2048, invalid=-16)
    dm, k = t(d_match, dev), t(key, dev)
    for g, r in zip(lr_resolve(dm, k, (dm,), **kw),
                    lr_resolve_plain(dm, k, (dm,), **kw)):
        assert torch.equal(g, r)
