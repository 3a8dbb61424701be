"""K1 on the card: `rectify_pair` (both views of a stereo pair in one
launch) and `remap_u8` (one image) against their plain versions, bit for
bit, over the map cases of tests/test_torch_remap.py. The tests need a CUDA
device and skip without one; the file imports no JAX, so it also runs on a
machine with the card (whose Python has no JAX, hence no conftest):

    python -m pytest --noconftest tests/test_torch_remap_cuda.py -q -p no:randomly
"""

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch.ops.cuda.remap import rectify_pair, rectify_pair_plain
from rt_depth_map_tpu_torch.ops.remap import remap_bilinear, remap_table
from torch_helpers import cuda_or_skip, t
from torch_helpers import remap_grid as _grid

#: the source of every case
H, W = 40, 56
CASES = ["identity", "shear", "random", "ties", "rotation"]


def pair_planes(seed, device="cpu"):
    """(left gray (H, W), left RGB (H, W, 3), right gray (H, W)) uint8."""
    rng = np.random.default_rng(seed)
    return tuple(t(rng.integers(0, 256, size=s, dtype=np.uint8), device)
                 for s in ((H, W), (H, W, 3), (H, W)))


@pytest.mark.cuda
@pytest.mark.parametrize("Ho,Wo", [(H, W), (H - 1, W - 1)])
@pytest.mark.parametrize("case", CASES)
def test_rectify_pair_kernel_matches_plain_on_cuda(case, Ho, Wo):
    """One launch for both views; an odd Wo and Ho * Wo = 1 mod 4 leave the
    last thread a partial quad of output pixels."""
    dev = cuda_or_skip()
    planes = pair_planes(12, dev)
    lt = remap_table(_grid(case, Ho, Wo), (H, W), dev)
    rt = remap_table(_grid("shear", Ho, Wo), (H, W), dev)
    before = rectify_pair.launches
    got = rectify_pair(*planes, lt, rt)
    assert rectify_pair.launches == before + 1
    for g, r in zip(got, rectify_pair_plain(*planes, lt, rt)):
        assert g.is_contiguous() and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("case", CASES)
def test_remap_kernel_matches_plain_on_cuda(case, channels):
    dev = cuda_or_skip()
    rng = np.random.default_rng(10)
    img = t(rng.integers(0, 256, size=(H, W, channels), dtype=np.uint8), dev)
    tab = remap_table(_grid(case, H - 1, W - 1), (H, W), dev)
    got = remap_bilinear(img, tab)
    ref = remap_bilinear(img, tab, plain=True)
    assert torch.equal(got, ref)
