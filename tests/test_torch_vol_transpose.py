"""Port parity: K12, the volume transpose. The plain version against the
Pallas kernel in interpret mode (its 3-D (A, D, B) -> (B, D, A) form, at
shapes on its tile grid), the SGM stage's (H, 1, W1, D) form against
numpy, and the wrapper's CPU route. Integer, bit-exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rt_depth_map_tpu.ops.pallas.vol_transpose import vol_transpose as j_vol_transpose
from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from rt_depth_map_tpu_torch.ops.cuda.vol_transpose import (
    vol_transpose,
    vol_transpose_plain,
)
from rt_depth_map_tpu_torch.ops.sgbm import swap_pixel_axes
from torch_helpers import cuda_or_skip, t


@pytest.mark.parametrize("shape,dtype", [((128, 8, 128), np.int16),
                                         ((256, 8, 128), np.int32)])
def test_plain_matches_pallas(monkeypatch, shape, dtype):
    # the reference runs its Pallas kernel only when asked to
    monkeypatch.setenv("RTDM_PALLAS_TRANSPOSE", "1")
    monkeypatch.delenv("RTDM_NO_PALLAS_TRANSPOSE", raising=False)
    x = np.random.default_rng(shape[0]).integers(-3000, 3000, shape).astype(dtype)
    ref = np.asarray(j_vol_transpose(jnp.asarray(x), block=128, interpret=True))
    got = vol_transpose_plain(t(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("H,W1,D", [(5, 7, 16), (16, 12, 3)])
def test_swap_pixel_axes_form(H, W1, D):
    """The SGM stage's call: (H, W1, D) <-> (W1, H, D), D moving whole."""
    x = np.random.default_rng(D).integers(-30000, 30000, (H, W1, D)).astype(np.int16)
    got = swap_pixel_axes(t(x))
    np.testing.assert_array_equal(got.numpy(), x.transpose(1, 0, 2))
    np.testing.assert_array_equal(swap_pixel_axes(got).numpy(), x)


def test_wrapper_runs_plain_on_cpu():
    x = t(np.arange(2 * 3 * 4 * 5, dtype=np.int32).reshape(2, 3, 4, 5))
    reset_launch_counts()
    got = vol_transpose(x)
    assert got.shape == (4, 3, 2, 5)
    assert torch.equal(got, x.permute(2, 1, 0, 3))
    assert all(w.launches == 0 for w, _, _ in KERNELS)
    with pytest.raises(ValueError, match="3 or more"):
        vol_transpose(x[0, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((45, 1, 300, 64), torch.int16),
                                         ((300, 1, 45, 64), torch.int32),
                                         ((130, 8, 70), torch.int16),
                                         ((33, 3, 65, 3), torch.int16),
                                         ((17, 2, 9, 5), torch.uint8)])
def test_kernel_matches_plain_on_cuda(shape, dtype):
    """Both kernel variants: multi-chunk units (the SGM volumes) and
    one-chunk units through the shared-memory tiles, with ragged tiles."""
    dev = cuda_or_skip()
    x = torch.randint(-100, 100, shape, device=dev).to(dtype)
    assert torch.equal(vol_transpose(x), vol_transpose_plain(x))
