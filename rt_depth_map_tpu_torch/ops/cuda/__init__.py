"""Hand-written CUDA kernels of the port, one module per kernel.

Each module holds the kernel's wrapper (which launches the kernel for CUDA
tensors and counts its launches in `<wrapper>.launches`), its plain PyTorch
version (used for CPU tensors, and as the reference on the card), and a note
on which TPU kernel it replaces. The CUDA sources are in `csrc/` and are
built at first use (`_build.py`).
"""

from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_cost_wta  # noqa: F401
from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import seg_min_propagate  # noqa: F401
from rt_depth_map_tpu_torch.ops.cuda.histogram import (  # noqa: F401
    label_histogram,
    label_histogram_banded,
    speckle_apply,
    speckle_decision,
)
from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import (  # noqa: F401
    lr_resolve,
    lr_resolve_bm,
    lr_resolve_sgbm,
)
from rt_depth_map_tpu_torch.ops.cuda.remap import rectify_pair, remap_u8  # noqa: F401
from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import sgm_cost_volume  # noqa: F401
from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import (  # noqa: F401
    sgm_final_wta,
    sgm_horiz_pass,
    sgm_vert_pass,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import sgm_horiz  # noqa: F401
from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import sgm_tile_final, sgm_tile_scan  # noqa: F401
from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import sgm_vert_wta  # noqa: F401
from rt_depth_map_tpu_torch.ops.cuda.vol_transpose import vol_transpose  # noqa: F401
from rt_depth_map_tpu_torch.ops.cuda.wls import tridiag_smooth  # noqa: F401

#: (wrapper, csrc file, TPU kernels it replaces) for every kernel of the port
KERNELS = (
    (rectify_pair, "rt_depth_map_tpu_torch/csrc/remap.cu",
     "rt_depth_map_tpu/ops/pallas/remap_plan.py:291"),
    (remap_u8, "rt_depth_map_tpu_torch/csrc/remap.cu",
     "rt_depth_map_tpu/ops/pallas/remap_plan.py:291"),
    (seg_min_propagate, "rt_depth_map_tpu_torch/csrc/cc_sweep.cu",
     "rt_depth_map_tpu/ops/pallas/cc_sweep.py:249"),
    (bm_cost_wta, "rt_depth_map_tpu_torch/csrc/bm_kernel.cu",
     "rt_depth_map_tpu/ops/pallas/bm_kernel.py:197"),
    (lr_resolve, "rt_depth_map_tpu_torch/csrc/lr_resolve.cu",
     "rt_depth_map_tpu/ops/pallas/lr_resolve.py:106"),
    (lr_resolve_sgbm, "rt_depth_map_tpu_torch/csrc/lr_resolve.cu",
     "rt_depth_map_tpu/ops/pallas/lr_resolve.py:106"),
    (lr_resolve_bm, "rt_depth_map_tpu_torch/csrc/lr_resolve.cu",
     "rt_depth_map_tpu/ops/pallas/lr_resolve.py:106"),
    (sgm_cost_volume, "rt_depth_map_tpu_torch/csrc/sgm_cost.cu",
     "rt_depth_map_tpu/ops/pallas/sgm_cost.py:283"),
    (vol_transpose, "rt_depth_map_tpu_torch/csrc/vol_transpose.cu",
     "rt_depth_map_tpu/ops/pallas/vol_transpose.py:31"),
    (sgm_horiz, "rt_depth_map_tpu_torch/csrc/sgm_horiz.cu",
     "rt_depth_map_tpu/ops/pallas/sgm_bidir.py:243"),
    (sgm_vert_wta, "rt_depth_map_tpu_torch/csrc/sgm_vert_wta.cu",
     "rt_depth_map_tpu/ops/pallas/sgm_bidir.py:542"),
    (sgm_horiz_pass, "rt_depth_map_tpu_torch/csrc/sgm_hdw.cu",
     "rt_depth_map_tpu/ops/pallas/sgm_hdw.py:461, "
     "rt_depth_map_tpu/ops/pallas/sgm_hdw.py:524"),
    (sgm_vert_pass, "rt_depth_map_tpu_torch/csrc/sgm_hdw.cu",
     "rt_depth_map_tpu/ops/pallas/sgm_hdw.py:573, "
     "rt_depth_map_tpu/ops/pallas/sgm_scan.py:131"),
    (sgm_final_wta, "rt_depth_map_tpu_torch/csrc/sgm_hdw.cu",
     "rt_depth_map_tpu/ops/pallas/sgm_hdw.py:621"),
    (label_histogram_banded, "rt_depth_map_tpu_torch/csrc/histogram.cu",
     "rt_depth_map_tpu/ops/pallas/histogram.py:198"),
    (label_histogram, "rt_depth_map_tpu_torch/csrc/histogram.cu",
     "rt_depth_map_tpu/ops/pallas/histogram.py:309"),
    (speckle_decision, "rt_depth_map_tpu_torch/csrc/histogram.cu",
     "rt_depth_map_tpu/ops/pallas/histogram.py:198"),
    (speckle_apply, "rt_depth_map_tpu_torch/csrc/histogram.cu",
     "rt_depth_map_tpu/ops/pallas/histogram.py:198"),
    # no TPU kernel: the reference runs these solves as lax.scans under XLA
    (tridiag_smooth, "rt_depth_map_tpu_torch/csrc/wls.cu",
     "rt_depth_map_tpu/ops/wls.py:78 (lax.scan, no Pallas kernel)"),
    # no TPU kernel: the exact width tiling's scans, lax.scans under XLA
    (sgm_tile_scan, "rt_depth_map_tpu_torch/csrc/sgm_tile.cu",
     "no Pallas kernel: lax.scan, rt_depth_map_tpu/parallel/exact_sgbm.py:159-184"),
    # no TPU kernel: the tile-local vertical paths (lax.scans) and the
    # winner-take-all of the exact tiling, under XLA
    (sgm_tile_final, "rt_depth_map_tpu_torch/csrc/sgm_tile.cu",
     "no Pallas kernel: lax.scan and XLA, rt_depth_map_tpu/parallel/exact_sgbm.py:337-343"),
)


def reset_launch_counts() -> None:
    for wrapper, _, _ in KERNELS:
        wrapper.launches = 0
