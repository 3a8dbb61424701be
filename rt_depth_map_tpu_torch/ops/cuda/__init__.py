"""Hand-written CUDA kernels of the port, one module per kernel.

Each module holds the kernel's wrapper (which launches the kernel for CUDA
tensors and counts its launches in `<wrapper>.launches`), its plain PyTorch
version (used for CPU tensors, and as the reference on the card), and a note
on which TPU kernel it replaces. The CUDA sources are in `csrc/` and are
built at first use (`_build.py`).
"""

from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_cost_wta  # noqa: F401
from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import seg_min_propagate  # noqa: F401
from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import lr_resolve  # noqa: F401
from rt_depth_map_tpu_torch.ops.cuda.remap import remap_u8  # noqa: F401

#: (wrapper, csrc file, TPU kernel it replaces) for every kernel of the port
KERNELS = (
    (remap_u8, "rt_depth_map_tpu_torch/csrc/remap.cu",
     "rt_depth_map_tpu/ops/pallas/remap_plan.py:291"),
    (seg_min_propagate, "rt_depth_map_tpu_torch/csrc/cc_sweep.cu",
     "rt_depth_map_tpu/ops/pallas/cc_sweep.py:249"),
    (bm_cost_wta, "rt_depth_map_tpu_torch/csrc/bm_kernel.cu",
     "rt_depth_map_tpu/ops/pallas/bm_kernel.py:197"),
    (lr_resolve, "rt_depth_map_tpu_torch/csrc/lr_resolve.cu",
     "rt_depth_map_tpu/ops/pallas/lr_resolve.py:106"),
)


def reset_launch_counts() -> None:
    for wrapper, _, _ in KERNELS:
        wrapper.launches = 0
