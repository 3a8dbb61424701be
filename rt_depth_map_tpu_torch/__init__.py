"""PyTorch/CUDA port of the rt_depth_map_tpu stereo depth engine.

A second package beside the JAX one, which stays the reference. It reuses the
JAX package's host-only modules (`config`, `sources`, `calib`, none of which
imports JAX) and never imports `jax`. The per-frame program runs on a CUDA
device; the stages that were Pallas kernels on the TPU are hand-written CUDA
kernels (`ops/cuda/`, sources in `csrc/`), built with nvcc at first use.
"""

from rt_depth_map_tpu_torch.pipeline.engine import Engine, FrameResult  # noqa: F401
