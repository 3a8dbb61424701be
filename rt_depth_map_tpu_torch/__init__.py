"""PyTorch/CUDA port of the rt_depth_map_tpu stereo depth engine.

A second package beside the JAX one, which stays the reference. It imports
neither `jax` nor anything of the JAX package: it keeps its own copies of the
pure-Python host layer it needs (`config`, `sources`, `decode`, `golden`,
`calib`, `metrics`, `utils`, `pipeline/stats`, `cli`). The per-frame program
runs on a CUDA device; the stages that were Pallas kernels on the TPU are
hand-written CUDA kernels (`ops/cuda/`, sources in `csrc/`), built with nvcc
at first use. `python -m rt_depth_map_tpu_torch` is the command line.
"""

from rt_depth_map_tpu_torch.pipeline.engine import Engine, FrameResult  # noqa: F401
