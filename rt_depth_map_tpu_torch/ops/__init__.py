"""Per-frame ops of the port, each a counterpart of `rt_depth_map_tpu/ops/`.

Plain tensor code is PyTorch; the four stages that ran Pallas kernels on the
TPU call the hand-written CUDA kernels of `ops/cuda/`.
"""
