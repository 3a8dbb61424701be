"""Engine and timing of the port (`rt_depth_map_tpu/pipeline/` counterpart)."""

from rt_depth_map_tpu_torch.pipeline.engine import Engine, FrameResult  # noqa: F401
from rt_depth_map_tpu_torch.pipeline.stats import ExecTimeStats  # noqa: F401
