# Copy of rt_depth_map_tpu/sources/__init__.py; the port imports nothing of the JAX package.
"""Stereo frame sources (L1a of the reference layer map, SURVEY.md section 1).

Re-creates the `VideoStreamStereoDevice` capture abstraction
(include/stream/video-stream-stereo-device.h:16-39): synchronized stereo
frame acquisition exposing (possibly still-encoded) per-eye buffers. The
reference's only implementation is live V4L2 MJPEG capture; since the repo
ships no recorded data and benchmarks must be reproducible (SURVEY.md
section 4 item 2), the primary sources here are a deterministic seeded
synthetic generator and a recorded-sequence directory reader, with V4L2
capture behind the same protocol.
"""

from rt_depth_map_tpu_torch.sources.base import StereoFrame, StereoSource  # noqa: F401
from rt_depth_map_tpu_torch.sources.synthetic import SyntheticStereoSource  # noqa: F401
from rt_depth_map_tpu_torch.sources.files import FileSequenceSource  # noqa: F401
from rt_depth_map_tpu_torch.sources.multi import MultiStreamSource  # noqa: F401


def make_source(cfg) -> "StereoSource":
    """Build the configured source (reference main.cpp:125 slot).

    Capture runs at the capture_width/height override when set (the
    intrinsics-file resolution override, main.cpp:87-90,116,123-125) and at
    the configured width/height otherwise."""
    w = cfg.capture_width or cfg.width
    h = cfg.capture_height or cfg.height
    if cfg.source == "synthetic":
        return SyntheticStereoSource(
            w, h, seed=cfg.seed, ring=getattr(cfg, "synthetic_ring", 0)
        )
    if cfg.source == "files":
        if not cfg.source_path:
            raise ValueError("source=files requires source_path")
        return FileSequenceSource(cfg.source_path)
    if cfg.source == "v4l2":
        from rt_depth_map_tpu_torch.sources.v4l2 import V4L2StereoSource

        return V4L2StereoSource(
            cfg.left_camera_device, cfg.right_camera_device, w, h
        )
    raise ValueError(f"unknown source {cfg.source!r}")
