# Copy of rt_depth_map_tpu/utils/log.py; the port imports nothing of the JAX package.
"""Structured logging (the reference's debug() printf macro, include/debug.h,
grown up: leveled, timestamped, rate-limitable)."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s: %(message)s"
_configured = False


def get_logger(name: str = "rt_depth_map_tpu_torch") -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger("rt_depth_map_tpu_torch")
        root.addHandler(handler)
        root.setLevel(os.environ.get("RTDM_LOG", "INFO").upper())
        root.propagate = False
        _configured = True
    return logging.getLogger(name)
