# Copy of rt_depth_map_tpu/utils/viewer.py; the port imports nothing of the JAX package.
"""Live display + runtime adjustment (reference estimator.cpp:71-81 and
create_adjustment_track_bars, estimator.cpp:294-304).

The reference shows an OpenCV "depth" window every frame (rectified view
with drawn boxes + distance labels), a "disparity" window behind the -dp
flag, waitKey(10), and -- with -a -- six HSV trackbars on the depth window
driving the detection thresholds live.

Split for headless testability: `AdjustState` owns the six trackbar values
and pushes them into the Engine (new threshold tensors for the next
frame, Engine.set_hsv_thresholds); `LiveViewer` binds cv2 windows/trackbars to an
AdjustState when a display exists. Tests drive AdjustState directly.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

#: (trackbar label, channel index, is_high) -- labels are the reference's
#: createTrackbar names verbatim (estimator.cpp:296-303)
TRACKBARS = (
    ("hue low", 0, False),
    ("hue high", 0, True),
    ("saturation low", 1, False),
    ("saturation high", 1, True),
    ("value low", 2, False),
    ("value high", 2, True),
)


class AdjustState:
    """Runtime HSV threshold state (iLowH..iHighV, estimator.cpp:108-113),
    initialized from the engine's configured color range."""

    def __init__(self, engine):
        self.engine = engine
        self.low = np.asarray(engine.hsv_low, np.int32).copy()
        self.high = np.asarray(engine.hsv_high, np.int32).copy()

    def set(self, name: str, value: int) -> None:
        """One trackbar change -> engine thresholds (the next frame)."""
        for label, ch, is_high in TRACKBARS:
            if label == name:
                (self.high if is_high else self.low)[ch] = int(value)
                self.engine.set_hsv_thresholds(
                    np.clip(self.low, 0, 255).astype(np.uint8),
                    np.clip(self.high, 0, 255).astype(np.uint8),
                )
                return
        raise KeyError(name)

    def get(self, name: str) -> int:
        for label, ch, is_high in TRACKBARS:
            if label == name:
                return int((self.high if is_high else self.low)[ch])
        raise KeyError(name)


def display_available() -> bool:
    """cv2 with a GUI backend + a display to talk to."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    if os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"):
        return True
    return os.name == "nt"


class LiveViewer:
    """cv2 windows: "depth" always, "disparity" behind show_disparity,
    HSV trackbars on the depth window when adjustable (reference -a)."""

    def __init__(self, engine, show_disparity: bool = True,
                 adjustable: bool = False, wait_ms: int = 10):
        import cv2

        self.cv2 = cv2
        self.state = AdjustState(engine)
        self.show_disparity = show_disparity
        self.wait_ms = wait_ms  # waitKey(10) parity (estimator.cpp:81)
        cv2.namedWindow("depth")
        if show_disparity:
            cv2.namedWindow("disparity")
        if adjustable:
            for label, ch, is_high in TRACKBARS:
                cv2.createTrackbar(
                    label, "depth", self.state.get(label), 255,
                    lambda v, n=label: self.state.set(n, v),
                )

    def show(self, i: int, result) -> bool:
        """Display one FrameResult; returns False when the user closed the
        window / pressed ESC (the loop should stop)."""
        from rt_depth_map_tpu_torch.utils.vis import disparity_vis, draw_depth_overlay

        cv2 = self.cv2
        img = draw_depth_overlay(result)[..., ::-1].copy()  # RGB -> BGR
        for x, y, txt in result.labels():
            cv2.putText(img, txt, (x, max(12, y)), cv2.FONT_HERSHEY_PLAIN,
                        1.0, (255, 255, 255), 1)
        cv2.imshow("depth", img)
        if self.show_disparity:
            cv2.imshow("disparity", disparity_vis(result.disparity))
        key = cv2.waitKey(self.wait_ms) & 0xFF
        return key != 27

    def close(self) -> None:
        self.cv2.destroyAllWindows()


def make_viewer(engine, show_disparity: bool, adjustable: bool
                ) -> Optional[LiveViewer]:
    """LiveViewer when a display exists, else None (headless fallback --
    the Zynq build likewise forces GUI flags off, cmdline-parser.cpp:37-43)."""
    if not display_available():
        return None
    try:
        return LiveViewer(engine, show_disparity, adjustable)
    except Exception:
        return None
