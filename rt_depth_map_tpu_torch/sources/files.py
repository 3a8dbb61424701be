# Copy of rt_depth_map_tpu/sources/files.py; the port imports nothing of the JAX package.
"""Recorded stereo sequence source.

Reads `left_*.{jpg,jpeg,png}` / `right_*` pairs from a directory in sorted
order, yielding encoded bytes for jpeg (so the decode stage runs, like the
reference's V4L2 MJPEG path) and raw arrays for png. Loops at the end so the
frame loop can run indefinitely like the reference's `while(1)`
(estimator.cpp:18).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from rt_depth_map_tpu_torch.sources.base import StereoFrame


class FileSequenceSource:
    def __init__(self, directory: str, rectified: bool = True, loop: bool = True):
        self.directory = directory
        self.rectified = rectified
        self.loop = loop
        self._idx = 0

        def listing(prefix: str) -> List[str]:
            return sorted(
                os.path.join(directory, f)
                for f in os.listdir(directory)
                if f.startswith(prefix)
                and f.lower().endswith((".jpg", ".jpeg", ".png"))
            )

        self.left_files = listing("left")
        self.right_files = listing("right")
        if not self.left_files or len(self.left_files) != len(self.right_files):
            raise ValueError(
                f"{directory}: need matching left_*/right_* sequences, got "
                f"{len(self.left_files)}/{len(self.right_files)}"
            )
        w, h = self._probe(self.left_files[0])
        self.width, self.height = w, h

    @staticmethod
    def _probe(path: str) -> Tuple[int, int]:
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise ValueError(f"unreadable image {path}")
        return img.shape[1], img.shape[0]

    def __len__(self) -> int:
        return len(self.left_files)

    def grab(self) -> Tuple[StereoFrame, StereoFrame]:
        if self._idx >= len(self.left_files):
            if not self.loop:
                raise StopIteration
            self._idx = 0
        lf, rf = self.left_files[self._idx], self.right_files[self._idx]
        self._idx += 1
        return self._load(lf), self._load(rf)

    @staticmethod
    def _load(path: str) -> StereoFrame:
        if path.lower().endswith((".jpg", ".jpeg")):
            with open(path, "rb") as f:
                return StereoFrame(encoding="mjpeg", data=f.read())
        import cv2

        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        return StereoFrame(encoding="raw", array=np.ascontiguousarray(bgr[..., ::-1]))

    def close(self) -> None:
        pass
