# Copy of rt_depth_map_tpu/sources/multi.py; the port imports nothing of the JAX package.
"""Multi-rig source: N synchronized stereo sources feeding one device batch.

The reference serves exactly one camera pair; the engine runs B pairs a
step (`Engine.step_batch`, one CUDA stream each; BASELINE.md's multi-stream
point is 4x 720p pairs). Each sub-source is its own rig (its own
seed/directory/device pair); grab_batch returns frame lists the Engine
decodes and stacks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from rt_depth_map_tpu_torch.sources.base import StereoFrame, StereoSource


class MultiStreamSource:
    def __init__(self, sources: Sequence[StereoSource]):
        if not sources:
            raise ValueError("need at least one source")
        w, h = sources[0].width, sources[0].height
        for s in sources:
            if (s.width, s.height) != (w, h):
                raise ValueError("all streams must share one resolution")
        self.sources = list(sources)
        self.width, self.height = w, h
        self.rectified = all(getattr(s, "rectified", False) for s in sources)

    def __len__(self) -> int:
        return len(self.sources)

    def grab(self) -> Tuple[StereoFrame, StereoFrame]:
        return self.sources[0].grab()

    def grab_batch(self) -> List[Tuple[StereoFrame, StereoFrame]]:
        return [s.grab() for s in self.sources]

    def close(self) -> None:
        for s in self.sources:
            s.close()
