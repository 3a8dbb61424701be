# Copy of rt_depth_map_tpu/sources/synthetic.py; the port imports nothing of the JAX package.
"""Deterministic seeded synthetic stereo sequence with ground truth.

The reference ships no recorded image data (SURVEY.md section 4), so
repeatable benchmarks and integration tests synthesize their own: a textured
background plane plus colored (HSV-detectable, default "red") rectangular
objects at known depths, rendered directly in rectified space so per-pixel
ground-truth disparity is exact (right view = per-layer horizontal shift,
painter's order far-to-near for correct occlusion).

Disparity follows the Bouguet Q geometry: d = f * B / Z with the synthetic
rig's focal length and baseline; `q_matrix()` returns the matching
reprojection matrix so reproject_to_3d recovers the designed depths.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from rt_depth_map_tpu_torch.sources.base import StereoFrame


@dataclasses.dataclass(frozen=True)
class SyntheticObject:
    x: int  # left-view top-left (at frame 0)
    y: int
    w: int
    h: int
    z_units: float  # depth in calibration units
    vx: float = 0.0  # px/frame motion
    vy: float = 0.0
    rgb: Tuple[int, int, int] = (200, 30, 30)  # detectable "red"


class SyntheticStereoSource:
    """Seeded generator; every frame is a pure function of (seed, index)."""

    def __init__(
        self,
        width: int,
        height: int,
        seed: int = 0,
        focal_px: Optional[float] = None,
        baseline_units: float = 4.8,  # ~12 cm at 25 mm units
        background_z_units: float = 160.0,  # 4 m
        num_objects: int = 3,
        objects: Optional[List[SyntheticObject]] = None,  # explicit placement
        encode: str = "raw",  # "raw" | "mjpeg" (exercises the decode stage)
        jpeg_quality: int = 92,
        ring: int = 0,  # pre-rendered frame ring: grab() cycles `ring`
        # distinct frames, each rendered once (a camera delivers frames at
        # sensor rate; re-running the numpy scene painter per grab is a
        # synthetic-source artifact that serialized ~270ms/frame onto the
        # capture path -- VERDICT round 3, missing item 1)
        scene: str = "default",  # scene family (accuracy hardening,
        # VERDICT round-4 item 5):
        #   "default"   blurred mid-contrast texture, 3 separated objects
        #               (bit-identical to the pre-family generator)
        #   "lowtex"    weak low-contrast texture (stresses the texture/
        #               uniqueness validity checks and SGM smoothing)
        #   "occlusion" 8 large overlapping objects across a wide depth
        #               range (stresses occlusion borders + speckle)
        #   "fine"      unblurred high-frequency texture (stresses
        #               subpixel interpolation + aliasing of the search)
    ):
        if scene not in ("default", "lowtex", "occlusion", "fine"):
            raise ValueError(f"unknown scene family {scene!r}")
        self.width = width
        self.height = height
        self.rectified = True
        self.seed = seed
        self.scene = scene
        self.f = float(focal_px if focal_px is not None else 0.9 * width)
        self.baseline = baseline_units
        self.bg_z = background_z_units
        self.encode = encode
        self.jpeg_quality = jpeg_quality
        self.ring = int(ring)
        self._ring_cache = {}
        self._idx = 0

        rng = np.random.default_rng(seed)
        # background texture, wider than the frame so the right view's shift
        # samples real texture instead of a border
        pad = int(np.ceil(self.f * self.baseline / 8.0)) + 8  # max disparity pad
        lo, hi = {"lowtex": (96, 132)}.get(scene, (40, 220))
        tex = rng.integers(lo, hi, size=(height, width + pad, 3), dtype=np.uint8)
        # separable box blur for SAD-friendly texture ("fine" skips it:
        # raw per-pixel noise stresses subpixel/aliasing behavior)
        k = 1 if scene == "fine" else 5
        if k > 1:
            csum = np.cumsum(
                np.pad(tex.astype(np.int32),
                       ((0, 0), (k // 2 + 1, k // 2), (0, 0))),
                axis=1,
            )
            tex = ((csum[:, k:] - csum[:, :-k]) // k).astype(np.int32)
            csum = np.cumsum(
                np.pad(tex, ((k // 2 + 1, k // 2), (0, 0), (0, 0))), axis=0)
            tex = ((csum[k:] - csum[:-k]) // k).astype(np.int32)
        self._tex = tex.astype(np.uint8)

        if scene == "occlusion" and objects is None and num_objects == 3:
            num_objects = 8
        if objects is not None:
            self.objects = list(objects)
        else:
            self.objects = []
            for i in range(num_objects):
                if scene == "occlusion":
                    # large objects crowded into the middle half so most
                    # overlap; wide depth spread -> big disparity steps
                    w = int(rng.integers(width // 6, width // 3))
                    h = int(rng.integers(height // 6, height // 3))
                    x = int(rng.integers(width // 5,
                                         max(width - w - width // 5,
                                             width // 5 + 1)))
                    y = int(rng.integers(height // 6,
                                         max(height - h - height // 6,
                                             height // 6 + 1)))
                    z = float(rng.uniform(16.0, 140.0))  # 0.4m - 3.5m
                else:
                    w = int(rng.integers(width // 12, width // 6))
                    h = int(rng.integers(height // 10, height // 5))
                    x = int(rng.integers(width // 8, width - w - width // 8))
                    y = int(rng.integers(height // 8,
                                         height - h - height // 8))
                    z = float(rng.uniform(24.0, 96.0))  # 0.6m - 2.4m
                self.objects.append(
                    SyntheticObject(
                        x=x, y=y, w=w, h=h, z_units=z,
                        vx=float(rng.uniform(-1.5, 1.5)),
                        vy=float(rng.uniform(-0.8, 0.8)),
                    )
                )
        # Non-repeating green-channel texture: gives SAD/SGM unambiguous
        # gradients (periodic patterns alias the disparity search) while the
        # whole object stays inside the "red" inRange gate -- g in [30, 78]
        # keeps hue <= 9 (H = 180*(g-b)/(6*(v-min)) with r=200, b=30 gives
        # h <= 180*48/1020 ~= 8.5). "lowtex" narrows the band to [48, 60]:
        # barely-textured objects, the worst case for the validity checks.
        glo, ghi = (48, 60) if scene == "lowtex" else (30, 78)
        self._obj_tex = [
            rng.integers(glo, ghi, size=(o.h, o.w), dtype=np.uint8)
            for o in self.objects
        ]

    # -- geometry ---------------------------------------------------------
    def disparity_of(self, z_units: float) -> float:
        return self.f * self.baseline / z_units

    def q_matrix(self) -> np.ndarray:
        """Bouguet Q (CALIB_ZERO_DISPARITY) consistent with disparity_of."""
        Q = np.zeros((4, 4), dtype=np.float64)
        Q[0, 0] = Q[1, 1] = 1.0
        Q[0, 3] = -self.width / 2.0
        Q[1, 3] = -self.height / 2.0
        Q[2, 3] = self.f
        Q[3, 2] = 1.0 / self.baseline
        return Q

    # -- rendering --------------------------------------------------------
    def render(self, index: int):
        """(left_rgb, right_rgb, gt_disparity float32, boxes) for one frame."""
        H, W = self.height, self.width
        d_bg = self.disparity_of(self.bg_z)
        left = self._tex[:, : W].copy()
        # right view: background sampled shifted right->left by d_bg
        off = int(round(d_bg))
        right = self._tex[:, off : off + W].copy()
        gt = np.full((H, W), d_bg, dtype=np.float32)

        # painter's order: far to near
        boxes = []
        order = sorted(range(len(self.objects)), key=lambda i: -self.objects[i].z_units)
        for oi in order:
            obj = self.objects[oi]
            d = self.disparity_of(obj.z_units)
            x = int(round(obj.x + obj.vx * index)) % max(W - obj.w, 1)
            y = int(round(obj.y + obj.vy * index)) % max(H - obj.h, 1)
            color = np.asarray(obj.rgb, np.uint8)
            left[y : y + obj.h, x : x + obj.w] = color
            left[y : y + obj.h, x : x + obj.w, 1] = self._obj_tex[oi]
            xr0 = x - int(round(d))
            xr_lo, xr_hi = max(xr0, 0), min(xr0 + obj.w, W)
            if xr_hi > xr_lo:
                right[y : y + obj.h, xr_lo:xr_hi] = left[
                    y : y + obj.h, xr_lo + int(round(d)) : xr_hi + int(round(d))
                ]
            gt[y : y + obj.h, x : x + obj.w] = d
            boxes.append((x, y, obj.w, obj.h, obj.z_units))
        return left, right, gt, boxes

    # -- StereoSource protocol ---------------------------------------------
    def grab(self) -> Tuple[StereoFrame, StereoFrame]:
        if self.ring:
            key = self._idx % self.ring
            frames = self._ring_cache.get(key)
            if frames is None:
                left, right, _, _ = self.render(key)
                if self.encode == "mjpeg":
                    frames = (self._encode(left), self._encode(right))
                else:
                    frames = (
                        StereoFrame(encoding="raw", array=left),
                        StereoFrame(encoding="raw", array=right),
                    )
                self._ring_cache[key] = frames
            self._idx += 1
            return frames
        left, right, _, _ = self.render(self._idx)
        self._idx += 1
        if self.encode == "mjpeg":
            return self._encode(left), self._encode(right)
        return (
            StereoFrame(encoding="raw", array=left),
            StereoFrame(encoding="raw", array=right),
        )

    def _encode(self, rgb: np.ndarray) -> StereoFrame:
        import cv2

        ok, buf = cv2.imencode(
            ".jpg", rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, self.jpeg_quality]
        )
        if not ok:
            raise RuntimeError("jpeg encode failed")
        return StereoFrame(encoding="mjpeg", data=buf.tobytes())

    def close(self) -> None:
        pass
