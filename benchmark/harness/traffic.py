"""The traffic generator: seeded stereo rigs, their frames and rectification.

A frozen copy of the scene painter of the port's synthetic source (a
blurred random texture as the background plane, red objects with a green
texture of their own, the right view shifted by each layer's disparity,
far to near), placed by the traffic file's parameters. Every rig's frame is
a pure function of (seed, rig, frame index): frame i of a rig is slot
i % ring of a ring rendered at set-up. Every seed paints the same object
sizes and disparities; the seed moves them, orders them and draws the
textures. Frames leave the painter raw (unrectified); the rectification
maps, the same for both eyes so that rows stay aligned, come from the seed
too.
"""

from __future__ import annotations

import time

import numpy as np


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, *keys])


def focal(width: int, scene: dict) -> float:
    return scene["focal_frac"] * width


def q_matrix(width: int, height: int, scene: dict) -> np.ndarray:
    """Bouguet's Q (CALIB_ZERO_DISPARITY) of the painted geometry."""
    Q = np.zeros((4, 4), np.float64)
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3] = -width / 2.0
    Q[1, 3] = -height / 2.0
    Q[2, 3] = focal(width, scene)
    Q[3, 2] = 1.0 / scene["baseline"]
    return Q


def rectification(seed: int, width: int, height: int, traffic: dict) -> dict:
    """grid_left, grid_right ((H, W, 2) float32 source coordinates) and Q: a
    fractional x shift and a vertical stretch whose top and bottom rows
    sample outside the frame, both drawn from the seed."""
    r = traffic["rectify"]
    g = _rng(seed, 1 << 20)
    dx = g.uniform(*r["x_shift"])
    s = g.uniform(*r["y_stretch_px"])
    oy, ox = np.mgrid[0:height, 0:width].astype(np.float32)
    grid = np.stack([ox + dx, oy * (height + s) / height - s / 2], -1).astype(np.float32)
    return dict(grid_left=grid, grid_right=grid.copy(),
                Q=q_matrix(width, height, traffic["scene"]))


def _texture(g, height, width, lo, hi, k):
    tex = g.integers(lo, hi, size=(height, width, 3), dtype=np.uint8)
    if k > 1:
        c = np.cumsum(np.pad(tex.astype(np.int32), ((0, 0), (k // 2 + 1, k // 2), (0, 0))), 1)
        tex = (c[:, k:] - c[:, :-k]) // k
        c = np.cumsum(np.pad(tex, ((k // 2 + 1, k // 2), (0, 0), (0, 0))), 0)
        tex = (c[k:] - c[:-k]) // k
    return tex.astype(np.uint8)


def _place(g, width, height, D, ring, objects, speed, tries=10000):
    """Boxes (x, y, w, h, d, vx, vy) that stay in the matched columns and in
    the frame over the ring, and apart from each other."""
    dys = g.permutation(len(objects))
    sizes = [(int(o[0] * width), int(o[1] * height)) for o in objects]
    placed = []
    for i, (w, h) in enumerate(sizes):
        d = objects[dys[i]][2] * D
        for _ in range(tries):
            vx, vy = g.uniform(-speed[0], speed[0]), g.uniform(-speed[1], speed[1])
            span_x, span_y = abs(vx) * ring + 2, abs(vy) * ring + 2
            x_lo, x_hi = D + 8 + span_x, width - w - 8 - span_x
            y_lo, y_hi = 8 + span_y, height - h - 8 - span_y
            if x_hi <= x_lo or y_hi <= y_lo:
                raise ValueError(f"an object of {w}x{h} does not fit a {width}x{height} frame at D={D}")
            x, y = g.uniform(x_lo, x_hi), g.uniform(y_lo, y_hi)
            pad = 8 + max(span_x, span_y)
            if all(x + w + pad <= p[0] or p[0] + p[2] + pad <= x or
                   y + h + pad <= p[1] or p[1] + p[3] + pad <= y for p in placed):
                placed.append((x, y, w, h, d, vx, vy))
                break
        else:
            raise ValueError("the traffic's objects do not fit apart in the frame")
    return placed


def rig_frames(seed: int, rig: int, width: int, height: int, D: int,
               traffic: dict) -> list:
    """The rig's ring of (left, right) raw RGB uint8 frames."""
    sc = traffic["scene"]
    g = _rng(seed, rig, 2)
    f = focal(width, sc)
    d_bg = f * sc["baseline"] / sc["background_z"]
    off = int(round(d_bg))
    tex = _texture(g, height, width + off + 8, *sc["texture"], sc["blur"])
    ring = traffic["ring"]
    objs = _place(g, width, height, D, ring, sc["objects"], sc["speed_px"])
    otex = [g.integers(*sc["object_green"], size=(o[3], o[2]), dtype=np.uint8) for o in objs]
    rgb = np.asarray(sc["object_rgb"], np.uint8)
    frames = []
    for i in range(ring):
        left = tex[:, :width].copy()
        right = tex[:, off: off + width].copy()
        for k in np.argsort([o[4] for o in objs]):  # far (small d) to near
            x0, y0, w, h, d, vx, vy = objs[k]
            x, y = int(round(x0 + vx * i)), int(round(y0 + vy * i))
            left[y: y + h, x: x + w] = rgb
            left[y: y + h, x: x + w, 1] = otex[k]
            rd = int(round(d))
            lo, hi = max(x - rd, 0), min(x - rd + w, width)
            if hi > lo:
                right[y: y + h, lo:hi] = left[y: y + h, lo + rd: hi + rd]
        frames.append((left, right))
    return frames


class RigSource:
    """One rig's camera for the engine: grab() hands the next frame of the
    ring and notes when it did (the start of that frame's latency)."""

    rectified = False  # the engine applies the rectification maps

    def __init__(self, frames, width: int, height: int):
        from rt_depth_map_tpu_torch.sources.base import StereoFrame

        self.width, self.height = width, height
        self._frames = [(StereoFrame("raw", array=lf), StereoFrame("raw", array=rf))
                        for lf, rf in frames]
        self.grab_times: list = []

    def grab(self):
        pair = self._frames[len(self.grab_times) % len(self._frames)]
        self.grab_times.append(time.perf_counter())
        return pair

    def close(self) -> None:
        pass
