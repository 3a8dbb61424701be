"""The Engine: host frame loop + the per-frame program on the port's device.

Port of `rt_depth_map_tpu/pipeline/engine.py` for a single frame stream.
Host side: grab -> MJPEG decode (stale-frame reuse on corrupt input) -> H2D,
with an optional prefetch thread. Device side, one method per frame:

  gray x2 -> rectification remap (K1) with ROI crop -> HSV threshold ->
  morphological open/close -> connected-component boxes (K2) -> matcher ->
  /16 -> Q reprojection -> per-box masked depth means.

The matcher is the configured kind, as in the reference's frame program:

  sgm: SGM with 8, 5 or 4 paths over the whole frame (K3 cost volume, then
       the route `ops/sgbm.py` picks for the shape: K12 transposes around
       K4 horizontal paths and K5 vertical and diagonal paths +
       winner-take-all, or the chained passes K9a, K9c, K9d; K6 LR check);
  bm:  block matching inside the boxes' ROI (K8 cost + winner, K6 LR check);

each followed by the speckle filter (K2 labels, K7 counts, K2 decision).

PyTorch runs eagerly, so there is no compile step; the CUDA kernels build at
their first launch. Not ported yet: batch > 1, run_preloaded, the WLS post
filter and show_disparity_value.
"""

from __future__ import annotations

import dataclasses
import signal
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rt_depth_map_tpu_torch.calib import RectificationResult
from rt_depth_map_tpu_torch.config import EngineConfig
from rt_depth_map_tpu_torch.convert import engine_state_from_numpy
from rt_depth_map_tpu_torch.ops.bm import stereo_bm
from rt_depth_map_tpu_torch.ops.color import in_range, rgb_to_gray, rgb_to_hsv
from rt_depth_map_tpu_torch.ops.detect import detect_objects, matching_region
from rt_depth_map_tpu_torch.ops.morphology import morph_open_close
from rt_depth_map_tpu_torch.ops.remap import remap_bilinear
from rt_depth_map_tpu_torch.ops.reproject import (
    calc_depth,
    disparity_fixed_to_float,
    reproject_to_3d,
)
from rt_depth_map_tpu_torch.ops.sgbm import check_config as check_sgm_config
from rt_depth_map_tpu_torch.ops.sgbm import stereo_sgbm
from rt_depth_map_tpu_torch.pipeline.stats import ExecTimeStats
from rt_depth_map_tpu_torch.sources import make_source


@dataclasses.dataclass
class FrameResult:
    """Outputs of one frame (host numpy)."""

    disparity: np.ndarray  # (Hr, Wr) int16 x16 fixed point
    boxes: np.ndarray  # (K, 5) int32 [x, y, w, h, valid], rect-crop coords
    depth_cm: np.ndarray  # (K,) float32, NaN where invalid/empty
    mean_z: np.ndarray  # (K,) float32 raw Z units
    count: np.ndarray  # (K,) int32 valid pixels per box
    mask: np.ndarray  # (Hr, Wr) uint8 filtered object mask
    rgb_rect: np.ndarray  # (Hr, Wr, 3) uint8 rectified left view

    @property
    def has_objects(self) -> bool:
        return bool(self.boxes[:, 4].sum() > 0)

    def labels(self):
        """(x, y, 'NNN cm') depth labels (estimator.cpp:250-259 parity)."""
        return [(int(b[0]), int(b[1]), f"{cm:.0f} cm")
                for b, cm in zip(self.boxes, self.depth_cm)
                if b[4] and np.isfinite(cm)]


def _identity_grid(width: int, height: int) -> np.ndarray:
    gx, gy = np.meshgrid(
        np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32)
    )
    return np.stack([gx, gy], axis=-1)


def _default_q(width: int, height: int) -> np.ndarray:
    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3] = -width / 2.0
    Q[1, 3] = -height / 2.0
    Q[2, 3] = 0.9 * width
    Q[3, 2] = 1.0 / 4.8
    return Q


def _to_host(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


class Engine:
    """Pipeline orchestrator (Estimator parity) for one device.

    device: "cuda" (the kernels run on the card; raises when CUDA is not
    available) or "cpu" (the kernels' plain versions run, for tests)."""

    def __init__(
        self,
        cfg: EngineConfig,
        rectification: Optional[RectificationResult] = None,
        source=None,
        device="cuda",
    ):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): CUDA is not available")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        if cfg.batch != 1 or cfg.enable_post_filter or cfg.show_disparity_value:
            raise NotImplementedError(
                "the port runs batch=1 without WLS or show_disparity_value; "
                "see ROADMAP.md")
        self.cfg = cfg
        self.device = device
        self.source = source if source is not None else make_source(cfg)
        self.decoder = None  # built at the first MJPEG frame
        W, H = self.source.width, self.source.height

        # rectification constants; a rectified source keeps identity maps
        if rectification is not None and not getattr(self.source, "rectified", False):
            self.map_left = rectification.map_left.astype(np.float32)
            self.map_right = rectification.map_right.astype(np.float32)
        else:
            self.map_left = self.map_right = _identity_grid(W, H)
        if rectification is not None:
            rx, ry, rw, rh = rectification.roi
            rx, ry = max(0, min(rx, W - 1)), max(0, min(ry, H - 1))
            rw, rh = min(rw, W - rx), min(rh, H - ry)
            self.roi = (rx, ry, rw, rh)
            self.Q = np.asarray(rectification.Q, np.float64)
        else:
            self.roi = (0, 0, W, H)
            q_fn = getattr(self.source, "q_matrix", None)
            self.Q = q_fn() if q_fn is not None else _default_q(W, H)

        # resolution-aware derived values (cmdline-parser.h:80-89)
        self.num_disparities = max(16, (cfg.scaled_num_disparities(W) // 16) * 16)
        self.min_object_size = max(1, cfg.scaled_min_object_size(W, H))
        mcfg = cfg.matcher.replace(num_disparities=self.num_disparities)
        if mcfg.kind not in ("bm", "sgm"):
            raise ValueError(f"unknown matcher kind {mcfg.kind!r}")
        if mcfg.kind == "sgm":
            if mcfg.block_size == 13:
                mcfg = mcfg.replace(block_size=5)  # SGBM reference block size
            check_sgm_config(mcfg, self.roi[2])
        self.matcher_config = mcfg

        hsv = cfg.hsv_range()
        self.hsv_low = np.asarray(hsv.low, np.uint8)
        self.hsv_high = np.asarray(hsv.high, np.uint8)

        self.state = engine_state_from_numpy(
            self.map_left, self.map_right, self.roi, self.Q, self.hsv_low,
            self.hsv_high, mcfg, self.min_object_size, device)
        self.stats = ExecTimeStats(cfg.enable_execution_time_measurement)
        self._last: Tuple[Optional[np.ndarray], Optional[np.ndarray]] = (None, None)
        # transient corrupt frames reuse the previous image; this many
        # consecutive failures is a dead stream
        self.max_consecutive_decode_failures = 30
        self._consecutive_failures = 0
        self._frames_done = 0

    # -- device program ----------------------------------------------------
    def frame_program(self, left_rgb: torch.Tensor, right_rgb: torch.Tensor,
                      plain: bool = False,
                      mark: Optional[Callable[[str], None]] = None) -> dict:
        """One frame on (H, W, 3) uint8 device tensors -> dict of device
        tensors (FrameResult's fields). plain=True runs the kernels' plain
        PyTorch versions instead (the reference for the card's kernels).
        mark(name), when given, is called after each stage (a stage
        profile records a CUDA event there)."""
        cfg, st = self.cfg, self.state
        mark = mark or (lambda name: None)
        lg = rgb_to_gray(left_rgb)
        rg = rgb_to_gray(right_rgb)
        mark("gray x2")
        # the left gray and RGB planes share a map: one 4-channel remap
        lrect4 = remap_bilinear(torch.cat([lg[..., None], left_rgb], dim=-1),
                                st.left, plain=plain)
        lrect = lrect4[..., 0].contiguous()
        rgbr = lrect4[..., 1:]
        rrect = remap_bilinear(rg, st.right, plain=plain)
        mark("remap K1 (left 4-ch + right 1-ch)")

        hsv = rgb_to_hsv(rgbr)
        mask = in_range(hsv, st.hsv_low, st.hsv_high)
        mark("HSV + inRange")
        filt = morph_open_close(mask, st.morph_segments)
        mark("morphology open+close")
        boxes = detect_objects(filt, st.min_object_size, cfg.max_objects,
                               plain=plain)
        mark("detect: K2 boxes, roots")
        if st.matcher.kind == "sgm":
            disp = stereo_sgbm(lrect, rrect, st.matcher, plain=plain, mark=mark)
        else:
            # ROI2 intentionally unset (the reference's FIXME,
            # estimator.cpp:55)
            disp = stereo_bm(lrect, rrect, st.matcher,
                             roi1=matching_region(boxes), roi2=None,
                             plain=plain)
            mark("BM matcher (K8, K6, speckle)")

        dint = disparity_fixed_to_float(disp)
        xyz = reproject_to_3d(dint, st.Q, st.matcher.min_disparity, True)
        mark("/16 + reprojection")
        depth_cm, mean_z, count = calc_depth(xyz, filt, boxes,
                                             cfg.calibration_unit_mm)
        mark("calc_depth")
        return dict(disparity=disp, boxes=boxes, depth_cm=depth_cm,
                    mean_z=mean_z, count=count, mask=filt, rgb_rect=rgbr)

    def _dispatch(self, left: np.ndarray, right: np.ndarray) -> dict:
        """H2D + the frame program for one decoded pair (device outputs)."""
        return self.frame_program(torch.from_numpy(left).to(self.device),
                                  torch.from_numpy(right).to(self.device))

    # -- host loop ---------------------------------------------------------
    def _decode_eye(self, frame, slot: int) -> Optional[np.ndarray]:
        if frame.encoding == "raw":
            return frame.array
        if self.decoder is None:
            from rt_depth_map_tpu_torch.decode import MJPEGDecoder

            self.decoder = MJPEGDecoder()
        arr = self.decoder.decode(frame.data, self.source.width, self.source.height)
        if arr is None:
            # corrupt frame: keep previous image (mjpeg-decoder-sw.cpp:108-110)
            return self._last[slot]
        return arr

    def process_pair(self, left_rgb: np.ndarray, right_rgb: np.ndarray) -> FrameResult:
        """Run the frame program on one decoded RGB pair."""
        return FrameResult(**_to_host(self._dispatch(left_rgb, right_rgb)))

    def step(self) -> Optional[FrameResult]:
        """One iteration of the frame loop (estimator.cpp:18-82)."""
        st = self.stats
        st.start_iteration()
        pair = self._grab_decode()
        if pair is None:
            return None  # nothing decoded yet at all
        with st.measure("h2d+device+d2h"):
            result = self.process_pair(*pair)
        self._frames_done += 1
        return result

    def _grab_decode(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """One grab+decode with the stale-frame/health bookkeeping; returns
        the decoded pair or None when nothing decoded yet."""
        st = self.stats
        with st.measure("grabOneFrame"):
            lf, rf = self.source.grab()
        with st.measure("decode"):
            left = self._decode_eye(lf, 0)
            right = self._decode_eye(rf, 1)
        fresh = (
            (lf.encoding == "raw" or left is not self._last[0])
            and (rf.encoding == "raw" or right is not self._last[1])
        )
        if not fresh:
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.max_consecutive_decode_failures:
                raise RuntimeError(
                    f"stream unhealthy: {self._consecutive_failures} "
                    f"consecutive decode failures"
                )
        else:
            self._consecutive_failures = 0
        if left is None or right is None:
            return None
        self._last = (left, right)
        return left, right

    def run(
        self,
        frames: Optional[int] = None,
        on_frame: Optional[Callable[[int, FrameResult], None]] = None,
        print_stats_on_sigint: bool = True,
        pipeline_depth: int = 2,
        prefetch: bool = True,
    ) -> int:
        """Blocking frame loop; frames=None runs until SIGINT. Returns the
        number of loop iterations.

        Up to `pipeline_depth` frames are in flight: results are pulled to
        the host only for a consumer (`on_frame`); otherwise one small field
        is read every few frames as backpressure. prefetch=True moves
        grab+decode to a background thread with a small queue, so camera and
        decoder latency overlap the device."""
        stop = {"flag": False}

        def handler(signum, frame):
            stop["flag"] = True

        old = None
        if print_stats_on_sigint:
            try:
                old = signal.signal(signal.SIGINT, handler)
            except ValueError:
                old = None  # non-main thread

        from collections import deque

        depth = max(1, pipeline_depth)
        pending = deque()  # (index, device output dict)
        sync_every = 8
        st = self.stats
        st.mark_overlapped("d2h")

        def retire(idx, out):
            if on_frame is not None:
                with st.measure("d2h"):
                    host = _to_host(out)
                if on_frame(idx, FrameResult(**host)) is False:
                    stop["flag"] = True  # consumer requested stop
            elif idx % sync_every == 0:
                with st.measure("d2h"):
                    out["count"].cpu()  # backpressure only

        producer = None
        pstop = None
        q = None
        perr: list = []
        if prefetch:
            import queue as _queue
            import threading

            st.mark_overlapped("grabOneFrame")
            st.mark_overlapped("decode")
            q = _queue.Queue(maxsize=depth + 2)
            pstop = threading.Event()

            def _produce():
                # a finite source must not be read past what the loop uses
                produced = 0
                while not pstop.is_set() and (frames is None or produced < frames):
                    try:
                        pair = self._grab_decode()
                    except Exception as e:  # dead stream: fail the loop
                        perr.append(e)
                        return
                    if pair is None:
                        continue
                    while not pstop.is_set():
                        try:
                            q.put(pair, timeout=0.1)
                            produced += 1
                            break
                        except _queue.Full:
                            continue

            producer = threading.Thread(target=_produce, daemon=True,
                                        name="rtdm-ingest")
            producer.start()

        def next_pair():
            if not prefetch:
                return self._grab_decode()
            import queue as _queue

            while True:
                if perr:
                    # pairs already decoded go first, then the failure
                    try:
                        return q.get_nowait()
                    except _queue.Empty:
                        raise perr[0] from None
                if stop["flag"]:
                    return None
                try:
                    with st.measure("grab (queue wait)"):
                        return q.get(timeout=0.1)
                except _queue.Empty:
                    continue

        try:
            i = 0
            done0 = self._frames_done
            t_loop0 = time.perf_counter()
            while frames is None or i < frames:
                if stop["flag"]:
                    break
                st.start_iteration()
                pair = next_pair()
                if pair is not None:
                    with st.measure("dispatch"):
                        pending.append((i, self._dispatch(*pair)))
                    self._frames_done += 1
                while len(pending) >= depth:
                    retire(*pending.popleft())
                i += 1
            while pending:
                retire(*pending.popleft())
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            st.note_wall(self._frames_done - done0, time.perf_counter() - t_loop0)
            if stop["flag"] and print_stats_on_sigint:
                print(st.report(), file=sys.stderr)
            return i
        finally:
            if pstop is not None:
                pstop.set()
            if producer is not None:
                producer.join(timeout=2.0)
            if old is not None:
                signal.signal(signal.SIGINT, old)

    def warmup(self) -> float:
        """Run one black frame (builds the kernels on first use); returns
        seconds."""
        W, H = self.source.width, self.source.height
        z = np.zeros((H, W, 3), np.uint8)
        t0 = time.perf_counter()
        self.process_pair(z, z)
        return time.perf_counter() - t0

    def close(self) -> None:
        self.source.close()
