"""The Engine: host frame loop + the per-frame program on the port's device.

Port of `rt_depth_map_tpu/pipeline/engine.py`. Host side: grab -> MJPEG
decode (stale-frame reuse on corrupt input) -> H2D from pinned memory, with
an optional prefetch thread (`run`), device-resident inputs cycled through
the program (`run_preloaded`), or B rigs a step (`step_batch`). Device side,
one method per frame:

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
With `enable_post_filter` (the reference's ENABLE_POST_FILTER), a right-view
matcher of the same kind runs over the mirrored range on (right, left),
without ROI, LR check or speckle filter, and the WLS filter (`ops/wls.py`:
the LR confidence, then the smoother kernel's row and column solves)
refines the left disparity into `filtered_disparity`. With
`show_disparity_value`, `disparity_mean` holds each box's mean disparity
over the depth mean's pixels, and `labels()` shows it.

The HSV thresholds and the minimum object size change at run time
(`set_hsv_thresholds`, `set_min_object_size`) without a rebuild.

Dispatch: `_dispatch` runs the frame program on one pair, host images or
device tensors. On the card the pair goes into the input buffers of its
shape's capture (`pipeline/graphs.py`): the first frame of a shape runs
eagerly, the second is captured, cut at the program's spans, and every
later frame replays; the setters drop the captures. With
`EngineConfig.batch` B > 1, `_dispatch_rigs` runs B pairs as one B-frame
program (`batch_program`, the reference's fused `_build_batch_frame_fn`),
eagerly: the batched K1, the colour and morphology stages over the batch,
detection frame by frame, and for SGM `stereo_sgbm_batch`, whose K3, K12,
K4, K12, K5 and K6 are each one launch for the B frames; each of its
frames equals `frame_program` on its pair. Each dispatch returns the
program's device outputs and the `SweepCounter` its K2 calls wrote their
sweep counts into: a capture's own, or the engine's for an eager program.
There is no compile step; the CUDA kernels build at their first launch.

Retire: every caller that hands results over (`process_pair`, `step`,
`run` with a consumer, `process_batch`, `step_batch`) takes a program's
outputs and sweep words with `_send`, inside the dispatch and before the
next upload: on the card each is copied without waiting into pinned host
memory of its own and an event is recorded (span `rtdm.engine.d2h_async`),
so the card runs the next program while the host hands this one over; on
the CPU the outputs are held and the words copied. `_receive` waits for
that event alone (on the CPU it copies the fields to numpy) and, while a
profiler runs, puts the program's own sweeps into the trace as
`rtdm.count.cc_sweeps.<n>`, one range a program run. `run` without a
consumer and `run_preloaded` hand nothing over: they read one small field
every few frames as backpressure.
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
from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import SweepCounter
from rt_depth_map_tpu_torch.ops.cuda.remap import (
    rectify_pair,
    rectify_pair_batch,
    rectify_pair_batch_plain,
    rectify_pair_plain,
)
from rt_depth_map_tpu_torch.ops.detect import detect_objects, matching_region
from rt_depth_map_tpu_torch.ops.morphology import morph_open_close
from rt_depth_map_tpu_torch.ops.reproject import (
    calc_depth,
    disparity_fixed_to_float,
    reproject_to_3d,
)
from rt_depth_map_tpu_torch.ops.sgbm import check_config as check_sgm_config
from rt_depth_map_tpu_torch.ops.sgbm import stereo_sgbm, stereo_sgbm_batch
from rt_depth_map_tpu_torch.ops.wls import right_matcher_config, wls_filter
from rt_depth_map_tpu_torch.pipeline.graphs import FrameGraphs
from rt_depth_map_tpu_torch.pipeline.stats import ExecTimeStats, count, span
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
    #: WLS-refined disparity (ENABLE_POST_FILTER), None unless enabled
    filtered_disparity: Optional[np.ndarray] = None
    #: (K,) mean disparity per box (SHOW_DISPARITY_VALUE), None unless enabled
    disparity_mean: Optional[np.ndarray] = None

    @property
    def has_objects(self) -> bool:
        return bool(self.boxes[:, 4].sum() > 0)

    def labels(self):
        """(x, y, 'NNN cm') depth labels (set_label parity,
        estimator.cpp:250-259); appends ' disparity = N' when
        SHOW_DISPARITY_VALUE output is present."""
        out = []
        for i, (box, cm) in enumerate(zip(self.boxes, self.depth_cm)):
            if box[4] and np.isfinite(cm):
                txt = f"{cm:.0f} cm"
                if self.disparity_mean is not None and np.isfinite(
                    self.disparity_mean[i]
                ):
                    txt += f" disparity = {self.disparity_mean[i]:.1f}"
                out.append((int(box[0]), int(box[1]), txt))
        return out


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
    return {k: v.cpu().numpy() for k, v in out.items() if v is not None}


#: fields of fewer bytes than this (the per-box arrays) are copied out of
#: their pinned memory when the program retires and it returns to the cache:
#: a consumer may keep them for every frame, and each block it kept would
#: take a page-locked allocation of its own. The images are handed over in it.
_COPY_OUT_BYTES = 1 << 16


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """`t` copied without waiting, on the current stream, into new pinned
    host memory (PyTorch's caching host allocator)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)


class _Sent:
    """One program's outputs and the words of its K2 sweep counter on their
    way to the host, taken right behind the program. On the card (`stream`
    given) each is copied without waiting into pinned memory of its own,
    then an event is recorded on `stream`: the memory returns to the
    allocator's cache only when the FrameResult that holds it is dropped,
    so no later program writes it. On the CPU the program has run: the
    outputs are its own and the words a copy."""

    def __init__(self, out: dict, sweeps: SweepCounter, stream=None):
        words = sweeps.words[:sweeps.calls]
        self.done = None
        if stream is None:
            self.out, self.sweeps = out, words.clone()
            return
        self.out = {k: _pinned_copy(v) for k, v in out.items() if v is not None}
        self.sweeps = _pinned_copy(words)
        self.done = torch.cuda.Event()
        self.done.record(stream)

    def wait(self) -> dict:
        """The fields as numpy arrays, once the copies are done."""
        if self.done is None:
            return _to_host(self.out)
        self.done.synchronize()
        return {k: v.numpy() if v.nbytes >= _COPY_OUT_BYTES else v.numpy().copy()
                for k, v in self.out.items()}

    def sweep_count(self) -> int:
        """K2's sweeps of the program, summed over its calls (after `wait`)."""
        return int(self.sweeps.sum())


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
            if cfg.enable_post_filter:
                check_sgm_config(right_matcher_config(mcfg), self.roi[2])
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
        # the single-frame program's captures on the card, one an input shape
        self._graphs = FrameGraphs(device) if device.type == "cuda" else None
        # K2's sweeps of the eager programs (three calls a frame)
        self._sweeps = SweepCounter(device, 16 * max(1, cfg.batch))

    # -- device program ----------------------------------------------------
    def _depth(self, disp, filt, boxes, rgbr, filtered) -> dict:
        """/16, the reprojection and the per-box depth of one frame or a
        batch (leading B), and the output dict."""
        st = self.state
        with span("rtdm.stage.reproject"):
            dint = disparity_fixed_to_float(disp)
            xyz = reproject_to_3d(dint, st.Q, st.matcher.min_disparity, True)
        # SHOW_DISPARITY_VALUE (estimator.h:33): the mean disparity per box
        # over the same accepted pixels as the depth mean
        extra = dint if self.cfg.show_disparity_value else None
        with span("rtdm.stage.depth"):
            depth_cm, mean_z, count, *disp_mean = calc_depth(
                xyz, filt, boxes, self.cfg.calibration_unit_mm, extra=extra)
        return dict(disparity=disp, boxes=boxes, depth_cm=depth_cm,
                    mean_z=mean_z, count=count, mask=filt, rgb_rect=rgbr,
                    filtered_disparity=filtered,
                    disparity_mean=disp_mean[0] if disp_mean else None)

    def frame_program(self, left_rgb: torch.Tensor, right_rgb: torch.Tensor,
                      plain: bool = False) -> dict:
        """One frame on (H, W, 3) uint8 device tensors -> dict of device
        tensors (FrameResult's fields). plain=True runs the kernels' plain
        PyTorch versions instead (the reference for the card's kernels).
        While a profiler runs, each stage is a span `rtdm.stage.<key>`:
        gray, rectify, hsv, morphology, detect, match (the matcher's steps
        are its `rtdm.match.*` spans), match_right and wls with the post
        filter, reproject, depth."""
        cfg, st = self.cfg, self.state
        with span("rtdm.stage.gray"):
            lg = rgb_to_gray(left_rgb)
            rg = rgb_to_gray(right_rgb)
        # both views' planes (left gray and RGB, right gray) in one launch
        rectify = rectify_pair_plain if plain else rectify_pair
        with span("rtdm.stage.rectify"):
            lrect, rgbr, rrect = rectify(lg, left_rgb, rg, st.left, st.right)
        with span("rtdm.stage.hsv"):
            hsv = rgb_to_hsv(rgbr)
            mask = in_range(hsv, st.hsv_low, st.hsv_high)
        with span("rtdm.stage.morphology"):
            filt = morph_open_close(mask, st.morph_segments)
        with span("rtdm.stage.detect"):
            boxes = detect_objects(filt, st.min_object_size, cfg.max_objects,
                                   plain=plain)
        with span("rtdm.stage.match"):
            if st.matcher.kind == "sgm":
                disp = stereo_sgbm(lrect, rrect, st.matcher, plain=plain)
            else:
                # ROI2 intentionally unset (the reference's FIXME,
                # estimator.cpp:55)
                disp = stereo_bm(lrect, rrect, st.matcher,
                                 roi1=matching_region(boxes), roi2=None,
                                 plain=plain)
        filtered = None
        if cfg.enable_post_filter:
            # ENABLE_POST_FILTER (estimator.cpp:59-71): the right-view
            # matcher, then the confidence-weighted WLS refinement
            rcfg = right_matcher_config(st.matcher)
            match = stereo_sgbm if st.matcher.kind == "sgm" else stereo_bm
            with span("rtdm.stage.match_right"):
                disp_r = match(rrect, lrect, rcfg, plain=plain)
            with span("rtdm.stage.wls"):
                filtered, _ = wls_filter(disp, disp_r, lrect, st.matcher,
                                         plain=plain)
        return self._depth(disp, filt, boxes, rgbr, filtered)

    def batch_program(self, lefts: torch.Tensor, rights: torch.Tensor,
                      plain: bool = False) -> dict:
        """B frames on (B, H, W, 3) uint8 device tensors -> dict of stacked
        device tensors (FrameResult's fields with a leading B), frame b
        equal to `frame_program(lefts[b], rights[b])`: the reference's
        B-frame program (`_step_batch`, its fused form): gray, one batched
        K1 launch (`rectify_pair_batch`), HSV, inRange and morphology over
        the batch, detection frame by frame, `stereo_sgbm_batch` (BM:
        `stereo_bm` frame by frame in each frame's ROI), with the post
        filter the right matcher through `stereo_sgbm_batch` and the WLS
        filter frame by frame, then the depth over the batch. plain and
        the stage spans as in `frame_program`."""
        cfg, st = self.cfg, self.state
        with span("rtdm.stage.gray"):
            lg = rgb_to_gray(lefts)
            rg = rgb_to_gray(rights)
        rectify = rectify_pair_batch_plain if plain else rectify_pair_batch
        with span("rtdm.stage.rectify"):
            lrect, rgbr, rrect = rectify(lg, lefts, rg, st.left, st.right)
        with span("rtdm.stage.hsv"):
            hsv = rgb_to_hsv(rgbr)
            mask = in_range(hsv, st.hsv_low, st.hsv_high)
        with span("rtdm.stage.morphology"):
            filt = morph_open_close(mask, st.morph_segments)
        with span("rtdm.stage.detect"):
            boxes = torch.stack([detect_objects(f, st.min_object_size,
                                                cfg.max_objects, plain=plain)
                                 for f in filt])
        with span("rtdm.stage.match"):
            if st.matcher.kind == "sgm":
                disp = stereo_sgbm_batch(lrect, rrect, st.matcher, plain=plain)
            else:
                disp = torch.stack([
                    stereo_bm(lrect[b], rrect[b], st.matcher,
                              roi1=matching_region(boxes[b]), roi2=None,
                              plain=plain)
                    for b in range(len(lrect))])
        filtered = None
        if cfg.enable_post_filter:
            rcfg = right_matcher_config(st.matcher)
            with span("rtdm.stage.match_right"):
                if st.matcher.kind == "sgm":
                    disp_r = stereo_sgbm_batch(rrect, lrect, rcfg, plain=plain)
                else:
                    disp_r = torch.stack([stereo_bm(r, lf, rcfg, plain=plain)
                                          for r, lf in zip(rrect, lrect)])
            with span("rtdm.stage.wls"):
                filtered = torch.stack([
                    wls_filter(d, dr, lf, st.matcher, plain=plain)[0]
                    for d, dr, lf in zip(disp, disp_r, lrect)])
        return self._depth(disp, filt, boxes, rgbr, filtered)

    def _upload(self, img, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decoded image (numpy or tensor) onto the device, on the
        current stream, into `out` where given. On the card the host copies
        it into pinned memory and does not wait for the device: a copy from
        pageable memory would wait for every frame queued before it. An
        image already on the device is not uploaded: it is returned, or
        copied into `out`."""
        if isinstance(img, torch.Tensor) and img.device.type == self.device.type:
            return img if out is None else out.copy_(img)
        with span("rtdm.engine.upload"):
            t = img if isinstance(img, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(img))
            if self.device.type == "cuda":
                t = t.pin_memory()
            if out is not None:
                return out.copy_(t, non_blocking=True)
            return t.to(self.device, non_blocking=True)

    def _dispatch(self, left, right) -> Tuple[dict, SweepCounter]:
        """The frame program for one decoded pair, host images or device
        tensors: (its device outputs, the counter its K2 sweeps went into).
        On the card the pair goes into the input buffers of its shape's
        capture, whose graphs replay; a replay's outputs are the capture's
        own, which the next replay rewrites."""
        if self._graphs is None:
            return self._eager(self.frame_program, self._upload(left),
                               self._upload(right))
        prog = self._graphs.get(left.shape, right.shape)
        self._upload(left, prog.left)
        self._upload(right, prog.right)
        return prog(self.frame_program), prog.sweeps

    def _dispatch_rigs(self, lefts, rights) -> Tuple[dict, SweepCounter]:
        """The batch program for B decoded pairs, each eye's B images
        uploaded as one pinned (B, H, W, 3) copy: as `_dispatch`."""
        def stacked(imgs):
            return self._upload(imgs if isinstance(imgs, torch.Tensor)
                                else np.stack(imgs))

        return self._eager(self.batch_program, stacked(lefts), stacked(rights))

    def _eager(self, program: Callable, left, right) -> Tuple[dict, SweepCounter]:
        """`program(left, right)`, its K2 sweeps counted by the engine."""
        with self._sweeps.recording():
            return program(left, right), self._sweeps

    def _send(self, out: dict, sweeps: SweepCounter) -> _Sent:
        """The outputs of the program just dispatched on their way to the
        host, inside the dispatch: on the card enqueued right behind the
        program (span `rtdm.engine.d2h_async`)."""
        if self.device.type != "cuda":
            return _Sent(out, sweeps)
        with span("rtdm.engine.d2h_async"):
            return _Sent(out, sweeps, torch.cuda.current_stream(self.device))

    def _receive(self, sent: _Sent, measure) -> dict:
        """The host fields of what `_send` returned, waited for inside
        `measure` (the caller's `rtdm.engine.d2h` span); then, under a
        profiler, the program's K2 sweeps as `rtdm.count.cc_sweeps.<n>`."""
        with measure:
            host = sent.wait()
        count("cc_sweeps", sent.sweep_count)
        return host

    # -- run-time thresholds -------------------------------------------------
    def set_hsv_thresholds(self, low, high) -> None:
        """Runtime HSV threshold adjustment (the reference's -a trackbar UI,
        estimator.cpp:294-304), for the next frame, without a rebuild. New
        device tensors go into the state: a frame still in flight keeps
        reading the ones it was given. The captured programs read the old
        ones, and are dropped."""
        self.hsv_low = np.asarray(low, np.uint8)
        self.hsv_high = np.asarray(high, np.uint8)
        self.state = dataclasses.replace(
            self.state,
            hsv_low=torch.tensor(self.hsv_low, device=self.device),
            hsv_high=torch.tensor(self.hsv_high, device=self.device))
        self._drop_captures()

    def set_min_object_size(self, min_size: int) -> None:
        """The minimum box area of the detection, for the next frame (a
        host number that the captured programs hold: they are dropped)."""
        self.min_object_size = int(min_size)
        self.state = dataclasses.replace(self.state,
                                         min_object_size=self.min_object_size)
        self._drop_captures()

    def _drop_captures(self) -> None:
        if self._graphs is not None:
            self._graphs.clear()

    # -- B rigs a step ------------------------------------------------------
    def process_batch(self, lefts, rights) -> list:
        """B decoded pairs (multi-stream batching, BASELINE.md) through the
        batch program on the current stream. Returns a list of B
        FrameResults."""
        B = self.cfg.batch
        if B <= 1:
            raise ValueError("process_batch needs EngineConfig.batch > 1")
        if not len(lefts) == B == len(rights):
            raise ValueError(f"process_batch: {len(lefts)} left and "
                             f"{len(rights)} right images for batch {B}")
        with span("rtdm.engine.dispatch"):
            sent = self._send(*self._dispatch_rigs(lefts, rights))
        host = self._receive(sent, span("rtdm.engine.d2h"))
        return [FrameResult(**{k: v[b] for k, v in host.items()})
                for b in range(B)]

    def step_batch(self) -> Optional[list]:
        """One batched iteration: grab cfg.batch pairs (one from each rig of
        a MultiStreamSource, or consecutive frames of a single source),
        decode, and run them as one step."""
        B = self.cfg.batch
        st = self.stats
        st.start_iteration()
        with st.measure("grabOneFrame", "rtdm.ingest.grab"):
            if hasattr(self.source, "grab_batch"):
                pairs = self.source.grab_batch()
            else:
                pairs = [self.source.grab() for _ in range(B)]
        with st.measure("decode", "rtdm.ingest.decode"):
            decoded = []
            for lf, rf in pairs:
                left = self._decode_eye(lf, 0)
                right = self._decode_eye(rf, 1)
                if left is not None and right is not None:
                    decoded.append((left, right))
        if len(decoded) < B:
            return None
        self._last = decoded[-1]
        with st.measure("h2d+device+d2h"):
            results = self.process_batch([d[0] for d in decoded],
                                         [d[1] for d in decoded])
        self._frames_done += B
        return results

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
        with span("rtdm.engine.dispatch"):
            sent = self._send(*self._dispatch(left_rgb, right_rgb))
        return FrameResult(**self._receive(sent, span("rtdm.engine.d2h")))

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
        with st.measure("grabOneFrame", "rtdm.ingest.grab"):
            lf, rf = self.source.grab()
        with st.measure("decode", "rtdm.ingest.decode"):
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

        Up to `pipeline_depth` frames are in flight: frame i is handed to
        the consumer (`on_frame`) after frame i + depth - 1 is dispatched and
        before frame i + depth is. On the card each frame's outputs are
        copied into pinned host memory of its own right behind its program,
        and retiring it waits for those copies alone, so the card runs the
        frames dispatched after it while the consumer runs. Without a
        consumer one small field is read every few frames as backpressure.
        prefetch=True moves grab+decode to a background thread with a small
        queue, so camera and decoder latency overlap the device."""
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
        pending = deque()  # (index, device outputs, or with a consumer `_send`'s)
        sync_every = 8
        st = self.stats
        st.mark_overlapped("d2h")

        def retire(idx, out):
            # no span encloses the consumer: it may start or stop a profiler
            if on_frame is not None:
                res = FrameResult(**self._receive(out, st.measure("d2h", "rtdm.engine.d2h")))
                if on_frame(idx, res) is False:
                    stop["flag"] = True  # consumer requested stop
            elif idx % sync_every == 0:
                with st.measure("d2h", "rtdm.engine.d2h"):
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
                    with st.measure("grab (queue wait)", "rtdm.ingest.wait"):
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
                    with st.measure("dispatch", "rtdm.engine.dispatch"):
                        out, sweeps = self._dispatch(*pair)
                        pending.append((i, out if on_frame is None
                                        else self._send(out, sweeps)))
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

    def run_preloaded(self, frames: int, n_inputs: int = 6,
                      pipeline_depth: int = 3) -> int:
        """Sustained-throughput loop over DEVICE-RESIDENT inputs: n_inputs
        distinct pairs are grabbed, decoded and uploaded ONCE, then cycled
        through the frame program for `frames` dispatches (the reference's
        device-owned buffers, include/filter/filter.h:13-37): throughput is
        bounded by the device program and its host launches, not ingest."""
        if frames <= 0:
            return 0
        st = self.stats
        pairs = []
        with st.measure("preload (grab+decode+h2d)"):
            guard = 0
            while len(pairs) < n_inputs and guard < 10 * n_inputs:
                guard += 1
                pair = self._grab_decode()
                if pair is None:
                    continue
                pairs.append((self._upload(pair[0]), self._upload(pair[1])))
            if not pairs:
                raise RuntimeError(
                    "run_preloaded: no frame pair could be grabbed+decoded "
                    f"in {guard} attempts (source unhealthy?)"
                )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        from collections import deque

        st.mark_overlapped("d2h")
        pending = deque()
        done0 = self._frames_done
        t0 = time.perf_counter()
        for i in range(frames):
            st.start_iteration()
            left, right = pairs[i % len(pairs)]
            with st.measure("dispatch", "rtdm.engine.dispatch"):
                pending.append(self._dispatch(left, right)[0])
            self._frames_done += 1
            while len(pending) >= max(1, pipeline_depth):
                out = pending.popleft()
                if i % 8 == 0:  # backpressure only
                    with st.measure("d2h", "rtdm.engine.d2h"):
                        out["count"].cpu()
        while pending:
            out = pending.popleft()
        with st.measure("d2h", "rtdm.engine.d2h"):
            out["count"].cpu()  # final completion barrier
        st.note_wall(self._frames_done - done0, time.perf_counter() - t0)
        return frames

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
