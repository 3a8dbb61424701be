# Copy of rt_depth_map_tpu/config.py; the port imports nothing of the JAX package.
"""Typed configuration for the engine.

Re-creates the reference's two-tier config system (SURVEY.md section 5.6):
CLI flags with resolution-aware derived values (reference
`utils/cmdline-parser.cpp:12-25`, `include/utils/cmdline-parser.h:80-89`) and
calibration files, plus the compile-time feature flags of
`include/estimator.h:32-34` surfaced as runtime options.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HSVRange:
    """An HSV threshold range, OpenCV convention (H in [0,180), S/V in [0,255]).

    Mirrors `struct hsv_object_ranges` (reference main.cpp:38-51).
    """

    name: str
    h_low: int
    h_high: int
    s_low: int
    s_high: int
    v_low: int
    v_high: int

    @property
    def low(self) -> Tuple[int, int, int]:
        return (self.h_low, self.s_low, self.v_low)

    @property
    def high(self) -> Tuple[int, int, int]:
        return (self.h_high, self.s_high, self.v_high)


# Predefined detectable object colors (reference main.cpp:45-51). Only "red" is
# effectively used by default (reference estimator.cpp:110-115 hardcodes the
# red range as the initial thresholds).
PREDEFINED_OBJECT_COLORS = {
    "red": HSVRange("red", 0, 9, 150, 255, 0, 255),
    "blue": HSVRange("blue", 78, 111, 111, 255, 0, 255),
    "green": HSVRange("green", 61, 92, 100, 255, 0, 255),
    "yellow": HSVRange("yellow", 23, 37, 117, 255, 111, 255),
    "orange": HSVRange("orange", 6, 19, 182, 255, 0, 255),
}


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Stereo matcher parameters.

    Defaults mirror the SWMatcherKonolige construction (reference
    main.cpp:130-135, bm-sw.cpp:12-26) and SWSemiGlobalMatcher
    (sgbm-sw.cpp:12-25) with P1/P2 = 8*3*5*5 / 32*3*5*5.
    """

    kind: str = "bm"  # "bm" (StereoBM parity) | "sgm" (StereoSGBM parity)
    num_disparities: int = 192  # width-scaled at resolve time
    block_size: int = 13  # SGM reference formula implies 5 for sgm kind
    min_disparity: int = 0
    pre_filter_cap: int = 31
    texture_threshold: int = 10
    uniqueness_ratio: int = 10
    speckle_window_size: int = 100
    speckle_range: int = 32
    disp12_max_diff: int = 1
    # SGM-only:
    p1: int = 8 * 3 * 5 * 5
    p2: int = 32 * 3 * 5 * 5
    num_paths: int = 8  # 5 = cv2 MODE_SGBM single-pass parity (4 causal
    # dirs + reverse horizontal), 8 = MODE_HH (production default),
    # 4 = causal-only (direction-family tests)
    # implementation selection: "auto" benchmarks-driven, "xla" pure-JAX,
    # "pallas" hand kernel.
    backend: str = "auto"
    # width-tiled multi-chip SGM mode (parallel/): "exact" = wavefront
    # boundary-state exchange (parallel/exact_sgbm.py, bit-exact vs
    # single-device at any tile width; zero compute inflation, scaling
    # ceiling 82% at n=8 vs margin's 56% at n=4 -- docs/SCALING.md), the
    # production default; "margin" = overlap-margin approximation (tiles
    # never talk during aggregation, ~0.1% divergence, but the static
    # margin recompute bounds the scaling ceiling)
    tile_mode: str = "exact"

    def replace(self, **kw) -> "MatcherConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine configuration.

    Field defaults mirror the reference CLI schema (cmdline-parser.cpp:12-25):
    h=720, w=1280, adjustable=0, disparity-map=1, cameras /dev/video0|1,
    intrinsics/extrinsics.yml, nd=192, mos=100, cu=25.0 mm.
    """

    width: int = 1280
    height: int = 720
    # Actual capture/pipeline size when it differs from the configured one:
    # the reference's intrinsics-file resolution override (main.cpp:87-90)
    # changes imgSize (capture + pipeline) while the *configured* w/h above
    # stay the denominators of the scale_to_width/scale_to_resolution
    # derived values (cmdline-parser.h:80-89).
    capture_width: Optional[int] = None
    capture_height: Optional[int] = None
    adjustable: bool = False
    show_disparity_map: bool = True
    left_camera_device: str = "/dev/video0"
    right_camera_device: str = "/dev/video1"
    intrinsics_file: str = "intrinsics.yml"
    extrinsics_file: str = "extrinsics.yml"
    number_of_disparities: int = 192
    minimal_object_size: int = 100
    calibration_unit_mm: float = 25.0
    object_color: str = "red"

    # Source selection: "v4l2" (live cameras), "files" (recorded sequence
    # directory), "synthetic" (seeded generator; the repo-reproducible default
    # since the reference ships no image data -- SURVEY.md section 4).
    source: str = "synthetic"
    source_path: Optional[str] = None
    seed: int = 0
    # pre-rendered frame ring for the synthetic source (0 = render every
    # frame): a camera delivers frames at sensor rate; re-painting the
    # numpy scene per grab serialized ~270ms in front of the device
    # pipeline (host-ingest-at-rate, SURVEY.md section 7 hard part 6)
    synthetic_ring: int = 8

    # Feature flags (reference include/estimator.h:32-34 compile-time flags,
    # runtime here).
    enable_post_filter: bool = False  # WLS disparity post-filter
    show_disparity_value: bool = False
    enable_execution_time_measurement: bool = True
    # Numerical sanity checking (SURVEY.md section 5.2: the reference has no
    # sanitizers; the JAX-native analog is jax_debug_nans/jax_debug_infs).
    debug_checks: bool = False

    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)

    # TPU execution
    batch: int = 1  # stereo pairs per device step (multi-stream batching)
    dtype: str = "float32"
    max_objects: int = 8  # static bound on per-frame detected objects

    # ---- resolution-aware derived values (cmdline-parser.h:80-89) ----
    # The reference scales the *configured* value from the *configured*
    # resolution to the *actual* image size: numDisparities proportional to
    # width, minimalObjectSize proportional to pixel area.

    def scaled_num_disparities(self, width: int) -> int:
        """`scale_to_width` semantics (cmdline-parser.h:85-89)."""
        return int(float(self.number_of_disparities) * width / self.width)

    def scaled_min_object_size(self, width: int, height: int) -> int:
        """`scale_to_resolution` semantics (cmdline-parser.h:80-84)."""
        return int(
            float(self.minimal_object_size)
            * (width * height)
            / (self.width * self.height)
        )

    def hsv_range(self) -> HSVRange:
        return PREDEFINED_OBJECT_COLORS[self.object_color]

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    # ---- persistence: config is the framework's durable state, alongside
    # calibration (SURVEY.md section 5.4) ----

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    def save(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        d = dict(d)
        m = d.pop("matcher", None)
        cfg = cls(**d)
        if m is not None:
            cfg = cfg.replace(matcher=MatcherConfig(**m))
        return cfg

    @classmethod
    def load(cls, path: str) -> "EngineConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))
