# Copy of rt_depth_map_tpu/cli.py; the port imports nothing of the JAX package.
"""App entry point (L3, reference main.cpp + utils/cmdline-parser.cpp).

Port of `rt_depth_map_tpu/cli.py`: the same flag schema, defaults and
choices, and the same `config_from_args`; `--backend` goes into
`MatcherConfig.backend` as there. The JAX-only start-up (platform pinning,
the compilation cache, TUNED.env) has no counterpart: the kernels build with
nvcc at first use. One flag is added, `--device {cuda,cpu}` (the
counterpart of JAX_PLATFORMS): cuda runs the kernels on the card and fails
when CUDA is not there; cpu runs their plain versions.

Flag schema mirrors EstimatorCmdLineParser (cmdline-parser.cpp:12-25):
height/width, adjustable, disparity-map, camera devices, calibration files,
number-of-disparities, minimal-object-size, calibration-unit -- plus the
source selection and matcher options this framework adds (the reference
hardcodes matcher choice at main.cpp:130).

Usage: python -m rt_depth_map_tpu_torch --source synthetic --frames 10 --stats
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import torch

from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rt-depth-map-torch",
        description="realtime stereo depth engine on a CUDA device "
        "(capability parity with wafgo/rt-depth-map)",
    )
    # reference flags (cmdline-parser.cpp:12-25); -h is argparse help, so
    # height uses --height/-H
    p.add_argument("-H", "--height", type=int, default=720)
    p.add_argument("-W", "--width", type=int, default=1280)
    p.add_argument("-a", "--adjustable", action="store_true",
                   help="enable runtime HSV threshold adjustment")
    p.add_argument("-dp", "--disparity-map", action="store_true", default=True,
                   help="compute/emit the disparity visualization")
    p.add_argument("-lcd", "--left-camera-device", default="/dev/video0")
    p.add_argument("-rcd", "--right-camera-device", default="/dev/video1")
    p.add_argument("-i", "--intrinsics-file-name", default=None,
                   help="intrinsics.yml (OpenCV FileStorage)")
    p.add_argument("-e", "--extrinsics-file-name", default=None,
                   help="extrinsics.yml (OpenCV FileStorage)")
    p.add_argument("-nd", "--number-of-disparities", type=int, default=192,
                   help="width-scaled like the reference (cmdline-parser.h:85-89)")
    p.add_argument("-mos", "--minimal-object-size", type=int, default=100,
                   help="area-scaled minimum object size")
    p.add_argument("-cu", "--calibration-unit", type=float, default=25.0,
                   help="calibration length unit in mm")
    p.add_argument("--object-color", default="red",
                   choices=["red", "blue", "green", "yellow", "orange"])
    # framework-specific
    p.add_argument("--source", default="synthetic",
                   choices=["synthetic", "files", "v4l2"])
    p.add_argument("--source-path", default=None,
                   help="directory with left_*/right_* images (source=files)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--matcher", default="bm", choices=["bm", "sgm"])
    p.add_argument("--paths", type=int, default=8, choices=[4, 5, 8],
                   help="SGM path count")
    p.add_argument("--backend", default="auto", choices=["auto", "xla", "pallas"])
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: run until SIGINT)")
    p.add_argument("--stats", action="store_true",
                   help="print the per-stage timing table at exit")
    p.add_argument("--save-frames", default=None, metavar="DIR",
                   help="write disparity/depth visualizations per frame")
    p.add_argument("--view", action="store_true",
                   help="live depth/disparity windows (falls back to "
                   "headless when no display; implied by --adjustable)")
    p.add_argument("--print-depth", action="store_true",
                   help="print per-object depth labels per frame")
    p.add_argument("--mjpeg", action="store_true",
                   help="JPEG-encode synthetic frames to exercise the decoder")
    p.add_argument("--preload", type=int, default=0, metavar="N",
                   help="upload N decoded pairs once and cycle them on "
                   "device (zero-copy-ingest throughput mode; requires "
                   "--frames)")
    p.add_argument("--synthetic-ring", type=int, default=8, metavar="N",
                   help="pre-rendered synthetic frame ring size (0 = "
                   "re-render every frame; default 8: a camera delivers "
                   "frames at sensor rate, the numpy scene painter does not)")
    p.add_argument("--no-prefetch", action="store_true",
                   help="disable the background grab+decode thread "
                   "(capture then serializes in front of dispatch, like "
                   "the reference's single-buffered V4L2 loop)")
    p.add_argument("--post-filter", action="store_true",
                   help="WLS disparity refinement (ENABLE_POST_FILTER)")
    p.add_argument("--show-disparity-value", action="store_true",
                   help="append mean disparity to labels (SHOW_DISPARITY_VALUE)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the kernels on the card (fails without CUDA); "
                   "cpu: their plain PyTorch versions")
    return p


def config_from_args(args) -> EngineConfig:
    return EngineConfig(
        width=args.width,
        height=args.height,
        adjustable=args.adjustable,
        show_disparity_map=args.disparity_map,
        left_camera_device=args.left_camera_device,
        right_camera_device=args.right_camera_device,
        intrinsics_file=args.intrinsics_file_name or "intrinsics.yml",
        extrinsics_file=args.extrinsics_file_name or "extrinsics.yml",
        number_of_disparities=args.number_of_disparities,
        minimal_object_size=args.minimal_object_size,
        calibration_unit_mm=args.calibration_unit,
        object_color=args.object_color,
        source=args.source,
        source_path=args.source_path,
        seed=args.seed,
        enable_post_filter=args.post_filter,
        show_disparity_value=args.show_disparity_value,
        matcher=MatcherConfig(
            kind=args.matcher, num_paths=args.paths, backend=args.backend
        ),
    )


def make_engine(args):
    """The engine `main` runs for parsed arguments: the configuration, the
    rectification from the calibration files (with the intrinsics-file
    resolution override) and the source."""
    cfg = config_from_args(args)

    rectification = None
    if args.intrinsics_file_name and args.extrinsics_file_name:
        from rt_depth_map_tpu_torch.calib import compute_rectification

        rectification = compute_rectification(
            args.intrinsics_file_name,
            args.extrinsics_file_name,
            (cfg.width, cfg.height),
        )
        # The intrinsics-file resolution overrides the CLI size for capture
        # and the whole pipeline, exactly like the reference's by-reference
        # imgSize (main.cpp:87-90,116,123-125) -- while the CLI-configured
        # size stays the denominator of the width/area-scaled derived
        # values, like the parser's stored w/h (cmdline-parser.h:80-89).
        if rectification.image_size != (cfg.width, cfg.height):
            print(
                f"intrinsics resolution override: "
                f"{cfg.width}x{cfg.height} -> "
                f"{rectification.image_size[0]}x{rectification.image_size[1]}"
                f" (main.cpp:87-90 parity)",
                file=sys.stderr,
            )
            cfg = cfg.replace(
                capture_width=rectification.image_size[0],
                capture_height=rectification.image_size[1],
            )

    source = None
    if args.source == "synthetic":
        from rt_depth_map_tpu_torch.sources import SyntheticStereoSource

        source = SyntheticStereoSource(
            cfg.capture_width or cfg.width,
            cfg.capture_height or cfg.height,
            seed=cfg.seed,
            encode="mjpeg" if args.mjpeg else "raw",
            ring=args.synthetic_ring,
        )

    from rt_depth_map_tpu_torch.pipeline import Engine

    return Engine(cfg, rectification=rectification, source=source,
                  device=args.device)


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.preload > 0 and not args.frames:
        print("--preload requires --frames", file=sys.stderr)
        return 2
    engine = make_engine(args)
    cfg = engine.cfg
    device = (torch.cuda.get_device_name(engine.device)
              if engine.device.type == "cuda" else "cpu (plain versions)")
    print(
        f"rt-depth-map-torch: "
        f"{cfg.capture_width or cfg.width}x{cfg.capture_height or cfg.height}, "
        f"matcher={args.matcher}, "
        f"D={engine.num_disparities}, roi={engine.roi}, device={device}",
        file=sys.stderr,
    )
    t = engine.warmup()
    print(f"built the kernels and ran a first frame in {t:.1f}s", file=sys.stderr)

    saver = None
    if args.save_frames:
        os.makedirs(args.save_frames, exist_ok=True)

        def saver(i, result):
            from rt_depth_map_tpu_torch.utils.vis import save_frame_visualization

            save_frame_visualization(
                os.path.join(args.save_frames, f"frame_{i:05d}.png"), result
            )

    viewer = None
    if args.view or args.adjustable:
        # live "depth"/"disparity" windows + -a HSV trackbars
        # (estimator.cpp:71-81,294-304); headless environments get None
        from rt_depth_map_tpu_torch.utils.viewer import make_viewer

        viewer = make_viewer(engine, args.disparity_map, args.adjustable)
        if viewer is None:
            print("no display available; running headless", file=sys.stderr)

    def on_frame(i, result):
        if args.print_depth:
            labels = result.labels()
            txt = ", ".join(f"({x},{y}) {s}" for x, y, s in labels) or "no objects"
            print(f"frame {i}: {txt}")
        if saver is not None:
            saver(i, result)
        if viewer is not None and not viewer.show(i, result):
            return False  # ESC/window close stops Engine.run

    consumer = on_frame if (args.print_depth or saver or viewer) else None
    if args.preload > 0:
        n = engine.run_preloaded(frames=args.frames, n_inputs=args.preload)
    else:
        n = engine.run(frames=args.frames, on_frame=consumer,
                       prefetch=not args.no_prefetch)
    if viewer is not None:
        viewer.close()
    if args.stats:
        print(engine.stats.report(), file=sys.stderr)
    engine.close()
    print(f"processed {n} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
