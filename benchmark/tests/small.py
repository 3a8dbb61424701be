"""Small sizes of the cells for the CPU tests: the configurations' settings
at a few hundred pixels, with fewer frames in the ring and the warm-up; and
the manifest they run under: BENCHMARK.json with the SGBM cells that the
check leaves out of it (the port's speckle filter departs from OpenCV's on
some frames, PERF.md), so that the SGBM reference, the batch loop and their
faults stay tested."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SGBM_FILE = "benchmark/configs/sgbm-720p-d192.json"
SGBM_CONFIG = {"name": "sgbm-720p-d192",
               "source": json.loads((ROOT / SGBM_FILE).read_text())["source"],
               "file": SGBM_FILE, "reduced": [],
               "why": "upstream SGBM at the ZED's HD720, D=192"}
SGBM_CELLS = [{"name": f"sgbm-720p-d192.{t}", "config": "sgbm-720p-d192", "traffic": t,
               "chips": 1, "why": "SGBM through the same loops"} for t in ("rig1", "rigs4")]

SCENE = {"objects": [[0.16, 0.3, 0.7], [0.12, 0.25, 0.5], [0.1, 0.2, 0.35]],
         "speed_px": [1.0, 0.5]}
SIZES = {  # configuration -> (width, height, D, minimum object size)
    "sgbm-720p-d192": (192, 64, 32, 20),
    "bm-1080p-d288": (256, 96, 48, 20),
}


def overrides(workload: str, ring: int = 2) -> dict:
    """run_cell's overrides for the cell at its small size."""
    W, H, D, mos = SIZES[workload.split(".")[0]]
    return {"config": {"engine": {"width": W, "height": H, "number_of_disparities": D,
                                  "minimal_object_size": mos},
                       "matcher": {"num_disparities": D}},
            "traffic": {"warmup_frames": 4, "trace_frames": 8, "ring": ring,
                        "check_slots": ring, "reference_batch": 4, "scene": SCENE}}


def manifest() -> dict:
    """BENCHMARK.json with the SGBM configuration and cells added."""
    m = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    m["configs"].append(SGBM_CONFIG)
    m["workloads"].extend(SGBM_CELLS)
    return m
