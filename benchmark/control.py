"""The check's control: the reference in the program's place, computed in
the precision below the configuration's (disparities in whole pixels, the
reprojection in bfloat16), compared with the full-precision reference by
the same comparison as a run's, on the same sampled frames of each seed.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

Prints one JSON line a seed and control with the numbers and the limits:
the control ("whole_pixels+bfloat16") and each of its parts alone. The
control has to fail at least one limit on every seed. The benchmark's runs
do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: the control, then each of its parts alone
CONTROLS = (("whole_pixels", "bfloat16"), ("whole_pixels",), ("bfloat16",))


def control_numbers(workload: str, seed: int, device: str, manifest=None, overrides=None,
                    controls=CONTROLS[:1]):
    """({control: numbers}, limits) of the controls on the frames that a
    run of the cell with this seed compares: every rig at the sampled
    slots."""
    import numpy as np
    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import check
    from benchmark.harness import traffic as gen
    from benchmark.reference.frame import reference_frames

    manifest = manifest or cells.load_json(ROOT / "BENCHMARK.json")
    _, config, tr = cells.cell_files(manifest, workload, overrides)
    W, H = config["engine"]["width"], config["engine"]["height"]
    D = config["matcher"]["num_disparities"]
    scene = gen.rectification(seed, W, H, tr)
    slots = cells.sampled_slots(seed, tr)
    keys = [(r, s) for r in range(tr["rigs"]) for s in slots]
    frames = {r: gen.rig_frames(seed, r, W, H, D, tr) for r in range(tr["rigs"])}
    rows = {c: [] for c in controls}
    for i in range(0, len(keys), tr["reference_batch"]):
        part = keys[i: i + tr["reference_batch"]]
        lefts = torch.from_numpy(np.stack([frames[r][s][0] for r, s in part])).to(device)
        rights = torch.from_numpy(np.stack([frames[r][s][1] for r, s in part])).to(device)
        ref = reference_frames(lefts, rights, scene, config)
        for c in controls:
            low = reference_frames(lefts, rights, scene, config, control=c)
            for j in range(len(part)):
                rows[c].append(check.compare({k: v[j].cpu().numpy() for k, v in low.items()},
                                             {k: v[j].cpu().numpy() for k, v in ref.items()}))
    return {c: check.worst(r) for c, r in rows.items()}, config["limits"]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args()
    import torch

    from benchmark.harness import check

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    failed_all = True
    for seed in a.seeds:
        t = time.perf_counter()
        readings, limits = control_numbers(a.workload, seed, "cuda", controls=CONTROLS)
        for c, numbers in readings.items():
            ok, _ = check.verdict(numbers, limits)
            if c == CONTROLS[0]:
                failed_all &= not ok
            print(json.dumps({"workload": a.workload, "seed": seed, "control": "+".join(c),
                              "correct": ok, "numbers": numbers, "limits": limits,
                              "seconds": time.perf_counter() - t}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
