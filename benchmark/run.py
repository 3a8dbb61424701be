"""Run one cell of the benchmark of rt_depth_map_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
Prints the card's name, clocks and power limit, then as the last line of
standard output one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics with --trace 0, its per-layer ones with
--trace 1), device, with --trace 1 the breakdown, and last the checks, each
compared number beside its limit (also the last lines of standard error).
Exits non-zero, printing no result, without the cards, when a module of JAX
or of the JAX package is loaded, or when the check cannot run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().replace("\n", " | ") or smi.stderr.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    # the program's kernel caches stay inside the checkout, at fixed paths
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness.guard import forbidden_modules

    manifest = cells.load_json(ROOT / "BENCHMARK.json")
    cell, config, _ = cells.cell_files(manifest, a.workload)
    # the host's intra-op thread pool, as the configuration states it (its
    # `assumed` gives the reason)
    torch.set_num_threads(config["host_threads"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    result = cells.run_cell(a.workload, a.seed, a.seconds, bool(a.trace), T_START,
                            manifest=manifest)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"timing: {json.dumps(result['timing'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
