#!/usr/bin/env python3
"""Host cost of the port's trace spans (`pipeline/stats.py` `span`).

    python3 tools/time_torch_spans.py [--device cuda|cpu] [--rounds N]

From the root of a checkout. Prints one JSON line:

- `site_ns`: a span site with no profiler running (`with span(name)`),
  against the shared null context alone, an empty call of one argument
  (what a point callback cost) and an unconditional `record_function`;
  the median of 7 timings of 200000 sites each, on the host's CPU;
- `frame_host_us`: the host time of one call of the frame program (its
  enqueue; the device is synchronised after each call, outside the timed
  part), median over ROUNDS rounds of 20 frames, with the spans and with
  every span site switched to the null context, with no profiler and
  under torch.profiler (host and device activities); the four modes take
  turns inside each round. chip_smoke.py's BM engine of a 1280x720
  configuration (D 192, block size 13, D scaled with the width) on its
  synthetic frames: on the card at 1920x1080 (D=288, the benchmark's
  cell), on the CPU at 320x180 (D=48, the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import timeit
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FRAMES = 20
MODES = (("spans", False), ("none", False), ("spans", True), ("none", True))


def site_ns() -> dict:
    from torch.autograd.profiler import record_function

    from rt_depth_map_tpu_torch.pipeline import stats

    span, null = stats.span, stats._NO_SPAN

    def point(name):
        pass

    def with_span():
        with span("rtdm.stage.match"):
            pass

    def with_null():
        with null:
            pass

    def with_rf():
        with record_function("rtdm.stage.match"):
            pass

    n = 200000
    out = {}
    for name, fn, count in (("span", with_span, n), ("null_context", with_null, n),
                            ("point_call", lambda: point("rtdm.stage.match"), n),
                            ("record_function", with_rf, n // 20)):
        out[name] = statistics.median(timeit.repeat(fn, number=count, repeat=7)) / count * 1e9
    return out


def frame_host_us(device: str, rounds: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from rt_depth_map_tpu_torch.ops import bm, sgbm
    from rt_depth_map_tpu_torch.pipeline import engine, stats

    if device == "cuda":
        from rt_depth_map_tpu_torch.ops.cuda import KERNELS, _build

        _build.build_all(sorted({src.rsplit("/", 1)[1][:-3] for _, src, _ in KERNELS}))
        w, h = 1920, 1080
    else:
        w, h = 320, 180
    cs.DEV = device
    # the BM defaults of a 1280x720 configuration: D 192 scaled with the width
    eng = cs._engine("bm-default", w, h)
    lnp, rnp, _, _ = eng.source.render(0)
    pair = (torch.from_numpy(lnp).to(device), torch.from_numpy(rnp).to(device))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sites = (stats, engine, bm, sgbm)
    real = stats.span

    def switch(on: bool) -> None:
        for mod in sites:
            mod.span = real if on else (lambda name: stats._NO_SPAN)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    times = {f"{s}{'_profiled' if p else ''}": [] for s, p in MODES}
    for _ in range(3):
        eng.frame_program(*pair)
    sync()
    try:
        for _ in range(rounds):
            for spans_on, profiled in MODES:
                switch(spans_on == "spans")
                prof = profile(activities=acts) if profiled else None
                if prof:
                    prof.start()
                key = f"{spans_on}{'_profiled' if profiled else ''}"
                for _ in range(FRAMES):
                    t = time.perf_counter()
                    eng.frame_program(*pair)
                    times[key].append((time.perf_counter() - t) * 1e6)
                    sync()
                if prof:
                    prof.stop()
    finally:
        switch(True)
    return {k: statistics.median(v) for k, v in times.items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--rounds", type=int, default=5)
    a = p.parse_args()
    import torch

    card = torch.cuda.get_device_name(0) if a.device == "cuda" else "cpu"
    out = {"device": card, "torch": torch.__version__, "site_ns": site_ns(),
           "frame_host_us": frame_host_us(a.device, a.rounds)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
