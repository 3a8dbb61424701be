"""Stretches of the window traced with torch.profiler, and what they hold.

A stretch starts and ends on frame boundaries of the host loop, each after a
device synchronise, so every device operation that the stretch's frames
launch runs inside it and nothing from before or after does. It records the
host's operations beside the device's (a trace of device activity alone
reads every duration as 0 on the card): they name what the host was doing
while the device sat idle (the breakdown's idle gaps).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

#: trace categories of device operations: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: trace categories of host work, for naming the idle gaps
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Stretch:
    """One traced stretch of `frames` frames (or steps) of the loop."""

    def __init__(self, name: str, frames: int, after: float = 0.0):
        self.name, self.frames = name, frames
        #: the share of the window that passes before it starts
        self.after = after
        self.first = None  # the loop's index at its start
        self.prof = None
        self.t0 = self.t1 = None
        self.dispatched: list = []  # (rig, frame index) launched inside

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def events(self) -> list:
        """The trace's events (chrome trace format), read back from a file
        in the run's temporary directory."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]


def device_ops(events) -> list:
    """(name, start_us, end_us) of each device operation."""
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]


def busy_intervals(ops) -> list:
    """The union of the operations' intervals, as sorted disjoint (a, b)."""
    out = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(i) for i in out]


def top_ops(ops, n: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    tot = defaultdict(float)
    for name, a, b in ops:
        tot[name[:160]] += (b - a) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, n: int = 10) -> list:
    """[what the host was doing, seconds] of the device's idle time between
    its first and last operation: each gap is named by the innermost host
    operation that covers its middle on the thread that launched the most
    kernels, or "host: between operations" where none does."""
    busy = busy_intervals(device_ops(events))
    launches = defaultdict(int)
    host = []
    for e in events:
        if e.get("cat") in HOST_CATS and "dur" in e:
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("tid")))
            if e.get("cat") == "cuda_runtime":
                launches[e.get("tid")] += 1
    tid = max(launches, key=launches.get) if launches else None
    host = sorted(h for h in host if h[3] == tid)
    starts = [h[0] for h in host]
    tot = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        name = "host: between operations"
        # on one thread the operations nest: the latest to start of those
        # still running at `mid` is the innermost (looked for among the
        # last 512 to start)
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(last - 512, -1), -1):
            if host[i][1] > mid:
                name = host[i][2]
                break
        tot[name[:160]] += (b - a) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
