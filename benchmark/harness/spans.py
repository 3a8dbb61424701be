"""The program's spans in a traced stretch, and the device work launched
inside them.

While a profiler runs, the port opens a `record_function` range at each of
its layer and stage boundaries (`rtdm.<layer>.<step>`, `pipeline/stats.py`
`span` of the port; PERF.md lists them). The chrome trace holds each range
as a `user_annotation` event on the thread that opened it, on the clock of
the host's operations. A device operation (kernel, copy, fill) carries the
correlation id of the CUDA API call that launched it: the operation belongs
to the ranges that hold that call's start on its thread.
Kineto's `gpu_user_annotation` events (from a range's first kernel to its
last, the gaps between included) are not read.

A program without the spans (an older commit) leaves every reading here
empty: the readers then return None.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict

from benchmark.harness import trace

#: the prefix of every span the program opens
PREFIX = "rtdm."
#: trace categories of the calls that launch device operations
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def events_of(ctx: dict):
    """The stretch's chrome-trace events for a reader's context: its
    `events` where the harness puts them there, else the list that
    `harness/cell.py` `per_layer` holds while it calls the readers with
    this very context; None where neither is found."""
    if "events" in ctx:
        return ctx["events"]
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        if f.f_code.co_name == "per_layer" and loc.get("ctx") is ctx:
            events = loc.get("events")
            return events if isinstance(events, list) else None
        f = f.f_back
    return None


def _thread(e: dict) -> tuple:
    return e.get("pid"), e.get("tid")


def ranges(events, prefix: str = PREFIX) -> list:
    """(name, thread, start_us, end_us) of each range whose name starts
    with `prefix`, in the trace's order."""
    return [(e["name"], _thread(e), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("cat") == "user_annotation" and "dur" in e
            and str(e.get("name", "")).startswith(prefix)]


def total_us(events, name: str):
    """The summed duration of the ranges named `name`; None where there
    is none."""
    d = [b - a for n, _, a, b in ranges(events, name) if n == name]
    return sum(d) if d else None


def launched(events) -> dict:
    """thread -> (launch starts, [(name, start_us, end_us) of the device
    operations]) in the order of their launches, for each device operation
    whose launch call is in the trace."""
    calls = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "ts" in e:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                calls[c] = (_thread(e), float(e["ts"]))
    rows = defaultdict(list)
    for e in events:
        if e.get("cat") in trace.DEVICE_CATS and "dur" in e:
            c = (e.get("args") or {}).get("correlation")
            if c in calls:
                thread, t = calls[c]
                a = float(e["ts"])
                rows[thread].append((t, (e["name"], a, a + float(e["dur"]))))
    out = {}
    for thread, r in rows.items():
        r.sort(key=lambda x: x[0])
        out[thread] = ([t for t, _ in r], [op for _, op in r])
    return out


def instances(events, name: str, by_thread: dict = None) -> list:
    """[(start_us, end_us, device operations launched inside)] of each range
    named `name`, in the order they start. by_thread: `launched(events)`,
    where the caller has it already."""
    by_thread = launched(events) if by_thread is None else by_thread
    out = []
    for n, thread, a, b in sorted(ranges(events, name), key=lambda r: r[2]):
        if n != name:
            continue
        starts, ops = by_thread.get(thread, ([], []))
        out.append((a, b, ops[bisect.bisect_left(starts, a): bisect.bisect_right(starts, b)]))
    return out


def launched_inside(events, match) -> list:
    """(name, start_us, end_us) of each device operation whose launch call
    started inside some range for which `match(range name)` holds, on the
    range's thread (once, however many such ranges nest around it)."""
    held = defaultdict(list)
    for n, thread, a, b in ranges(events):
        if match(n):
            held[thread].append((n, a, b))
    out = []
    for thread, (starts, ops) in launched(events).items():
        union = trace.busy_intervals(held.get(thread, []))
        lo = [a for a, _ in union]
        for t, op in zip(starts, ops):
            i = bisect.bisect_right(lo, t) - 1
            if i >= 0 and t <= union[i][1]:
                out.append(op)
    return out


def busy_us(ops) -> float:
    """The union of the operations' intervals, in microseconds."""
    return sum(b - a for a, b in trace.busy_intervals(ops))


def span_ms_per_frame(ctx: dict, name: str):
    """A reader's value: the summed duration of the spans `name` over the
    stretch's frames, in ms; None without frames or without such spans."""
    events = events_of(ctx)
    if not events or not ctx["frames"]:
        return None
    us = total_us(events, name)
    return None if us is None else us * 1e-3 / ctx["frames"]
