"""The span reduction and its readers on a hand-made chrome trace with
correlation ids: ranges on two threads, a kernel launched inside nested
ranges, a copy, a launch outside every range, one on another thread."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import cell, spans, trace

ROOT = Path(__file__).resolve().parents[2]
MAIN, INGEST = 10, 11


def _range(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur}


def _launch(name, ts, corr, tid=MAIN, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": 1.0, "args": {"correlation": corr}}


def _device(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


EVENTS = [
    # frame 1: dispatch > stage.match > match.cost, then the d2h
    _range("rtdm.engine.dispatch", 0.0, 100.0),
    _range("rtdm.stage.gray", 2.0, 8.0),
    _launch("cudaLaunchKernel", 4.0, 1),
    _device("kernel", "gray_kernel", 20.0, 5.0, 1),
    _range("rtdm.stage.match", 40.0, 50.0),
    _range("rtdm.match.cost", 45.0, 20.0),
    _launch("cudaLaunchKernel", 50.0, 2),
    _device("kernel", "bm_cost_wta_kernel", 60.0, 30.0, 2),
    _range("rtdm.match.speckle", 70.0, 15.0),
    _launch("cuLaunchCooperativeKernel", 72.0, 3, cat="cuda_driver"),
    _device("kernel", "cc_propagate_kernel", 80.0, 20.0, 3),  # overlaps K8
    _range("rtdm.engine.d2h", 110.0, 40.0),
    _launch("cudaMemcpyAsync", 112.0, 4),
    _device("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 115.0, 10.0, 4),
    # a launch outside every range, and one on the ingest thread at a time
    # that lies inside the main thread's match range
    _launch("cudaLaunchKernel", 105.0, 5),
    _device("kernel", "stray_kernel", 130.0, 4.0, 5),
    _range("rtdm.ingest.grab", 30.0, 30.0, tid=INGEST),
    _launch("cudaMemsetAsync", 55.0, 6, tid=INGEST),
    _device("gpu_memset", "Memset (Device)", 140.0, 2.0, 6),
    # frame 2
    _range("rtdm.ingest.wait", 150.0, 3.0),
    _range("rtdm.engine.dispatch", 160.0, 20.0),
    _range("rtdm.stage.match", 165.0, 10.0),
    _launch("cudaLaunchKernel", 170.0, 7),
    _device("kernel", "bm_cost_wta_kernel", 200.0, 25.0, 7),
    _range("rtdm.engine.d2h", 190.0, 60.0),
    # what spans.py does not read: Kineto's device-side ranges, flows
    {"ph": "X", "cat": "gpu_user_annotation", "name": "rtdm.stage.match", "pid": 0,
     "tid": 7, "ts": 60.0, "dur": 170.0},
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 2, "pid": 1, "tid": MAIN, "ts": 50.0},
]


def test_ranges_and_their_totals():
    names = [r[0] for r in spans.ranges(EVENTS)]
    assert names.count("rtdm.engine.dispatch") == 2 and names.count("rtdm.stage.match") == 2
    assert spans.total_us(EVENTS, "rtdm.engine.dispatch") == 120.0
    assert spans.total_us(EVENTS, "rtdm.engine.d2h") == 100.0
    assert spans.total_us(EVENTS, "rtdm.engine") is None  # a whole name, not a prefix
    assert spans.total_us(trace_without_spans(), "rtdm.engine.dispatch") is None


def test_kernel_launched_inside_nested_ranges():
    match = spans.launched_inside(EVENTS, lambda n: n == "rtdm.stage.match")
    assert [op[0] for op in match] == ["bm_cost_wta_kernel", "cc_propagate_kernel",
                                       "bm_cost_wta_kernel"]
    # K8 lies in dispatch, stage.match and match.cost; K2's cuLaunch* call too
    assert [op[0] for op in spans.launched_inside(EVENTS, lambda n: n == "rtdm.match.cost")] \
        == ["bm_cost_wta_kernel"]
    assert len(spans.launched_inside(EVENTS, lambda n: n == "rtdm.engine.dispatch")) == 4
    # the union of intervals: 60..100 (K8 and K2 overlap) and 200..225
    assert spans.busy_us(match) == 65.0
    each = spans.instances(EVENTS, "rtdm.stage.match")
    assert [(a, b, [op[0] for op in ops]) for a, b, ops in each] == [
        (40.0, 90.0, ["bm_cost_wta_kernel", "cc_propagate_kernel"]),
        (165.0, 175.0, ["bm_cost_wta_kernel"])]


def test_memcpy_attributed_to_its_range():
    d2h = spans.launched_inside(EVENTS, lambda n: n == "rtdm.engine.d2h")
    assert d2h == [("Memcpy DtoH (Device -> Pageable)", 115.0, 125.0)]


def test_launch_outside_every_range_and_on_another_thread():
    inside = [op[0] for op in spans.launched_inside(EVENTS, lambda n: n.startswith("rtdm."))]
    assert "stray_kernel" not in inside
    # the ingest thread's memset started inside that thread's grab range,
    # not inside the main thread's match range that holds the same time
    assert "Memset (Device)" in inside
    assert "Memset (Device)" not in {
        op[0] for op in spans.launched_inside(EVENTS, lambda n: n == "rtdm.stage.match")}
    # 6 of the 7 device operations have their launch inside some rtdm. range
    assert len(trace.device_ops(EVENTS)) == 7 and len(inside) == 6


def trace_without_spans():
    """The same trace as a program without spans records it."""
    return [e for e in EVENTS if e["cat"] != "user_annotation"]


def _ctx(events=None, frames=2):
    config = json.loads((ROOT / "benchmark/configs/bm-1080p-d288.json").read_text())
    ops = trace.device_ops(EVENTS)
    ctx = dict(ops=ops, busy_s=sum(b - a for a, b in trace.busy_intervals(ops)) * 1e-6,
               window_s=300e-6, frames=frames, rois=[(0, 0, 400, 300)] * frames,
               config=config, device_name="NVIDIA H100 80GB HBM3", width=1920,
               height=1080)
    if events is not None:
        ctx["events"] = events
    return ctx


NEW = {"ingest_wait_ms_per_frame": 3.0e-3 / 2, "enqueue_ms_per_frame": 120e-3 / 2,
       "d2h_wait_ms_per_frame": 100e-3 / 2, "match_device_ms_per_frame": 65e-3 / 2}
OLD = ("device_ops_per_frame", "device_ms_per_frame", "bm_roofline_pct", "sgm_roofline_pct",
       "device_idle_pct")


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_readers(name):
    read = cell.reader(name)
    assert read(_ctx(EVENTS)) == pytest.approx(NEW[name])
    # a program without the spans: no reading
    assert read(_ctx(trace_without_spans())) is None
    assert read(_ctx(EVENTS, frames=0)) is None


def test_ingest_wait_reads_the_loops_thread_only():
    """Where the loop grabs and decodes itself, those spans are its wait;
    the ingest thread's are not."""
    own = [_range("rtdm.ingest.grab", 101.0, 2.0), _range("rtdm.ingest.decode", 103.0, 1.0)]
    read = cell.reader("ingest_wait_ms_per_frame")
    assert read(_ctx(EVENTS + own)) == pytest.approx((3.0 + 3.0) * 1e-3 / 2)
    loop_less = [e for e in EVENTS if e["name"] != "rtdm.engine.dispatch"]
    assert read(_ctx(loop_less)) is None


@pytest.mark.parametrize("name", OLD)
def test_existing_readers_ignore_the_events(name):
    read = cell.reader(name)
    assert read(_ctx()) == read(_ctx(EVENTS))


class _Stretch:
    window_s = 300e-6
    dispatched = [(0, 0), (0, 1)]

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


class _Window:
    ring = 2

    def __init__(self, events):
        self.stretches = [_Stretch(events)]
        box = np.array([[0, 0, 400, 300, 1]], np.int32)
        self.boxes = {(0, 0): box, (0, 1): box}


def test_readers_through_the_harness():
    """`harness/cell.py` `per_layer` gives its readers no `events`: the
    span readers find the trace it holds, and read what they read with it."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = _ctx()["config"]
    workload = "bm-1080p-d288.rig1"
    metrics, _, _, breakdown = cell.per_layer(manifest, workload, config, _Window(EVENTS),
                                              "NVIDIA H100 80GB HBM3", 1920, 1080)
    for name, v in NEW.items():
        assert metrics[name]["value"] == pytest.approx(v), name
    # the breakdown names the gaps that fall inside a range by the range
    assert "rtdm.engine.d2h" in dict(breakdown["idle_gaps"])
    bare, _, _, _ = cell.per_layer(manifest, workload, config,
                                   _Window(trace_without_spans()),
                                   "NVIDIA H100 80GB HBM3", 1920, 1080)
    assert not set(NEW) & set(bare)
    assert {k: v for k, v in metrics.items() if k not in NEW} == bare
