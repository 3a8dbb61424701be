"""The trace reduction on a hand-made chrome trace."""

import pytest

from benchmark.harness import trace

EVENTS = [
    {"cat": "kernel", "name": "k1", "ts": 0.0, "dur": 10.0},
    {"cat": "kernel", "name": "k2", "ts": 5.0, "dur": 10.0},  # overlaps k1
    {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30.0, "dur": 5.0},
    {"cat": "gpu_memset", "name": "Memset", "ts": 50.0, "dur": 2.0},
    {"cat": "cpu_op", "name": "aten::copy_", "ts": 14.0, "dur": 20.0, "tid": 1},
    {"cat": "cpu_op", "name": "aten::add", "ts": 20.0, "dur": 2.0, "tid": 1},
    {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.0, "dur": 1.0, "tid": 1},
    {"cat": "cpu_op", "name": "other thread", "ts": 0.0, "dur": 100.0, "tid": 2},
    {"cat": "python_function", "name": "ignored", "ts": 0.0, "dur": 100.0, "tid": 1},
]


def test_device_ops_and_union():
    ops = trace.device_ops(EVENTS)
    assert [o[0] for o in ops] == ["k1", "k2", "Memcpy DtoH", "Memset"]
    assert trace.busy_intervals(ops) == [(0.0, 15.0), (30.0, 35.0), (50.0, 52.0)]


def test_top_ops_in_seconds():
    assert trace.top_ops(trace.device_ops(EVENTS), 2) == [
        ["k1", pytest.approx(1e-5)], ["k2", pytest.approx(1e-5)]]


def test_idle_gaps_named_by_the_innermost_host_operation():
    gaps = dict(trace.idle_gaps(EVENTS))
    # 15..30 (middle 22.5: inside aten::copy_ only), 35..52 (43.5: none)
    assert gaps == {"aten::copy_": pytest.approx(15e-6),
                    "host: between operations": pytest.approx(15e-6)}
