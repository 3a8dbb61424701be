"""The single-frame program as CUDA graphs, cut at its span boundaries.

On the card the engine runs `frame_program` as a short chain of captured
CUDA graphs instead of several hundred launches from Python a frame, one
capture per input shape (`FrameGraphs`). The first frame of a shape runs
eagerly (the kernels load and set their attributes, the allocator warms),
the second is captured and replayed, and every later frame replays. The
inputs are two static (H, W, 3) uint8 device buffers that the engine's
upload writes into. A replay returns the capture's own output tensors,
which the next replay rewrites: a caller that keeps a frame copies them
out on the same stream before it enqueues the next one (the engine into
pinned host memory of the frame's own, `Engine._send`).

The capture is cut wherever one of the program's `rtdm.` spans opens or
closes (`pipeline/stats.py` `cutting`); a cut where the open graph holds no
work only moves that graph under the new stack of spans (`Segmenter`). So
the work of each graph ran inside one stack of spans, and under a profiler
the replay opens the same nested ranges around each graph's launch
(`replay`): each device operation is then joined by its launch call to the
same ranges as when the program runs eagerly. With no profiler the replay
is a plain loop of launches.

Each capture owns a `SweepCounter` (`ops/cuda/cc_sweep.py`) in device
memory, a static buffer like its inputs and outputs: the eager run and the
capture record K2's sweep counts into it, so every replay fills it again
(`FrameGraph.sweeps`), and the engine copies its words out with the
frame's outputs.

The graphs of one capture share one private memory pool and replay in
capture order on the caller's current stream. The capture is in
"thread_local" mode: `Engine.run`'s prefetch thread keeps grabbing while
the loop's thread captures. Python's cyclic garbage collector is off while
it captures: a collection there could destroy another engine's graphs,
which CUDA refuses during a capture, and the capture would fail. An error
during capture propagates: a program that the engine graphs must capture,
and nothing falls back to eager launches.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import warnings
from typing import Callable, List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import SweepCounter
from rt_depth_map_tpu_torch.pipeline import stats

#: (the stack of spans its work ran inside, outermost first; the graph)
Segment = Tuple[Tuple[str, ...], object]


class Segmenter:
    """Cuts one capture into segments at the span boundaries (the cutter
    that `stats.cutting` hands the spans).

    capture: `begin()` opens a graph on the current stream, `has_work()`
    says whether the open graph holds an operation, `end()` closes it and
    returns it. A graph that holds no operation is never kept: a cut there
    moves the open graph under the new stack instead."""

    def __init__(self, capture):
        self.capture = capture
        self.stack: List[str] = []
        self.segments: List[Segment] = []
        self._under: Tuple[str, ...] = ()  # the stack of the open graph
        self._open = False

    def start(self) -> None:
        self.capture.begin()
        self._open = True

    def _cut(self) -> None:
        if self.capture.has_work():
            self.segments.append((self._under, self.capture.end()))
            self.capture.begin()
        self._under = tuple(self.stack)

    def enter(self, name: str) -> None:
        self.stack.append(name)
        self._cut()

    def exit(self, name: str) -> None:
        if not self.stack or self.stack[-1] != name:
            raise RuntimeError(f"span {name!r} closed inside {self.stack}")
        self.stack.pop()
        self._cut()

    def finish(self) -> List[Segment]:
        """Closes the capture; the segments in capture order."""
        if self.stack:
            raise RuntimeError(f"spans {self.stack} still open at the capture's end")
        work = self.capture.has_work()
        self._open = False
        graph = self.capture.end()
        if work:
            self.segments.append((self._under, graph))
        return self.segments

    def abort(self) -> None:
        """Ends a capture that an error left open; its graphs are dropped."""
        if self._open:
            self._open = False
            try:
                self.capture.end()
            except RuntimeError:
                pass  # an invalidated capture: the caller's error says why


def capture_segments(program: Callable[[], dict], capture) -> Tuple[List[Segment], dict]:
    """(segments, outputs) of `program` captured by `capture` (see
    `Segmenter`), cut at its spans. The outputs are the tensors that the
    capture allocated: each replay rewrites them."""
    cutter = Segmenter(capture)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with capture:
            cutter.start()
            try:
                with stats.cutting(cutter):
                    out = program()
                return cutter.finish(), out
            except BaseException:
                cutter.abort()
                raise
    finally:
        if collecting:
            gc.enable()


def replay(segments) -> None:
    """Launches the segments' graphs in order on the current stream. While
    a profiler runs, each launch is inside a range of every span of its
    stack; consecutive segments share the ranges of a common outer part."""
    if not stats._profiling():
        for _, graph in segments:
            graph.replay()
        return
    opened: list = []  # (name, range), the outermost first
    try:
        for stack, graph in segments:
            keep = 0
            while (keep < len(opened) and keep < len(stack)
                   and opened[keep][0] == stack[keep]):
                keep += 1
            while len(opened) > keep:
                opened.pop()[1].__exit__(None, None, None)
            for name in stack[keep:]:
                rng = record_function(name)
                rng.__enter__()
                opened.append((name, rng))
            graph.replay()
    finally:
        while opened:
            opened.pop()[1].__exit__(None, None, None)


@functools.lru_cache(maxsize=None)
def _capture_info():
    """`cuStreamGetCaptureInfo_v2` of libcuda, the CUDA library that every
    CUDA program has loaded."""
    fn = ctypes.CDLL("libcuda.so.1").cuStreamGetCaptureInfo_v2
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    return fn


class CudaCapture:
    """Graphs captured on a side stream into one private memory pool (a
    context manager: inside, the side stream is current)."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._ctx = None

    def __enter__(self):
        self._ctx = torch.cuda.stream(self.stream)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        ctx, self._ctx = self._ctx, None
        return ctx.__exit__(*exc)

    def begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def has_work(self) -> bool:
        """Whether the open graph holds a node: a stream that has captured
        one depends on it, a capture that has not yet depends on nothing."""
        status, deps = ctypes.c_int(0), ctypes.c_size_t(0)
        err = _capture_info()(self.stream.cuda_stream, ctypes.byref(status),
                              None, None, None, ctypes.byref(deps))
        if err != 0 or status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError(f"graph capture: cuStreamGetCaptureInfo error {err}, "
                               f"status {status.value}")
        return deps.value > 0

    def end(self) -> torch.cuda.CUDAGraph:
        graph, self._graph = self._graph, None
        with warnings.catch_warnings():
            # the capture's last graph may hold nothing; it is dropped
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            graph.capture_end()
        return graph


class FrameGraph:
    """The frame program at one input shape: eager at the first call,
    captured at the second, replayed at every call from the second on.
    `left` and `right` are its input buffers: fill them, then call it with
    the program (which it does not keep: the engine that owns it is freed
    when its last reference goes, not by the garbage collector). From the
    second call on it returns the capture's output tensors, which the next
    call rewrites. `sweeps` holds K2's sweep counts of the program's last
    run, in device memory."""

    def __init__(self, shape: tuple, device, capture=CudaCapture):
        self.new_capture = capture
        self.left = torch.empty(shape, dtype=torch.uint8, device=device)
        self.right = torch.empty_like(self.left)
        self.sweeps = SweepCounter(device)
        self.calls = 0
        self.segments: Optional[List[Segment]] = None
        self.outputs: Optional[dict] = None

    def __call__(self, program: Callable) -> dict:
        self.calls += 1
        if self.calls == 1:
            with self.sweeps.recording():
                return program(self.left, self.right)
        if self.segments is None:
            with self.sweeps.recording():
                self.segments, self.outputs = capture_segments(
                    lambda: program(self.left, self.right),
                    self.new_capture(self.left.device))
        with stats.span("rtdm.engine.replay"):
            replay(self.segments)
        return dict(self.outputs)


class FrameGraphs:
    """The engine's frame programs as graphs, one `FrameGraph` an input
    shape. `clear` drops them all: the next frame of each shape runs
    eagerly and the one after captures again."""

    def __init__(self, device, capture=CudaCapture):
        self.device, self.capture = device, capture
        self._by_shape: dict = {}

    def get(self, left_shape, right_shape) -> FrameGraph:
        shape = tuple(left_shape)
        if tuple(right_shape) != shape:
            raise ValueError(f"left {shape} and right {tuple(right_shape)} differ in shape")
        prog = self._by_shape.get(shape)
        if prog is None:
            prog = self._by_shape[shape] = FrameGraph(shape, self.device, self.capture)
        return prog

    def clear(self) -> None:
        self._by_shape.clear()
