"""The pure-Python parts of the frame program's CUDA graphs
(`pipeline/graphs.py`) on the CPU, with a stand-in capture: the segment
plan (span nesting -> segments in capture order, a cut where the open graph
holds no work moving it instead), the ranges a replay opens under a
profiler, the capture hook limited to the capturing thread, and the
engine's rule of when it runs eagerly, captures and replays (setters and
new shapes capture again), what a replay hands back, and the order in
which `run` dispatches and retires frames. The captures themselves, and
the pinned copies that retire a frame on the card, run on the card:
`tests/test_torch_graph_cuda.py`."""

import gc
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from rt_depth_map_tpu_torch import Engine
from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
from rt_depth_map_tpu_torch.pipeline import graphs, stats
from rt_depth_map_tpu_torch.pipeline.stats import span
from rt_depth_map_tpu_torch.sources import MultiStreamSource, SyntheticStereoSource
from rt_depth_map_tpu_torch.sources.synthetic import SyntheticObject

W, H, D = 128, 48, 16


class StubGraph:
    def __init__(self, ops, log):
        self.ops, self.log = tuple(ops), log

    def replay(self):
        self.log.append(self.ops)
        torch.ones(1).add_(1)  # an operation the profiler places in the open ranges


class StubCapture:
    """A capture on the CPU: a graph is the list of work noted while it was
    open (`note`, or with `watch` every aten operation the program runs)."""

    def __init__(self, device=None, watch=False, log=None):
        self.watch = watch
        self.log = [] if log is None else log
        self.ops = None
        self.begun = self.ended = 0
        self._mode = None

    def __enter__(self):
        if self.watch:
            stub = self

            class Watch(TorchDispatchMode):
                def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                    if stub.ops is not None:
                        stub.ops.append(str(func))
                    return func(*args, **(kwargs or {}))

            self._mode = Watch()
            self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        if self._mode is not None:
            self._mode.__exit__(*exc)
            self._mode = None
        return False

    def note(self, op):
        self.ops.append(op)

    def begin(self):
        assert self.ops is None, "a graph is already open"
        self.ops = []
        self.begun += 1

    def has_work(self):
        return bool(self.ops)

    def end(self):
        ops, self.ops = self.ops, None
        self.ended += 1
        return StubGraph(ops, self.log)


def _program(cap):
    """Work outside, inside and between nested spans, and spans with none."""
    def run():
        with span("rtdm.stage.a"):
            cap.note("a1")
            with span("rtdm.match.b"):
                cap.note("b1")
                cap.note("b2")
            with span("rtdm.match.empty"):
                pass
            cap.note("a2")
        with span("rtdm.stage.c"):
            pass
        with span("rtdm.stage.d"):
            cap.note("d1")
        return {"out": torch.zeros(1)}
    return run


def test_segments_follow_the_span_nesting_and_drop_empty_cuts():
    cap = StubCapture()
    segments, out = graphs.capture_segments(_program(cap), cap)
    assert [(stack, g.ops) for stack, g in segments] == [
        (("rtdm.stage.a",), ("a1",)),
        (("rtdm.stage.a", "rtdm.match.b"), ("b1", "b2")),
        (("rtdm.stage.a",), ("a2",)),
        (("rtdm.stage.d",), ("d1",)),
    ]
    assert set(out) == {"out"}
    # one graph kept a segment, one more for the empty tail, none for the
    # empty cuts (before a, inside empty and c, between the stages)
    assert cap.begun == cap.ended == 5
    assert stats._local.cutter is None


def test_work_before_the_first_span_and_after_the_last_is_kept():
    cap = StubCapture()

    def run():
        cap.note("head")
        with span("rtdm.stage.a"):
            cap.note("a")
        cap.note("tail")
        return {}

    segments, _ = graphs.capture_segments(run, cap)
    assert [(stack, g.ops) for stack, g in segments] == [
        ((), ("head",)), (("rtdm.stage.a",), ("a",)), ((), ("tail",))]


def test_an_error_ends_the_capture_and_propagates():
    cap = StubCapture()

    def run():
        with span("rtdm.stage.a"):
            cap.note("a")
            raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        graphs.capture_segments(run, cap)
    assert cap.begun == cap.ended and cap.ops is None
    assert stats._local.cutter is None
    assert stats.span("rtdm.stage.a") is stats._NO_SPAN  # spans are spans again


def test_spans_of_other_threads_do_not_cut():
    cap = StubCapture()
    seen = []

    def other():
        seen.append(stats.span("rtdm.ingest.grab"))

    def run():
        with span("rtdm.stage.a"):
            cap.note("a")
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        return {}

    segments, _ = graphs.capture_segments(run, cap)
    assert seen == [stats._NO_SPAN]
    assert [stack for stack, _ in segments] == [("rtdm.stage.a",)]


@pytest.mark.parametrize("collecting", [True, False])
def test_no_garbage_collection_during_a_capture(collecting):
    """A collection inside a capture could destroy another engine's graphs,
    which CUDA refuses while the thread captures."""
    seen = []

    def run():
        seen.append(gc.isenabled())
        return {}

    def failing():
        seen.append(gc.isenabled())
        raise ValueError("boom")

    was = gc.isenabled()
    (gc.enable if collecting else gc.disable)()
    try:
        graphs.capture_segments(run, StubCapture())
        assert gc.isenabled() == collecting
        with pytest.raises(ValueError):
            graphs.capture_segments(failing, StubCapture())
        assert gc.isenabled() == collecting
    finally:
        (gc.enable if was else gc.disable)()
    assert seen == [False, False]


def test_nested_capture_is_refused():
    cap = StubCapture()

    def run():
        graphs.capture_segments(lambda: {}, StubCapture())

    with pytest.raises(RuntimeError, match="already capturing"):
        graphs.capture_segments(run, cap)


def test_replay_launches_in_order_and_opens_the_stacks_under_a_profiler():
    cap = StubCapture()
    segments, _ = graphs.capture_segments(_program(cap), cap)
    graphs.replay(segments)  # no profiler: launches only
    assert cap.log == [("a1",), ("b1", "b2"), ("a2",), ("d1",)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        graphs.replay(segments)
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    ranges = [e.name for e in events if e.name.startswith("rtdm.")]
    # stage a stays open across its three segments, as when run eagerly
    assert ranges == ["rtdm.stage.a", "rtdm.match.b", "rtdm.stage.d"]

    def chain(e):
        out = []
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.name.startswith("rtdm."):
                out.append(e.name)
        return tuple(reversed(out))

    adds = [chain(e) for e in events if e.name == "aten::add_"]
    assert adds == [stack for stack, _ in segments]


def _source(seed=3):
    objects = [SyntheticObject(x=20, y=10, w=40, h=24, z_units=40.0, vx=1.0)]
    src = SyntheticStereoSource(W, H, seed=seed, objects=objects)
    src.rectified = True
    return src


def _engine(kind="bm", batch=1):
    mcfg = MatcherConfig(kind=kind, num_disparities=D, block_size=9 if kind == "bm" else 5,
                         speckle_window_size=20, speckle_range=32, disp12_max_diff=1)
    cfg = EngineConfig(width=W, height=H, number_of_disparities=D, matcher=mcfg,
                       batch=batch)
    src = _source() if batch == 1 else MultiStreamSource(
        [_source(s) for s in range(3, 3 + batch)])
    return Engine(cfg, source=src, device="cpu")


@pytest.mark.parametrize("kind", ["bm", "sgm"])
def test_frame_program_segments_lie_in_its_stage_spans(kind):
    """The real program cut by its own spans: every segment of work lies
    under a stage span, each stage's first segment in program order."""
    eng = _engine(kind)
    left, right = (torch.from_numpy(a) for a in _source().render(0)[:2])
    cap = StubCapture(watch=True)
    segments, out = graphs.capture_segments(lambda: eng.frame_program(left, right), cap)
    stacks = [stack for stack, _ in segments]
    assert all(stack and stack[0].startswith("rtdm.stage.") for stack in stacks)
    assert all(len(stack) == 1 or stack[1].startswith("rtdm.match.") for stack in stacks)
    stages = list(dict.fromkeys(stack[0] for stack in stacks))
    assert stages == [f"rtdm.stage.{s}" for s in ("gray", "rectify", "hsv", "morphology",
                                                  "detect", "match", "reproject", "depth")]
    assert all(g.ops for _, g in segments)
    ref = eng.frame_program(left, right)
    for k, v in ref.items():
        if v is not None:
            np.testing.assert_array_equal(out[k].numpy(), v.numpy(), err_msg=k)


def _counted(eng, captures):
    """Installs graphs with a stand-in capture on the CPU engine; returns the
    list of its frame programs run, each True where it ran under a capture."""
    calls = []
    frame_program = eng.frame_program

    def program(left, right, plain=False):
        calls.append(stats._local.cutter is not None)
        return frame_program(left, right, plain)

    def capture(device):
        captures.append(StubCapture(device))
        return captures[-1]

    eng.frame_program = program
    eng._graphs = graphs.FrameGraphs(eng.device, capture=capture)
    return calls


def test_first_frame_eager_second_captured_then_replayed():
    eng = _engine()
    captures = []
    calls = _counted(eng, captures)
    pairs = [_source().render(i)[:2] for i in range(4)]
    first = eng.process_pair(*pairs[0])
    second = eng.process_pair(*pairs[1])
    eng.process_pair(*pairs[2])
    eng.process_pair(*pairs[3])
    assert calls == [False, True]  # eager, then the capture; replays run no program
    assert len(captures) == 1
    for res, pair in ((first, pairs[0]), (second, pairs[1])):
        ref = eng.frame_program(*(torch.from_numpy(a) for a in pair))
        np.testing.assert_array_equal(res.disparity, ref["disparity"].numpy())


@pytest.mark.parametrize("setter", ["hsv", "size"])
def test_a_setter_drops_the_capture(setter):
    eng = _engine()
    captures = []
    calls = _counted(eng, captures)
    pair = _source().render(0)[:2]
    for _ in range(3):
        eng.process_pair(*pair)
    if setter == "hsv":
        eng.set_hsv_thresholds([0, 100, 50], [15, 255, 255])
    else:
        eng.set_min_object_size(400)
    for _ in range(3):
        eng.process_pair(*pair)
    assert calls == [False, True, False, True]
    assert len(captures) == 2


def test_each_shape_gets_its_own_capture():
    eng = _engine()
    captures = []
    calls = _counted(eng, captures)
    small = [a[: H // 2, : W // 2].copy() for a in _source().render(0)[:2]]
    eng.process_pair(*_source().render(0)[:2])
    eng.process_pair(*small)
    eng.process_pair(*_source().render(1)[:2])
    eng.process_pair(*small)
    assert calls == [False, False, True, True]
    assert sorted(eng._graphs._by_shape) == [(H // 2, W // 2, 3), (H, W, 3)]
    with pytest.raises(ValueError, match="differ in shape"):
        eng.process_pair(small[0], _source().render(0)[1])


def test_run_and_run_preloaded_go_through_the_graphs():
    for loop in ("run", "run_preloaded"):
        eng = _engine()
        captures = []
        calls = _counted(eng, captures)
        if loop == "run":
            eng.run(frames=5, on_frame=lambda i, r: True, print_stats_on_sigint=False)
        else:
            eng.run_preloaded(5, n_inputs=2, pipeline_depth=2)
        assert calls == [False, True] and len(captures) == 1, loop


def test_a_replay_hands_back_the_capture_outputs():
    """A replay returns the capture's own output tensors and counter (the
    caller copies them out before the next replay), from host images and
    from device tensors alike."""
    eng = _engine()
    captures = []
    _counted(eng, captures)
    left, right = (torch.from_numpy(a) for a in _source().render(0)[:2])
    for _ in range(3):
        out, sweeps = eng._dispatch(*_source().render(0)[:2])
    (prog,) = eng._graphs._by_shape.values()
    assert prog.calls == 3 and all(out[k] is v for k, v in prog.outputs.items())
    assert sweeps is prog.sweeps
    out, sweeps = eng._dispatch(left, right)
    assert prog.calls == 4 and sweeps is prog.sweeps
    assert all(out[k] is v for k, v in prog.outputs.items())


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_run_retires_frame_i_between_dispatches_i_plus_depth_minus_1_and_i_plus_depth(
        depth, prefetch):
    eng = _engine()
    _counted(eng, [])
    log = []
    dispatch = eng._dispatch

    def logged(left, right):
        log.append(("dispatch", sum(e[0] == "dispatch" for e in log)))
        return dispatch(left, right)

    eng._dispatch = logged
    n = 7
    eng.run(frames=n, on_frame=lambda i, r: log.append(("retire", i)),
            print_stats_on_sigint=False, pipeline_depth=depth, prefetch=prefetch)
    assert [i for kind, i in log if kind == "retire"] == list(range(n))
    at = {e: k for k, e in enumerate(log)}
    for i in range(n):
        assert at[("dispatch", min(i + depth - 1, n - 1))] < at[("retire", i)]
        if i + depth < n:
            assert at[("retire", i)] < at[("dispatch", i + depth)]


@pytest.mark.parametrize("depth", [2, 3])
def test_cpu_run_results_equal_the_eager_program(depth):
    """On the CPU `run` hands over each frame's own program outputs, copied
    to the host when the frame retires: every result the consumer kept
    equals the program on its pair after the loop."""
    eng = _engine("sgm")
    got = {}
    eng.run(frames=5, on_frame=lambda i, r: got.__setitem__(i, r),
            print_stats_on_sigint=False, pipeline_depth=depth)
    assert sorted(got) == list(range(5))
    for i, res in got.items():
        left, right = (torch.from_numpy(a) for a in _source().render(i)[:2])
        ref = eng.frame_program(left, right)
        for k, v in ref.items():
            got_k = getattr(res, k)
            assert (v is None) == (got_k is None), k
            if v is not None:
                np.testing.assert_array_equal(got_k, v.numpy(), err_msg=f"frame {i} {k}")


def test_the_batch_paths_stay_eager():
    eng = _engine(batch=2)
    captures = []
    calls = _counted(eng, captures)
    pairs = [_source(s).render(0)[:2] for s in (3, 4)]
    eng.process_batch([p[0] for p in pairs], [p[1] for p in pairs])
    eng.step_batch()
    assert calls == []  # the batch program is not the frame program
    assert captures == [] and eng._graphs._by_shape == {}


def test_the_cpu_engine_has_no_graphs():
    assert _engine()._graphs is None
