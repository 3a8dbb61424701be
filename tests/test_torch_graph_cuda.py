"""The single-frame program replayed as CUDA graphs on the card
(`pipeline/graphs.py`), against the eager `frame_program` bit for bit on
every field over several frames: BM, SGM-8 on the bidir route, SGM-5 on the
chained route, a nonzero min_disparity, the WLS post filter with the mean
disparity of each box. Also: the outputs a loop still holds survive the
next replays (`run` at pipeline depths 2 and 3, both matchers, each frame's
images in pinned memory of its own), `run_preloaded` replays every frame
from the second on and leaves its last frame's outputs in the capture, a setter
between frames captures again and the next frame equals a fresh engine's,
the capture works while `run`'s prefetch thread grabs, and under a
profiler `benchmark/harness/spans.py` gives each stage range the same
device operations with the replay as without, and K2's sweep counter holds
the eager program's counts on every replay, read without a synchronise of
its own and only under a profiler, and `run` puts each frame's own counts
into the trace. `run`'s dispatch never waits for the card. Needs the card:
run with `python3 -m pytest --noconftest` there (no JAX)."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from rt_depth_map_tpu_torch import Engine
from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
from rt_depth_map_tpu_torch.ops.sgbm import uses_bidir
from rt_depth_map_tpu_torch.pipeline import graphs
from rt_depth_map_tpu_torch.pipeline.engine import FrameResult, _to_host
from rt_depth_map_tpu_torch.sources import SyntheticStereoSource
from torch_helpers import cuda_or_skip

W, H, D = 640, 192, 64
FIELDS = ("disparity", "boxes", "depth_cm", "mean_z", "count", "mask", "rgb_rect",
          "filtered_disparity", "disparity_mean")
CASES = {
    "bm": dict(kind="bm"),
    "sgm8-bidir": dict(kind="sgm", num_paths=8),
    "sgm5-chained": dict(kind="sgm", num_paths=5),
    "bm-mind": dict(kind="bm", min_disparity=8),
    "sgm8-mind": dict(kind="sgm", num_paths=8, min_disparity=-8),
    "bm-wls": dict(kind="bm", post_filter=True),
}


def _cfg(kind="bm", num_paths=8, min_disparity=0, post_filter=False):
    m = (MatcherConfig(kind="sgm", num_disparities=D, block_size=5, pre_filter_cap=0,
                       num_paths=num_paths, min_disparity=min_disparity)
         if kind == "sgm" else
         MatcherConfig(kind="bm", num_disparities=D, min_disparity=min_disparity))
    return EngineConfig(width=W, height=H, number_of_disparities=D, matcher=m,
                        enable_post_filter=post_filter, show_disparity_value=post_filter)


def _source(ring=0, seed=0):
    return SyntheticStereoSource(W, H, seed=seed, ring=ring)


def _dev(a):
    return torch.from_numpy(a).to("cuda")


def _eager(eng, left, right) -> FrameResult:
    return FrameResult(**_to_host(eng.frame_program(_dev(left), _dev(right))))


def _assert_equal(got: FrameResult, ref: FrameResult, what: str):
    for k in FIELDS:
        a, b = getattr(got, k), getattr(ref, k)
        assert (a is None) == (b is None), f"{what} {k}"
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


def _graph(eng):
    (prog,) = eng._graphs._by_shape.values()
    return prog


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_replays_equal_the_eager_program(case):
    cuda_or_skip()
    eng = Engine(_cfg(**CASES[case]), source=_source(), device="cuda")
    src = _source()
    found = 0
    for i in range(5):  # eager, captured, then replayed
        left, right = src.render(i)[:2]
        got = eng.process_pair(left, right)
        _assert_equal(got, _eager(eng, left, right), f"{case} frame {i}")
        found += got.has_objects
    prog = _graph(eng)
    assert prog.calls == 5 and len(prog.segments) > 5 and found
    m = eng.matcher_config
    if m.kind == "sgm":
        bidir = uses_bidir(m.num_paths, H, W, D, m.min_disparity)
        assert bidir == (case == "sgm8-bidir" or case == "sgm8-mind" and bidir)
        step = "rtdm.match.vert_wta" if bidir else "rtdm.match.final_wta"
        assert any(step in stack for stack, _ in prog.segments), case


def _memory(a: np.ndarray):
    """(first byte, one past the last) of an array's buffer."""
    lo = a.__array_interface__["data"][0]
    return lo, lo + a.nbytes


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bm", "sgm"])
@pytest.mark.parametrize("depth", [2, 3])
def test_run_outputs_survive_later_replays(depth, kind):
    """The consumer keeps every FrameResult: each equals the eager program
    on its pair after all 12 frames ran; its images lie in pinned memory,
    its per-box arrays were copied out of it, and no two arrays held share
    a byte."""
    cuda_or_skip()
    eng = Engine(_cfg(kind), source=_source(ring=5), device="cuda")
    got = {}
    eng.run(frames=12, on_frame=lambda i, r: got.__setitem__(i, r),
            print_stats_on_sigint=False, pipeline_depth=depth)
    assert sorted(got) == list(range(12)) and _graph(eng).calls == 12
    ref_src = _source(ring=5)
    spans = []
    for i, res in got.items():
        left, right = ref_src.render(i % 5)[:2]
        _assert_equal(res, _eager(eng, left, right), f"{kind} depth {depth} frame {i}")
        for k in FIELDS:
            a = getattr(res, k)
            if a is not None:
                big = a.ndim >= 2 and a.shape[0] == res.mask.shape[0]
                assert torch.from_numpy(a).is_pinned() == big, f"frame {i} {k}"
                spans.append(_memory(a))
    spans.sort()
    assert all(b <= c for (_, b), (c, _) in zip(spans, spans[1:]))


@pytest.mark.cuda
def test_run_preloaded_outputs_survive_later_replays(monkeypatch):
    """`run_preloaded` dispatches its device-resident pairs into the
    capture: every frame from the second on replays, and after it returns
    the capture's outputs equal the eager program on the last pair."""
    cuda_or_skip()
    eng = Engine(_cfg(), source=_source(), device="cuda")
    dispatched, replays = [], []
    dispatch, replay = eng._dispatch, graphs.replay

    def logged(left, right):
        dispatched.append((left, right))
        return dispatch(left, right)

    def counted(segments):
        replays.append(len(dispatched))
        return replay(segments)

    eng._dispatch = logged
    monkeypatch.setattr(graphs, "replay", counted)
    eng.run_preloaded(10, n_inputs=4, pipeline_depth=3)
    prog = _graph(eng)
    assert len(dispatched) == 10 and prog.calls == 10
    assert replays == list(range(2, 11))
    assert all(left.is_cuda and right.is_cuda for left, right in dispatched)
    ref = eng.frame_program(*dispatched[-1])
    for k, v in ref.items():
        if v is not None:
            assert torch.equal(prog.outputs[k].nan_to_num(), v.nan_to_num()), k


@pytest.mark.cuda
def test_a_setter_captures_again():
    cuda_or_skip()
    low, high, size = [0, 100, 50], [15, 255, 255], 400
    eng = Engine(_cfg(), source=_source(), device="cuda")
    src = _source()
    for i in range(3):
        eng.process_pair(*src.render(i)[:2])
    first = _graph(eng)
    eng.set_hsv_thresholds(low, high)
    eng.set_min_object_size(size)
    assert eng._graphs._by_shape == {}
    fresh = Engine(_cfg(), source=_source(), device="cuda")
    fresh.set_hsv_thresholds(low, high)
    fresh.set_min_object_size(size)
    for i in range(3, 7):
        left, right = src.render(i)[:2]
        got = eng.process_pair(left, right)
        _assert_equal(got, fresh.process_pair(left, right), f"frame {i} against a fresh engine")
        _assert_equal(got, _eager(eng, left, right), f"frame {i} against the eager program")
    assert _graph(eng) is not first and _graph(eng).calls == 4


class _SlowSource(SyntheticStereoSource):
    """Grabs slower than the loop's frames, so the prefetch thread is always
    inside one; each grab's interval is kept. A grab outlasts the time from
    the loop's taking a pair to the capture's start even where a slow first
    frame filled the prefetch queue (the thread then grabs one frame a
    pair taken) and the upload's pinned memory is still being allocated."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.grabs = []

    def grab(self):
        t0 = time.perf_counter()
        time.sleep(0.1)
        out = super().grab()
        self.grabs.append((t0, time.perf_counter(), threading.current_thread().name))
        return out


@pytest.mark.cuda
def test_capture_while_the_prefetch_thread_grabs(monkeypatch):
    cuda_or_skip()
    src = _SlowSource(W, H, seed=0, ring=5)
    eng = Engine(_cfg(), source=src, device="cuda")
    windows = []
    real = graphs.capture_segments

    def timed(program, capture):
        t0 = time.perf_counter()
        try:
            return real(program, capture)
        finally:
            windows.append((t0, time.perf_counter()))

    monkeypatch.setattr(graphs, "capture_segments", timed)
    got = {}
    eng.run(frames=10, on_frame=lambda i, r: got.__setitem__(i, r),
            print_stats_on_sigint=False, prefetch=True)
    assert len(windows) == 1 and len(got) == 10
    (t0, t1), = windows
    during = [name for a, b, name in src.grabs if a <= t1 and b >= t0]
    assert during and set(during) == {"rtdm-ingest"}, (
        during, t1 - t0, [(a - t0, b - t0, name) for a, b, name in src.grabs])
    ref_src = _source(ring=5)
    for i, res in got.items():
        _assert_equal(res, _eager(eng, *ref_src.render(i % 5)[:2]), f"frame {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bm", "sgm"])
def test_profiler_sees_the_stage_ranges_alike(kind, tmp_path):
    """Each `rtdm.stage.*` and `rtdm.match.*` range holds as many device
    operations when the program replays as when it runs eagerly, and the
    same kernels (a copy or a fill is named by how CUDA ran it: a graph's
    copy node is a "Memcpy", the eager call may be a kernel);
    `rtdm.engine.replay` holds no operation outside a stage range. The
    first frames after a profiler starts can lose device records on the
    card (a replayed frame's first stages once read no operation), so a
    profile that replays runs first, as the benchmark's warm stretch does,
    and each profile's first frame is left out of the comparison."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import spans

    cuda_or_skip()
    eng = Engine(_cfg(kind), source=_source(), device="cuda")
    left, right = _source().render(0)[:2]
    for _ in range(3):
        eng.process_pair(left, right)
    dl, dr = _dev(left), _dev(right)
    eng.frame_program(dl, dr)

    def traced(fn, name):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                fn()
            torch.cuda.synchronize()
        path = tmp_path / f"{name}.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]

    def kernels(ops):
        return sorted(n for n, _, _ in ops if "memcpy" not in n.lower()
                      and "memset" not in n.lower())

    traced(lambda: eng.process_pair(left, right), "warm")
    runs = {"eager": traced(lambda: eng.frame_program(dl, dr), "eager"),
            "replay": traced(lambda: eng.process_pair(left, right), "replay")}
    rows = {}
    for mode, events in runs.items():
        by_thread = spans.launched(events)
        rows[mode] = {
            name: [(len(ops), kernels(ops))
                   for _, _, ops in spans.instances(events, name, by_thread)[1:]]
            for name in dict.fromkeys(r[0] for r in spans.ranges(events))
            if name.startswith(("rtdm.stage.", "rtdm.match."))}
    assert rows["eager"] and rows["replay"] == rows["eager"]
    replay = runs["replay"]
    held = spans.launched_inside(replay, lambda n: n == "rtdm.engine.replay")
    staged = spans.launched_inside(replay, lambda n: n.startswith("rtdm.stage."))
    assert len(staged) == len(held) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bm", "sgm"])
def test_sweep_counts_under_replay(kind):
    """The capture's counter is filled by each replay with the sweeps the
    eager program's K2 calls ran on the same frame. Outside a profiler
    neither the replayed dispatch nor its `_send` makes the host wait
    (set_sync_debug_mode "error"), and its `_receive` reads no count; under
    one the count range carries the replay's sum."""
    from torch.profiler import ProfilerActivity, profile

    cuda_or_skip()
    eng = Engine(_cfg(kind), source=_source(), device="cuda")
    src = _source()
    pairs = [src.render(i)[:2] for i in range(4)]
    expect = _program_sweeps(eng, pairs)
    assert eng._sweeps.calls == 3 and all(n > 0 for n in expect)
    for left, right in pairs[:2]:  # eager, captured
        eng.process_pair(left, right)
    prog = _graph(eng)
    torch.cuda.synchronize()
    for (left, right), n in zip(pairs, expect):
        dl, dr = _dev(left), _dev(right)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, sweeps = eng._dispatch(dl, dr)
            sent = eng._send(out, sweeps)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert sweeps is prog.sweeps and prog.sweeps.calls == 3
        sent.sweep_count = None  # no profiler: `_receive` reads no count
        eng._receive(sent, contextlib.nullcontext())
        assert int(prog.sweeps.words[:3].sum()) == n
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [eng.process_pair(left, right) for left, right in pairs]
    names = [e.name for e in prof.events() if e.name.startswith("rtdm.count.")]
    assert names == [f"rtdm.count.cc_sweeps.{n}" for n in expect] and len(got) == 4


def _program_sweeps(eng, pairs):
    """K2's sweeps of the eager program on each pair."""
    out = []
    for left, right in pairs:
        with eng._sweeps.recording():
            eng.frame_program(_dev(left), _dev(right))
        out.append(int(eng._sweeps.words[:eng._sweeps.calls].sum()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bm", "sgm"])
def test_run_counts_each_frames_own_sweeps(kind):
    """Under a profiler `run` puts one count range a frame into the trace,
    in frame order, each the sweeps of that frame's own program (eager,
    captured, then replayed) while later frames already run."""
    from torch.profiler import ProfilerActivity, profile

    cuda_or_skip()
    n = 8
    eng = Engine(_cfg(kind), source=_source(), device="cuda")
    src = _source()
    expect = _program_sweeps(eng, [src.render(i)[:2] for i in range(n)])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(frames=n, on_frame=lambda i, r: True, print_stats_on_sigint=False,
                pipeline_depth=2)
    names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.name.startswith("rtdm.count.")]
    assert names == [f"rtdm.count.cc_sweeps.{c}" for c in expect]
    assert _graph(eng).calls == n and all(c > 0 for c in expect)


@pytest.mark.cuda
def test_run_dispatch_never_waits_for_the_card():
    """With no profiler, once a frame replays, neither its dispatch (the
    upload and the replay) nor the enqueue of its pinned copies makes the
    host wait for the device (set_sync_debug_mode "error" raises on any
    synchronising call)."""
    cuda_or_skip()
    eng = Engine(_cfg(), source=_source(ring=5), device="cuda")
    guarded = []

    def strict(fn):
        def call(*args):
            if not any(p.segments is not None for p in eng._graphs._by_shape.values()):
                return fn(*args)  # the eager frame and the capture
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                guarded.append(fn.__name__)
        return call

    eng._dispatch = strict(eng._dispatch)
    eng._send = strict(eng._send)
    got = {}
    eng.run(frames=8, on_frame=lambda i, r: got.__setitem__(i, r),
            print_stats_on_sigint=False, pipeline_depth=2)
    assert len(got) == 8
    assert guarded.count("_dispatch") == 6 and guarded.count("_send") == 7
