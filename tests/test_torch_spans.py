"""The port's trace spans (`pipeline/stats.py` `span`) on the CPU engine
under a CPU torch.profiler: the stage ranges of both programs under the
dispatch, the layer ranges of each loop, no range without a profiler, the
means table unchanged by them, and no range around the consumer."""

import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rt_depth_map_tpu_torch import Engine
from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
from rt_depth_map_tpu_torch.pipeline import stats
from rt_depth_map_tpu_torch.sources import MultiStreamSource, SyntheticStereoSource
from rt_depth_map_tpu_torch.sources.synthetic import SyntheticObject
from torch_helpers import profiled_spans

W, H, D = 128, 48, 16
STAGES = {"gray", "rectify", "hsv", "morphology", "detect", "match", "reproject", "depth"}
MATCH = {"sgm": {"preprocess", "cost", "to_x_major", "horiz", "to_row_major", "vert_wta",
                 "lr_check", "speckle"},
         "bm": {"prefilter", "cost", "winner", "lr_check", "speckle"}}


def _source(seed=3):
    objects = [SyntheticObject(x=20, y=10, w=40, h=24, z_units=40.0, vx=1.0)]
    src = SyntheticStereoSource(W, H, seed=seed, objects=objects)
    src.rectified = True
    return src


def _engine(kind="bm", batch=1, post_filter=False, source=None):
    mcfg = MatcherConfig(kind=kind, num_disparities=D, block_size=9 if kind == "bm" else 5,
                         speckle_window_size=20, speckle_range=32, disp12_max_diff=1)
    cfg = EngineConfig(width=W, height=H, number_of_disparities=D, matcher=mcfg,
                       batch=batch, enable_post_filter=post_filter)
    if source is None:
        source = _source() if batch == 1 else MultiStreamSource(
            [_source(s) for s in range(3, 3 + batch)])
    return Engine(cfg, source=source, device="cpu")


def _keys(spans, layer):
    return {e.name.split(".", 2)[2] for e in spans if e.name.startswith(f"rtdm.{layer}.")}


def _ancestors(e):
    out = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        out.append(e.name)
    return out


def _count(spans, name):
    return sum(e.name == name for e in spans)


@pytest.mark.parametrize("kind,post_filter", [("sgm", False), ("bm", False), ("bm", True)])
def test_stage_spans_nest_under_dispatch_alike_in_both_programs(kind, post_filter):
    pair = _source().render(0)[:2]
    stages = STAGES | ({"match_right", "wls"} if post_filter else set())
    keys = []
    for batch, call in ((1, lambda e: e.process_pair(*pair)),
                        (2, lambda e: e.process_batch([pair[0]] * 2, [pair[1]] * 2))):
        eng = _engine(kind, batch, post_filter)
        _, spans = profiled_spans(lambda: call(eng))
        assert _keys(spans, "stage") == stages
        assert _keys(spans, "match") == MATCH[kind]
        for e in spans:
            if e.name.startswith("rtdm.stage."):
                assert _ancestors(e) == ["rtdm.engine.dispatch"], e.name
            if e.name.startswith("rtdm.match."):
                assert _ancestors(e)[0] in ("rtdm.stage.match", "rtdm.stage.match_right")
                assert _ancestors(e)[-1] == "rtdm.engine.dispatch"
        uploads = [e for e in spans if e.name == "rtdm.engine.upload"]
        assert len(uploads) == 2 and all(_ancestors(e) == ["rtdm.engine.dispatch"]
                                         for e in uploads)
        assert _count(spans, "rtdm.engine.dispatch") == _count(spans, "rtdm.engine.d2h") == 1
        keys.append([e.name for e in spans if e.name.startswith("rtdm.stage.")])
    # the same stages in the same order; BM matches frame by frame in a batch
    assert keys[0] == keys[1]


@pytest.mark.parametrize("prefetch", [True, False])
def test_run_layer_spans(prefetch):
    eng = _engine()
    _, spans = profiled_spans(lambda: eng.run(frames=4, on_frame=lambda i, r: True,
                                              print_stats_on_sigint=False,
                                              prefetch=prefetch))
    assert _count(spans, "rtdm.engine.dispatch") == _count(spans, "rtdm.engine.d2h") == 4
    assert _count(spans, "rtdm.engine.upload") == 8
    dispatch_thread = {e.thread for e in spans if e.name == "rtdm.engine.dispatch"}
    grab_thread = {e.thread for e in spans if e.name == "rtdm.ingest.grab"}
    if prefetch:
        # the loop's thread waits on the queue; grab and decode run on the
        # ingest thread, which a profiler records only where it started there
        assert _count(spans, "rtdm.ingest.wait") >= 4
        assert {e.thread for e in spans if e.name == "rtdm.ingest.wait"} == dispatch_thread
        assert grab_thread.isdisjoint(dispatch_thread)
    else:
        assert _count(spans, "rtdm.ingest.wait") == 0 and grab_thread == dispatch_thread
        assert _count(spans, "rtdm.ingest.grab") == _count(spans, "rtdm.ingest.decode") == 4
    for e in spans:
        if not e.name.startswith(("rtdm.stage.", "rtdm.match.", "rtdm.engine.upload")):
            assert _ancestors(e) == [], e.name  # the layers do not nest in each other


@pytest.mark.parametrize("loop", ["step", "step_batch", "run_preloaded"])
def test_loop_layer_spans(loop):
    eng = _engine(batch=2 if loop == "step_batch" else 1)
    if loop == "run_preloaded":
        _, spans = profiled_spans(lambda: eng.run_preloaded(4, n_inputs=2,
                                                            pipeline_depth=2))
        assert _count(spans, "rtdm.engine.dispatch") == 4
        assert _count(spans, "rtdm.engine.d2h") == 1  # the final barrier
        assert _count(spans, "rtdm.ingest.grab") == _count(spans, "rtdm.ingest.decode") == 2
        assert _count(spans, "rtdm.engine.upload") == 4
    else:
        _, spans = profiled_spans(getattr(eng, loop))
        # step_batch grabs and decodes every rig's pair in one span each
        assert _count(spans, "rtdm.ingest.grab") == _count(spans, "rtdm.ingest.decode") == 1
        assert _count(spans, "rtdm.engine.dispatch") == _count(spans, "rtdm.engine.d2h") == 1
        assert _count(spans, "rtdm.engine.upload") == 2
    assert _keys(spans, "stage") == STAGES
    for e in spans:
        if e.name.startswith("rtdm.stage."):
            assert _ancestors(e) == ["rtdm.engine.dispatch"]


def test_no_record_function_without_a_profiler(monkeypatch):
    calls = []
    real = stats.record_function

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(stats, "record_function", counting)
    eng = _engine()
    assert stats.span("rtdm.engine.dispatch") is stats._NO_SPAN
    eng.run(frames=2, on_frame=lambda i, r: True, print_stats_on_sigint=False)
    eng.step()
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert stats.span("rtdm.engine.dispatch") is not stats._NO_SPAN
        eng.step()
    assert "rtdm.engine.dispatch" in calls and "rtdm.stage.match" in calls


def _table(report):
    """The report's rows without their numbers."""
    return [re.sub(r" *[-0-9.]+", " #", ln) for ln in report.splitlines()]


@pytest.mark.parametrize("prefetch", [False, True])
def test_means_table_unchanged_by_a_profiler(prefetch):
    def run(profiled):
        eng = _engine()
        loop = lambda: eng.run(frames=3, on_frame=lambda i, r: True,  # noqa: E731
                               print_stats_on_sigint=False, prefetch=prefetch)
        if profiled:
            profiled_spans(loop)
        else:
            loop()
        eng.step()
        st = eng.stats
        counts = {n: a.count for n, a in st._stages.items()}
        rows = _table(st.report())
        if prefetch:
            # the queue's wait counts its timed-out polls, and the ingest
            # thread's first means may come before or after the loop's
            counts.pop("grab (queue wait)")
            rows.sort()
        return counts, st._overlapped, st.iterations, rows

    plain, traced = run(False), run(True)
    assert plain == traced
    assert set(plain[0]) == {"grabOneFrame", "decode", "dispatch", "d2h", "h2d+device+d2h"}


@pytest.mark.parametrize("prefetch", [True, False])
def test_no_span_covers_the_consumer(prefetch):
    """The consumer may start or stop a profiler: nothing the program
    opened is still open while it runs."""
    eng = _engine()

    def on_frame(i, res):
        with torch.autograd.profiler.record_function("consumer"):
            return True

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(frames=3, on_frame=on_frame, print_stats_on_sigint=False, prefetch=prefetch)
    consumers = [e for e in prof.events() if e.name == "consumer"]
    assert len(consumers) == 3 and all(e.cpu_parent is None for e in consumers)


def test_a_profiler_started_inside_the_consumer_sees_whole_spans():
    """The benchmark's way: a profiler started in one frame's consumer and
    stopped in a later one's holds whole dispatch and d2h spans only."""
    eng = _engine()
    prof = profile(activities=[ProfilerActivity.CPU])

    def on_frame(i, res):
        if i == 1:
            prof.start()
        elif i == 4:
            prof.stop()
        return True

    eng.run(frames=6, on_frame=on_frame, print_stats_on_sigint=False, pipeline_depth=2)
    names = [e.name for e in prof.events() if e.name.startswith("rtdm.engine.")]
    # frames 3, 4 and 5 dispatched and 2, 3 and 4 retired between the two
    assert names.count("rtdm.engine.dispatch") == 3
    assert names.count("rtdm.engine.d2h") == 3
    assert all(e.cpu_parent is None for e in prof.events()
               if e.name in ("rtdm.engine.dispatch", "rtdm.engine.d2h"))
