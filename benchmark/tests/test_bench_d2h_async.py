"""`d2h_async_pct` on hand-made chrome traces: every dispatch span holding
its frame's pinned copies, some of them only, a copy span on another thread
or outside its dispatch, and a program that never opens the span."""

from benchmark.harness import cell

READ = cell.reader("d2h_async_pct")
MAIN, OTHER = 10, 11


def _range(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur}


def _frame(ts, copies=True):
    """A replayed frame's dispatch: the upload, the replay, then the pinned
    copies where `copies`."""
    out = [_range("rtdm.engine.dispatch", ts, 50.0),
           _range("rtdm.engine.upload", ts + 1.0, 5.0),
           _range("rtdm.engine.replay", ts + 10.0, 30.0)]
    if copies:
        out.append(_range("rtdm.engine.d2h_async", ts + 41.0, 8.0))
    return out + [_range("rtdm.engine.d2h", ts + 60.0, 30.0)]


def _ctx(events):
    return {"events": events, "frames": 4}


def test_every_dispatch_holds_its_copies():
    events = [e for k in range(4) for e in _frame(100.0 * k)]
    assert READ(_ctx(events)) == 100.0


def test_a_share_of_the_dispatches():
    events = [e for k in range(4) for e in _frame(100.0 * k, copies=k != 0)]
    assert READ(_ctx(events)) == 75.0
    # a copy span on another thread, inside no dispatch of its own
    events.append(_range("rtdm.engine.d2h_async", 5.0, 8.0, tid=OTHER))
    assert READ(_ctx(events)) == 75.0


def test_a_copy_span_outside_the_dispatch_does_not_count():
    events = [_range("rtdm.engine.dispatch", 0.0, 100.0),
              _range("rtdm.engine.d2h_async", 95.0, 10.0)]  # ends after the dispatch
    assert READ(_ctx(events)) == 0.0


def test_no_copy_span_reads_none():
    eager = [e for k in range(4) for e in _frame(100.0 * k, copies=False)]
    assert READ(_ctx(eager)) is None
    assert READ(_ctx(eager + [_range("rtdm.engine.d2h_asyncs", 41.0, 8.0)])) is None
    assert READ(_ctx([_range("rtdm.engine.d2h_async", 10.0, 5.0)])) is None
    assert READ(_ctx([])) is None
