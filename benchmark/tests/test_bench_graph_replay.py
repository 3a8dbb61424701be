"""`graph_replay_pct` on hand-made chrome traces: dispatch spans with and
without a replay span inside, a replay span on another thread, a program
that never replays, and a trace without spans."""

from benchmark.harness import cell

READ = cell.reader("graph_replay_pct")
MAIN, OTHER = 10, 11


def _range(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur}


def _ctx(events):
    return {"events": events, "frames": 4}


def test_share_of_dispatches_that_replay():
    events = [
        # an eager frame (the first of its shape), then three replayed ones
        _range("rtdm.engine.dispatch", 0.0, 100.0),
        _range("rtdm.engine.upload", 1.0, 5.0),
        _range("rtdm.stage.match", 40.0, 30.0),
        _range("rtdm.engine.dispatch", 200.0, 50.0),
        _range("rtdm.engine.replay", 210.0, 30.0),
        _range("rtdm.stage.match", 215.0, 10.0),
        _range("rtdm.engine.dispatch", 300.0, 50.0),
        _range("rtdm.engine.replay", 310.0, 30.0),
        _range("rtdm.engine.dispatch", 400.0, 50.0),
        _range("rtdm.engine.replay", 410.0, 40.0),
        # a replay range on another thread inside no dispatch of its own
        _range("rtdm.engine.replay", 10.0, 20.0, tid=OTHER),
        _range("rtdm.engine.d2h", 120.0, 30.0),
    ]
    assert READ(_ctx(events)) == 75.0
    replayed = [e for e in events if not (e["name"] == "rtdm.engine.dispatch" and e["ts"] == 0)]
    assert READ(_ctx(replayed)) == 100.0


def test_a_replay_outside_the_dispatch_does_not_count():
    events = [_range("rtdm.engine.dispatch", 0.0, 100.0),
              _range("rtdm.engine.replay", 90.0, 20.0)]  # ends after the dispatch
    assert READ(_ctx(events)) == 0.0


def test_a_program_that_never_replays_reads_none():
    eager = [_range("rtdm.engine.dispatch", 0.0, 100.0),
             _range("rtdm.engine.replayed", 10.0, 50.0),  # another name
             _range("rtdm.stage.match", 40.0, 30.0)]
    assert READ(_ctx(eager)) is None
    assert READ(_ctx([_range("rtdm.engine.replay", 10.0, 50.0)])) is None
    assert READ(_ctx([])) is None
