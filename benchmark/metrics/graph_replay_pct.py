"""engine: the share of the traced stretch's `rtdm.engine.dispatch` spans
that hold an `rtdm.engine.replay` span on their thread (frames whose
program replayed as captured CUDA graphs), in percent. None where the
stretch holds no dispatch span or no replay span at all: a program that
never replays (an older commit, or the CPU) reports nothing."""

from benchmark.harness import spans

DISPATCH, REPLAY = "rtdm.engine.dispatch", "rtdm.engine.replay"


def read(ctx):
    events = spans.events_of(ctx)
    if not events:
        return None
    dispatches = [r for r in spans.ranges(events, DISPATCH) if r[0] == DISPATCH]
    replays = [r for r in spans.ranges(events, REPLAY) if r[0] == REPLAY]
    if not dispatches or not replays:
        return None
    held = sum(any(t == thread and a <= ra and rb <= b for _, t, ra, rb in replays)
               for _, thread, a, b in dispatches)
    return 100.0 * held / len(dispatches)
