"""engine: the share of the traced stretch's `rtdm.engine.dispatch` spans
that hold an `rtdm.engine.d2h_async` span on their thread (frames whose
outputs were copied into pinned host memory right behind their program,
to be retired by their own event), in percent. None where the stretch
holds no dispatch span or no such span at all: a program that retires
frames otherwise (an older commit, the batch program, the CPU) reports
nothing."""

from benchmark.harness import spans

DISPATCH, ASYNC = "rtdm.engine.dispatch", "rtdm.engine.d2h_async"


def read(ctx):
    events = spans.events_of(ctx)
    if not events:
        return None
    dispatches = [r for r in spans.ranges(events, DISPATCH) if r[0] == DISPATCH]
    copies = [r for r in spans.ranges(events, ASYNC) if r[0] == ASYNC]
    if not dispatches or not copies:
        return None
    held = sum(any(t == thread and a <= ca and cb <= b for _, t, ca, cb in copies)
               for _, thread, a, b in dispatches)
    return 100.0 * held / len(dispatches)
