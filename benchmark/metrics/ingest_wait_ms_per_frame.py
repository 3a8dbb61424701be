"""host ingest: ms a frame that the loop's thread (the one that opens the
`rtdm.engine.dispatch` spans) spent getting a decoded pair: its
`rtdm.ingest.*` spans summed over the traced stretch, over its frames.
With prefetch that is the wait on the queue (`rtdm.ingest.wait`; grab and
decode run on the ingest thread); where the loop grabs and decodes itself
(no prefetch, `step_batch`), `rtdm.ingest.grab` and `rtdm.ingest.decode`.
None where the program opens no such span."""

from benchmark.harness import spans


def read(ctx):
    events = spans.events_of(ctx)
    if not events or not ctx["frames"]:
        return None
    loop = {thread for _, thread, _, _ in spans.ranges(events, "rtdm.engine.dispatch")}
    us = [b - a for _, thread, a, b in spans.ranges(events, "rtdm.ingest.") if thread in loop]
    return sum(us) * 1e-3 / ctx["frames"] if us else None
