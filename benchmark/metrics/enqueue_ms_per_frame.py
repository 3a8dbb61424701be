"""engine: host ms a frame spent uploading a frame and enqueueing its
program (the program's `rtdm.engine.dispatch` spans summed over the traced
stretch, over its frames). None where the program opens no such span."""

from benchmark.harness import spans


def read(ctx):
    return spans.span_ms_per_frame(ctx, "rtdm.engine.dispatch")
