"""engine: host ms a frame spent waiting for a frame's results on the host
(the program's `rtdm.engine.d2h` spans, which hold the wait for the frame's
device work and the copy, summed over the traced stretch, over its
frames). None where the program opens no such span."""

from benchmark.harness import spans


def read(ctx):
    return spans.span_ms_per_frame(ctx, "rtdm.engine.d2h")
