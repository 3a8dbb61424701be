"""stages: device ms a frame of the matcher stage: the union of the
intervals of the device operations launched inside the program's
`rtdm.stage.match` spans (the launch call, joined by its correlation id,
on the span's thread), over the traced stretch's frames. None where the
program opens no such span."""

from benchmark.harness import spans


def read(ctx):
    events = spans.events_of(ctx)
    if not events or not ctx["frames"]:
        return None
    ops = spans.launched_inside(events, lambda name: name == "rtdm.stage.match")
    if not ops:
        return None
    return spans.busy_us(ops) * 1e-3 / ctx["frames"]
