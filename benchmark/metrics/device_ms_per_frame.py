"""kernels: milliseconds a frame in which some device operation ran (the
union of their intervals over the traced stretch, over its frames)."""


def read(ctx):
    if not ctx["frames"] or not ctx["ops"]:
        return None
    return ctx["busy_s"] * 1e3 / ctx["frames"]
