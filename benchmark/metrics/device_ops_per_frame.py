"""engine: device operations (kernels, copies, fills) a frame in the
traced stretch. A count: fusion or a CUDA graph moves it."""


def read(ctx):
    if not ctx["frames"]:
        return None
    return len(ctx["ops"]) / ctx["frames"]
