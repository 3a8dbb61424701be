"""kernels: the BM matcher's least time (`harness/roofline.py` `bm_work`:
the SAD window a (pixel, disparity) inside each frame's matching region,
from the union of that frame's boxes) over the device time of the kernels
that implement it, named in the configuration's `stage_kernels["bm"]`.
None where no such kernel ran."""

from benchmark.harness import roofline


def read(ctx):
    cfg = ctx["config"]
    m = cfg["matcher"]
    names = cfg["stage_kernels"].get("bm", [])
    t = sum(b - a for n, a, b in ctx["ops"] if any(k in n for k in names)) * 1e-6
    if m["kind"] != "bm" or t <= 0:
        return None
    least = 0.0
    for roi in ctx["rois"]:
        nbytes, lane_ops = roofline.bm_work(ctx["height"], ctx["width"], m["num_disparities"],
                                            m["block_size"], roi, m["min_disparity"])
        s = roofline.least_s(nbytes, lane_ops, ctx["device_name"])
        if s is None:
            return None
        least += s
    return 100.0 * least / t
