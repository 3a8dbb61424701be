"""kernels: the SGM matcher's least time (`harness/roofline.py`
`sgm_work`: cost volume, path recurrence and winner-take-all counted from
the shapes) over the device time of the kernels that implement it, named
in the configuration's `stage_kernels["sgm"]`. None where no such kernel ran."""

from benchmark.harness import roofline


def read(ctx):
    cfg = ctx["config"]
    m = cfg["matcher"]
    names = cfg["stage_kernels"].get("sgm", [])
    t = sum(b - a for n, a, b in ctx["ops"] if any(k in n for k in names)) * 1e-6
    if m["kind"] != "sgm" or t <= 0:
        return None
    nbytes, lane_ops = roofline.sgm_work(ctx["height"], ctx["width"], m["num_disparities"],
                                         m["num_paths"], m["min_disparity"])
    least = roofline.least_s(nbytes, lane_ops, ctx["device_name"])
    if least is None:
        return None
    return 100.0 * least * ctx["frames"] / t
