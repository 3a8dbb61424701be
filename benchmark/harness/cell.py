"""One run of one cell: set-up, the measured window, the check against the
reference, and with tracing on, the traced stretches and the per-layer
readers.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in BENCHMARK.json: the configuration's
file (`configs/<name>.json`: the engine's and matcher's settings, the
host's thread count, the reference's thresholds, the kernels of its
matcher stage, the check's limits), the traffic file (`traffic/<name>.json`: the loop, the rigs, the
scene, the ring, the sampled slots), and each per-layer metric's reader
(`metrics/<name>.py`, a `read(ctx)` that returns a number or None).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from pathlib import Path

import numpy as np

from benchmark.harness import check, trace
from benchmark.harness import traffic as gen

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_files(manifest: dict, workload: str, overrides: dict = None):
    """(cell, configuration, traffic) of the named cell. overrides:
    {"config": {...}, "traffic": {...}} merged into the files' top-level
    groups (the CPU tests' small sizes)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(ROOT / cfg["file"])
    tr = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    for group, part in (overrides or {}).items():
        target = config if group == "config" else tr
        for k, v in part.items():
            target[k] = {**target[k], **v} if isinstance(v, dict) else v
    return cell, config, tr


def sampled_slots(seed: int, tr: dict) -> list:
    """The ring slots whose frames the check compares, drawn from the seed:
    a run's and the control's."""
    return np.random.default_rng([seed % 2**64, 3]).choice(
        tr["ring"], size=tr["check_slots"], replace=False).tolist()


def cell_metrics(manifest: dict, workload: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` metrics that the cell reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def union_roi(boxes: np.ndarray):
    """The union (x, y, w, h) of the valid boxes, or None."""
    v = boxes[boxes[:, 4] > 0]
    if not len(v):
        return None
    x0, y0 = int(v[:, 0].min()), int(v[:, 1].min())
    return (x0, y0, int((v[:, 0] + v[:, 2]).max()) - x0, int((v[:, 1] + v[:, 3]).max()) - y0)


class Window:
    """What the loop records: the frames and latencies of the window, the
    sampled frames' results, each (rig, slot)'s boxes, and the stretches."""

    def __init__(self, seconds: float, ring: int, slots, stretches):
        self.seconds, self.ring, self.slots = seconds, ring, set(slots)
        self.stretches = list(stretches)
        self.t0 = None
        self.latencies: list = []
        self.done: list = []  # each frame's arrival, seconds into the window
        self.kept: dict = {}  # (rig, slot) -> the last FrameResult's fields
        self.small: list = []  # (rig, slot, the small fields) of each frame
        self.boxes: dict = {}  # (rig, slot) -> boxes

    def open(self) -> None:
        self.t0 = time.perf_counter()

    def inside(self, t: float) -> bool:
        return t < self.t0 + self.seconds

    def frame(self, t: float, t_grab: float, rig: int, idx: int, res) -> None:
        slot = idx % self.ring
        self.boxes[(rig, slot)] = res.boxes
        if self.t0 is None or not self.inside(t):
            return
        self.latencies.append(t - t_grab)
        self.done.append(t - self.t0)
        if slot in self.slots:
            self.kept[(rig, slot)] = {k: getattr(res, k) for k in check.BIG + check.SMALL}
            self.small.append((rig, slot, {k: getattr(res, k) for k in check.SMALL}))

    def pending(self):
        """The next stretch not yet finished."""
        return next((s for s in self.stretches if s.t1 is None), None)


def drive_run(engine, src, tr: dict, win: Window, warm_profile: bool) -> None:
    """One rig through `Engine.run` with prefetch; the consumer takes each
    whole FrameResult and ends the loop after the window and stretches."""
    warm = tr["warmup_frames"]
    if warm < 4:
        raise ValueError("warmup_frames: at least 4")
    state = {}

    def on_frame(idx, res):
        t = time.perf_counter()
        win.frame(t, src.grab_times[idx], 0, idx, res)
        if win.t0 is None:
            if warm_profile and idx == warm - 4:
                state["warm"] = trace.Stretch("warm", 2)
                state["warm"].start()
            if warm_profile and idx == warm - 2:
                state["warm"].stop()
            if idx + 1 >= warm:
                win.open()
            return True
        s = win.pending()
        if s is not None:
            if s.t0 is None and t >= win.t0 + s.after * win.seconds:
                s.start()
                s.first = idx
            elif s.t0 is not None and idx - s.first >= s.frames:
                s.stop()
                s.dispatched = [(0, j) for j in range(s.first + 2, idx + 2)]
            return True
        return win.inside(t)

    engine.run(frames=None, on_frame=on_frame, print_stats_on_sigint=False,
               pipeline_depth=tr["pipeline_depth"], prefetch=tr["prefetch"])


def drive_steps(engine, srcs, tr: dict, win: Window, warm_profile: bool) -> None:
    """B rigs a step through `Engine.step_batch`; a step's frames are done
    when it returns their FrameResults."""
    B = len(srcs)
    steps = max(1, tr["warmup_frames"] // B)
    k = 0

    def step():
        nonlocal k
        res = engine.step_batch()
        t = time.perf_counter()
        for r in range(B):
            win.frame(t, srcs[r].grab_times[k], r, k, res[r])
        k += 1
        return t

    for i in range(steps):
        if warm_profile and i == steps - 2:
            w = trace.Stretch("warm", 1)
            w.start()
            step()
            w.stop()
        else:
            step()
    win.open()
    while True:
        s = win.pending()
        if s is not None and s.t0 is None and time.perf_counter() >= win.t0 + s.after * win.seconds:
            s.start()
            first = k
            for _ in range(s.frames):
                step()
            s.stop()
            s.dispatched = [(r, j) for j in range(first, k) for r in range(B)]
            continue
        t = step()
        if not win.inside(t) and win.pending() is None:
            return


def reference_check(config: dict, frames: dict, scene: dict, win: Window,
                    device, batch: int):
    """(numbers, compared frames, frames that failed a limit): the kept
    results against the reference computed for their (rig, slot)."""
    import torch

    from benchmark.reference.frame import reference_frames

    keys = sorted(win.kept)
    refs = {}
    for i in range(0, len(keys), batch):
        part = keys[i: i + batch]
        lefts = torch.from_numpy(np.stack([frames[r][s][0] for r, s in part])).to(device)
        rights = torch.from_numpy(np.stack([frames[r][s][1] for r, s in part])).to(device)
        out = reference_frames(lefts, rights, scene, config)
        for j, key in enumerate(part):
            refs[key] = {k: v[j].cpu().numpy() for k, v in out.items()}
        del lefts, rights, out
    limits = config["limits"]
    rows, failed = [], 0
    for key, prog in win.kept.items():
        row = check.compare(prog, refs[key])
        rows.append(row)
        failed += not check.verdict(row, {k: limits[k] for k in row})[0]
    for r, s, small in win.small:
        row = check.compare(small, refs[(r, s)])
        rows.append(row)
        failed += not check.verdict(row, {k: limits[k] for k in row})[0]
    return check.worst(rows), len(rows), failed


def per_layer(manifest: dict, workload: str, config: dict, win: Window,
              device_name: str, width: int, height: int) -> tuple:
    """(metrics, device busy_s, window_s, breakdown) of the traced stretch.
    A reader's context: the device operations (name, start_us, end_us), the
    busy and the stretch's seconds, its frames and each one's matching
    region (the union of its boxes), the configuration and the card."""
    a = win.stretches[0]
    events = a.events()
    ops = trace.device_ops(events)
    busy_s = sum(b - x for x, b in trace.busy_intervals(ops)) * 1e-6
    rois = [union_roi(win.boxes[(r, j % win.ring)]) for r, j in a.dispatched]
    ctx = dict(ops=ops, busy_s=busy_s, window_s=a.window_s, frames=len(rois), rois=rois,
               config=config, device_name=device_name, width=width, height=height)
    metrics = {}
    for m in cell_metrics(manifest, workload, "per_layer"):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    breakdown = {"device_ops": trace.top_ops(ops), "idle_gaps": trace.idle_gaps(events)}
    return metrics, busy_s, a.window_s, breakdown


def run_cell(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
             device: str = "cuda", manifest: dict = None, overrides: dict = None) -> dict:
    """One run; returns the result object (the checks' rows under "checks").
    overrides: as `cell_files` takes them."""
    import torch

    from rt_depth_map_tpu_torch.calib import RectificationResult
    from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
    from rt_depth_map_tpu_torch.pipeline.engine import Engine
    from rt_depth_map_tpu_torch.sources.multi import MultiStreamSource

    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    cell, config, tr = cell_files(manifest, workload, overrides)
    eng, m = config["engine"], config["matcher"]
    W, H, D = eng["width"], eng["height"], m["num_disparities"]
    rigs = tr["rigs"]

    if device == "cuda":
        from rt_depth_map_tpu_torch.ops.cuda import _build

        _build.build_all([n for n in config["libraries"]
                          if (_build.CSRC_DIR / f"{n}.cu").exists()])
        torch.cuda.reset_peak_memory_stats()
    scene = gen.rectification(seed, W, H, tr)
    frames = {r: gen.rig_frames(seed, r, W, H, D, tr) for r in range(rigs)}
    srcs = [gen.RigSource(frames[r], W, H) for r in range(rigs)]
    rect = RectificationResult(map_left=scene["grid_left"], map_right=scene["grid_right"],
                               Q=scene["Q"], roi=(0, 0, W, H), image_size=(W, H))
    ecfg = EngineConfig(**eng, batch=rigs, matcher=MatcherConfig(**m))
    source = srcs[0] if rigs == 1 else MultiStreamSource(srcs)
    engine = Engine(ecfg, rectification=rect, source=source, device=device)
    if (engine.num_disparities, engine.min_object_size) != (D, eng["minimal_object_size"]):
        raise ValueError(f"the engine resolves D={engine.num_disparities} and a minimum "
                         f"object size of {engine.min_object_size}, not the configuration's")

    slots = sampled_slots(seed, tr)
    stretches = [trace.Stretch("A", max(1, tr["trace_frames"] // rigs), after=0.3)] \
        if traced else []
    win = Window(seconds, tr["ring"], slots, stretches)
    if tr["mode"] == "run":
        drive_run(engine, srcs[0], tr, win, traced)
    else:
        drive_steps(engine, srcs, tr, win, traced)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = win.t0 - t_start
    n_frames = len(win.latencies)
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    engine.close()
    del engine, source, srcs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers, compared, failed = reference_check(config, frames, scene, win, device,
                                                tr["reference_batch"])
    timing = {"setup_s": setup_s, "reference_s": time.perf_counter() - t_ref,
              "frames_each_s": np.bincount(np.asarray(win.done, dtype=int),
                                           minlength=int(seconds)).tolist()}
    ok, rows = check.verdict(numbers, config["limits"])
    ok = ok and compared > 0
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    result = {"correct": bool(ok), "attempted": n_frames, "failed": int(failed)}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": name,
           "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    if traced:
        t_read = time.perf_counter()
        metrics, busy_s, window_s, breakdown = per_layer(
            manifest, workload, config, win, name, W, H)
        timing["trace_read_s"] = time.perf_counter() - t_read
        dev.update(busy_s=busy_s, window_s=window_s)
        result.update(metrics=metrics, device=dev, breakdown=breakdown)
    else:
        values = {
            "fps": n_frames / seconds,
            "latency_p95_ms": float(np.percentile(win.latencies, 95)) * 1e3 if n_frames else None,
            "setup_s": setup_s,
        }
        result.update(metrics={
            e["name"]: {"value": values[e["name"]], "unit": e["unit"]}
            for e in cell_metrics(manifest, workload, "end_to_end")}, device=dev)
    result["timing"] = timing
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result
