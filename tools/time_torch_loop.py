#!/usr/bin/env python3
"""Time the engine's frame loops in one or more checkouts on one card, each
checkout in its own process, in the order given.

    python3 tools/time_torch_loop.py ROOT [ROOT ...]

Each ROOT is the root of a checkout holding `rt_depth_map_tpu_torch/` and
`chip_smoke.py` (for example the parent commit unpacked with `git archive`
beside this one, given as parent, change, change, parent, so that the
host's and the card's drift over the call shows). A process imports the
package of its ROOT only and builds that checkout's kernels into its own
`build/`. On SGM-8 1280x720 (D=128) and BM-128 1280x720, chip_smoke.py's
engines and synthetic frames, it reads:

- `run`: `Engine.run` with prefetch and no consumer over REPS runs of
  FRAMES frames, after a run of 8 frames that renders the source's ring of
  8 pairs (frames/s of each run, from the engine's wall clock);
- `run` cold, as chip_smoke.py's phase 4 times it: REPS fresh engines,
  each warmed up and run once over COLD frames, its ring rendered by the
  run's ingest thread;
- the frame program's median host time through a synchronise on one
  resident pair, and its device time and device operations a frame
  (torch.profiler);
- where the checkout has them, `run_preloaded` (6 resident pairs) and
  `step_batch` of 4 rigs (frames/s over 20 steps after 8 that render the
  rigs' rings, REPS times; `step_batch_fps`, its first rep): the B-frame
  program where the checkout has `batch_program`, else the pipelined mode
  (one CUDA stream a rig); where the checkout has `batch_program`, also
  the pipelined mode's steps through `dispatch_batch` (chip_smoke.py's
  `_pipelined_step`); each also with a step's device time and device
  operations on resident images (`step_batch`: {"step_batch" or
  "pipelined": {"fps": [...], "device_ms", "device_ops"}}); null where
  the checkout has no `step_batch`.

One JSON line a process: the card's name and power limit, the checkout,
the numbers.
"""

from __future__ import annotations

import sys
import time

import torch_timing as tt

FRAMES, COLD, REPS, BATCH, STEPS = 120, 30, 3, 4, 20
PATHS = (("SGM-8 720p", "sgm"), ("BM-128 720p", "bm"))


def _fps(eng, run, frames):
    f0, s0 = eng.stats.wall_frames, eng.stats.wall_seconds
    run(frames)
    return (eng.stats.wall_frames - f0) / (eng.stats.wall_seconds - s0)


def child(root: str) -> dict:
    cs, torch = tt.setup(root)
    from rt_depth_map_tpu_torch import Engine

    W, H = cs.W, cs.H
    out = {"card": cs._card(), "root": root}
    for name, kind in PATHS:
        cold = []
        for _ in range(REPS):
            fresh = cs._engine(kind, W, H, ring=8)
            fresh.warmup()
            cold.append(_fps(fresh, lambda n: fresh.run(
                frames=n, print_stats_on_sigint=False), COLD))
        eng = cs._engine(kind, W, H, ring=8)
        eng.warmup()
        loop = lambda n: eng.run(frames=n, print_stats_on_sigint=False)  # noqa: E731
        loop(8)
        runs = [_fps(eng, loop, FRAMES) for _ in range(REPS)]
        lnp, rnp, _, _ = cs._source(W, H).render(0)
        pair = (torch.from_numpy(lnp).cuda(), torch.from_numpy(rnp).cuda())
        frame_ms = cs._wall_ms(lambda: eng.frame_program(*pair), reps=20)
        dev_ms, ops = tt.device_profile(torch, lambda: eng.frame_program(*pair))
        row = {"run_fps": runs, "cold_run_fps": cold, "frame_ms": frame_ms,
               "device_ms": dev_ms, "device_ops": ops, "run_preloaded_fps": None,
               "step_batch_fps": None}
        if hasattr(eng, "run_preloaded"):
            pre = cs._engine(kind, W, H, ring=8)
            pre.warmup()
            row["run_preloaded_fps"] = _fps(
                pre, lambda n: pre.run_preloaded(frames=n, n_inputs=6), FRAMES)
        row["step_batch"] = None
        if hasattr(eng, "step_batch"):
            from rt_depth_map_tpu_torch.pipeline.engine import _to_host
            from rt_depth_map_tpu_torch.sources import MultiStreamSource

            pairs = [cs._source(W, H, seed=s).render(0)[:2] for s in range(BATCH)]
            lefts = [p[0] for p in pairs]
            rights = [p[1] for p in pairs]
            modes = [("step_batch", lambda b: b.step_batch(),
                      lambda b: b.process_batch(lefts, rights))]
            if hasattr(eng, "batch_program"):
                modes.append(("pipelined", cs._pipelined_step,
                              lambda b: [_to_host(o) for o in
                                         b.dispatch_batch(lefts, rights)]))
            row["step_batch"] = {}
            for mode, step, resident in modes:
                b = Engine(cs._config(kind, W, H).replace(batch=BATCH),
                           rectification=cs._rectification(W, H),
                           source=MultiStreamSource([cs._source(W, H, ring=8, seed=s)
                                                     for s in range(BATCH)]),
                           device="cuda")
                for _ in range(8):
                    step(b)
                fps = []
                for _ in range(REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(STEPS):
                        step(b)
                    fps.append(BATCH * STEPS / (time.perf_counter() - t0))
                dev_ms, ops = tt.device_profile(torch, lambda: resident(b))
                row["step_batch"][mode] = {"fps": fps, "device_ms": dev_ms,
                                           "device_ops": ops}
                del b
            row["step_batch_fps"] = row["step_batch"]["step_batch"]["fps"][0]
        out[name] = row
        del eng
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(tt.main(__file__, __doc__, {"--child": child}))
