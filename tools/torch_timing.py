"""The harness the port's timing tools (`tools/time_torch_*.py`) share.

A tool runs each checkout root given on its command line in a process of
its own, in the order given (parent, change, change, parent shows the
card's drift over the call); the process imports the package of its root
only and builds that checkout's kernels into its own `build/`. It times a
call as 20 launches issued back to back between two CUDA events (the
host's work before each launch overlaps the previous kernel, so that figure
is device time alone where the kernel outlasts the host's work for a call,
and the host's work where it does not: a wrapper's is some tens of us),
reads a call's device activities from torch.profiler (`device_profile`),
and can build copies of one kernel source with parts taken out
(`build_ablations`), whose outputs are wrong by design and only timed.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys


def setup(root: str):
    """Import `root`'s chip_smoke.py and package, and build its kernels;
    returns (chip_smoke, torch)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from rt_depth_map_tpu_torch.ops.cuda import KERNELS, _build

    _build.build_all(sorted({src.rsplit("/", 1)[1][:-3] for _, src, _ in KERNELS}))
    return cs, torch


def b2b_ms(torch, fn, n=20) -> float:
    """Milliseconds a call of fn, n calls issued back to back between two
    CUDA events (after one call to warm up)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_profile(torch, fn, frames=5):
    """(device ms, device operations) a call of fn, from torch.profiler over
    `frames` calls after one to warm up: the device activities (kernels,
    copies, fills) and the sum of their self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0) for e in events)
    return dev_us / 1e3 / frames, sum(e.count for e in events) / frames


def build_ablations(stem: str, ablations, entry: str, argtypes) -> list:
    """Build one copy of `csrc/<stem>.cu` and the headers for each list of
    (file, old, new) substitutions in `ablations`, into `build/sweep/<stem>/`,
    one nvcc each, all at once; returns each copy's (lib, entry function)."""
    from rt_depth_map_tpu_torch.ops.cuda import _build

    out_dir = _build.BUILD_DIR.parent / "sweep" / stem
    procs = []
    for i, subs in enumerate(ablations):
        d = out_dir / str(i)
        d.mkdir(parents=True, exist_ok=True)
        texts = {f.name: f.read_text() for f in _build.CSRC_DIR.iterdir()
                 if f.suffix in (".cu", ".cuh")}
        for name, old, new in subs:
            if old not in texts[name]:
                raise RuntimeError(f"ablation {i}: {old!r} not in {name}")
            texts[name] = texts[name].replace(old, new)
        for name, text in texts.items():
            (d / name).write_text(text)
        so = d / f"{stem}.so"
        procs.append((so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = _build.I
        lib.rtdm_error_string.argtypes = [_build.I]
        lib.rtdm_error_string.restype = ctypes.c_char_p
        libs.append((lib, fn))
    return libs


def main(tool: str, doc: str, modes: dict) -> int:
    """The command line of a timing tool: `tool ROOT [ROOT ...]` runs
    modes["--child"] on each root, `tool --<mode> ROOT` runs
    modes["--<mode>-child"] on one, each in a process of its own that
    prints the mode's result as one JSON line."""
    argv = sys.argv[1:]
    if len(argv) == 2 and argv[0] in modes:
        print(json.dumps(modes[argv[0]](argv[1])), flush=True)
        return 0
    mode = argv[0] if len(argv) == 2 and f"{argv[0]}-child" in modes else None
    roots = argv[1:] if mode else argv
    if not roots or any(r.startswith("--") for r in roots):
        print(doc, file=sys.stderr)
        return 2
    rc = 0
    for root in roots:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(tool),
                               f"{mode}-child" if mode else "--child", root],
                              cwd=root)
        rc = rc or proc.returncode
    return rc
