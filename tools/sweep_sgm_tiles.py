#!/usr/bin/env python3
"""Sweep the tile constants of the port's K3 and K4 kernels on one GPU.

Writes copies of `csrc/sgm_cost.cu` with other (SC_TX, SC_R) and of
`csrc/sgm_horiz.cu` with other (SH_ROWS, ring depth) into `build/sweep/`,
builds each with nvcc (all at once), then holds each variant bit for bit
against the plain versions and prints its median time (CUDA events) on a
random 1280x720 pair at D=128 (K3 also at 1920x1080, D=256; K4 on int16 and
int32 volumes), twice, in turns. The first variant of each list is the
source as it stands. Run from the root of a checkout on a machine with the
card:

    python3 tools/sweep_sgm_tiles.py
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rt_depth_map_tpu_torch.ops.cuda import _build  # noqa: E402
from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (  # noqa: E402
    plane_stack,
    sgm_cost_volume_plain,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import sgm_horiz_plain  # noqa: E402

K3 = [(16, 64), (32, 64), (16, 32), (16, 48), (8, 64), (16, 96)]
K4 = [(2, 8), (4, 8), (1, 8), (1, 4), (2, 4), (1, 16)]
OUT = _build.BUILD_DIR.parent / "sweep"
P, I = ctypes.c_void_p, ctypes.c_int


def _time_ms(fn, reps=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _variant(src: str, name: str, subs) -> Path:
    """A copy of csrc/<src>.cu with each (old, new) of subs replaced."""
    text = (_build.CSRC_DIR / f"{src}.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{src}.cu no longer holds {old!r}")
        text = text.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def _build_variants():
    os.makedirs(OUT, exist_ok=True)
    jobs = [(f"cost_{tx}_{r}", _variant("sgm_cost", f"cost_{tx}_{r}", [
        ("#define SC_TX 16 ", f"#define SC_TX {tx} "),
        ("#define SC_R 64 ", f"#define SC_R {r} ")])) for tx, r in K3]
    jobs += [(f"horiz_{rows}_{ring}", _variant("sgm_horiz", f"horiz_{rows}_{ring}", [
        ("#define SH_ROWS 2 ", f"#define SH_ROWS {rows} "),
        ("K <= 4 ? 8 : 4;", f"K <= 4 ? {ring} : {max(ring // 2, 2)};")]))
        for rows, ring in K4]
    procs = [(name, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}", "-o",
         str(OUT / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, src in jobs]
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = sorted({int(ln.split("Used ")[1].split()[0])
                       for ln in out.splitlines() if "Used " in ln})
        spills = [ln.strip() for ln in out.splitlines()
                  if "spill stores" in ln and not ln.strip().startswith("0 bytes")]
        print(f"{name}: registers {regs[0]}-{regs[-1]}, spills {spills[:2]}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_sgm_tiles: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build_variants()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for H, W, D in ((720, 1280, 128), (1080, 1920, 256)):
        left = torch.randint(0, 256, (H, W), dtype=torch.uint8, device="cuda",
                             generator=g)
        lpl, rpl = plane_stack(left, 0), plane_stack(torch.roll(left, 40, 1), 0)
        ref = sgm_cost_volume_plain(lpl, rpl, D, 5, torch.int16)[0]
        cases.append((H, W, D, lpl, rpl, ref))
    Ct = cases[0][5].transpose(0, 1).contiguous()
    Sh_ref = sgm_horiz_plain(Ct, 600, 2400)
    for _ in range(2):
        for tx, r in K3:
            fn = ctypes.CDLL(str(OUT / f"cost_{tx}_{r}.so")).rtdm_sgm_cost
            fn.argtypes = [P, P, I, I, I, I, I, I, I, P, P]
            fn.restype = I
            res = []
            for H, W, D, lpl, rpl, ref in cases:
                out = torch.empty_like(ref)

                def call():
                    assert fn(lpl.data_ptr(), rpl.data_ptr(), H, W, D, 5, D,
                              W - D, 2, out.data_ptr(), stream()) == 0

                call()
                torch.cuda.synchronize()
                res.append(f"{H}x{W} D={D} exact {torch.equal(out, ref)} "
                           f"{_time_ms(call):.4f} ms")
            print(f"K3 SC_TX {tx} SC_R {r}: " + "; ".join(res), flush=True)
        for rows, ring in K4:
            fn = ctypes.CDLL(str(OUT / f"horiz_{rows}_{ring}.so")).rtdm_sgm_horiz
            fn.argtypes = [P, I, P, I, I, I, I, I, P]
            fn.restype = I
            res = []
            for C in (Ct, Ct.to(torch.int32)):
                out = torch.empty(Ct.shape, dtype=torch.int32, device="cuda")

                def call():
                    assert fn(C.data_ptr(), C.element_size(), out.data_ptr(),
                              Ct.shape[1], Ct.shape[0], Ct.shape[2], 600, 2400,
                              stream()) == 0

                call()
                torch.cuda.synchronize()
                res.append(f"{C.dtype} exact {torch.equal(out, Sh_ref)} "
                           f"{_time_ms(call):.4f} ms")
            print(f"K4 SH_ROWS {rows} SH_RING {ring}: " + "; ".join(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
