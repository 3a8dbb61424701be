"""Build the port's CUDA kernels with nvcc at first use and bind them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
for Hopper (`sm_90a`) into `build/torch_kernels/<name>-<hash>.so` at the root
of the checkout. The hash covers the source, the shared headers
(`csrc/*.cuh`) and the compiler flags, so an edited kernel is rebuilt and an
unchanged one is reused. A file lock serialises concurrent builds (several
processes importing the port at once); `build_all` runs one nvcc per source,
all at once.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

_libs: dict = {}
#: seconds each kernel's nvcc build took in this process (absent when the
#: library was already built)
build_seconds: dict = {}
#: nvcc/ptxas output of each build (registers, shared memory, spills)
build_log: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _so_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names) -> None:
    """Build every library of `names` that is not built yet, one nvcc
    process per source, all started together; raise if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = []
        for name in names:
            so = _so_path(name)
            if so.exists():
                continue
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs.append((name, so, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, so, tmp, t0, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{out}")
                continue
            os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
            build_log[name] = out
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(_so_path(name)))
    lib.rtdm_error_string.argtypes = [ctypes.c_int]
    lib.rtdm_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.rtdm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def on_card(t, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raise for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def require(t, name: str, dtype, shape=None) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
