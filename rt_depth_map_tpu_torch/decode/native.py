# Copy of rt_depth_map_tpu/decode/native.py; the port imports nothing of the JAX package.
"""ctypes bindings for the native C++ decoder (native/rtdm_jpeg.cpp).

Builds the shared library on first use (g++ + system libjpeg, see
native/Makefile) and exposes single-frame and threaded batch decode. The
engine uses this as the production decode path; the pure-Python
decode/mjpeg.py remains the fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "librtdm_native.so")
_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def build_locked(target: str = "") -> None:
    """Run `make -C native [target]` under a cross-process file lock.

    The Makefile compiles straight to the .so (no .o intermediates), so two
    concurrent makes of the same target would interleave writes into the
    output; parallel test workers (pytest-xdist) hit exactly that. flock
    serializes them; the lock file lives next to the Makefile."""
    import fcntl

    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR] + ([target] if target else []),
                check=True,
                capture_output=True,
                text=True,
            )
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                build_locked()
            except (subprocess.CalledProcessError, OSError) as e:
                _build_error = getattr(e, "stderr", str(e)) or str(e)
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            _build_error = str(e)
            return None
        lib.rtdm_jpeg_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_ulong,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.rtdm_jpeg_decode.restype = ctypes.c_int
        lib.rtdm_jpeg_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_ulong),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.rtdm_jpeg_decode_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def decode(data: bytes, width: int, height: int) -> Optional[np.ndarray]:
    """One frame -> (H, W, 3) uint8 RGB; None on corrupt/mismatched input."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_build_error}")
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.rtdm_jpeg_decode(
        data,
        len(data),
        width,
        height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None


def decode_batch(
    frames: Sequence[bytes], width: int, height: int, n_threads: int = 4
) -> List[Optional[np.ndarray]]:
    """Decode N frames on the native thread pool."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_build_error}")
    n = len(frames)
    if n == 0:
        return []
    out = np.empty((n, height, width, 3), np.uint8)
    status = (ctypes.c_int * n)()
    datas = (ctypes.c_char_p * n)(*frames)
    lens = (ctypes.c_ulong * n)(*[len(f) for f in frames])
    lib.rtdm_jpeg_decode_batch(
        datas,
        lens,
        n,
        width,
        height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status,
        n_threads,
    )
    return [out[i] if status[i] == 0 else None for i in range(n)]
