# Copy of rt_depth_map_tpu/sources/v4l2.py; the port imports nothing of the JAX package.
"""Live V4L2 MJPEG stereo capture.

Re-creates V4LStreamStereoDevice (v4l2-stream-stereo-device.cpp:13-133):
per-device QUERYCAP -> S_FMT(MJPEG, w, h) -> REQBUFS(MMAP, count=1) ->
QUERYBUF -> mmap -> STREAMON, then per frame QBUF both eyes before DQBUF both
(software L/R sync). Implemented with raw ioctls via ctypes against
videodev2.h ABI -- no external deps. Single buffer per camera matches the
reference's queue depth (count=1, v4l2-stream-stereo-device.cpp:57).

Only importable on Linux with real /dev/video* devices; everything else in
the framework uses the synthetic/file sources.
"""

from __future__ import annotations

import ctypes
import fcntl
import mmap
import os
from typing import Tuple

from rt_depth_map_tpu_torch.sources.base import StereoFrame

# videodev2.h ABI (stable uapi)
_VIDIOC_QUERYCAP = 0x80685600
_VIDIOC_S_FMT = 0xC0D05605
_VIDIOC_REQBUFS = 0xC0145608
_VIDIOC_QUERYBUF = 0xC0585609
_VIDIOC_QBUF = 0xC058560F
_VIDIOC_DQBUF = 0xC0585611
_VIDIOC_STREAMON = 0x40045612
_VIDIOC_STREAMOFF = 0x40045613

_V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
_V4L2_MEMORY_MMAP = 1
_V4L2_PIX_FMT_MJPEG = 0x47504A4D  # 'MJPG'
_V4L2_CAP_VIDEO_CAPTURE = 0x00000001
_V4L2_CAP_STREAMING = 0x04000000


class _v4l2_capability(ctypes.Structure):
    # 104 bytes (the 0x68 encoded in VIDIOC_QUERYCAP = _IOR('V', 0, 104))
    _fields_ = [
        ("driver", ctypes.c_uint8 * 16),
        ("card", ctypes.c_uint8 * 32),
        ("bus_info", ctypes.c_uint8 * 32),
        ("version", ctypes.c_uint32),
        ("capabilities", ctypes.c_uint32),
        ("device_caps", ctypes.c_uint32),
        ("reserved", ctypes.c_uint32 * 3),
    ]


class _v4l2_pix_format(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("pixelformat", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("bytesperline", ctypes.c_uint32),
        ("sizeimage", ctypes.c_uint32),
        ("colorspace", ctypes.c_uint32),
        ("priv", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("enc", ctypes.c_uint32),
        ("quantization", ctypes.c_uint32),
        ("xfer_func", ctypes.c_uint32),
    ]


class _v4l2_format(ctypes.Structure):
    # The kernel's fmt union is 8-byte aligned (v4l2_window holds pointers),
    # so fmt starts at offset 8, not 4; total size is the 208 encoded in
    # VIDIOC_S_FMT (_IOWR('V', 5, 208)). Checked by tests/test_v4l2_abi.py.
    _fields_ = [
        ("type", ctypes.c_uint32),
        ("_pad0", ctypes.c_uint32),
        ("fmt", _v4l2_pix_format),
        ("_pad", ctypes.c_uint8 * 152),
    ]


class _v4l2_timecode(ctypes.Structure):
    # 16 bytes: u32 type, u32 flags, u8 frames/seconds/minutes/hours,
    # u8 userbits[4]
    _fields_ = [
        ("type", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("frames", ctypes.c_uint8),
        ("seconds", ctypes.c_uint8),
        ("minutes", ctypes.c_uint8),
        ("hours", ctypes.c_uint8),
        ("userbits", ctypes.c_uint8 * 4),
    ]


class _v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [
        ("count", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("capabilities", ctypes.c_uint32),
        ("flags", ctypes.c_uint8),
        ("reserved", ctypes.c_uint8 * 3),
    ]


class _v4l2_buffer(ctypes.Structure):
    class _m(ctypes.Union):
        _fields_ = [
            ("offset", ctypes.c_uint32),
            ("userptr", ctypes.c_ulong),
            ("planes", ctypes.c_void_p),
            ("fd", ctypes.c_int32),
        ]

    # 64-bit layout, 88 bytes total (the 0x58 encoded in VIDIOC_QUERYBUF):
    # struct timeval timestamp is 8-byte aligned (4 pad bytes after field),
    # v4l2_timecode is 16 bytes, and the m union (contains pointers) is
    # 8-byte aligned after memory. Offsets asserted by tests/test_v4l2_abi.py
    # against linux/videodev2.h ground truth.
    _fields_ = [
        ("index", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("bytesused", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("timestamp", ctypes.c_uint64 * 2),
        ("timecode", _v4l2_timecode),
        ("sequence", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("m", _m),
        ("length", ctypes.c_uint32),
        ("reserved2", ctypes.c_uint32),
        ("request_fd", ctypes.c_int32),
    ]


assert ctypes.sizeof(_v4l2_format) == 208, ctypes.sizeof(_v4l2_format)
assert ctypes.sizeof(_v4l2_buffer) == 88, ctypes.sizeof(_v4l2_buffer)
assert ctypes.sizeof(_v4l2_requestbuffers) == 20


class _Camera:
    def __init__(self, device: str, width: int, height: int):
        self.fd = os.open(device, os.O_RDWR)
        # capability verification before S_FMT (QUERYCAP,
        # v4l2-stream-stereo-device.cpp:22-38): the device must support
        # video capture AND streaming I/O, else fail with a clear error
        # instead of an opaque S_FMT/REQBUFS errno later.
        cap = _v4l2_capability()
        fcntl.ioctl(self.fd, _VIDIOC_QUERYCAP, cap)
        card = bytes(cap.card).split(b"\0", 1)[0].decode(errors="replace")
        if not cap.capabilities & _V4L2_CAP_VIDEO_CAPTURE:
            os.close(self.fd)
            raise RuntimeError(
                f"{device} ({card}) does not support video capture")
        if not cap.capabilities & _V4L2_CAP_STREAMING:
            os.close(self.fd)
            raise RuntimeError(
                f"{device} ({card}) does not support streaming I/O")
        fmt = _v4l2_format()
        fmt.type = _V4L2_BUF_TYPE_VIDEO_CAPTURE
        fmt.fmt.width = width
        fmt.fmt.height = height
        fmt.fmt.pixelformat = _V4L2_PIX_FMT_MJPEG
        fcntl.ioctl(self.fd, _VIDIOC_S_FMT, fmt)

        req = _v4l2_requestbuffers()
        req.count = 1
        req.type = _V4L2_BUF_TYPE_VIDEO_CAPTURE
        req.memory = _V4L2_MEMORY_MMAP
        fcntl.ioctl(self.fd, _VIDIOC_REQBUFS, req)

        buf = _v4l2_buffer()
        buf.index = 0
        buf.type = _V4L2_BUF_TYPE_VIDEO_CAPTURE
        buf.memory = _V4L2_MEMORY_MMAP
        fcntl.ioctl(self.fd, _VIDIOC_QUERYBUF, buf)
        self.mm = mmap.mmap(
            self.fd, buf.length, mmap.MAP_SHARED,
            mmap.PROT_READ | mmap.PROT_WRITE, offset=buf.m.offset,
        )
        fcntl.ioctl(
            self.fd, _VIDIOC_STREAMON,
            ctypes.c_int(_V4L2_BUF_TYPE_VIDEO_CAPTURE),
        )

    def queue(self) -> None:
        buf = _v4l2_buffer()
        buf.index = 0
        buf.type = _V4L2_BUF_TYPE_VIDEO_CAPTURE
        buf.memory = _V4L2_MEMORY_MMAP
        fcntl.ioctl(self.fd, _VIDIOC_QBUF, buf)

    def dequeue(self) -> bytes:
        buf = _v4l2_buffer()
        buf.type = _V4L2_BUF_TYPE_VIDEO_CAPTURE
        buf.memory = _V4L2_MEMORY_MMAP
        fcntl.ioctl(self.fd, _VIDIOC_DQBUF, buf)
        return self.mm[: buf.bytesused]

    def close(self) -> None:
        try:
            fcntl.ioctl(
                self.fd, _VIDIOC_STREAMOFF,
                ctypes.c_int(_V4L2_BUF_TYPE_VIDEO_CAPTURE),
            )
        finally:
            self.mm.close()
            os.close(self.fd)


class V4L2StereoSource:
    """Two-camera synchronized capture (QBUF both, then DQBUF both --
    v4l2-stream-stereo-device.cpp:112-133 software sync)."""

    def __init__(self, left_device: str, right_device: str, width: int, height: int):
        self.width, self.height = width, height
        self.rectified = False
        self.left = _Camera(left_device, width, height)
        self.right = _Camera(right_device, width, height)

    def grab(self) -> Tuple[StereoFrame, StereoFrame]:
        self.left.queue()
        self.right.queue()
        lbytes = self.left.dequeue()
        rbytes = self.right.dequeue()
        return (
            StereoFrame(encoding="mjpeg", data=lbytes),
            StereoFrame(encoding="mjpeg", data=rbytes),
        )

    def close(self) -> None:
        self.left.close()
        self.right.close()
