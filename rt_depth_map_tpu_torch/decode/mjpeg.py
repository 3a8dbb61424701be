# Copy of rt_depth_map_tpu/decode/mjpeg.py; the port imports nothing of the JAX package.
"""MJPEG -> RGB decoding with default-Huffman-table injection.

UVC cameras commonly emit MJPEG frames without DHT segments, relying on the
ISO/IEC 10918-1 Annex K.3.3 default tables; strict decoders reject such
streams. The reference patches the decoder state after reading the header
(mjpeg-decoder-sw.cpp:88-93,116-119); here the equivalent is done on the byte
stream -- if no DHT marker is present, the standard tables are spliced in
before the SOS segment -- which keeps the behavior decoder-agnostic (the
actual entropy decode is cv2.imdecode / PIL on host; a native libjpeg path
lives in decode/native when built).

Failure behavior parity: `decode` returns None on corrupt input instead of
raising, mirroring the reference's setjmp recovery that keeps the previous
frame (mjpeg-decoder-sw.cpp:108-110,139-141).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# ISO/IEC 10918-1 Annex K.3.3 default Huffman tables, serialized as a single
# JFIF DHT segment (marker FFC4): 4 tables (DC/AC x luma/chroma) with the
# standard BITS/HUFFVAL contents. Built programmatically below to avoid a
# 400-byte magic blob.

_DC_LUMA_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_LUMA_VALS = list(range(12))
_DC_CHROMA_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
_DC_CHROMA_VALS = list(range(12))

_AC_LUMA_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_LUMA_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]
_AC_CHROMA_BITS = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
_AC_CHROMA_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]


def _dht_payload(table_class: int, table_id: int, bits, vals) -> bytes:
    return bytes([(table_class << 4) | table_id] + list(bits) + list(vals))


def default_dht_segment() -> bytes:
    """One FFC4 segment carrying all four K.3.3 default tables."""
    payload = (
        _dht_payload(0, 0, _DC_LUMA_BITS, _DC_LUMA_VALS)
        + _dht_payload(1, 0, _AC_LUMA_BITS, _AC_LUMA_VALS)
        + _dht_payload(0, 1, _DC_CHROMA_BITS, _DC_CHROMA_VALS)
        + _dht_payload(1, 1, _AC_CHROMA_BITS, _AC_CHROMA_VALS)
    )
    length = len(payload) + 2
    return b"\xff\xc4" + length.to_bytes(2, "big") + payload


def _iter_segments(buf: bytes):
    """Yield (marker, offset) for each JFIF segment up to SOS/EOI."""
    i = 2  # skip SOI
    n = len(buf)
    while i + 4 <= n:
        if buf[i] != 0xFF:
            return
        marker = buf[i + 1]
        if marker == 0xD8 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            i += 2
            continue
        yield marker, i
        if marker in (0xDA, 0xD9):  # SOS / EOI: entropy data follows
            return
        seg_len = int.from_bytes(buf[i + 2 : i + 4], "big")
        i += 2 + seg_len


def has_huffman_tables(jpeg: bytes) -> bool:
    return any(m == 0xC4 for m, _ in _iter_segments(jpeg))


def inject_default_huffman_tables(jpeg: bytes) -> bytes:
    """Insert the K.3.3 tables before SOS when no DHT segment is present
    (mjpeg-decoder-sw.cpp:116-119 `insertHuffTables` trigger parity)."""
    sos_off = None
    for marker, off in _iter_segments(jpeg):
        if marker == 0xC4:
            return jpeg
        if marker == 0xDA:
            sos_off = off
            break
    if sos_off is None:
        return jpeg
    return jpeg[:sos_off] + default_dht_segment() + jpeg[sos_off:]


class MJPEGDecoder:
    """Host MJPEG decoder (MJPEGDecoderDevice parity).

    backend: "auto" (native C++ libjpeg if buildable, else cv2/PIL),
    "native", "cv2", or "pil". The native path (native/rtdm_jpeg.cpp)
    installs the default Huffman tables inside libjpeg and decodes batches
    on a thread pool."""

    def __init__(self, backend: str = "auto"):
        self.backend = backend
        self._cv2 = None
        self._native = None
        if backend in ("auto", "native"):
            from rt_depth_map_tpu_torch.decode import native

            if native.available():
                self._native = native
            elif backend == "native":
                raise RuntimeError(
                    f"native decoder unavailable: {native.build_error()}"
                )
        if self._native is None and backend in ("auto", "cv2"):
            try:
                import cv2

                self._cv2 = cv2
            except ImportError:
                if backend == "cv2":
                    raise

    def decode_batch(self, frames, width: int, height: int):
        """Decode N frames; native path uses the C++ thread pool."""
        if self._native is not None:
            return self._native.decode_batch(
                [bytes(f) for f in frames], width, height
            )
        return [self.decode(f, width, height) for f in frames]

    def decode(self, data: bytes, width: int, height: int) -> Optional[np.ndarray]:
        """bytes -> (H, W, 3) uint8 RGB, or None on corrupt input."""
        if not data:
            return None
        if self._native is not None:
            return self._native.decode(bytes(data), width, height)
        try:
            buf = inject_default_huffman_tables(bytes(data))
            if self._cv2 is not None:
                arr = self._cv2.imdecode(
                    np.frombuffer(buf, np.uint8), self._cv2.IMREAD_COLOR
                )
                if arr is None:
                    return None
                rgb = arr[..., ::-1]
            else:
                import io

                from PIL import Image

                rgb = np.asarray(Image.open(io.BytesIO(buf)).convert("RGB"))
            if rgb.shape[0] != height or rgb.shape[1] != width:
                return None
            return np.ascontiguousarray(rgb)
        except Exception:
            return None
