"""Uncompressed RGBA AVI chunks in NumPy: the one lossless imgstore chunk
format that needs no codec library.

OpenCV's writer (its FFmpeg backend) stores fourcc ``RGBA`` as a RIFF
``AVI `` file whose ``LIST movi`` holds one ``00dc`` chunk of H·W·4 bytes
a frame, each frame top-down as R, G, B, A, with an ``idx1`` index after
it; files past 1 GiB continue in ``RIFF AVIX`` lists (OpenDML). The reader
here walks that tree for the frames' offsets and reads each frame back as
the BGR array OpenCV returns. The writer writes the same layout (without
the OpenDML placeholders), which OpenCV reads back frame for frame.
"""

from __future__ import annotations

import os
import struct
from fractions import Fraction

import numpy as np

MAX_RIFF_BYTES = 1 << 30      # a plain AVI RIFF list stays under 1 GiB
_AVIF_HASINDEX = 0x10
_AVIF_ISINTERLEAVED = 0x100
_AVIIF_KEYFRAME = 0x10


def _chunks(buf: bytes, start: int, end: int):
    """(fourcc, data offset, size, list type or None) of each chunk in
    ``buf[start:end]``, odd sizes padded."""
    off = start
    while off + 8 <= end:
        tag = buf[off:off + 4]
        size = struct.unpack_from("<I", buf, off + 4)[0]
        kind = buf[off + 8:off + 12] if tag in (b"RIFF", b"LIST") else None
        yield tag, off + 8, size, kind
        off += 8 + size + (size & 1)


class RgbaAviReader:
    """Random access to the frames of one RGBA AVI file (``release``
    closes it, as on ``cv2.VideoCapture``)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._index()
        except Exception:
            self._f.close()
            raise

    def _index(self):
        size = os.fstat(self._f.fileno()).st_size
        # the RIFF lists are walked by their headers alone: each frame's
        # bytes are skipped by seeking, never read or searched
        self.width = self.height = None
        self.offsets = []
        pos = 0
        while pos + 12 <= size:
            self._f.seek(pos)
            tag, n, kind = struct.unpack("<4sI4s", self._f.read(12))
            if tag != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
                raise ValueError(f"{self.path}: not an AVI RIFF list at {pos}")
            self._walk(pos + 12, pos + 8 + n)
            pos += 8 + n + (n & 1)
        if self.width is None:
            raise ValueError(f"{self.path}: no video stream header")
        self.frame_bytes = self.width * self.height * 4

    def _walk(self, start: int, end: int):
        """Reads ``hdrl`` whole (a few KiB) and walks ``movi`` by seeking
        from one chunk header to the next."""
        pos = start
        while pos + 8 <= end:
            self._f.seek(pos)
            head = self._f.read(12)
            tag, n = struct.unpack_from("<4sI", head)
            kind = head[8:12]
            if tag == b"LIST" and kind == b"hdrl":
                self._f.seek(pos + 12)
                self._header(self._f.read(n - 4))
            elif tag == b"LIST" and kind in (b"movi", b"rec "):
                self._walk(pos + 12, pos + 8 + n)
            elif tag[2:] in (b"dc", b"db") and tag[:2] == b"00":
                if n != self.width * self.height * 4:
                    raise ValueError(f"{self.path}: frame of {n} bytes at "
                                     f"{pos}, not {self.height}x"
                                     f"{self.width}x4")
                self.offsets.append(pos + 8)
            pos += 8 + n + (n & 1)

    def _header(self, hdrl: bytes):
        for tag, off, n, kind in _chunks(hdrl, 0, len(hdrl)):
            if tag == b"LIST" and kind == b"strl":
                for t, o, m, _ in _chunks(hdrl, off + 4, off + n):
                    if t == b"strf" and self.width is None:
                        (_, w, h, _, bits, comp) = struct.unpack_from(
                            "<IiiHH4s", hdrl, o)
                        if comp != b"RGBA" or bits != 32:
                            raise ValueError(
                                f"{self.path}: stream 0 is {comp!r} at "
                                f"{bits} bits, not RGBA at 32")
                        self.width, self.height = w, abs(h)

    def __len__(self) -> int:
        return len(self.offsets)

    def read(self, i: int) -> np.ndarray:
        """Frame ``i`` as a contiguous (H, W, 3) BGR uint8 array."""
        rgba = np.empty((self.height, self.width, 4), np.uint8)
        self._f.seek(self.offsets[i])
        if self._f.readinto(memoryview(rgba).cast("B")) != self.frame_bytes:
            raise IOError(f"{self.path}: frame {i} is truncated")
        return np.ascontiguousarray(rgba[..., 2::-1])

    def release(self):
        self._f.close()


def write_rgba_avi(path: str, frames: np.ndarray, fps: float) -> None:
    """Write (N, H, W, 3) BGR uint8 frames as one RGBA AVI file (alpha
    255). Raises ``ValueError`` when the file would pass 1 GiB: the caller
    picks a smaller imgstore ``chunksize``."""
    frames = np.asarray(frames)
    n, h, w, c = frames.shape
    if frames.dtype != np.uint8 or c != 3:
        raise ValueError("frames must be (N, H, W, 3) uint8")
    fb = h * w * 4
    movi = 4 + n * (8 + fb)
    idx1 = 16 * n
    rate = Fraction(fps).limit_denominator(1_000_000)
    avih = struct.pack(
        "<10I16x", round(1e6 / fps), min(int(fb * fps + 0.5), 2**32 - 1), 0,
        _AVIF_HASINDEX | _AVIF_ISINTERLEAVED, n, 0, 1, fb, w, h)
    strh = struct.pack(
        "<4s4sIHHIIIIIIiI4h", b"vids", b"RGBA", 0, 0, 0, 0,
        rate.denominator, rate.numerator, 0, n, fb, -1, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 32, b"RGBA", fb,
                       0, 0, 0, 0)

    def chunk(tag, data):
        return tag + struct.pack("<I", len(data)) + data

    strl = chunk(b"LIST", b"strl" + chunk(b"strh", strh)
                 + chunk(b"strf", strf))
    hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + strl)
    riff = 4 + len(hdrl) + 8 + movi + 8 + idx1
    if riff + 8 > MAX_RIFF_BYTES:
        raise ValueError(
            f"an RGBA chunk of {n} frames of {w}x{h} takes {riff + 8} "
            f"bytes, over the {MAX_RIFF_BYTES} an AVI file may hold: "
            "lower the chunksize")
    rgba = np.empty((h, w, 4), np.uint8)
    rgba[..., 3] = 255
    frame_head = b"00dc" + struct.pack("<I", fb)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", riff) + b"AVI " + hdrl)
        f.write(b"LIST" + struct.pack("<I", movi) + b"movi")
        for fr in frames:
            rgba[..., :3] = fr[..., ::-1]
            f.write(frame_head)
            f.write(memoryview(rgba).cast("B"))
        index = np.zeros((n, 4), "<u4")
        index[:, 0] = np.frombuffer(b"00dc", "<u4")[0]
        index[:, 1] = _AVIIF_KEYFRAME
        index[:, 2] = 4 + np.arange(n, dtype=np.uint32) * (8 + fb)
        index[:, 3] = fb
        f.write(b"idx1" + struct.pack("<I", idx1) + index.tobytes())
