"""Minimal dependency-free PNG writer.

Replaces the reference's vendored stb_image_write (stb_image_write.h) with ~40
lines over zlib: 8-bit RGB, one IDAT, no filtering beyond per-scanline
filter-type 0. Output is byte-for-byte deterministic.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an RGB PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {image.shape} {image.dtype}")
    height, width = image.shape[:2]
    raw = b"".join(
        b"\x00" + image[row].tobytes() for row in range(height)
    )
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB(A) PNG written by this module or the reference's stb
    writer (filter types 0-4 supported). Used by the golden-image tests to
    compare against renders/ in the reference checkout."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    width = height = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, depth, color = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or color not in (2, 6):
                raise ValueError(f"{path}: unsupported PNG (depth {depth}, color {color})")
            channels = 3 if color == 2 else 4
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = width * channels
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    offset = 0
    for row in range(height):
        ftype = raw[offset]
        line = np.frombuffer(raw, np.uint8, stride, offset + 1).astype(np.int32)
        offset += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = prev[i]
                c = prev[i - channels] if i >= channels else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:  # Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        out[row] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(height, width, channels)[:, :, :3]
