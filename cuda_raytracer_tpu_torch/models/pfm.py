"""PFM HDR image reader/writer (reference: scene.cu:548-567).

The reference reads exactly three header lines (type, "width height", scale —
scale ignored, no byte-order handling, no y-flip) followed by raw float32 RGB.
We match that exactly on read so environment maps index identically, and
provide a writer so substitute/procedural maps can be materialised.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_pfm(path: str) -> np.ndarray:
    """Load a PFM as an (H, W, 3) float32 array, reference semantics:
    row 0 is the first row in the file (no vertical flip), scale ignored."""
    with open(path, "rb") as f:
        data = f.read()
    # Three newline-terminated header lines, then raw float32 RGB.
    first = data.index(b"\n")
    second = data.index(b"\n", first + 1)
    third = data.index(b"\n", second + 1)
    dims = data[first + 1 : second].split()
    width, height = int(dims[0]), int(dims[1])
    pixels = np.frombuffer(
        data, dtype="<f4", count=width * height * 3, offset=third + 1
    )
    return pixels.reshape(height, width, 3).copy()


def write_pfm(path: str, image: np.ndarray, scale: float = -1.0) -> None:
    """Write an (H, W, 3) float32 array in the same layout load_pfm reads."""
    image = np.asarray(image, np.float32)
    height, width = image.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{width} {height}\n".encode())
        f.write(f"{scale}\n".encode())
        f.write(image.astype("<f4").tobytes())


def image_dims(path: str) -> Tuple[int, int]:
    with open(path, "rb") as f:
        head = f.read(256)
    first = head.index(b"\n")
    second = head.index(b"\n", first + 1)
    dims = head[first + 1 : second].split()
    return int(dims[0]), int(dims[1])
