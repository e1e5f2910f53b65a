"""Binary little-endian PLY mesh loader (reference: scene.cu:489-546).

The reference's loader is hardcoded to the exact layout its assets use:
8 float32 vertex properties (x y z nx ny nz u v) and uint8-count / int32-index
face lists, with fan triangulation of polygons. This loader parses the header
properly (so it fails loudly on other layouts instead of reading garbage) and
vectorises the common all-triangles case into a single ``np.frombuffer``.

Returns raw vertex triples (p1, p2, p3) — edge-form conversion happens after
the BVH build, as in the reference (scene.cu:1029-1035).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_VERTEX_PROPS = ("x", "y", "z", "nx", "ny", "nz", "u", "v")


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load triangles from a binary_little_endian PLY file.

    Returns (p1, p2, p3), each (T, 3) float32, fan-triangulated with the
    reference's (v0, v[j-1], v[j]) winding (scene.cu:534-545).
    """
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    vertex_count = face_count = None
    vertex_props = []
    current_element = None
    face_list_ok = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format" and parts[1] != "binary_little_endian":
            raise ValueError(f"{path}: unsupported PLY format {parts[1]}")
        if parts[0] == "element":
            current_element = parts[1]
            if parts[1] == "vertex":
                vertex_count = int(parts[2])
            elif parts[1] == "face":
                face_count = int(parts[2])
        elif parts[0] == "property":
            if current_element == "vertex":
                if parts[1] != "float":
                    raise ValueError(f"{path}: non-float vertex property {line!r}")
                vertex_props.append(parts[-1])
            elif current_element == "face":
                face_list_ok = parts[1] == "list" and parts[2] in (
                    "uint8",
                    "uchar",
                ) and parts[3] in ("int", "int32", "uint", "uint32")
    if vertex_count is None or face_count is None:
        raise ValueError(f"{path}: missing vertex/face elements")
    if tuple(vertex_props) != _VERTEX_PROPS:
        raise ValueError(f"{path}: unsupported vertex layout {vertex_props}")
    if face_count and not face_list_ok:
        raise ValueError(f"{path}: unsupported face list format")

    vertex_bytes = vertex_count * 8 * 4
    vertices = np.frombuffer(body[:vertex_bytes], dtype="<f4").reshape(
        vertex_count, 8
    )
    positions = np.ascontiguousarray(vertices[:, :3])

    face_body = body[vertex_bytes:]
    # Fast path: every face is a triangle → fixed 13-byte stride records.
    tri_record = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
    if len(face_body) >= face_count * tri_record.itemsize:
        faces = np.frombuffer(
            face_body[: face_count * tri_record.itemsize], dtype=tri_record
        )
        if np.all(faces["n"] == 3):
            tri_idx = faces["idx"].astype(np.int64)
            p1 = positions[tri_idx[:, 0]]
            p2 = positions[tri_idx[:, 1]]
            p3 = positions[tri_idx[:, 2]]
            return p1.copy(), p2.copy(), p3.copy()

    # General path: variable-size polygons, fan-triangulated.
    p1s, p2s, p3s = [], [], []
    offset = 0
    for _ in range(face_count):
        n = face_body[offset]
        offset += 1
        idx = np.frombuffer(face_body, dtype="<i4", count=n, offset=offset)
        offset += 4 * n
        for j in range(2, n):
            p1s.append(positions[idx[0]])
            p2s.append(positions[idx[j - 1]])
            p3s.append(positions[idx[j]])
    if not p1s:
        empty = np.zeros((0, 3), np.float32)
        return empty, empty.copy(), empty.copy()
    return (
        np.asarray(p1s, np.float32),
        np.asarray(p2s, np.float32),
        np.asarray(p3s, np.float32),
    )
