"""Scene text → plain arrays, for the reference path tracer.

Reads the scene language the benchmark writes (``material``, ``sphere``,
``triangle``, ``quad``, ``sky``, ``sky_map``, ``camera``, ``image``) with
the upstream renderer's semantics (isaac-chandler/cuda-raytracer,
scene.cu:569-831): materials default to white diffuse and specular, a quad
is the fan (0, 1, 2) + (0, 2, 3), the camera's forward and up vectors are
normalised and its field of view is given in degrees. It works out from
the text alone everything a renderer derives from it: triangles in edge
form with their geometric normals, and the camera's near-plane basis.
Nothing here reads the program under test.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np

MATERIAL_FIELDS = ("diffuse", "specular", "emit", "metallicity", "roughness", "ior")


@dataclasses.dataclass
class SceneData:
    """A parsed scene as float32 / int32 NumPy arrays."""

    width: int
    height: int
    rays_per_pixel: int
    bounces: int
    exposure: float
    material_names: List[str]
    materials: Dict[str, np.ndarray]  # diffuse/specular/emit (M, 3); the rest (M,)
    tri_p1: np.ndarray  # (T, 3)
    tri_e1: np.ndarray  # (T, 3) p2 - p1
    tri_e2: np.ndarray  # (T, 3) p3 - p1
    tri_normal: np.ndarray  # (T, 3) normalise(cross(e2, e1))
    tri_material: np.ndarray  # (T,)
    sphere_center: np.ndarray  # (S, 3)
    sphere_radius: np.ndarray  # (S,)
    sphere_material: np.ndarray  # (S,)
    environment_map: np.ndarray  # (H, W, 3)
    # position, top_left, scaled_right, scaled_up, inv_width, inv_height
    camera: Dict[str, np.ndarray]


def read_pfm(path: str) -> np.ndarray:
    """Three header lines (type, "width height", scale), then raw float32
    RGB, row 0 first (the upstream reader: no flip, scale ignored)."""
    with open(path, "rb") as f:
        data = f.read()
    first = data.index(b"\n")
    second = data.index(b"\n", first + 1)
    third = data.index(b"\n", second + 1)
    width, height = (int(v) for v in data[first + 1:second].split())
    pixels = np.frombuffer(data, dtype="<f4", count=width * height * 3, offset=third + 1)
    return pixels.reshape(height, width, 3).copy()


def write_pfm(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) float32 map in the layout ``read_pfm`` reads."""
    image = np.asarray(image, np.float32)
    with open(path, "wb") as f:
        f.write(b"PF\n" + f"{image.shape[1]} {image.shape[0]}\n-1.0\n".encode())
        f.write(image.astype("<f4").tobytes())


def camera_basis(position, forward, up, fov_radians: float, width: int, height: int) -> dict:
    """Near plane at distance 1, ``right = up × forward``, in float32."""
    position = np.asarray(position, np.float32)
    forward = np.asarray(forward, np.float32)
    up = np.asarray(up, np.float32)
    right = np.cross(up, forward)
    plane_h = np.float32(2.0 * np.tan(0.5 * fov_radians))
    plane_w = np.float32(plane_h * width / height)
    scaled_right = plane_w * right
    scaled_up = plane_h * up
    return dict(
        position=position,
        top_left=(forward - 0.5 * scaled_right + 0.5 * scaled_up).astype(np.float32),
        scaled_right=scaled_right.astype(np.float32),
        scaled_up=scaled_up.astype(np.float32),
        inv_width=np.float32(1.0 / (width - 1)) if width > 1 else np.float32(1.0),
        inv_height=np.float32(1.0 / (height - 1)) if height > 1 else np.float32(1.0),
    )


def parse(text: str, base_dir: str = ".") -> SceneData:
    """Parse scene text; relative ``sky_map`` paths resolve in ``base_dir``."""
    image = dict(width=1920, height=1080, rays_per_pixel=1, bounces=3, exposure=0.0)
    names: List[str] = []
    mats: List[dict] = []
    tris: List[np.ndarray] = []
    tri_mat: List[int] = []
    spheres: List[List[float]] = []
    sphere_mat: List[int] = []
    env = np.zeros((1, 1, 3), np.float32)
    cam = None
    for line in text.splitlines():
        tok = line.split()
        if not tok:
            continue
        cmd, args = tok[0], tok[1:]
        if cmd == "material":
            m = dict(diffuse=np.ones(3, np.float32), specular=np.ones(3, np.float32),
                     emit=np.zeros(3, np.float32), metallicity=np.float32(0),
                     roughness=np.float32(0), ior=np.float32(0))
            i = 1
            while i < len(args):
                if args[i] in ("diffuse", "specular", "emit"):
                    m[args[i]] = np.array([float(v) for v in args[i + 1:i + 4]], np.float32)
                    i += 4
                elif args[i] in ("metallicity", "roughness", "ior"):
                    m[args[i]] = np.float32(float(args[i + 1]))
                    i += 2
                else:
                    i += 1
            if args[0] in names:
                mats[names.index(args[0])] = m
            else:
                names.append(args[0])
                mats.append(m)
        elif cmd == "triangle":
            tris.append(np.array([float(v) for v in args[1:10]], np.float32))
            tri_mat.append(names.index(args[0]))
        elif cmd == "quad":
            p = np.array([float(v) for v in args[1:13]], np.float32).reshape(4, 3)
            for a, b, c in ((0, 1, 2), (0, 2, 3)):
                tris.append(np.concatenate([p[a], p[b], p[c]]))
                tri_mat.append(names.index(args[0]))
        elif cmd == "sphere":
            spheres.append([float(v) for v in args[1:5]])
            sphere_mat.append(names.index(args[0]))
        elif cmd == "sky":
            env = np.array([float(v) for v in args[:3]], np.float32).reshape(1, 1, 3)
        elif cmd == "sky_map":
            env = read_pfm(os.path.join(base_dir, args[0]))
        elif cmd == "camera":
            vals, i = {}, 0
            while i < len(args):
                if args[i] == "fov":
                    vals["fov"] = float(args[i + 1])
                    i += 2
                else:
                    vals[args[i]] = np.array([float(v) for v in args[i + 1:i + 4]], np.float32)
                    i += 4
            cam = vals
        elif cmd == "image":
            image = dict(width=int(args[0]), height=int(args[1]), rays_per_pixel=int(args[2]),
                         bounces=int(args[3]), exposure=float(args[4]))
    if cam is None:
        raise ValueError("scene text has no camera line")
    tri = np.asarray(tris, np.float32).reshape(-1, 9)
    p1, p2, p3 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    e1, e2 = p2 - p1, p3 - p1
    cross = np.cross(e2, e1)
    norm = np.linalg.norm(cross, axis=-1, keepdims=True)
    sph = np.asarray(spheres, np.float32).reshape(-1, 4)
    return SceneData(
        **image,
        material_names=names,
        materials={f: np.stack([m[f] for m in mats]).astype(np.float32) for f in MATERIAL_FIELDS},
        tri_p1=p1, tri_e1=e1, tri_e2=e2,
        tri_normal=(cross / np.where(norm == 0, 1.0, norm)).astype(np.float32),
        tri_material=np.asarray(tri_mat, np.int32),
        sphere_center=sph[:, :3].copy(), sphere_radius=sph[:, 3].copy(),
        sphere_material=np.asarray(sphere_mat, np.int32),
        environment_map=env,
        camera=camera_basis(cam["position"], cam["forward"] / np.linalg.norm(cam["forward"]),
                            cam["up"] / np.linalg.norm(cam["up"]), float(np.deg2rad(cam["fov"])),
                            image["width"], image["height"]),
    )
