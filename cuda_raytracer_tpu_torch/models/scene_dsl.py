"""Scene-description DSL parser and scene assembly (counterpart of
``cuda_raytracer_tpu/models/scene_dsl.py``; reference: scene.cu:569-831).

Line-oriented text format, parsed with identical command semantics and
defaults:
  image w h rays_per_pixel bounces exposure     (defaults 1920x1080, 1, 3)
  material <name> [diffuse r g b] [specular r g b] [emit r g b]
                  [metallicity m] [roughness r] [ior n]
  sphere <material> cx cy cz radius
  triangle <material> p1 p2 p3                  (9 floats)
  quad <material> p1 p2 p3 p4                   (12 floats → fan (0,1,2)+(0,2,3))
  ply <material> <path>
  sky r g b                                     (1x1 environment map)
  sky_map <path.pfm>
  camera position x y z forward x y z up x y z fov deg

Assembly then mirrors the reference's load_scene tail: flatten to arrays,
precompute camera data, build the BVH (max_depth 30, or 0 for no_bvh → single
root leaf), convert triangles to edge form with geometric normals, and compute
scene bounds for Morton normalisation — all into the padded SoA `Scene` on
the requested device. Parsing and assembly are the JAX package's NumPy code,
so every array equals the JAX scene's exactly.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from cuda_raytracer_tpu_torch.models import bvh as bvh_mod
from cuda_raytracer_tpu_torch.models import cluster as cluster_mod
from cuda_raytracer_tpu_torch.models import pfm, ply, procedural
from cuda_raytracer_tpu_torch.models.scene import (
    PAD_COORD,
    RenderConfig,
    Scene,
    make_materials,
    pad_rows,
    precompute_camera,
    round_up,
)
from cuda_raytracer_tpu_torch.utils.backend import resolve_device


@dataclasses.dataclass
class ParsedScene:
    """Raw parse result, before BVH build / padding / device upload."""

    width: int = 1920
    height: int = 1080
    rays_per_pixel: int = 1
    bounces: int = 3
    exposure: float = 0.0

    camera_position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    camera_forward: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 0, 1], np.float32)
    )
    camera_up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 1, 0], np.float32)
    )
    vertical_fov: float = 0.0

    environment_map: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((1, 1, 3), np.float32)
    )

    material_names: List[str] = dataclasses.field(default_factory=list)
    materials: List[Dict[str, np.ndarray]] = dataclasses.field(default_factory=list)

    sphere_center: List[np.ndarray] = dataclasses.field(default_factory=list)
    sphere_radius: List[float] = dataclasses.field(default_factory=list)
    sphere_material: List[int] = dataclasses.field(default_factory=list)

    tri_p1: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_p2: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_p3: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_material: List[int] = dataclasses.field(default_factory=list)


def _default_material() -> Dict[str, np.ndarray]:
    # Reference defaults: scene.cu:653-659.
    return dict(
        diffuse=np.ones(3, np.float32),
        specular=np.ones(3, np.float32),
        emit=np.zeros(3, np.float32),
        metallicity=np.float32(0.0),
        roughness=np.float32(0.0),
        ior=np.float32(0.0),
    )


class SceneParseError(ValueError):
    """Scene-DSL error with file:line context.

    The reference fails with an uncontextualised exception (unknown materials
    throw from ``materials_map.at``, scene.cu:701; malformed numbers crash in
    ``std::stof``); SURVEY §5.3 asks this build to do better: every parse
    failure names the file, line number, and offending line."""


def parse_scene_text(
    text: str,
    base_dir: str = ".",
    allow_substitute_assets: bool = True,
    filename: str = "<scene>",
) -> ParsedScene:
    """Parse the DSL. ``base_dir`` resolves relative ply/sky_map paths the way
    the reference resolves them against the working directory. Malformed
    commands raise SceneParseError with ``filename``:line diagnostics."""
    scene = ParsedScene()
    material_ids: Dict[str, int] = {}

    def _material_id(name: str, line_no: int, line: str) -> int:
        try:
            return material_ids[name]
        except KeyError:
            known = ", ".join(sorted(material_ids)) or "<none defined yet>"
            raise SceneParseError(
                f"{filename}:{line_no}: unknown material {name!r} in "
                f"{line.strip()!r} (materials defined so far: {known})"
            ) from None

    for line_no, raw_line in enumerate(text.splitlines(), start=1):
        tokens = raw_line.split()
        if not tokens:
            continue
        command, args = tokens[0], tokens[1:]
        try:
            _dispatch_line(
                scene, material_ids, _material_id, command, args,
                line_no, raw_line, base_dir, allow_substitute_assets,
            )
        except SceneParseError:
            raise
        except FileNotFoundError:
            raise
        except (ValueError, IndexError, KeyError) as exc:
            raise SceneParseError(
                f"{filename}:{line_no}: malformed {command!r} command in "
                f"{raw_line.strip()!r} ({type(exc).__name__}: {exc})"
            ) from exc
    return scene


def _dispatch_line(
    scene, material_ids, _material_id, command, args,
    line_no, raw_line, base_dir, allow_substitute_assets,
):
        if command == "sky":
            rgb = np.array([float(v) for v in args[:3]], np.float32)
            scene.environment_map = rgb.reshape(1, 1, 3)
        elif command == "sky_map":
            path = os.path.join(base_dir, args[0])
            if os.path.exists(path):
                scene.environment_map = pfm.load_pfm(path)
            elif allow_substitute_assets:
                warnings.warn(
                    f"sky_map {args[0]!r} not found; using deterministic "
                    "procedural substitute (reference checkout is missing "
                    "this blob)"
                )
                scene.environment_map = procedural.substitute_envmap()
            else:
                raise FileNotFoundError(path)
        elif command == "camera":
            # camera position x y z forward x y z up x y z fov deg
            vals = {}
            i = 0
            while i < len(args):
                key = args[i]
                if key == "fov":
                    vals["fov"] = float(args[i + 1])
                    i += 2
                else:
                    vals[key] = np.array(
                        [float(v) for v in args[i + 1 : i + 4]], np.float32
                    )
                    i += 4
            scene.camera_position = vals["position"]
            forward = vals["forward"]
            scene.camera_forward = forward / np.linalg.norm(forward)
            up = vals["up"]
            scene.camera_up = up / np.linalg.norm(up)
            scene.vertical_fov = float(np.deg2rad(vals["fov"]))
        elif command == "material":
            name = args[0]
            material = _default_material()
            i = 1
            while i < len(args):
                prop = args[i]
                if prop in ("diffuse", "specular", "emit"):
                    material[prop] = np.array(
                        [float(v) for v in args[i + 1 : i + 4]], np.float32
                    )
                    i += 4
                elif prop in ("metallicity", "roughness", "ior"):
                    material[prop] = np.float32(float(args[i + 1]))
                    i += 2
                else:
                    i += 1  # unknown props skipped, like the reference
            material_ids[name] = len(scene.materials)
            scene.material_names.append(name)
            scene.materials.append(material)
        elif command == "sphere":
            scene.sphere_material.append(_material_id(args[0], line_no, raw_line))
            vals = [float(v) for v in args[1:5]]
            if len(vals) != 4:
                raise ValueError("sphere needs <material> cx cy cz radius")
            scene.sphere_center.append(np.array(vals[:3], np.float32))
            scene.sphere_radius.append(vals[3])
        elif command == "triangle":
            scene.tri_material.append(_material_id(args[0], line_no, raw_line))
            vals = np.array([float(v) for v in args[1:10]], np.float32)
            if vals.shape[0] != 9:
                raise ValueError("triangle needs <material> + 9 coordinates")
            scene.tri_p1.append(vals[0:3])
            scene.tri_p2.append(vals[3:6])
            scene.tri_p3.append(vals[6:9])
        elif command == "quad":
            mat = _material_id(args[0], line_no, raw_line)
            vals = np.array([float(v) for v in args[1:13]], np.float32)
            if vals.shape[0] != 12:
                raise ValueError("quad needs <material> + 12 coordinates")
            p = [vals[j : j + 3] for j in range(0, 12, 3)]
            for a, b, c in ((0, 1, 2), (0, 2, 3)):
                scene.tri_material.append(mat)
                scene.tri_p1.append(p[a])
                scene.tri_p2.append(p[b])
                scene.tri_p3.append(p[c])
        elif command == "ply":
            mat = _material_id(args[0], line_no, raw_line)
            path = os.path.join(base_dir, args[1])
            if not os.path.exists(path):
                if allow_substitute_assets:
                    warnings.warn(
                        f"ply {args[1]!r} not found; skipping (reference "
                        "checkout is missing this blob)"
                    )
                    return
                raise FileNotFoundError(path)
            p1, p2, p3 = ply.load_ply(path)
            scene.tri_p1.extend(p1)
            scene.tri_p2.extend(p2)
            scene.tri_p3.extend(p3)
            scene.tri_material.extend([mat] * p1.shape[0])
        elif command == "image":
            scene.width = int(args[0])
            scene.height = int(args[1])
            scene.rays_per_pixel = int(args[2])
            scene.bounces = int(args[3])
            scene.exposure = float(args[4])
        # Unknown commands fall through silently, matching the reference's
        # if/else-if chain.


def assemble_scene(
    parsed: ParsedScene,
    use_bvh: bool = True,
    config_overrides: Optional[dict] = None,
    prefer_native_bvh: bool = True,
    cluster_tris: int = cluster_mod.DEFAULT_CLUSTER_TRIS,
    device=None,
) -> Scene:
    """Build the `Scene` on ``device`` (default CUDA) from a parse result:
    BVH build, edge-form conversion, bounds, padding, upload."""
    device = resolve_device(device)

    def up(a) -> torch.Tensor:
        # 32-bit leaves only, as the JAX package stores them.
        a = np.array(a, copy=True)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        return torch.from_numpy(a).to(device)

    sphere_count = len(parsed.sphere_radius)
    tri_count = len(parsed.tri_p1)

    p1 = np.asarray(parsed.tri_p1, np.float32).reshape(tri_count, 3)
    p2 = np.asarray(parsed.tri_p2, np.float32).reshape(tri_count, 3)
    p3 = np.asarray(parsed.tri_p3, np.float32).reshape(tri_count, 3)

    built = bvh_mod.build_bvh(
        p1, p2, p3,
        max_depth=bvh_mod.MAX_BVH_DEPTH if use_bvh else 0,
        prefer_native=prefer_native_bvh,
    )
    order = built.order
    p1, p2, p3 = p1[order], p2[order], p3[order]
    tri_materials = np.asarray(parsed.tri_material, np.int32)[order] if tri_count else (
        np.zeros(0, np.int32)
    )

    # Edge form + geometric normal (reference: scene.cu:1029-1035; note the
    # normal is cross(e2, e1), i.e. (p3-p1) x (p2-p1)).
    e1 = p2 - p1
    e2 = p3 - p1
    cross = np.cross(e2, e1)
    norm = np.linalg.norm(cross, axis=-1, keepdims=True)
    normal = cross / np.where(norm == 0, 1.0, norm)

    # Scene bounds: root AABB expanded by spheres (scene.cu:822-830), with the
    # correct-extent Morton normalisation (quirk Q5 fixed; ops/morton.py).
    min_coord = built.node_min[0].copy()
    max_coord = built.node_max[0].copy()
    for center, radius in zip(parsed.sphere_center, parsed.sphere_radius):
        min_coord = np.minimum(min_coord, center - radius)
        max_coord = np.maximum(max_coord, center + radius)
    extent = max_coord - min_coord
    inv_extent = np.where(extent > 0, 1.0 / np.where(extent == 0, 1.0, extent), 1.0)

    config = dict(
        width=parsed.width,
        height=parsed.height,
        rays_per_pixel=parsed.rays_per_pixel,
        bounces=parsed.bounces,
        exposure=parsed.exposure,
    )
    if config_overrides:
        config.update(config_overrides)
    render_config = RenderConfig(**config)

    # Padding: spheres/materials to 8, triangles to 8. Padded spheres sit at
    # an unreachable coordinate; padded triangles are degenerate (zero edges →
    # Möller–Trumbore determinant 0 → miss).
    sphere_pad = round_up(sphere_count, 8) if sphere_count else 1
    tri_pad = round_up(tri_count, 8) if tri_count else 1
    centers = np.asarray(parsed.sphere_center, np.float32).reshape(sphere_count, 3)
    radii = np.asarray(parsed.sphere_radius, np.float32)

    # Hit indices address this array directly: spheres at [0, sphere_count),
    # triangles at [sphere_count, sphere_count + tri_count) (scene.cuh:110-116)
    # — padding goes at the END so the shared index space stays dense.
    material_index = pad_rows(
        np.concatenate(
            [
                np.asarray(parsed.sphere_material, np.int32).reshape(sphere_count),
                tri_materials,
            ]
        ),
        sphere_pad + tri_pad,
        0,
    )

    mats = parsed.materials or [_default_material()]
    materials = make_materials(
        diffuse=np.stack([m["diffuse"] for m in mats]),
        specular=np.stack([m["specular"] for m in mats]),
        emitted=np.stack([m["emit"] for m in mats]),
        metallicity=np.array([m["metallicity"] for m in mats]),
        roughness=np.array([m["roughness"] for m in mats]),
        ior=np.array([m["ior"] for m in mats]),
        device=device,
    )

    node_count = built.child1.shape[0]
    node_pad = round_up(node_count, 8)

    # Cluster cut for the dense TPU intersector (models/cluster.py).
    pack = render_config.cluster_pack
    if pack > 1:
        # Paired-sub-cluster tables (cluster_pack doc in models/scene.py):
        # the BVH is cut at cluster_tris/pack triangles, boxes stay at
        # sub-cluster granularity, blocks pack `pack` consecutive
        # sub-clusters into one lane-aligned (16, cluster_tris) block.
        if render_config.cull_split != 1:
            raise ValueError("cluster_pack > 1 requires cull_split == 1")
        if cluster_tris % pack:
            raise ValueError(
                f"cluster_pack {pack} must divide cluster_tris {cluster_tris}"
            )
        clusters = cluster_mod.pad_clusters(
            cluster_mod.build_clusters(
                built, tri_count, max_tris=cluster_tris // pack
            ),
            pack,
        )
        cluster_blocks, slot_tri = cluster_mod.pack_paired_blocks(
            clusters, p1.astype(np.float32), e1.astype(np.float32),
            e2.astype(np.float32), pack,
        )
        cull_min, cull_max = clusters.aabb_min, clusters.aabb_max
    else:
        clusters = cluster_mod.build_clusters(
            built, tri_count, max_tris=cluster_tris
        )
        cluster_blocks, slot_tri = cluster_mod.pack_cluster_blocks(
            clusters, p1.astype(np.float32), e1.astype(np.float32),
            e2.astype(np.float32),
        )
        # Two-level cull tables: (K * cull_split, 3) sub-boxes, row-major by
        # cluster (models/cluster.split_aabbs; identity at cull_split=1).
        cull_min, cull_max = cluster_mod.split_aabbs(
            clusters, p1.astype(np.float32), e1.astype(np.float32),
            e2.astype(np.float32), render_config.cull_split,
        )
    # Append one degenerate dummy cluster (row K): the fused closest-hit
    # kernel targets it with sentinel pairs (zero edges → MT det 0 → miss).
    dummy = np.zeros((1,) + cluster_blocks.shape[1:], np.float32)
    dummy[0, 0:3, :] = 1e17
    dummy[0, 9, :] = -1.0
    cluster_blocks = np.concatenate([cluster_blocks, dummy], axis=0)

    camera = precompute_camera(
        parsed.camera_position,
        parsed.camera_forward,
        parsed.camera_up,
        parsed.vertical_fov,
        render_config.width,
        render_config.height,
        device=device,
    )

    return Scene(
        sphere_center=up(pad_rows(centers, sphere_pad, PAD_COORD)),
        sphere_radius=up(pad_rows(radii, sphere_pad, 0.0)),
        tri_p1=up(pad_rows(p1.astype(np.float32), tri_pad, PAD_COORD)),
        tri_e1=up(pad_rows(e1.astype(np.float32), tri_pad, 0.0)),
        tri_e2=up(pad_rows(e2.astype(np.float32), tri_pad, 0.0)),
        tri_normal=up(pad_rows(normal.astype(np.float32), tri_pad, 0.0)),
        material_index=up(material_index),
        materials=materials,
        bvh_min=up(pad_rows(built.node_min, node_pad, bvh_mod.AABB_EMPTY_MIN)),
        bvh_max=up(pad_rows(built.node_max, node_pad, bvh_mod.AABB_EMPTY_MAX)),
        bvh_child1=up(pad_rows(built.child1, node_pad, 0)),
        bvh_child2=up(pad_rows(built.child2, node_pad, 0)),
        cluster_min=up(cull_min),
        cluster_max=up(cull_max),
        cluster_blocks=up(cluster_blocks),
        cluster_slot_tri=up(slot_tri),
        environment_map=up(parsed.environment_map),
        camera=camera,
        min_coord=up(min_coord.astype(np.float32)),
        inv_extent=up(inv_extent.astype(np.float32)),
        config=render_config,
        sphere_count=sphere_count,
        triangle_count=tri_count,
        material_count=len(mats),
        bvh_node_count=node_count,
        max_leaf_size=built.max_leaf_size,
        num_clusters=clusters.num_clusters,
        # Block WIDTH (lane count), not sub-cluster size: with
        # cluster_pack > 1 each block carries `pack` sub-clusters of
        # cluster_tris/pack triangles (num_clusters counts sub-clusters).
        cluster_tris=clusters.max_tris * pack,
    )


def load_scene(
    path: str,
    use_bvh: bool = True,
    config_overrides: Optional[dict] = None,
    base_dir: Optional[str] = None,
    prefer_native_bvh: bool = True,
    cluster_tris: int = cluster_mod.DEFAULT_CLUSTER_TRIS,
    device=None,
) -> Scene:
    """Parse + assemble a .scene file onto ``device`` (default CUDA).
    Relative asset paths resolve against ``base_dir`` (default: the scene
    file's directory)."""
    device = resolve_device(device)
    with open(path) as f:
        text = f.read()
    if base_dir is None:
        base_dir = os.path.dirname(os.path.abspath(path))
    parsed = parse_scene_text(text, base_dir=base_dir, filename=path)
    return assemble_scene(
        parsed,
        use_bvh=use_bvh,
        config_overrides=config_overrides,
        prefer_native_bvh=prefer_native_bvh,
        cluster_tris=cluster_tris,
        device=device,
    )
