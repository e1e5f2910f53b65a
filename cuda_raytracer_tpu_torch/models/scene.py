"""Scene data model as dataclasses of tensors (counterpart of ``cuda_raytracer_tpu/models/scene.py``).

Structure-of-arrays: every primitive attribute is a flat, padded float32 or
int32 tensor, so a batch of rays can index it directly. A ``Scene`` lives on
one device (``scene.device``) and moves with ``scene.to(device)``.

Triangles are stored post-BVH-build in edge form: p1, e1 = p2-p1,
e2 = p3-p1, and geometric normal normalise(cross(e2, e1)).

``scene_from_numpy`` / ``scene_to_numpy`` carry a scene across packages as
plain NumPy arrays plus static fields, so the tests can hand the JAX package
and the port the very same scene.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cuda_raytracer_tpu_torch.utils.backend import resolve_device

# Sentinel coordinate for padding primitives: far enough that padded spheres
# can never be hit, small enough that squaring it stays finite in float32.
PAD_COORD = 1e17

# derived(): key + ids of the source tensors → (their versions, weak
# references to them, the value).
_DERIVED: Dict[tuple, tuple] = {}


def derived(key: tuple, sources: Tuple[torch.Tensor, ...], build: Callable[[], object]):
    """``build()``, computed once per ``key`` and set of ``sources`` (a
    scene's tensors, by identity) and reused while none of them has been
    modified in place. A scene keeps its tensors through ``with_config`` and
    ``replace`` of other fields, so tables derived from them (the packet
    kernels' box and super-box tables, the shading's material table) are
    built once per scene, on its device, not once per bounce. The entry is
    dropped when a source tensor is freed, so the value must not be a view
    of one (a view would keep it alive)."""
    ident = (key,) + tuple(id(t) for t in sources)
    versions = tuple(t._version for t in sources)
    hit = _DERIVED.get(ident)
    if hit is not None and hit[0] == versions and all(
            ref() is t for ref, t in zip(hit[1], sources)):
        return hit[2]
    value = build()
    refs = tuple(weakref.ref(t, lambda _, ident=ident: _DERIVED.pop(ident, None))
                 for t in sources)
    _DERIVED[ident] = (versions, refs, value)
    return value


def _tensor_fields(obj):
    return [
        f.name for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    ]


def _moved(obj, device):
    return dataclasses.replace(
        obj, **{name: getattr(obj, name).to(device) for name in _tensor_fields(obj)}
    )


@dataclasses.dataclass(frozen=True)
class Materials:
    """Deduplicated material table, SoA, leading dim M (padded)."""

    diffuse_albedo: torch.Tensor  # (M, 3)
    specular_albedo: torch.Tensor  # (M, 3)
    emitted: torch.Tensor  # (M, 3)
    metallicity: torch.Tensor  # (M,)
    roughness: torch.Tensor  # (M,)
    index_of_refraction: torch.Tensor  # (M,)  0 == opaque

    def to(self, device) -> "Materials":
        return _moved(self, device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera with precomputed near-plane basis."""

    position: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    scaled_right: torch.Tensor  # (3,)
    scaled_up: torch.Tensor  # (3,)
    near_plane_top_left: torch.Tensor  # (3,)
    inv_width: torch.Tensor  # ()
    inv_height: torch.Tensor  # ()
    vertical_fov: float = 0.0

    def to(self, device) -> "Camera":
        return _moved(self, device)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render settings. Every field and default of the JAX ``RenderConfig``
    is kept, so a config carries across packages unchanged, and the port
    selects its paths from them as the JAX package does."""

    width: int = 1920
    height: int = 1080
    rays_per_pixel: int = 1
    bounces: int = 3
    exposure: float = 0.0
    # Max rays/pixel traced per pass (the reference's
    # MAX_RAYS_PER_PIXEL_PER_PASS = 20).
    max_rays_per_pixel_per_pass: int = 20
    # Reorder rays by Morton key between bounces (reference `no_sort` flag).
    # Brute scenes never reorder, so the port's brute path ignores it.
    sort_rays: bool = True
    sort_depth: int = 5
    # Triangle intersector: "auto" (brute up to 512 triangles; above, the
    # BVH walk on a CUDA device, packet elsewhere: render/wavefront.
    # resolve_intersector), "brute", "packet" or "bvh" (the per-ray walk).
    intersector: str = "auto"
    packet_tile: int = 64
    packet_cap: int = 64
    packet_backend: str = "auto"
    packet_skip: bool = True
    cull_split: int = 1
    cull_hier: int = 0
    # Shading engine for forward renders: "auto" uses the whole-pass CUDA
    # kernel (ops/kernels/shade.py) for eligible scenes on a CUDA device,
    # "xla" the plain wavefront path, "megakernel" forces the kernel's
    # entry point (its plain version on the CPU).
    shade_engine: str = "auto"
    cluster_pack: int = 1
    sort_engine: str = "auto"
    # Reorder key: "morton", or "cullhit" / "auto" (the first two slab-hit
    # cluster ids on a packet scene, the Morton key otherwise).
    sort_key: str = "morton"
    live_schedule: tuple = ()


@dataclasses.dataclass(frozen=True)
class Scene:
    """Full scene: geometry + BVH + clusters + materials + environment +
    camera, padded, with the true counts as plain integers."""

    # Spheres (not in the BVH, by reference design)
    sphere_center: torch.Tensor  # (S, 3)
    sphere_radius: torch.Tensor  # (S,)

    # Triangles, edge representation (post-build)
    tri_p1: torch.Tensor  # (T, 3)
    tri_e1: torch.Tensor  # (T, 3)  p2 - p1
    tri_e2: torch.Tensor  # (T, 3)  p3 - p1
    tri_normal: torch.Tensor  # (T, 3)  normalise(cross(e2, e1))

    # Per-primitive material index: spheres at [0, S), triangles at [S, S+T).
    material_index: torch.Tensor  # (S + T,) int32

    materials: Materials

    # Flat BVH over triangles (leaf: child2 <= child1).
    bvh_min: torch.Tensor  # (N, 3)
    bvh_max: torch.Tensor  # (N, 3)
    bvh_child1: torch.Tensor  # (N,) int32
    bvh_child2: torch.Tensor  # (N,) int32

    # Cluster cut of the BVH (models/cluster.py), for the mesh path.
    cluster_min: torch.Tensor  # (K * config.cull_split, 3)
    cluster_max: torch.Tensor  # (K * config.cull_split, 3)
    cluster_blocks: torch.Tensor  # (K + 1, 16, C)
    cluster_slot_tri: torch.Tensor  # (K*C,) int32, -1 for padding slots

    environment_map: torch.Tensor  # (H, W, 3) linear radiance
    camera: Camera

    # Scene bounds for Morton-key normalisation.
    min_coord: torch.Tensor  # (3,)
    inv_extent: torch.Tensor  # (3,)

    config: RenderConfig
    sphere_count: int
    triangle_count: int
    material_count: int
    bvh_node_count: int
    max_leaf_size: int
    num_clusters: int = 1
    cluster_tris: int = 256

    @property
    def num_pixels(self) -> int:
        return self.config.width * self.config.height

    @property
    def device(self) -> torch.device:
        return self.sphere_center.device

    def replace(self, **kwargs) -> "Scene":
        return dataclasses.replace(self, **kwargs)

    def with_config(self, **overrides) -> "Scene":
        return self.replace(config=dataclasses.replace(self.config, **overrides))

    def to(self, device) -> "Scene":
        device = resolve_device(device)
        moved = _moved(self, device)
        return dataclasses.replace(
            moved, materials=self.materials.to(device), camera=self.camera.to(device)
        )


def round_up(n: int, multiple: int) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def pad_rows(arr: np.ndarray, target: int, fill: float) -> np.ndarray:
    """Pad axis 0 of ``arr`` to ``target`` rows with ``fill``."""
    pad = target - arr.shape[0]
    if pad <= 0:
        return arr
    pad_block = np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad_block], axis=0)


def make_materials(
    diffuse: np.ndarray,
    specular: np.ndarray,
    emitted: np.ndarray,
    metallicity: np.ndarray,
    roughness: np.ndarray,
    ior: np.ndarray,
    pad_to: Optional[int] = None,
    device=None,
) -> Materials:
    device = resolve_device(device)
    m = diffuse.shape[0]
    target = pad_to if pad_to is not None else round_up(m, 8)

    def col(a):
        return torch.from_numpy(pad_rows(a.astype(np.float32), target, 0.0)).to(device)

    return Materials(
        diffuse_albedo=col(diffuse),
        specular_albedo=col(specular),
        emitted=col(emitted),
        metallicity=col(metallicity),
        roughness=col(roughness),
        index_of_refraction=col(ior),
    )


def precompute_camera(
    position: np.ndarray,
    forward: np.ndarray,
    up: np.ndarray,
    vertical_fov: float,
    width: int,
    height: int,
    device=None,
) -> Camera:
    """Near-plane basis: right-handed ``right = up × forward``, near plane
    at distance 1 with height 2·tan(fov/2), width scaled by aspect ratio.
    Computed in NumPy float32 exactly as the JAX package does."""
    device = resolve_device(device)
    position = np.asarray(position, np.float32)
    forward = np.asarray(forward, np.float32)
    up = np.asarray(up, np.float32)
    right = np.cross(up, forward)
    near_plane_height = np.float32(2.0 * np.tan(0.5 * vertical_fov))
    near_plane_width = np.float32(near_plane_height * width / height)
    scaled_right = near_plane_width * right
    scaled_up = near_plane_height * up
    top_left = forward - 0.5 * scaled_right + 0.5 * scaled_up
    inv_width = np.float32(1.0 / (width - 1)) if width > 1 else np.float32(1.0)
    inv_height = np.float32(1.0 / (height - 1)) if height > 1 else np.float32(1.0)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)

    return Camera(
        position=t(position),
        forward=t(forward),
        up=t(up),
        scaled_right=t(scaled_right),
        scaled_up=t(scaled_up),
        near_plane_top_left=t(top_left),
        inv_width=t(inv_width),
        inv_height=t(inv_height),
        vertical_fov=float(vertical_fov),
    )


# Static (non-tensor) fields of a Scene, in the order scene_to_numpy emits them.
STATIC_FIELDS = (
    "sphere_count", "triangle_count", "material_count", "bvh_node_count",
    "max_leaf_size", "num_clusters", "cluster_tris",
)


def scene_to_numpy(scene: Scene) -> Tuple[Dict[str, np.ndarray], dict]:
    """(arrays, static): every tensor leaf as a NumPy array keyed by field
    name (``materials.<f>`` and ``camera.<f>`` for the nested ones), and the
    static fields with ``config`` as a dict. Inverse of scene_from_numpy."""
    arrays = {}
    for name in _tensor_fields(scene):
        arrays[name] = getattr(scene, name).cpu().numpy()
    for prefix, sub in (("materials", scene.materials), ("camera", scene.camera)):
        for name in _tensor_fields(sub):
            arrays[f"{prefix}.{name}"] = getattr(sub, name).cpu().numpy()
    static = {name: getattr(scene, name) for name in STATIC_FIELDS}
    static["config"] = dataclasses.asdict(scene.config)
    static["camera.vertical_fov"] = scene.camera.vertical_fov
    return arrays, static


def scene_from_numpy(arrays: Dict[str, np.ndarray], static: dict, device=None) -> Scene:
    """Build a port ``Scene`` from NumPy leaves and static fields, in the
    layout ``scene_to_numpy`` emits (the JAX ``Scene``'s field names)."""
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    def sub(cls, prefix, **extra):
        names = [f.name for f in dataclasses.fields(cls) if f.name not in extra]
        return cls(**{n: t(arrays[f"{prefix}.{n}"]) for n in names}, **extra)

    config = static["config"]
    if not isinstance(config, RenderConfig):
        config = RenderConfig(**dict(config))
    top = [
        f.name for f in dataclasses.fields(Scene)
        if f.name not in STATIC_FIELDS + ("config", "materials", "camera")
    ]
    return Scene(
        **{n: t(arrays[n]) for n in top},
        materials=sub(Materials, "materials"),
        camera=sub(Camera, "camera", vertical_fov=float(static["camera.vertical_fov"])),
        config=config,
        **{n: int(static[n]) for n in STATIC_FIELDS},
    )
