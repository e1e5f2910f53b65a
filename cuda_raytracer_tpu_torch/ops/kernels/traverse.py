"""The BVH closest hit (``intersector="bvh"``): wrapper of ``csrc/traverse.cu``.

Counterpart of ``cuda_raytracer_tpu/ops/traverse.py`` (``_traverse_tile``,
``bvh_closest_hit``): each ray walks the scene's BVH with its own stack of
(node, entry distance) pairs and returns its nearest triangle hit. The JAX
package walks a tile of rays in lockstep (a ``lax.while_loop``); the kernel
gives each ray one CUDA thread and reproduces that walk ray by ray, so its
(t, index) equal the plain version's (``ops/traverse.plain_bvh_closest_hit``)
bit for bit.

``bvh_walk`` is the walk's one dispatch point (``render/wavefront`` calls
it):

- On a CUDA tensor it launches the kernel and counts the launch
  (``LAUNCHES``); with ``stats`` (a (4,) int64 tensor) the counting variant
  adds the entries popped, slab tests and triangle tests, and raises the
  fourth counter to the most entries one ray popped. It raises on what the
  kernel does not take, a tree deeper than ``MAX_BVH_DEPTH`` among them (its
  stack holds ``STACK_DEPTH`` entries), and on a failed launch. Nothing
  falls back.
- On a CPU tensor it runs the plain version.

The kernel walks the scene's ``walk_tables``, built once a scene through
``models/scene.derived``: one 64-byte record per inner node in breadth-first
order (both children's boxes and words) and 48-byte triangle records, laid
out as ``csrc/traverse.cuh`` describes. The kernel picks its rays a warp
from n; ``lanes`` overrides that pick only to time the alternatives
(``chip_walk.py``), and never changes what it computes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from cuda_raytracer_tpu_torch.models.bvh import MAX_BVH_DEPTH
from cuda_raytracer_tpu_torch.models.scene import derived
from cuda_raytracer_tpu_torch.ops import traverse
from cuda_raytracer_tpu_torch.ops.kernels import build
from cuda_raytracer_tpu_torch.ops.kernels.cull import device_kind, raise_on_error

# Kernel launches made in this process (CUDA tensors only).
LAUNCHES = 0

INNER_WORD = 0x7FFFFFFF  # the second word of an inner child (csrc/traverse.cuh)
RECORD_WORDS = 16  # 32-bit words of a node record (rt::kRecordQuads × 4)
TRI_WORDS = 12  # float32 words of a triangle record (rt::kTriQuads × 4)


@dataclasses.dataclass(frozen=True)
class WalkTables:
    """The kernel's view of a scene's BVH and triangles (``csrc/traverse.cuh``)."""

    records: torch.Tensor  # (R, 16) int32: the float bits of both children's boxes, their words
    triangles: torch.Tensor  # (T, 12) float32: p1, e1, e2, 3 zeros
    nodes: np.ndarray  # (R,) int64: the inner node whose children row r holds
    root: Tuple[int, int]  # the root's words


def library() -> build.Built:
    """Build (at first use) and bind ``csrc/traverse.cu``."""
    built = build.load("traverse")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = built.lib.rt_bvh_walk
    fn.argtypes = [p, i, p, i, p, p, i, p, p] + [i] * 5 + [p, p, p, p]
    fn.restype = ctypes.c_int
    built.lib.rt_error_string.argtypes = [ctypes.c_int]
    built.lib.rt_error_string.restype = ctypes.c_char_p
    return built


def tree_levels(child1: torch.Tensor, child2: torch.Tensor) -> List[np.ndarray]:
    """The tree's inner nodes level by level from node 0 (each level in
    order, a parent's child1 before its child2); stops once past
    MAX_BVH_DEPTH levels."""
    c1, c2 = child1.cpu().numpy().astype(np.int64), child2.cpu().numpy().astype(np.int64)
    level, levels = np.zeros(1, dtype=np.int64), []
    while len(levels) <= MAX_BVH_DEPTH:
        inner = level[c2[level] > c1[level]]
        if inner.size == 0:
            break
        levels.append(inner)
        level = np.stack([c1[inner], c2[inner]], axis=1).reshape(-1)
    return levels


def tree_depth(child1: torch.Tensor, child2: torch.Tensor) -> int:
    """Levels below the root of the tree's deepest leaf (the root alone: 0),
    walked level by level from node 0; stops once past MAX_BVH_DEPTH."""
    return len(tree_levels(child1, child2))


def build_walk_tables(scene) -> WalkTables:
    """``walk_tables`` without the cache: the records and triangle records on
    the scene's device. Raises on a tree deeper than MAX_BVH_DEPTH."""
    levels = tree_levels(scene.bvh_child1, scene.bvh_child2)
    if len(levels) > MAX_BVH_DEPTH:
        raise ValueError(f"the BVH is deeper than MAX_BVH_DEPTH = {MAX_BVH_DEPTH}: the "
                         f"walk's stack holds {traverse.STACK_DEPTH} entries")
    c1 = scene.bvh_child1.cpu().numpy().astype(np.int64)
    c2 = scene.bvh_child2.cpu().numpy().astype(np.int64)
    lo = scene.bvh_min.cpu().numpy().view(np.int32)
    hi = scene.bvh_max.cpu().numpy().view(np.int32)
    nodes = np.concatenate(levels) if levels else np.zeros(0, dtype=np.int64)
    row = np.full(c1.shape[0], -1, dtype=np.int64)
    row[nodes] = np.arange(nodes.size)

    def words(node):
        leaf = c2[node] <= c1[node]
        return np.stack([np.where(leaf, c1[node], row[node]),
                         np.where(leaf, c2[node], INNER_WORD)], axis=-1)

    a, b = c1[nodes], c2[nodes]
    records = np.concatenate([lo[a], hi[a], lo[b], hi[b], words(a), words(b)],
                             axis=1).astype(np.int32)
    tris = torch.cat([scene.tri_p1, scene.tri_e1, scene.tri_e2,
                      torch.zeros_like(scene.tri_p1)], dim=1)
    root = words(np.zeros(1, dtype=np.int64))[0]
    device = scene.bvh_min.device
    return WalkTables(torch.from_numpy(records).to(device), tris.contiguous(), nodes,
                      (int(root[0]), int(root[1])))


def walk_tables(scene) -> WalkTables:
    """The scene's walk tables, built once a scene (``models/scene.derived``)."""
    sources = (scene.bvh_min, scene.bvh_max, scene.bvh_child1, scene.bvh_child2,
               scene.tri_p1, scene.tri_e1, scene.tri_e2)
    return derived(("bvh_walk_tables",), sources, lambda: build_walk_tables(scene))


def _check(scene, origin, direction, closest, hit_index, stats) -> None:
    n = origin.shape[0]
    for name, x in (("origin", origin), ("direction", direction)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape != (n, 3) or (
                n > 1 and x.stride(1) != 1):
            raise ValueError(f"{name} must be (n, 3) float32 with unit column stride, got "
                             f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    if closest.dtype != torch.float32 or closest.shape != (n,) or not closest.is_contiguous():
        raise ValueError("closest must be a contiguous (n,) float32")
    if hit_index.dtype != torch.int32 or hit_index.shape != (n,) or not (
            hit_index.is_contiguous()):
        raise ValueError("hit_index must be a contiguous (n,) int32")
    tables = (scene.bvh_min, scene.bvh_max, scene.tri_p1, scene.tri_e1, scene.tri_e2)
    if any(x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3
           or not x.is_contiguous() for x in tables):
        raise ValueError("BVH boxes and triangles must be contiguous (rows, 3) float32")
    for x in (scene.bvh_child1, scene.bvh_child2):
        if x.dtype != torch.int32 or x.shape != (scene.bvh_min.shape[0],) or not (
                x.is_contiguous()):
            raise ValueError("BVH children must be contiguous (nodes,) int32")
    if stats is not None and (stats.dtype != torch.int64 or stats.shape != (4,)
                              or stats.device != origin.device):
        raise ValueError("stats must be a (4,) int64 tensor on the rays' device")
    for x in (direction, closest, hit_index, scene.bvh_child1, scene.bvh_child2) + tables:
        if x.device != origin.device:
            raise ValueError(f"bvh_walk: tensors on {x.device} and {origin.device}")


def _check_tables(tb: WalkTables, lanes: int, device) -> None:
    if not 0 <= lanes <= 32:
        raise ValueError(f"bvh_walk: lanes must be 0 (the kernel picks) or 1-32, got {lanes}")
    for name, x, words, dtype in (("records", tb.records, RECORD_WORDS, torch.int32),
                                  ("triangles", tb.triangles, TRI_WORDS, torch.float32)):
        if (x.dtype != dtype or x.dim() != 2 or x.shape[1] != words or not x.is_contiguous()
                or x.data_ptr() % 16 or x.device != device):
            raise ValueError(f"bvh_walk: the {name} table must be a contiguous, 16-byte "
                             f"aligned (rows, {words}) {dtype} on {device}")


def bvh_walk(scene, origin: torch.Tensor, direction: torch.Tensor, closest: torch.Tensor,
             hit_index: torch.Tensor, tile_size: int = traverse.DEFAULT_TILE,
             stats: torch.Tensor = None, lanes: int = 0):
    """(n, 3) origins and directions (any row stride: column views of the
    packed wavefront are taken as they are), the hit so far (closest (n,)
    float32 at most 1e30, -1 on a dead ray; hit_index (n,) int32) → (t (n,)
    float32, index (n,) int32) updated with the nearest triangle hit, indexed
    ``sphere_count + triangle``. ``tile_size`` is the plain version's;
    ``lanes`` (rays a warp, 1-32) the kernel's, 0 letting it pick."""
    global LAUNCHES
    _check(scene, origin, direction, closest, hit_index, stats)
    tb = walk_tables(scene)
    if device_kind(origin, "bvh_walk") == "cpu":
        if stats is not None:
            raise ValueError("stats counts the kernel's work: CUDA tensors only")
        return traverse.plain_bvh_closest_hit(scene, origin, direction, closest, hit_index,
                                              tile_size)
    _check_tables(tb, lanes, origin.device)
    n = origin.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    index = torch.empty(n, dtype=torch.int32, device=origin.device)
    lib = library().lib
    with torch.cuda.device(origin.device):
        err = lib.rt_bvh_walk(
            origin.data_ptr(), origin.stride(0), direction.data_ptr(), direction.stride(0),
            closest.data_ptr(), hit_index.data_ptr(), n, tb.records.data_ptr(),
            tb.triangles.data_ptr(), *tb.root, max(scene.max_leaf_size, 1),
            scene.sphere_count, lanes, t.data_ptr(), index.data_ptr(),
            stats.data_ptr() if stats is not None else None,
            torch.cuda.current_stream(origin.device).cuda_stream)
    raise_on_error(lib, err, "bvh_walk")
    LAUNCHES += 1
    return t, index
