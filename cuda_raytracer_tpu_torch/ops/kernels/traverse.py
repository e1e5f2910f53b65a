"""The BVH closest hit (``intersector="bvh"``): wrapper of ``csrc/traverse.cu``.

Counterpart of ``cuda_raytracer_tpu/ops/traverse.py`` (``_traverse_tile``,
``bvh_closest_hit``): each ray walks the scene's BVH with its own stack of
(node, entry distance) pairs and returns its nearest triangle hit. The JAX
package walks a tile of rays in lockstep (a ``lax.while_loop``); the kernel
gives each ray one CUDA thread and reproduces that walk ray by ray, so its
(t, index) equal the plain version's (``ops/traverse.plain_bvh_closest_hit``)
bit for bit.

- On a CUDA tensor ``bvh_walk`` launches the kernel and counts the launch
  (``LAUNCHES``); with ``stats`` (a (3,) int64 tensor) the counting variant
  adds the entries popped, slab tests and triangle tests. It raises on what
  the kernel does not take, a tree deeper than ``MAX_BVH_DEPTH`` among them
  (its stack holds ``STACK_DEPTH`` entries). Nothing falls back.
- On a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cuda_raytracer_tpu_torch.models.bvh import MAX_BVH_DEPTH
from cuda_raytracer_tpu_torch.models.scene import derived
from cuda_raytracer_tpu_torch.ops import traverse
from cuda_raytracer_tpu_torch.ops.kernels import build
from cuda_raytracer_tpu_torch.ops.kernels.cull import device_kind, raise_on_error

# Kernel launches made in this process (CUDA tensors only).
LAUNCHES = 0


def library() -> build.Built:
    """Build (at first use) and bind ``csrc/traverse.cu``."""
    built = build.load("traverse")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = built.lib.rt_bvh_walk
    fn.argtypes = [p, i, p, i, p, p, i] + [p] * 7 + [i, i, p, p, p, p]
    fn.restype = ctypes.c_int
    built.lib.rt_error_string.argtypes = [ctypes.c_int]
    built.lib.rt_error_string.restype = ctypes.c_char_p
    return built


def tree_depth(child1: torch.Tensor, child2: torch.Tensor) -> int:
    """Levels below the root of the tree's deepest leaf (the root alone: 0),
    walked level by level from node 0; stops once past MAX_BVH_DEPTH."""
    c1, c2 = child1.cpu().numpy(), child2.cpu().numpy()
    level, depth = np.zeros(1, dtype=np.int64), 0
    while True:
        inner = level[c2[level] > c1[level]]
        if inner.size == 0 or depth > MAX_BVH_DEPTH:
            return depth
        level = np.concatenate([c1[inner], c2[inner]]).astype(np.int64)
        depth += 1


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
    if stats is not None and (stats.dtype != torch.int64 or stats.shape != (3,)
                              or stats.device != origin.device):
        raise ValueError("stats must be a (3,) int64 tensor on the rays' device")
    for x in (direction, closest, hit_index, scene.bvh_child1, scene.bvh_child2) + tables:
        if x.device != origin.device:
            raise ValueError(f"bvh_walk: tensors on {x.device} and {origin.device}")
    depth = derived(("bvh_depth",), (scene.bvh_child1, scene.bvh_child2),
                    lambda: tree_depth(scene.bvh_child1, scene.bvh_child2))
    if depth > MAX_BVH_DEPTH:
        raise ValueError(f"the BVH is deeper than MAX_BVH_DEPTH = {MAX_BVH_DEPTH}: the "
                         f"walk's stack holds {traverse.STACK_DEPTH} entries")


def bvh_walk(scene, origin: torch.Tensor, direction: torch.Tensor, closest: torch.Tensor,
             hit_index: torch.Tensor, tile_size: int = traverse.DEFAULT_TILE,
             stats: torch.Tensor = None):
    """(n, 3) origins and directions (any row stride: column views of the
    packed wavefront are taken as they are), the hit so far (closest (n,)
    float32 at most 1e30, -1 on a dead ray; hit_index (n,) int32) → (t (n,)
    float32, index (n,) int32) updated with the nearest triangle hit, indexed
    ``sphere_count + triangle``. ``tile_size`` is the plain version's."""
    global LAUNCHES
    _check(scene, origin, direction, closest, hit_index, stats)
    if device_kind(origin, "bvh_walk") == "cpu":
        if stats is not None:
            raise ValueError("stats counts the kernel's work: CUDA tensors only")
        return traverse.plain_bvh_closest_hit(scene, origin, direction, closest, hit_index,
                                              tile_size)
    n = origin.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    index = torch.empty(n, dtype=torch.int32, device=origin.device)
    lib = library().lib
    with torch.cuda.device(origin.device):
        err = lib.rt_bvh_walk(
            origin.data_ptr(), origin.stride(0), direction.data_ptr(), direction.stride(0),
            closest.data_ptr(), hit_index.data_ptr(), n, scene.bvh_min.data_ptr(),
            scene.bvh_max.data_ptr(), scene.bvh_child1.data_ptr(), scene.bvh_child2.data_ptr(),
            scene.tri_p1.data_ptr(), scene.tri_e1.data_ptr(), scene.tri_e2.data_ptr(),
            max(scene.max_leaf_size, 1), scene.sphere_count, t.data_ptr(), index.data_ptr(),
            stats.data_ptr() if stats is not None else None,
            torch.cuda.current_stream(origin.device).cuda_stream)
    raise_on_error(lib, err, "bvh_walk")
    LAUNCHES += 1
    return t, index
