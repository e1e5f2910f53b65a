"""BVH traversal (counterpart of ``cuda_raytracer_tpu/ops/traverse.py``; reference scene.cu:134-241).

The reference walks the BVH with a per-thread stack of (node, entry
distance) pairs, popping the nearest child first and skipping entries whose
distance already exceeds the closest hit. ``ops/kernels/traverse.bvh_walk``
is that walk's one dispatch point: on a CUDA tensor one thread per ray in
the hand-written kernel (``csrc/traverse.cu``), on a CPU tensor the plain
version below.

The plain version is the JAX package's lockstep walk in PyTorch: a tile of
rays advances together, each ray carrying its own stack as a row of a
(rays, depth) array, pops and pushes as masked gathers and scatters, leaves
intersected as (rays, max_leaf_size) Möller–Trumbore tiles, one ``.any()``
host sync per step. Each ray's walk is independent of the others', so the
kernel's per-ray loop reproduces it ray by ray: the same (t, index) bits.
``_safe_inv_dir`` is also the packet intersector's slab-test inverse.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuda_raytracer_tpu_torch.models.bvh import MAX_BVH_DEPTH
from cuda_raytracer_tpu_torch.ops import intersect

STACK_DEPTH = MAX_BVH_DEPTH + 1  # reference: unsigned node_index_stack[31]
DEFAULT_TILE = 1 << 15


def _safe_inv_dir(direction: torch.Tensor) -> torch.Tensor:
    """1/direction that never produces NaN in the slab test: components with
    |d| < 1e-30 map to ±1e30 instead of ±inf (0 * 1e30 = 0 keeps the
    reference's accept/reject behaviour; torch.minimum propagates NaN)."""
    small = direction.abs() < 1e-30
    return torch.where(
        small,
        torch.where(direction < 0, -1e30, 1e30),
        1.0 / torch.where(small, 1.0, direction),
    )


def _traverse_tile(
    scene,
    origin: torch.Tensor,  # (R, 3)
    direction: torch.Tensor,  # (R, 3)
    closest: torch.Tensor,  # (R,) initial closest hit (e.g. from spheres)
    hit_index: torch.Tensor,  # (R,) int32 initial hit index
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lockstep walk of one tile of rays → (closest, hit_index). The
    root is pushed with distance 0 and never slab-tested; an entry is
    processed only while its distance is below the ray's closest hit (a dead
    ray enters with -1 and does no work)."""
    rays, dev = origin.shape[0], origin.device
    leaf_span = max(scene.max_leaf_size, 1)
    n_nodes, n_tris = scene.bvh_child1.shape[0], scene.tri_p1.shape[0]
    rows = torch.arange(rays, device=dev)
    span = torch.arange(leaf_span, device=dev)
    inv_dir = _safe_inv_dir(direction)
    child1_of, child2_of = scene.bvh_child1.long(), scene.bvh_child2.long()

    # Column STACK_DEPTH takes the pushes a ray does not make (JAX's
    # mode="drop"); it is never read.
    stack_node = torch.zeros((rays, STACK_DEPTH + 1), dtype=torch.int64, device=dev)
    stack_dist = torch.zeros((rays, STACK_DEPTH + 1), dtype=torch.float32, device=dev)
    stack_size = torch.ones(rays, dtype=torch.int64, device=dev)

    while bool((stack_size > 0).any()):
        active = stack_size > 0
        top = torch.clamp(stack_size - 1, min=0)
        node = stack_node[rows, top]
        dist = stack_dist[rows, top]
        stack_size = torch.where(active, stack_size - 1, stack_size)
        # Skip stale entries: a closer hit may have been found since the node
        # was pushed (scene.cu:150-153).
        process = active & (dist < closest)

        child1 = child1_of[node]
        child2 = child2_of[node]
        is_leaf = child2 <= child1

        # --- Leaf: Möller–Trumbore over the leaf's triangle span ---------
        leaf_do = process & is_leaf
        tri_ids = child2[:, None] + span[None, :]
        tri_valid = leaf_do[:, None] & (tri_ids < child1[:, None])
        tri_clamped = torch.clamp(tri_ids, 0, n_tris - 1)
        t = intersect.moller_trumbore(
            origin[:, None, :], direction[:, None, :], scene.tri_p1[tri_clamped],
            scene.tri_e1[tri_clamped], scene.tri_e2[tri_clamped],
        )  # (R, L)
        t = torch.where(tri_valid, t, intersect.MISS)
        best = torch.argmin(t, dim=1, keepdim=True)  # the first minimum
        best_t = torch.gather(t, 1, best)[:, 0]
        better = best_t < closest
        closest = torch.where(better, best_t, closest)
        hit_index = torch.where(
            better, scene.sphere_count + torch.gather(tri_clamped, 1, best)[:, 0], hit_index
        ).to(torch.int32)

        # --- Inner: slab-test both children, push far then near ----------
        inner_do = process & ~is_leaf
        c1 = torch.clamp(child1, 0, n_nodes - 1)  # a leaf's child1 is a triangle end
        c2 = torch.clamp(child2, 0, n_nodes - 1)
        hit1, t1 = intersect.ray_aabb(origin, inv_dir, scene.bvh_min[c1], scene.bvh_max[c1],
                                      closest)
        hit2, t2 = intersect.ray_aabb(origin, inv_dir, scene.bvh_min[c2], scene.bvh_max[c2],
                                      closest)
        hit1 = hit1 & inner_do
        hit2 = hit2 & inner_do
        both = hit1 & hit2
        c1_near = t1 < t2
        # First pushed entry (popped last): the farther child when both hit,
        # else whichever single child hit.
        far_node = torch.where(both, torch.where(c1_near, child2, child1),
                               torch.where(hit1, child1, child2))
        far_dist = torch.where(both, torch.maximum(t1, t2), torch.where(hit1, t1, t2))
        near_node = torch.where(c1_near, child1, child2)
        near_dist = torch.minimum(t1, t2)

        push_a = hit1 | hit2
        push_b = both
        slot_a = torch.where(push_a, stack_size, STACK_DEPTH)
        slot_b = torch.where(push_b, stack_size + 1, STACK_DEPTH)
        stack_node[rows, slot_a] = far_node
        stack_dist[rows, slot_a] = far_dist
        stack_node[rows, slot_b] = near_node
        stack_dist[rows, slot_b] = near_dist
        stack_size = stack_size + push_a.long() + push_b.long()

    return closest, hit_index


def plain_bvh_closest_hit(
    scene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    closest: torch.Tensor,
    hit_index: torch.Tensor,
    tile_size: int = DEFAULT_TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The BVH walk kernel's plain version: ``_traverse_tile`` over
    ``tile_size``-ray tiles, the last one padded with rays that do no work
    (origin 0, direction 1, closest 0), as the JAX package tiles the batch."""
    rays = origin.shape[0]
    if rays <= tile_size:
        return _traverse_tile(scene, origin, direction, closest, hit_index)
    pad = (-rays) % tile_size
    if pad:
        F = torch.nn.functional
        origin = F.pad(origin, (0, 0, 0, pad))
        direction = F.pad(direction, (0, 0, 0, pad), value=1.0)
        closest = F.pad(closest, (0, pad), value=0.0)
        hit_index = F.pad(hit_index, (0, pad), value=-1)
    parts = [
        _traverse_tile(scene, origin[lo:lo + tile_size], direction[lo:lo + tile_size],
                       closest[lo:lo + tile_size], hit_index[lo:lo + tile_size])
        for lo in range(0, rays + pad, tile_size)
    ]
    return (torch.cat([p[0] for p in parts])[:rays],
            torch.cat([p[1] for p in parts])[:rays])

