"""Binned-SAH BVH builder emitting flat arrays (reference: scene.cu:833-1036).

Host-side top-down build with the reference's exact semantics:
  * 8-bin surface-area heuristic over triangle centroids per axis,
    half-area cost = xy + xz + yz (scene.cu:852-857,888-952)
  * split only if the best plane beats the parent cost ``area * count``
  * leaves hold <= 4 triangles, max depth 30 (scene.cu:10,875)
  * leaf encoding ``child2 <= child1`` with triangle range [child2, child1);
    inner children are node indices appended contiguously (scene.cuh:82-100)
  * degenerate partitions (all triangles on one side) terminate as a leaf
    even above the leaf-size target (scene.cu:977-980)
  * ``max_depth=0`` yields a single root leaf — that is how the reference's
    `no_bvh` mode works (scene.cu:820) and how ours does too.

Rather than swapping triangle structs in place, the builder partitions an
index permutation; callers apply it once to all per-triangle arrays. Two
implementations exist, as in the JAX package: this NumPy one (the oracle) and
the C++ one of ``native/bvh_builder.cpp`` (``native/bvh_native.py``), which
gives the same arrays and is the default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

MAX_BVH_DEPTH = 30
SAH_BINS = 8
LEAF_TARGET = 4

# Empty-AABB sentinels, matching the reference's "very large floats instead of
# infinity" choice (scene.cuh:70-74).
AABB_EMPTY_MIN = 1e30
AABB_EMPTY_MAX = -1e30


@dataclasses.dataclass
class BvhArrays:
    """Flat BVH ready for device upload."""

    node_min: np.ndarray  # (N, 3) float32
    node_max: np.ndarray  # (N, 3) float32
    child1: np.ndarray  # (N,) int32
    child2: np.ndarray  # (N,) int32
    order: np.ndarray  # (T,) int32 — permutation applied to triangle arrays
    max_leaf_size: int


def _half_area(box_min: np.ndarray, box_max: np.ndarray) -> float:
    size = box_max - box_min
    return size[0] * size[1] + size[0] * size[2] + size[1] * size[2]


def build_bvh_numpy(
    p1: np.ndarray,
    p2: np.ndarray,
    p3: np.ndarray,
    max_depth: int = MAX_BVH_DEPTH,
) -> BvhArrays:
    """Reference-semantics binned-SAH build. ``p1/p2/p3``: (T, 3) float32
    raw triangle vertices (pre edge-form conversion)."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    p3 = np.asarray(p3, np.float64)
    tri_count = p1.shape[0]
    centroid = (p1 + p2 + p3) / 3.0
    # Per-triangle AABB, precomputed once.
    tmin = np.minimum(np.minimum(p1, p2), p3)
    tmax = np.maximum(np.maximum(p1, p2), p3)

    order = np.arange(tri_count, dtype=np.int64)

    node_min: list = []
    node_max: list = []
    child1: list = []
    child2: list = []

    def new_node(lo: int, hi: int) -> int:
        node_min.append(np.full(3, AABB_EMPTY_MIN))
        node_max.append(np.full(3, AABB_EMPTY_MAX))
        child1.append(hi)
        child2.append(lo)
        return len(child1) - 1

    root = new_node(0, tri_count)

    # Iterative DFS with an explicit stack, preserving the reference's
    # left-then-right recursion order so node layouts match across builders.
    stack = [(root, max_depth)]
    while stack:
        node, depth = stack.pop()
        lo, hi = child2[node], child1[node]
        idx = order[lo:hi]
        count = hi - lo
        if count > 0:
            node_min[node] = tmin[idx].min(axis=0)
            node_max[node] = tmax[idx].max(axis=0)
        if count <= LEAF_TARGET or depth == 0:
            continue

        our_cost = _half_area(node_min[node], node_max[node]) * count
        cent = centroid[idx]

        best_cost = our_cost
        best_axis = -1
        best_position = 0.0
        for axis in range(3):
            cmin = cent[:, axis].min()
            cmax = cent[:, axis].max()
            if cmin == cmax:
                continue
            scale = SAH_BINS / (cmax - cmin)
            bin_of = np.minimum(
                SAH_BINS - 1, ((cent[:, axis] - cmin) * scale).astype(np.int64)
            )
            bin_counts = np.bincount(bin_of, minlength=SAH_BINS)
            bmin = np.full((SAH_BINS, 3), AABB_EMPTY_MIN)
            bmax = np.full((SAH_BINS, 3), AABB_EMPTY_MAX)
            for b in range(SAH_BINS):
                sel = bin_of == b
                if bin_counts[b]:
                    bmin[b] = tmin[idx[sel]].min(axis=0)
                    bmax[b] = tmax[idx[sel]].max(axis=0)

            # Prefix/suffix half-area sweep (scene.cu:923-938).
            left_min = np.minimum.accumulate(bmin, axis=0)
            left_max = np.maximum.accumulate(bmax, axis=0)
            right_min = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            right_max = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
            left_count = np.cumsum(bin_counts)

            step = (cmax - cmin) / SAH_BINS
            for i in range(SAH_BINS - 1):
                lc = left_count[i]
                rc = count - lc
                if lc == 0 or rc == 0:
                    # Reference reaches 0*inf = NaN here, which its
                    # `cost < best` test rejects; skip explicitly.
                    continue
                plane_cost = lc * _half_area(
                    left_min[i], left_max[i]
                ) + rc * _half_area(right_min[i + 1], right_max[i + 1])
                if plane_cost != 0 and plane_cost < best_cost:
                    best_axis = axis
                    best_position = cmin + step * (i + 1)
                    best_cost = plane_cost

        if best_axis < 0 or best_cost >= our_cost:
            continue

        # Stable partition of the index permutation (membership matches the
        # reference's Hoare partition; intra-side order is builder-defined).
        left_mask = centroid[idx, best_axis] < best_position
        mid = lo + int(left_mask.sum())
        if mid == lo or mid == hi:
            continue
        order[lo:hi] = np.concatenate([idx[left_mask], idx[~left_mask]])

        left = new_node(lo, mid)
        right = new_node(mid, hi)
        child1[node] = left
        child2[node] = right
        # Push right first so left is processed first (reference recursion
        # order, scene.cu:995-996).
        stack.append((right, depth - 1))
        stack.append((left, depth - 1))

    c1 = np.asarray(child1, np.int32)
    c2 = np.asarray(child2, np.int32)
    leaf = c2 <= c1
    max_leaf = int((c1[leaf] - c2[leaf]).max()) if leaf.any() else 0
    return BvhArrays(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        child1=c1,
        child2=c2,
        order=order.astype(np.int32),
        max_leaf_size=max_leaf,
    )


def build_bvh(
    p1: np.ndarray,
    p2: np.ndarray,
    p3: np.ndarray,
    max_depth: int = MAX_BVH_DEPTH,
    prefer_native: bool = True,
) -> BvhArrays:
    """Build a BVH with the C++ builder, or with NumPy when ``prefer_native``
    is False or there are no triangles. Unlike the JAX package, a native
    build or load that fails raises instead of falling back."""
    if prefer_native and p1.shape[0] > 0:
        from cuda_raytracer_tpu_torch.native import bvh_native

        return bvh_native.build_bvh_native(p1, p2, p3, max_depth)
    return build_bvh_numpy(p1, p2, p3, max_depth)


def validate_bvh(bvh: BvhArrays, tri_count: int) -> Optional[str]:
    """Structural invariants used by the test-suite: returns an error string
    or None. Checks leaf ranges partition [0, T), children are in-bounds,
    and child AABBs are contained in their parents."""
    n = bvh.child1.shape[0]
    leaf = bvh.child2 <= bvh.child1
    spans = []
    for i in range(n):
        if leaf[i]:
            spans.append((int(bvh.child2[i]), int(bvh.child1[i])))
        else:
            c1, c2 = int(bvh.child1[i]), int(bvh.child2[i])
            if not (0 < c1 < n and 0 < c2 < n):
                return f"node {i}: child index out of range"
            if c2 != c1 + 1:
                return f"node {i}: children not contiguous"
            for c in (c1, c2):
                if np.any(bvh.node_min[c] < bvh.node_min[i] - 1e-3) or np.any(
                    bvh.node_max[c] > bvh.node_max[i] + 1e-3
                ):
                    return f"node {i}: child {c} AABB not contained"
    spans.sort()
    pos = 0
    for lo, hi in spans:
        if lo != pos:
            return f"leaf ranges do not partition triangles at {pos} (got {lo})"
        pos = hi
    if pos != tri_count:
        return f"leaf ranges cover {pos} of {tri_count} triangles"
    if sorted(bvh.order.tolist()) != list(range(tri_count)):
        return "order is not a permutation"
    return None
