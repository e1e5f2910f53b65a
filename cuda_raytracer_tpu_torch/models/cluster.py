"""Triangle clusters: a BVH cut for dense, DMA-friendly intersection.

The reference's per-thread BVH walk is the antithesis of TPU execution:
divergent control flow and per-ray random gathers. The TPU-native structure
built here cuts the SAH BVH at subtrees holding at most ``max_tris``
triangles, yielding K *clusters* — contiguous triangle ranges with tight
AABBs (BVH subtrees always cover contiguous ranges in the permuted triangle
order, scene.cuh:82-100 layout). Rendering then becomes:

  1. cull: slab-test every ray against all K cluster AABBs — dense,
     gather-free VPU work;
  2. pair: (ray, hit-cluster) pairs grouped by cluster into fixed-size tiles;
  3. intersect: each tile runs Möller–Trumbore against its cluster's
     *uniform padded block* of ``max_tris`` triangles — one contiguous block
     per tile, fetched by index (a scalar-prefetch BlockSpec in the Pallas
     kernel, a plain dynamic gather in the XLA fallback).

Cluster-uniform padding stores triangles a second time in (K, C) block
layout; padding slots are degenerate triangles (zero edges → MT determinant
0 → miss).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cuda_raytracer_tpu_torch.models.bvh import BvhArrays

# Swept on TPU v5e (teapot, 131k-ray wavefronts, round 2): with the fused
# walk+sweep kernel and batched MT, C=256 cuts triangle tests/ray ~5× vs
# C=1024 (pair extraction no longer scales with T·K, so small clusters are
# affordable); best fwd+bwd step 96 ms at C=256/tile=64 vs 119 ms at
# C=1024/tile=128. C must be a multiple of 128 (lane alignment of the
# (16, C) block DMAs).
DEFAULT_CLUSTER_TRIS = 256


@dataclasses.dataclass
class ClusterArrays:
    """K clusters over the BVH-permuted triangle array."""

    start: np.ndarray  # (K,) int32 — first triangle (permuted order)
    count: np.ndarray  # (K,) int32 — triangles in cluster (<= C)
    aabb_min: np.ndarray  # (K, 3) float32
    aabb_max: np.ndarray  # (K, 3) float32
    max_tris: int  # C — uniform block size

    @property
    def num_clusters(self) -> int:
        return int(self.start.shape[0])


def build_clusters(
    bvh: BvhArrays, tri_count: int, max_tris: int = DEFAULT_CLUSTER_TRIS
) -> ClusterArrays:
    """Cut the BVH into subtrees of <= max_tris triangles (DFS order, so
    cluster ranges are sorted and contiguous)."""
    starts, counts, mins, maxs = [], [], [], []
    if tri_count > 0:
        # (node, range) DFS. Leaf ranges are stored in the node; inner ranges
        # are the union of the children's, recovered by carrying them down.
        stack = [(0, 0, tri_count)]
        while stack:
            node, lo, hi = stack.pop()
            is_leaf = bvh.child2[node] <= bvh.child1[node]
            if hi - lo <= max_tris or is_leaf:
                # Oversized leaves (degenerate-partition BVH nodes, or the
                # single-root no_bvh tree) are split into C-sized chunks that
                # share the node's AABB.
                for chunk_lo in range(lo, max(hi, lo + 1), max_tris):
                    chunk_hi = min(chunk_lo + max_tris, hi)
                    starts.append(chunk_lo)
                    counts.append(chunk_hi - chunk_lo)
                    mins.append(bvh.node_min[node])
                    maxs.append(bvh.node_max[node])
                    if chunk_hi >= hi:
                        break
                continue
            left, right = int(bvh.child1[node]), int(bvh.child2[node])
            # Left child covers [lo, mid), right [mid, hi): mid is the left
            # subtree's range end — find it from the leftmost descent of the
            # right child (equivalently the left child's rightmost leaf).
            mid = _range_start(bvh, right)
            stack.append((right, mid, hi))
            stack.append((left, lo, mid))
    if not starts:
        starts, counts = [0], [0]
        mins = [np.full(3, 1e30, np.float32)]
        maxs = [np.full(3, -1e30, np.float32)]
    return ClusterArrays(
        start=np.asarray(starts, np.int32),
        count=np.asarray(counts, np.int32),
        aabb_min=np.asarray(mins, np.float32).reshape(-1, 3),
        aabb_max=np.asarray(maxs, np.float32).reshape(-1, 3),
        max_tris=max_tris,
    )


def _range_start(bvh: BvhArrays, node: int) -> int:
    """First triangle index covered by ``node`` (follow left/leaf chain)."""
    while bvh.child2[node] > bvh.child1[node]:  # inner
        node = int(bvh.child1[node])
    return int(bvh.child2[node])


def pack_cluster_blocks(
    clusters: ClusterArrays,
    tri_p1: np.ndarray,
    tri_e1: np.ndarray,
    tri_e2: np.ndarray,
    pad_coord: float = 1e17,
):
    """Cluster-uniform triangle storage.

    Returns (blocks, slot_to_tri):
      blocks      (K, 16, C) float32 — rows 0-8 are p1/e1/e2 components
                  (p1x p1y p1z e1x e1y e1z e2x e2y e2z), row 9 the permuted
                  triangle index as float (-1 padding; exact below 2^24 —
                  lets the Pallas sweep resolve hit ids without a gather),
                  rows 10-15 zero padding to a (16, C) sublane-aligned tile;
      slot_to_tri (K*C,) int32 — permuted triangle index per slot, -1 pad.
    """
    K, C = clusters.num_clusters, clusters.max_tris
    # Row 9 carries triangle ids as float32, exact only below 2^24; beyond
    # that, hit ids (hence materials/normals) would corrupt silently.
    if tri_p1.shape[0] >= 1 << 24:
        raise ValueError(
            f"{tri_p1.shape[0]} triangles exceeds the float32-exact id range "
            "(2^24) of the packed cluster blocks; shard the scene or widen "
            "the id row to a float64 pair."
        )
    blocks = np.zeros((K, 16, C), np.float32)
    slot_to_tri = np.full(K * C, -1, np.int32)
    # Padding slots get a far-away degenerate triangle: zero edges give a
    # zero MT determinant → guaranteed miss.
    blocks[:, 0:3, :] = pad_coord
    blocks[:, 9, :] = -1.0
    for k in range(K):
        n = int(clusters.count[k])
        if n == 0:
            continue
        lo = int(clusters.start[k])
        blocks[k, 0:3, :n] = tri_p1[lo : lo + n].T
        blocks[k, 3:6, :n] = tri_e1[lo : lo + n].T
        blocks[k, 6:9, :n] = tri_e2[lo : lo + n].T
        blocks[k, 9, :n] = np.arange(lo, lo + n, dtype=np.float32)
        slot_to_tri[k * C : k * C + n] = np.arange(lo, lo + n, dtype=np.int32)
    return blocks, slot_to_tri


def pad_clusters(clusters: ClusterArrays, multiple: int) -> ClusterArrays:
    """Pad the cluster list to a count multiple with EMPTY clusters (count 0,
    far-away point AABBs — under the windowed slab test a point box can only
    hit on an exact three-axis tie, and its block slots are degenerate
    triangles that always miss)."""
    K = clusters.num_clusters
    pad = (-K) % multiple
    if not pad:
        return clusters
    return ClusterArrays(
        start=np.concatenate([clusters.start, np.zeros(pad, np.int32)]),
        count=np.concatenate([clusters.count, np.zeros(pad, np.int32)]),
        aabb_min=np.concatenate(
            [clusters.aabb_min, np.full((pad, 3), 1e17, np.float32)]
        ),
        aabb_max=np.concatenate(
            [clusters.aabb_max, np.full((pad, 3), 1e17, np.float32)]
        ),
        max_tris=clusters.max_tris,
    )


def pack_paired_blocks(
    clusters: ClusterArrays,
    tri_p1: np.ndarray,
    tri_e1: np.ndarray,
    tri_e2: np.ndarray,
    pack: int,
    pad_coord: float = 1e17,
):
    """Block storage for ``cluster_pack > 1`` (PERF_NOTES roadmap item 0):
    ``pack`` consecutive sub-clusters of ``C_sub = clusters.max_tris``
    triangles share one (16, pack * C_sub) lane-aligned block — block b's
    lanes [h*C_sub, (h+1)*C_sub) hold sub-cluster pack*b + h. The cull stays
    at sub-cluster granularity (tighter boxes ⇒ fewer swept triangles), the
    sweep at full 128-lane blocks with unhit halves lane-masked to MISS, so
    the effective pair set equals an exact C_sub cull.

    ``clusters`` must be pre-padded to a ``pack`` multiple (pad_clusters).
    Returns (blocks (K/pack, 16, pack*C_sub), slot_to_tri (K*C_sub,) in
    block-major lane order)."""
    K = clusters.num_clusters
    if K % pack:
        raise ValueError(f"cluster count {K} not a multiple of pack {pack}")
    blocks, slot_to_tri = pack_cluster_blocks(
        clusters, tri_p1, tri_e1, tri_e2, pad_coord
    )
    C_sub = clusters.max_tris
    blocks = (
        blocks.reshape(K // pack, pack, 16, C_sub)
        .transpose(0, 2, 1, 3)
        .reshape(K // pack, 16, pack * C_sub)
    )
    return blocks, slot_to_tri


def split_aabbs(
    clusters: ClusterArrays,
    tri_p1: np.ndarray,
    tri_e1: np.ndarray,
    tri_e2: np.ndarray,
    split: int,
):
    """Sub-cluster cull boxes: ``split`` tight AABBs per cluster.

    Each cluster's slot range is cut into ``split`` equal chunks (contiguous
    in BVH-permuted order, so spatially coherent) and each chunk gets a
    tight box over its triangles' three vertices — the *two-level cull*:
    the sweep still runs whole (16, C) blocks (128-lane aligned), but a
    block is culled in only when some chunk box is slab-hit, which is
    strictly tighter than one box over the union. Row k*split+s is chunk s
    of cluster k; empty chunks get a far-away degenerate POINT box (the
    block padding coordinate 1e17) — under the windowed Tavian slab test
    (packet_intersect._cull_tile_mask) a point box can only "hit" when all
    three per-axis parameters tie exactly, so it prunes like a miss. (An
    inverted min>max box would be WRONG here: the running-window form
    leaves the window untouched per axis, so inverted boxes always hit.)
    ``split=1`` returns the BVH node boxes unchanged.

    Boxes are inflated by a 2^-18 relative margin: the MT accept region is
    computed in f32 with its own rounding, so a few-ulp overhang past the
    exact hull must still cull in — the margin is ~16x any plausible drift,
    at negligible tightness cost.
    """
    if split <= 1:
        return clusters.aabb_min, clusters.aabb_max
    K, C = clusters.num_clusters, clusters.max_tris
    if C % split:
        raise ValueError(f"cull_split {split} must divide cluster_tris {C}")
    chunk = C // split
    mins = np.full((K * split, 3), 1e17, np.float32)
    maxs = np.full((K * split, 3), 1e17, np.float32)
    v2 = tri_p1 + tri_e1
    v3 = tri_p1 + tri_e2
    for k in range(K):
        n = int(clusters.count[k])
        lo = int(clusters.start[k])
        for s in range(split):
            a = s * chunk
            b = min(n, a + chunk)
            if a >= b:
                break
            sl = slice(lo + a, lo + b)
            pts = np.concatenate([tri_p1[sl], v2[sl], v3[sl]])
            bmin = pts.min(axis=0)
            bmax = pts.max(axis=0)
            margin = np.float32(2.0 ** -18) * np.maximum(
                np.maximum(np.abs(bmin), np.abs(bmax)), np.float32(1e-20)
            )
            mins[k * split + s] = bmin - margin
            maxs[k * split + s] = bmax + margin
    return mins, maxs


def cluster_stats(clusters: ClusterArrays) -> dict:
    """Observability: fill rate and size distribution."""
    counts = clusters.count
    return dict(
        num_clusters=clusters.num_clusters,
        max_tris=clusters.max_tris,
        total_tris=int(counts.sum()),
        fill_rate=float(counts.sum() / max(1, counts.size * clusters.max_tris)),
        largest=int(counts.max()) if counts.size else 0,
    )
