"""Morton (Z-order) sort keys for wavefront ray reordering (counterpart of
``cuda_raytracer_tpu/ops/morton.py``).

5 bits per axis for origin and direction, interleaved into 15-bit codes and
packed as ``origin_code << 16 | direction_code`` in a 32-bit key; dead rays
get ``DEAD_RAY_KEY`` so an ascending sort puts them last (scene.cu:42-60,
480-485). The interleave is the correct 3-way bit spread (masks 0x100F /
0x10C3 / 0x1249), not the reference's hex-for-binary mask (SURVEY quirk
Q1), and origins are normalised by the scene extent (quirk Q5).

``first2_cluster_keys`` is the packet scenes' other key (``sort_key``
"cullhit"): each ray's first two slab-hit cluster ids.

Keys are uint32 values held in int64 tensors (torch has no uint32
arithmetic on the CPU), so sorting them as int64 orders them as uint32.
"""

from __future__ import annotations

import torch

from cuda_raytracer_tpu_torch.ops import vecmath

DEAD_RAY_KEY = 0xFFFFFFFF


def interleave_5(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 5 bits of ``x`` to every 3rd bit: 0bABCDE →
    0bA00B00C00D00E (int64 in, int64 out)."""
    x = x & 0x1F
    x = (x | (x << 8)) & 0x100F
    x = (x | (x << 4)) & 0x10C3
    x = (x | (x << 2)) & 0x1249
    return x


def morton_code(v: torch.Tensor) -> torch.Tensor:
    """15-bit Morton code of points ``v`` in [0, 1]^3, (..., 3) float32 →
    (...,) int64, quantised as ``(ushort)(x * 31.99)`` (scene.cu:53-60)."""
    q = (v * 31.99).to(torch.int64)
    return (
        interleave_5(q[..., 0])
        | (interleave_5(q[..., 1]) << 1)
        | (interleave_5(q[..., 2]) << 2)
    )


def ray_sort_keys(
    origin: torch.Tensor,
    direction: torch.Tensor,
    alive: torch.Tensor,
    min_coord: torch.Tensor,
    inv_extent: torch.Tensor,
) -> torch.Tensor:
    """32-bit coherence keys (int64 holding uint32): high half the Morton
    code of the normalised origin, low half that of the direction mapped
    from [-1, 1] to [0, 1]; dead rays → ``DEAD_RAY_KEY``."""
    origin_unit = vecmath.clamp01((origin - min_coord) * inv_extent)
    dir_unit = 0.5 * (direction + 1.0)
    keys = (morton_code(origin_unit) << 16) | morton_code(dir_unit)
    return torch.where(alive, keys, DEAD_RAY_KEY)


# Cluster boxes per step of first2_cluster_keys: bounds its (R, chunk, 3)
# slab intermediates, as the JAX package chunks them.
_FIRST2_CHUNK = 256


def first2_cluster_keys(
    origin: torch.Tensor,
    direction: torch.Tensor,
    alive: torch.Tensor,
    cluster_min: torch.Tensor,
    cluster_max: torch.Tensor,
    num_clusters: int,
    cull_split: int,
) -> torch.Tensor:
    """Cull-derived coherence keys (int64 holding uint32): each ray's first
    and second DISTINCT slab-hit cluster ids (fh, sh), row // cull_split of
    the first K * cull_split boxes, K = num_clusters for "none". Ids are
    squeezed to 11 bits when K + 1 > 2048 (``id * 2047 // K``) and packed as
    ``fh << 21 | sh << 10``; dead rays get ``DEAD_RAY_KEY``. The JAX
    package's form, chunk by chunk over the boxes: the box table is padded
    to whole chunks with far-away point boxes, ``1 / where(d == 0, 1e-30,
    d)`` is the inverse direction, the slab test is unwindowed (entry
    floored at 0), and each chunk's two smallest ids merge into the running
    pair."""
    o, d = origin.detach(), direction.detach()
    rows = num_clusters * cull_split
    boxes_min, boxes_max = cluster_min[:rows], cluster_max[:rows]
    pad = (-rows) % _FIRST2_CHUNK
    if pad:
        # Far-away point boxes (the split_aabbs convention): a point box
        # slab-hits only when all three axis parameters tie exactly.
        boxes_min = torch.nn.functional.pad(boxes_min, (0, 0, 0, pad), value=3e30)
        boxes_max = torch.nn.functional.pad(boxes_max, (0, 0, 0, pad), value=3e30)
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    K = num_clusters
    fh = torch.full((o.shape[0],), K, dtype=torch.int64, device=o.device)
    sh = fh.clone()
    for r0 in range(0, rows, _FIRST2_CHUNK):
        bmin = boxes_min[r0:r0 + _FIRST2_CHUNK]  # (kc, 3)
        bmax = boxes_max[r0:r0 + _FIRST2_CHUNK]
        t1 = (bmin[None] - o[:, None]) * inv[:, None]  # (R, kc, 3)
        t2 = (bmax[None] - o[:, None]) * inv[:, None]
        near = torch.clamp_min(torch.minimum(t1, t2).amax(dim=2), 0.0)
        far = torch.maximum(t1, t2).amin(dim=2)
        hit = near <= far  # (R, kc)
        # Sub-box rows map down to their cluster id; first two DISTINCT ids.
        ids = (r0 + torch.arange(bmin.shape[0], device=o.device)) // cull_split
        idx = torch.where(hit, ids[None], K)
        m1 = idx.amin(dim=1)
        m2 = torch.where(idx == m1[:, None], K, idx).amin(dim=1)
        # Chunks ascend in cluster id, so the merge is a fill-in; a chunk
        # boundary can only re-present fh's own id (sub-rows of one cluster
        # when cull_split > 1), which c1 guards.
        c1 = torch.where(m1 == fh, m2, m1)
        sh = torch.where(fh == K, m2, torch.minimum(sh, c1))
        fh = torch.minimum(fh, m1)
    if K + 1 > 2048:
        fh = (fh * 2047) // K  # monotone squeeze; "none" (K) -> exactly 2047
        sh = (sh * 2047) // K
    keys = (fh << 21) | (sh << 10)
    return torch.where(alive, keys, DEAD_RAY_KEY)
