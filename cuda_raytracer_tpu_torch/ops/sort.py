"""Stable bucket sort destinations for ray-coherence keys (counterpart of
``cuda_raytracer_tpu/ops/sort.py``).

The JAX package computes the "count" engine's permutation as a destination
map in matmul form (a one-hot of each key's bucket, a strictly lower
triangular product for the rank within a block, cumulative sums for the
bases), because a comparator sort is slow on a TPU. The destinations are
those of a stable counting sort on the key's top byte: buckets ascend, dead
rays land strictly last, ties keep their source order. That is the inverse
of a stable argsort on the bucket, which is how this module computes it.

The port's reorder (``render/wavefront.sort_order``) does not call it: one
stable ``torch.argsort`` on the bucket gives the gather order directly, the
inverse of these destinations.
"""

from __future__ import annotations

import torch

from cuda_raytracer_tpu_torch.ops.morton import DEAD_RAY_KEY

# Rows per rank block of the JAX matmul form; the destinations do not
# depend on it.
BLK = 256
# Buckets: live keys bucket on bits 30..23, clamped to [0, BUCKETS - 2];
# bucket BUCKETS - 1 holds the dead rays only.
BUCKETS = 256
BUCKET_SHIFT = 23


def bucket_sort_dest(keys: torch.Tensor) -> torch.Tensor:
    """(n,) int64 keys holding uint32 values → (n,) int32 stable
    counting-sort destinations by bucket: element i moves to dest[i]. Fewer
    than 2^24 keys, the bound of the JAX form's float32 counts."""
    n = keys.shape[0]
    if n >= 1 << 24:
        raise ValueError(
            f"bucket_sort_dest: {n} keys >= 2^24, beyond the float32 rank arithmetic of "
            "the JAX form; sort in chunks"
        )
    bucket = torch.where(keys == DEAD_RAY_KEY, BUCKETS - 1,
                         torch.clamp(keys >> BUCKET_SHIFT, max=BUCKETS - 2))
    order = torch.argsort(bucket, stable=True)
    dest = torch.empty_like(order)
    dest[order] = torch.arange(n, device=keys.device)
    return dest.to(torch.int32)
