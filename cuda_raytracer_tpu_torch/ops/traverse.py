"""BVH traversal helpers (counterpart of ``cuda_raytracer_tpu/ops/traverse.py``).

Only the safe inverse direction is ported so far: the packet intersector's
slab tests use it. The lockstep BVH walk (``bvh_closest_hit``,
``intersector="bvh"``) is still to port (ROADMAP.md queue A).
"""

from __future__ import annotations

import torch


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
