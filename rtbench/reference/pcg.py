"""PCG-XSH-RR 64/32, the upstream renderer's generator (random.cuh:5-75), on
torch integer tensors.

Every 32-bit value is carried in int64 holding 0 <= x < 2^32 and masked
after each wrap-around; the 64-bit state is a pair of such limbs, and
products are built from 16-bit partial products so no int64 product
overflows. Seeds follow raytracing.cu: a camera ray's stream is seeded
with ``ray * 298592570346 + 709579 * pass_seed`` and a bounce's with
``ray * 4137874753 + 279220567 * (pass_seed * 20 + bounce)``, both mod 2^32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF
MULT = (0x5851F42D, 0x4C957F2D)  # 6364136223846793005
INC = (0x0002EAA8, 0x23801605)  # 820957824423429
SEED_MULT = (0x00184C15, 0xE415650B)  # 6839056345687307

CAMERA_RAY_MULT = 298592570346 & MASK32
CAMERA_PASS_MULT = 709579
BOUNCE_RAY_MULT = 4137874753
BOUNCE_PASS_MULT = 279220567

INV_UINT_MAX = float(np.float32(1.0) / np.float32(4294967295.0))
TWO_INV_UINT_MAX = float(np.float32(2.0) / np.float32(4294967295.0))
TWO_PI_INV_UINT_MAX = float(np.float32(2.0 * math.pi) / np.float32(4294967295.0))


def mul32(a, b):
    """(a * b) mod 2^32."""
    a0, a1, b0, b1 = a & MASK16, a >> 16, b & MASK16, b >> 16
    return (a0 * b0 + (((a1 * b0 + a0 * b1) & MASK16) << 16)) & MASK32


def mul32_wide(a, b):
    """32 x 32 → 64-bit product as (hi, lo)."""
    a0, a1, b0, b1 = a & MASK16, a >> 16, b & MASK16, b >> 16
    p00 = a0 * b0
    mid = a1 * b0 + (p00 >> 16)
    mid2 = a0 * b1 + (mid & MASK16)
    hi = a1 * b1 + (mid >> 16) + (mid2 >> 16)
    return hi & MASK32, ((mid2 << 16) & MASK32) | (p00 & MASK16)


def advance(hi, lo):
    """state * MULT + INC mod 2^64."""
    h, l = mul32_wide(lo, MULT[1])
    h = (h + mul32(lo, MULT[0]) + mul32(hi, MULT[1])) & MASK32
    s = l + INC[1]
    return (h + INC[0] + (s >> 32)) & MASK32, s & MASK32


def output(hi, lo):
    """XSH-RR output of a state."""
    t_lo = lo ^ (((lo >> 18) | (hi << 14)) & MASK32)
    t_hi = hi ^ (hi >> 18)
    x = ((t_lo >> 27) | (t_hi << 5)) & MASK32
    rot = hi >> 27
    return ((x >> rot) | (x << ((-rot) & 31))) & MASK32


def draws(seed: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` raw draws of generators seeded with ``seed`` (uint32
    values in int64): shape (n,) + seed.shape."""
    hi, lo = mul32_wide(seed, SEED_MULT[1])
    hi = (hi + mul32(seed, SEED_MULT[0])) & MASK32
    hi, lo = advance(hi, lo)
    out = []
    for _ in range(n):
        out.append(output(hi, lo))
        hi, lo = advance(hi, lo)
    return torch.stack(out)


def camera_draws(ray_id: torch.Tensor, pass_seed: int) -> torch.Tensor:
    """The two jitter draws of camera rays ``ray_id`` (int64)."""
    add = (CAMERA_PASS_MULT * (pass_seed & MASK32)) & MASK32
    return draws((mul32(ray_id & MASK32, CAMERA_RAY_MULT) + add) & MASK32, 2)


def bounce_draws(ray_id: torch.Tensor, pass_seed: int, bounce: int) -> torch.Tensor:
    """The five draws of one bounce of rays ``ray_id`` (int64)."""
    add = (BOUNCE_PASS_MULT * ((((pass_seed & MASK32) * 20) + bounce) & MASK32)) & MASK32
    return draws((mul32(ray_id & MASK32, BOUNCE_RAY_MULT) + add) & MASK32, 5)


def to_01(bits, dtype=torch.float32):
    return (bits.to(torch.float32) * INV_UINT_MAX).to(dtype)


def on_sphere(bits_a, bits_b, dtype=torch.float32):
    """A uniform point on the unit sphere from two draws (random.cuh:63-75)."""
    r1 = (bits_a.to(torch.float32) * TWO_PI_INV_UINT_MAX).to(dtype)
    r2 = (bits_b.to(torch.float32) * TWO_INV_UINT_MAX).to(dtype)
    x = torch.sqrt(r2 * (2.0 - r2))
    return torch.stack([torch.cos(r1) * x, torch.sin(r1) * x, 1.0 - r2], dim=-1)
