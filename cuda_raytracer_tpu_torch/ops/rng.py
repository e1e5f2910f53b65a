"""PCG-XSH-RR 64/32 random number generator on torch tensors, bit-exact.

Counterpart of ``cuda_raytracer_tpu/ops/rng.py`` (the reference's
random.cuh:5-75): a 64-bit LCG state advanced by
``state = state * 6364136223846793005 + 820957824423429`` with an
xorshift-high + random-rotate output, seeded by multiplying the 32-bit seed
with 6839056345687307 and burning one draw.

Torch on the CPU has no uint32 add, shift or compare, so every 32-bit value
is carried in an int64 tensor holding 0 ≤ x < 2^32 and masked with
``0xFFFFFFFF`` after each wrap-around operation. The 64-bit state is a pair
of such limbs ``(hi, lo)``, and products are built from 16-bit partial
products exactly as the JAX module does, so no int64 product can overflow.
The CUDA kernel (``csrc/shade.cu``) uses native ``uint64_t`` for the same
stream; the tests hold both to the JAX bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF

# 6364136223846793005 = 0x5851F42D_4C957F2D (the PCG default multiplier)
_MULT_HI = 0x5851F42D
_MULT_LO = 0x4C957F2D
# Stream increment 820957824423429 (odd, so `inc | 1 == inc`)
_INC_HI = 0x0002EAA8
_INC_LO = 0x23801605
# Seeding multiplier 6839056345687307
_SEED_MULT_HI = 0x00184C15
_SEED_MULT_LO = 0xE415650B

# Value scalings, as float32 constants computed exactly like the JAX module.
INV_UINT_MAX = float(np.float32(1.0) / np.float32(4294967295.0))
TWO_INV_UINT_MAX = float(np.float32(2.0) / np.float32(4294967295.0))
TWO_PI_INV_UINT_MAX = float(np.float32(2.0 * math.pi) / np.float32(4294967295.0))


class PcgState(NamedTuple):
    """64-bit PCG state as two 32-bit limbs held in int64 tensors."""

    hi: torch.Tensor
    lo: torch.Tensor


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret an integer tensor's low 32 bits as an unsigned value in
    int64 (int32 -1 → 0xFFFFFFFF)."""
    return x.to(torch.int64) & MASK32


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``(a * b) mod 2^32`` for 32-bit values, with no int64 overflow."""
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    return (a0 * b0 + (((a1 * b0 + a0 * b1) & _MASK16) << 16)) & MASK32


def _mul32_wide(a: torch.Tensor, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full 32x32→64 unsigned multiply via 16-bit limbs; returns (hi, lo)."""
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    p00 = a0 * b0
    mid = a1 * b0 + (p00 >> 16)
    mid2 = a0 * b1 + (mid & _MASK16)
    hi = a1 * b1 + (mid >> 16) + (mid2 >> 16)
    lo = ((mid2 << 16) & MASK32) | (p00 & _MASK16)
    return hi & MASK32, lo


def _mul64(a_hi, a_lo, b_hi: int, b_lo: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """64x64→low-64 multiply on limb pairs (b is a constant)."""
    hi, lo = _mul32_wide(a_lo, b_lo)
    hi = (hi + mul32(a_lo, b_hi) + mul32(a_hi, b_lo)) & MASK32
    return hi, lo


def _add64(a_hi, a_lo, b_hi: int, b_lo: int) -> Tuple[torch.Tensor, torch.Tensor]:
    s = a_lo + b_lo
    return (a_hi + b_hi + (s >> 32)) & MASK32, s & MASK32


def pcg_advance(state: PcgState) -> PcgState:
    """One LCG step: ``state * MULT + INC``."""
    hi, lo = _mul64(state.hi, state.lo, _MULT_HI, _MULT_LO)
    hi, lo = _add64(hi, lo, _INC_HI, _INC_LO)
    return PcgState(hi, lo)


def pcg_output(state: PcgState) -> torch.Tensor:
    """XSH-RR output of a (pre-advance) state."""
    # xorshifted = (uint32)(((state >> 18) ^ state) >> 27)
    t_lo = state.lo ^ (((state.lo >> 18) | (state.hi << 14)) & MASK32)
    t_hi = state.hi ^ (state.hi >> 18)
    xorshifted = ((t_lo >> 27) | (t_hi << 5)) & MASK32
    rot = state.hi >> 27  # (uint32)(state >> 59)
    neg_rot = (-rot) & 31
    return ((xorshifted >> rot) | (xorshifted << neg_rot)) & MASK32


def pcg_next(state: PcgState) -> Tuple[PcgState, torch.Tensor]:
    """Advance and return (new_state, draw)."""
    return pcg_advance(state), pcg_output(state)


def srand(seed: torch.Tensor) -> PcgState:
    """Seed from a 32-bit value: multiply by a large odd constant and burn
    one draw."""
    seed = as_u32(seed)
    hi, lo = _mul32_wide(seed, _SEED_MULT_LO)
    hi = (hi + mul32(seed, _SEED_MULT_HI)) & MASK32
    return pcg_advance(PcgState(hi, lo))


def uniforms(seed: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` raw 32-bit draws (in int64) of a freshly seeded
    generator, stacked on a new leading axis: shape ``(n,) + seed.shape``."""
    state = srand(seed)
    outs = []
    for _ in range(n):
        state, value = pcg_next(state)
        outs.append(value)
    return torch.stack(outs, dim=0)


def to_01(bits: torch.Tensor) -> torch.Tensor:
    """32-bit draw → [0, 1] float32, exactly ``bits * (1.0f / UINT_MAX)``.
    int64 → float32 rounds to nearest, like the unsigned convert."""
    return bits.to(torch.float32) * INV_UINT_MAX


def to_02(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.float32) * TWO_INV_UINT_MAX


def to_radians(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.float32) * TWO_PI_INV_UINT_MAX


def random01(state: PcgState) -> Tuple[PcgState, torch.Tensor]:
    """Advance once → (new state, the draw as a [0, 1] float32)."""
    state, bits = pcg_next(state)
    return state, to_01(bits)


def on_sphere_from_bits(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """Uniform point on the unit sphere from two raw draws: r1 ∈ [0, 2π),
    r2 ∈ [0, 2], z = 1 - r2, ring radius sqrt(r2 * (2 - r2)). (..., 3)."""
    r1 = to_radians(bits_a)
    r2 = to_02(bits_b)
    x = torch.sqrt(r2 * (2.0 - r2))
    return torch.stack([torch.cos(r1) * x, torch.sin(r1) * x, 1.0 - r2], dim=-1)


def random_on_sphere(state: PcgState) -> Tuple[PcgState, torch.Tensor]:
    """Advance twice → (new state, a uniform point on the unit sphere,
    (..., 3)), as random.cuh:63-75 draws it."""
    state, a = pcg_next(state)
    state, b = pcg_next(state)
    return state, on_sphere_from_bits(a, b)
