"""Möller–Trumbore sweep over an extracted (tile, cluster) pair list: wrapper of ``csrc/sweep.cu``.

Counterpart of ``cuda_raytracer_tpu/ops/pallas/sweep.py`` (``sweep_pairs``,
its ``_sweep_kernel``), the sweep of the ``"pallas"`` packet engine. Each of
the first ``total`` pairs ``(pairs[0, i], pairs[1, i])`` sweeps the rays of
one tile of ``rays_tiles`` against the (16, C) block of one cluster, and
every ray keeps its closest hit over its tile's pairs: smaller t wins, equal
t goes to the larger triangle id (the fold is order-independent, so the
pairs may come in any order). Unlike the fused kernels the sweep has **no
window**: rays carry only origin and direction, so a ray reports its nearest
hit of every swept pair, beyond its current closest hit and for dead rays
too; the engine filters afterwards (``packet_intersect._finalize``).

Output contract (kernel and plain version alike): (t (T + 1, tile) float32,
tri (T + 1, tile) int32), (``MISS``, -1) for rays no swept pair hits. Pairs
at or past ``min(total, P)`` are never swept (they are the (T, 0) sentinels
of ``packet_intersect.extract_pairs``), and neither is a pair whose tile or
cluster id lies outside the inputs. Row T, the dummy tile, then reads
(``MISS``, -1); callers slice it off.

The kernel cuts the first ``min(total, P)`` pairs into ``ranges`` contiguous,
equal ranges, one block's work each (``None``: one range per block of a
full wave on the card); the result does not depend on the count.

- On a CUDA tensor it launches the hand-written kernel and counts the launch
  in ``LAUNCHES``. It never falls back.
- On a CPU tensor it runs ``plain_sweep``: the pair-list sweep of
  ``fused.sweep_pair_list`` over the valid pairs.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_raytracer_tpu_torch.ops.kernels import build
from cuda_raytracer_tpu_torch.ops.kernels.cull import device_kind, raise_on_error
from cuda_raytracer_tpu_torch.ops.kernels.fused import MISS, sweep_pair_list

# Lanes of a rays_tiles row: the TPU layout pads tiles below 128 rays to 128.
LANES = 128

# Kernel launches made by sweep_pairs in this process (CUDA tensors only).
LAUNCHES = 0


def make_rays_tiles(origin: torch.Tensor, direction: torch.Tensor, tile: int) -> torch.Tensor:
    """(R, 3) origins and directions, R a multiple of ``tile`` → the
    tile-major (T + 1, 8, max(tile, LANES)) float32 rows ``[ox oy oz dx dy dz
    0 0]``; row T is a zero dummy tile (zero directions: every test
    misses), the lanes past ``tile`` are zero."""
    T = origin.shape[0] // tile
    rows = torch.cat([origin, direction], dim=1).reshape(T, tile, 6).permute(0, 2, 1)
    return torch.nn.functional.pad(rows, (0, max(0, LANES - tile), 0, 2, 0, 1)).contiguous()


def _valid_pairs(rays_tiles, blocks, pairs, total):
    """The pairs the sweep takes: the first min(total, P), in range."""
    n = min(int(total), pairs.shape[1])
    pair_tile, pair_k = pairs[0, :n].long(), pairs[1, :n].long()
    ok = ((pair_tile >= 0) & (pair_tile < rays_tiles.shape[0])
          & (pair_k >= 0) & (pair_k < blocks.shape[0]))
    return pair_tile[ok], pair_k[ok]


def plain_sweep(rays_tiles: torch.Tensor, blocks: torch.Tensor, pairs: torch.Tensor,
                total: torch.Tensor, tile: int):
    """The kernel's plain PyTorch version, same inputs and outputs."""
    pair_tile, pair_k = _valid_pairs(rays_tiles, blocks, pairs, total)
    return sweep_pair_list(rays_tiles[:, :, :tile], blocks, pair_tile, pair_k)


def _check(rays_tiles, blocks, pairs, total, tile):
    if (rays_tiles.dtype != torch.float32 or rays_tiles.dim() != 3
            or rays_tiles.shape[1] != 8):
        raise ValueError(f"rays_tiles must be (T + 1, 8, L) float32, got {rays_tiles.dtype} "
                         f"{tuple(rays_tiles.shape)}")
    if not 1 <= tile <= min(1024, rays_tiles.shape[2]):
        raise ValueError(f"tile must be 1..min(1024, L = {rays_tiles.shape[2]}), got {tile}")
    if blocks.dtype != torch.float32 or blocks.dim() != 3 or blocks.shape[1] != 16:
        raise ValueError(f"blocks must be (K, 16, C) float32, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if pairs.dtype != torch.int32 or pairs.dim() != 2 or pairs.shape[0] != 2:
        raise ValueError(f"pairs must be (2, P) int32, got {pairs.dtype} {tuple(pairs.shape)}")
    if total.dtype != torch.int32 or total.numel() != 1:
        raise ValueError(f"total must be one int32, got {total.dtype} {tuple(total.shape)}")
    for x in (blocks, pairs, total):
        if x.device != rays_tiles.device:
            raise ValueError(f"an input lies on {x.device}, rays on {rays_tiles.device}")
    for x in (rays_tiles, blocks, pairs):
        if not x.is_contiguous():
            raise ValueError("sweep_pairs inputs must be contiguous")


def library() -> build.Built:
    """Build (at first use) and bind ``csrc/sweep.cu``."""
    built = build.load("sweep")
    fn = built.lib.rt_sweep_pairs
    fn.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 2
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 4
    )
    fn.restype = ctypes.c_int
    built.lib.rt_error_string.argtypes = [ctypes.c_int]
    built.lib.rt_error_string.restype = ctypes.c_char_p
    return built


def sweep_pairs(
    rays_tiles: torch.Tensor,  # (T + 1, 8, L) f32 — rows o xyz, d xyz, 0, 0
    blocks: torch.Tensor,  # (K, 16, C) f32 — rows 0-8 p1/e1/e2, row 9 tri id
    pairs: torch.Tensor,  # (2, P) int32 — [pair tile; pair cluster]
    total: torch.Tensor,  # () int32 — number of valid pairs, may exceed P
    tile: int = None,  # rays per tile (L may be padded past it)
    ranges: int = None,  # contiguous pair ranges; None: one per block of a full wave
):
    """→ (t (T + 1, tile) float32, tri (T + 1, tile) int32): every ray's
    closest hit over the swept pairs of its tile, no window."""
    global LAUNCHES
    tile = rays_tiles.shape[2] if tile is None else tile
    _check(rays_tiles, blocks, pairs, total, tile)
    if ranges is not None and ranges < 1:
        raise ValueError(f"ranges must be >= 1, got {ranges}")
    if device_kind(rays_tiles, "sweep_pairs") == "cpu":
        return plain_sweep(rays_tiles, blocks, pairs, total, tile)
    T1, _, L = rays_tiles.shape
    K, _, C = blocks.shape
    keys = torch.empty((T1, tile), dtype=torch.int64, device=rays_tiles.device)
    t_out = torch.empty((T1, tile), dtype=torch.float32, device=rays_tiles.device)
    tri_out = torch.empty((T1, tile), dtype=torch.int32, device=rays_tiles.device)
    total = total.reshape(1).contiguous()
    lib = library().lib
    with torch.cuda.device(rays_tiles.device):
        err = lib.rt_sweep_pairs(
            rays_tiles.data_ptr(), T1, L, tile, blocks.data_ptr(), K, C,
            pairs.data_ptr(), pairs.shape[1], total.data_ptr(), ranges or 0, keys.data_ptr(),
            t_out.data_ptr(), tri_out.data_ptr(),
            torch.cuda.current_stream(rays_tiles.device).cuda_stream,
        )
    raise_on_error(lib, err, "sweep")
    LAUNCHES += 1
    return t_out, tri_out
