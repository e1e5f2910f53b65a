"""Packet closest hit over culled (tile, cluster) pairs: wrapper of ``csrc/fused.cu``.

Counterpart of ``cuda_raytracer_tpu/ops/pallas/fused.py``
(``fused_closest_hit``, its resident and DMA-wave kernels). For every ray
tile it sweeps each selected cluster's (16, C) block with the
Möller–Trumbore t-plane (eps 0.005) and folds (t, tri): smaller t wins,
equal t goes to the larger triangle id. The selection is ``pack_words``'s
(T, Kw) int32 words (bit b of word g selects cluster 32 g + b). With the
cull's entries and per-ray hit bits, a cluster is skipped when no ray that
hits its box has a bound min(best so far, window) reaching the entry scaled
by ``SKIP_SLACK``.

Output contract (kernel and plain version alike): per ray, the closest hit
strictly inside its window (t < window) as (t, triangle id); every other
ray, dead and padded rays included, reports (``MISS``, -1). Within the
window the skip test cannot drop the winning pair (a triangle hit lies at
or beyond the slab entry of a box that holds it; ``SKIP_SLACK`` covers the
rounding between the two expression chains), so the skip does not change
the output.

When a launch has few ray tiles, each tile's selected clusters are split
over several blocks (``fused1.split_plan``'s choice of splits, as for
fused1: the grid is (T, splits), each block sweeps its own share of the
tile's set bits and folds its per-ray best into a 64-bit key by atomic
minimum; a finishing pass applies the windows), so the tail bounces' few
live tiles fill the card. The result is the same at every split;
``splits=1`` is one block per tile.

- On a CUDA tensor it launches the hand-written kernel and counts the launch
  in ``LAUNCHES``. It never falls back.
- On a CPU tensor it runs ``plain_fused``: every selected pair swept in
  PyTorch, no skip.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_raytracer_tpu_torch.ops.kernels import build
from cuda_raytracer_tpu_torch.ops.kernels.cull import (
    check_rays,
    device_kind,
    pack_bits,
    raise_on_error,
)

HIT_EPS = 0.005
MISS = 1e30
SKIP_SLACK = 1.0 - 2.0 ** -14
# Elements per (pairs, tile, C) intermediate of the plain sweep.
PLAIN_ELEMS = 1 << 22
# Clusters per unit of fused1.split_plan's splits: at most one split per 32
# clusters (fused1's own unit is smaller).
SPLIT_UNIT = 32

# Kernel launches made by fused_closest_hit in this process (CUDA tensors only).
LAUNCHES = 0


def pack_words(mask: torch.Tensor) -> torch.Tensor:
    """(T, K) bool selection → (T, ceil(K / 32)) int32 words, bit b of word g
    set iff cluster 32 g + b is selected."""
    return pack_bits(mask.T).T.contiguous()


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_words``: (T, Kw) int32 → (T, 32 Kw) bool."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1) != 0


def mt_t_plane(o, d, tri9):
    """The Möller–Trumbore t-plane (``ops/pallas/sweep._mt_t_plane``),
    broadcasting: accepted hit distance or ``MISS``. Division-free
    sign-folded acceptance, then t = td / det."""
    ox, oy, oz = o
    dx, dy, dz = d
    p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z = tri9
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = hx * e1x + hy * e1y + hz * e1z
    fx = ox - p1x
    fy = oy - p1y
    fz = oz - p1z
    ud = fx * hx + fy * hy + fz * hz
    qx = fy * e1z - fz * e1y
    qy = fz * e1x - fx * e1z
    qz = fx * e1y - fy * e1x
    vd = dx * qx + dy * qy + dz * qz
    td = e2x * qx + e2y * qy + e2z * qz
    s = torch.sign(det)
    ad = torch.abs(det)
    us = ud * s
    vs = vd * s
    ts = td * s
    ok = ((det != 0.0) & (us >= 0.0) & (us <= ad) & (vs >= 0.0)
          & (us + vs <= ad) & (ts >= HIT_EPS * ad))
    return torch.where(ok, td / torch.where(det == 0.0, 1.0, det), MISS)


def pair_t_planes(od8: torch.Tensor, blocks: torch.Tensor, pair_tile, pair_k):
    """(n, tile, C) t-planes of n (tile, cluster) pairs, and the blocks'
    triangle-id rows (n, 1, C) as float."""
    rays = od8[pair_tile]  # (n, 8, tile)
    blk = blocks[pair_k]  # (n, 16, C)
    o = tuple(rays[:, a, :, None] for a in range(3))
    d = tuple(rays[:, 3 + a, :, None] for a in range(3))
    tri9 = tuple(blk[:, i, None, :] for i in range(9))
    return mt_t_plane(o, d, tri9), blk[:, 9:10, :]


def fold_pairs(T: int, tile: int, pair_tile, best, tri, device):
    """Per-pair (best t, tri) rows (n, tile) → per-tile (T, tile): the
    minimum t, and the largest triangle id among the pairs that reach it."""
    index = pair_tile[:, None].expand(-1, tile)
    t_tile = torch.full((T, tile), MISS, dtype=torch.float32, device=device)
    t_tile = t_tile.scatter_reduce(0, index, best, "amin")
    matched = (best < MISS) & (best == t_tile[pair_tile])
    tri_tile = torch.full((T, tile), -1, dtype=torch.int32, device=device)
    tri_tile = tri_tile.scatter_reduce(0, index, torch.where(matched, tri, -1), "amax")
    return t_tile, tri_tile


def clamp_to_window(od8: torch.Tensor, t_tile, tri_tile):
    """Keep hits strictly inside each ray's window; others → (MISS, -1)."""
    inside = t_tile < od8[:, 6, :]
    return torch.where(inside, t_tile, MISS), torch.where(inside, tri_tile, -1)


def sweep_pair_list(rays: torch.Tensor, blocks: torch.Tensor, pair_tile, pair_k):
    """The (tile, cluster) pairs listed by ``pair_tile`` / ``pair_k`` swept
    and folded, without a window: per ray of each of the (T, 8, tile) ray
    tiles (rows 0-5 read), the smallest t over its tile's pairs and the
    largest triangle id reaching it, (``MISS``, -1) where none hits."""
    T, _, tile = rays.shape
    C = blocks.shape[2]
    step = max(1, PLAIN_ELEMS // (tile * C))
    bests, tris = [], []
    for lo in range(0, pair_tile.shape[0], step):
        t, trif = pair_t_planes(rays, blocks, pair_tile[lo:lo + step], pair_k[lo:lo + step])
        m = t.amin(dim=2)
        hit = (t == m[:, :, None]) & (t < MISS)
        bests.append(m)
        tris.append(torch.where(hit, trif, -1.0).amax(dim=2).to(torch.int32))
    if bests:
        return fold_pairs(T, tile, pair_tile, torch.cat(bests), torch.cat(tris), rays.device)
    return (torch.full((T, tile), MISS, dtype=torch.float32, device=rays.device),
            torch.full((T, tile), -1, dtype=torch.int32, device=rays.device))


def sweep_selected(od8: torch.Tensor, blocks: torch.Tensor, select: torch.Tensor):
    """Every selected (tile, cluster) pair of the (T, K') bool ``select``
    swept and folded, then clamped to the windows: the sweep both kernels
    share, in PyTorch."""
    pair_tile, pair_k = torch.nonzero(select, as_tuple=True)
    return clamp_to_window(od8, *sweep_pair_list(od8, blocks, pair_tile, pair_k))


def plain_fused(od8, blocks, words, entry=None, hitmask=None):
    """The kernel's plain PyTorch version: every selected pair swept. The
    skip inputs are accepted and ignored (the skip does not change the
    output, see the module docstring)."""
    return sweep_selected(od8, blocks, unpack_words(words))


def _check(od8, blocks, words, entry, hitmask, stats):
    check_rays(od8)
    T, _, tile = od8.shape
    if blocks.dtype != torch.float32 or blocks.dim() != 3 or blocks.shape[1] != 16:
        raise ValueError(f"blocks must be (K, 16, C) float32, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if words.dtype != torch.int32 or words.dim() != 2 or words.shape[0] != T:
        raise ValueError(f"words must be (T={T}, Kw) int32, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if words.shape[1] > -(-blocks.shape[0] // 32):
        raise ValueError(f"{words.shape[1]} selection words address more clusters "
                         f"than the {blocks.shape[0]} blocks")
    if (entry is None) != (hitmask is None):
        raise ValueError("entry and hitmask come together (the skip test) or not at all")
    if stats is not None and (stats.dtype != torch.int64 or stats.shape != (3,)):
        raise ValueError("stats must be a (3,) int64 tensor")
    tensors = [blocks, words] + ([stats] if stats is not None else [])
    if entry is not None:
        K = entry.shape[1]
        if entry.dtype != torch.float32 or entry.shape != (T, K):
            raise ValueError(f"entry must be (T, K) float32, got {tuple(entry.shape)}")
        if hitmask.dtype != torch.int32 or hitmask.shape != (T, -(-tile // 32), K):
            raise ValueError(f"hitmask must be (T, ceil(tile/32), K) int32, got "
                             f"{tuple(hitmask.shape)}")
        if words.shape[1] != -(-K // 32):
            raise ValueError(f"entry covers {K} clusters, the words {words.shape[1]} words")
        tensors += [entry, hitmask]
    for x in tensors:
        if x.device != od8.device:
            raise ValueError(f"an input lies on {x.device}, rays on {od8.device}")
        if not x.is_contiguous():
            raise ValueError("fused_closest_hit inputs must be contiguous")


def library() -> build.Built:
    """Build (at first use) and bind ``csrc/fused.cu``."""
    built = build.load("fused")
    fn = built.lib.rt_fused_closest_hit
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
    )
    fn.restype = ctypes.c_int
    built.lib.rt_error_string.argtypes = [ctypes.c_int]
    built.lib.rt_error_string.restype = ctypes.c_char_p
    return built


def fused_closest_hit(
    od8: torch.Tensor,  # (T, 8, tile) f32 — rays and windows
    blocks: torch.Tensor,  # (K, 16, C) f32 — rows 0-8 p1/e1/e2, row 9 tri id
    words: torch.Tensor,  # (T, Kw) int32 — selected clusters
    entry: torch.Tensor = None,  # (T, K) f32 cull entries — enables the skip
    hitmask: torch.Tensor = None,  # (T, ceil(tile/32), K) int32 per-ray hit bits
    stats: torch.Tensor = None,  # (3,) int64 on the card: [1] swept pairs, [2] their MT tests
    splits: int = None,  # blocks per tile; None: fused1.split_plan's choice
):
    """→ (t (T, tile) float32, tri (T, tile) int32): the closest in-window
    hit of every ray over its tile's selected clusters."""
    global LAUNCHES
    from cuda_raytracer_tpu_torch.ops.kernels.fused1 import split_plan

    _check(od8, blocks, words, entry, hitmask, stats)
    T, _, tile = od8.shape
    splits = split_plan(T, blocks.shape[0], splits=splits, unit=SPLIT_UNIT)[0]
    if device_kind(od8, "fused_closest_hit") == "cpu":
        return plain_fused(od8, blocks, words, entry, hitmask)
    t_out = torch.empty((T, tile), dtype=torch.float32, device=od8.device)
    tri_out = torch.empty((T, tile), dtype=torch.int32, device=od8.device)
    keys = (torch.empty((T, tile), dtype=torch.int64, device=od8.device)
            if splits > 1 else None)
    skip = entry is not None
    lib = library().lib
    with torch.cuda.device(od8.device):
        err = lib.rt_fused_closest_hit(
            od8.data_ptr(), blocks.data_ptr(), words.data_ptr(), words.shape[1],
            entry.data_ptr() if skip else None, hitmask.data_ptr() if skip else None,
            T, entry.shape[1] if skip else 0, blocks.shape[2], tile, splits,
            keys.data_ptr() if keys is not None else None,
            t_out.data_ptr(), tri_out.data_ptr(),
            stats.data_ptr() if stats is not None else None,
            torch.cuda.current_stream(od8.device).cuda_stream,
        )
    raise_on_error(lib, err, "fused")
    LAUNCHES += 1
    return t_out, tri_out
