"""Single-kernel packet closest hit (cull + walk + sweep): wrapper of ``csrc/fused1.cu``.

Counterpart of ``cuda_raytracer_tpu/ops/pallas/fused1.py``
(``fused1_closest_hit``, ``pack`` 1 and 2). For every ray tile it culls the rays
against the K cluster boxes (the windowed slab test of ``cull.py``), and
sweeps every box some ray of the tile hits, exactly as ``fused.py`` sweeps,
with a per-ray early-out: a box is swept only when some ray's bound
min(best so far, window) reaches that ray's own slab entry for it (scaled by
``SKIP_SLACK``). With ``gate_g`` > 0 the super boxes ``sup`` (one per
``gate_g`` consecutive boxes, see ``shard_supers``) gate whole 128-box
chunks; a tile whose rays are all dead does nothing. The gate, the dead-tile
skip and the early-out are conservative, so the output is the one
``fused.py`` documents: per ray, the closest hit strictly inside its window,
else (``MISS``, -1).

With ``pack=2`` (paired sub-cluster tables, ``cluster_pack=2``) the K boxes
are sub-cluster boxes and ``blocks`` holds K / 2 blocks of C lanes: lanes
``[h*C/2, (h+1)*C/2)`` of block b are sub-cluster 2b + h
(``models/cluster.pack_paired_blocks``). Only the halves some ray of a tile
hits are swept, so the result is that of ``pack=1`` over the same
sub-clusters cut at C / 2.

When a launch has few ray tiles, each tile's boxes are split over several
blocks (``split_plan``: the grid is (T, splits), each block culls and
sweeps its own range of whole ``SPLIT_CHUNK``-box chunks and folds its
per-ray best into a 64-bit key by atomic minimum; a finishing pass applies
the windows), so the tail bounces' few live tiles fill the card. The result
is the same at every split; ``splits=1`` is one block per tile.

- On a CUDA tensor it launches the hand-written kernel and counts the launch
  in ``LAUNCHES`` (``pack=1``) or ``LAUNCHES_PACK2``. It never falls back.
- On a CPU tensor it runs ``plain_fused1``: the plain cull's per-ray hit
  bits ORed over each tile select the (sub-cluster) pairs, and every pair
  is swept.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_raytracer_tpu_torch.ops.kernels import build
from cuda_raytracer_tpu_torch.ops.kernels.cull import (
    check_boxes,
    check_rays,
    device_kind,
    plain_cull,
    raise_on_error,
)
from cuda_raytracer_tpu_torch.ops.kernels.fused import sweep_selected

CHUNK = 128  # boxes per cull chunk; gate_g must divide it
# Boxes per cull chunk of the split kernel (at least gate_g): the unit a
# tile's boxes are split in. On an H100 (NVIDIA H100 80GB HBM3, 700 W) the
# centre block's tail bounces (11-15 live tiles of 64) ran in 0.14-0.17 ms
# at 46 splits of 16 boxes against 0.18-0.21 ms at 23 of 32
# (chip_fused1.py; PERF.md).
SPLIT_CHUNK = 16
# Blocks (tiles x splits) a launch aims for, counting dead tiles, which
# return at once: a full 2^18-ray block's 4,096 tiles stay one block each,
# the fastest there (bounce 1: 1.05 ms against 1.13-2.56 ms at 5-46 splits
# on the same H100).
TARGET_BLOCKS = 4096

PACKS = (1, 2)  # sub-clusters per block the kernel takes

# Kernel launches made by fused1_closest_hit in this process (CUDA tensors
# only): with pack=1, and with pack=2.
LAUNCHES = 0
LAUNCHES_PACK2 = 0


def shard_supers(box_min: torch.Tensor, box_max: torch.Tensor, G: int) -> torch.Tensor:
    """Tight super boxes over G consecutive boxes → (ceil(K / G), 6) float32
    ``[min xyz, max xyz]``. Padding boxes (far points at 1e17) are left out
    of the union; an all-padding group keeps the far point box."""
    K = box_min.shape[0]
    n_sup = -(-K // G)
    pad = n_sup * G - K
    inf = float("inf")
    smin = torch.nn.functional.pad(box_min, (0, 0, 0, pad), value=inf).reshape(n_sup, G, 3)
    smax = torch.nn.functional.pad(box_max, (0, 0, 0, pad), value=-inf).reshape(n_sup, G, 3)
    is_pad = smin[:, :, 0] >= 1e16
    gmin = torch.where(is_pad[:, :, None], inf, smin).amin(dim=1)
    gmax = torch.where(is_pad[:, :, None], -inf, smax).amax(dim=1)
    empty = is_pad.all(dim=1)[:, None]
    gmin = torch.where(empty, 1e17, gmin)
    gmax = torch.where(empty, 1e17, gmax)
    return torch.cat([gmin, gmax], dim=1).contiguous()


def sub_blocks(blocks: torch.Tensor, pack: int) -> torch.Tensor:
    """(Kb, 16, C) blocks of ``pack`` sub-clusters each → the (Kb * pack,
    16, C / pack) blocks of the sub-clusters, one per box."""
    if pack == 1:
        return blocks
    Kb, rows, C = blocks.shape
    return (blocks.reshape(Kb, rows, pack, C // pack).permute(0, 2, 1, 3)
            .reshape(Kb * pack, rows, C // pack))


def split_plan(T: int, K: int, gate_g: int = 0, splits: int = None, unit: int = None):
    """(splits, chunk) of a launch over T tiles and K boxes: ``splits=None``
    chooses enough splits that T * splits reaches ``TARGET_BLOCKS``, at most
    one per chunk of max(``unit``, gate_g) boxes (``unit`` defaults to
    ``SPLIT_CHUNK``); 1 keeps one block per tile and 128-box chunks. Any
    explicit count is taken as it is (blocks past K do nothing)."""
    chunk = max(unit or SPLIT_CHUNK, gate_g)
    if splits is None:
        n_chunks = max(1, -(-K // chunk))
        per = -(-n_chunks // min(-(-TARGET_BLOCKS // max(T, 1)), n_chunks))
        splits = -(-n_chunks // per)  # no split left without boxes
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    return (1, CHUNK) if splits == 1 else (splits, chunk)


def plain_fused1(od8, aabb, blocks, sup=None, gate_g: int = 0, pack: int = 1):
    """The kernel's plain PyTorch version: cull, OR the per-ray hit bits over
    each tile, sweep every selected pair. The gate and the early-out do not
    change the output, so the plain version has neither. With ``pack=2``
    the selection is per sub-cluster box, and each selected half of a block
    is swept alone: an unhit half is a miss."""
    _, mask = plain_cull(od8, aabb, with_mask=True)
    K = aabb.shape[1]
    return sweep_selected(od8, sub_blocks(blocks[:K // pack], pack),
                          (mask != 0).any(dim=1))


def _check(od8, aabb, blocks, sup, gate_g, stats, pack):
    check_rays(od8)
    check_boxes(aabb, od8)
    K = aabb.shape[1]
    if blocks.dtype != torch.float32 or blocks.dim() != 3 or blocks.shape[1] != 16:
        raise ValueError(f"blocks must be (K, 16, C) float32, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if pack not in PACKS:
        raise ValueError(f"pack={pack} unsupported (1 or 2)")
    if K % pack or blocks.shape[2] % pack:
        raise ValueError(f"pack={pack} must divide K={K} and C={blocks.shape[2]}")
    if blocks.shape[0] < K // pack:
        raise ValueError(f"{blocks.shape[0]} blocks for {K} boxes at pack={pack}")
    if gate_g < 0 or (gate_g and CHUNK % gate_g):
        raise ValueError(f"gate_g={gate_g} must divide {CHUNK}")
    if gate_g and (sup is None or sup.shape != (-(-K // gate_g), 6)
                   or sup.dtype != torch.float32):
        raise ValueError(f"gate_g={gate_g} needs sup as (ceil(K/gate_g), 6) float32")
    if stats is not None and (stats.dtype != torch.int64 or stats.shape != (3,)):
        raise ValueError("stats must be a (3,) int64 tensor")
    for x in (blocks, sup, stats):
        if x is None:
            continue
        if x.device != od8.device:
            raise ValueError(f"an input lies on {x.device}, rays on {od8.device}")
        if not x.is_contiguous():
            raise ValueError("fused1_closest_hit inputs must be contiguous")


def library() -> build.Built:
    """Build (at first use) and bind ``csrc/fused1.cu``."""
    built = build.load("fused1")
    fn = built.lib.rt_fused1_closest_hit
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
    )
    fn.restype = ctypes.c_int
    built.lib.rt_error_string.argtypes = [ctypes.c_int]
    built.lib.rt_error_string.restype = ctypes.c_char_p
    return built


def fused1_closest_hit(
    od8: torch.Tensor,  # (T, 8, tile) f32 — rays and windows
    aabb: torch.Tensor,  # (8, K) f32 — box table
    blocks: torch.Tensor,  # (>= K / pack, 16, C) f32 — box k's triangles in block k / pack
    sup: torch.Tensor = None,  # (ceil(K / gate_g), 6) f32 super boxes
    gate_g: int = 0,  # boxes per super box; 0 culls every chunk
    stats: torch.Tensor = None,  # (3,) int64 on the card: [0] slab, [1] pairs, [2] MT tests
    pack: int = 1,  # boxes (sub-clusters) per block: 1, or 2 for paired tables
    splits: int = None,  # blocks per tile; None: split_plan's choice
):
    """→ (t (T, tile) float32, tri (T, tile) int32): the closest in-window
    hit of every ray over the boxes its tile hits."""
    global LAUNCHES, LAUNCHES_PACK2
    _check(od8, aabb, blocks, sup, gate_g, stats, pack)
    T, _, tile = od8.shape
    K = aabb.shape[1]
    splits, chunk = split_plan(T, K, gate_g, splits)
    if device_kind(od8, "fused1_closest_hit") == "cpu":
        return plain_fused1(od8, aabb, blocks, sup, gate_g, pack)
    t_out = torch.empty((T, tile), dtype=torch.float32, device=od8.device)
    tri_out = torch.empty((T, tile), dtype=torch.int32, device=od8.device)
    keys = (torch.empty((T, tile), dtype=torch.int64, device=od8.device)
            if splits > 1 else None)
    lib = library().lib
    with torch.cuda.device(od8.device):
        err = lib.rt_fused1_closest_hit(
            od8.data_ptr(), aabb.data_ptr(), sup.data_ptr() if gate_g else None,
            sup.shape[0] if gate_g else 0, gate_g, blocks.data_ptr(), T, K,
            blocks.shape[2], pack, tile, splits, chunk,
            keys.data_ptr() if keys is not None else None, t_out.data_ptr(),
            tri_out.data_ptr(), stats.data_ptr() if stats is not None else None,
            torch.cuda.current_stream(od8.device).cuda_stream,
        )
    raise_on_error(lib, err, "fused1")
    if pack == 1:
        LAUNCHES += 1
    else:
        LAUNCHES_PACK2 += 1
    return t_out, tri_out
