"""Packet (ray-tile) clustered closest hit (counterpart of ``cuda_raytracer_tpu/ops/packet_intersect.py``).

Rays are grouped into tiles of ``tile`` consecutive rays; each tile is
slab-tested against the K cluster boxes, and only the (tile, cluster) pairs
some ray of the tile hits are swept with Möller–Trumbore over the cluster's
(16, C) block (closest hit, eps 0.005, shared sphere/triangle hit-index
space: scene.cu:134-241). Four engines, picked by ``backend``:

- ``"xla"``, the plain reference (phases A-D): tile cull, each tile's
  ``cap`` nearest hit clusters ranked by slab entry, a sweep of the kept
  pairs, a dense reduce. A tile that hits more than ``cap`` clusters drops
  the farthest; the per-tile ``cutoff`` certificate counts every ray whose
  result the drop could have changed (``suspect``).
- ``"fused"``: the cull kernel, then the fused walk + sweep kernel
  (``ops/kernels/cull.py``, ``ops/kernels/fused.py``), exact by
  construction (suspect ≡ 0). ``skip`` enables the slab-entry early-out;
  ``config.cull_hier`` > 0 makes the cull hierarchical (``_cull``: super
  boxes gate the chunks of the gated cull kernel, in one launch).
- ``"fused1"``: the single cull + walk + sweep kernel
  (``ops/kernels/fused1.py``), exact by construction.
- ``"pallas"``: the cull kernel, a cumsum extraction of the culled (tile,
  cluster) pairs into a list of at most ``T * cap`` pairs, and the pair
  sweep kernel (``ops/kernels/sweep.py``). Exact while the pair budget
  holds; past it the certificate makes every ray suspect (all or nothing),
  so ``render_framebuffer``'s cap-doubling retry applies. With
  ``two_round`` it sweeps front to back: each tile's ``ROUND1_NEAREST``
  nearest clusters first, then the rest re-culled against windows tightened
  to the first round's hits. The fused engine has the same two-round
  option (round 1: each tile's nearest cluster).

``"auto"`` is ``"fused"`` on a CUDA device and ``"xla"`` on the CPU; a
render pass of 10 or more rays per pixel takes ``"fused1"`` on a CUDA
device instead (``render/pipeline._regime_scene``). The
kernel engines run their plain versions on CPU tensors (the JAX package's
``*_interpret`` engine names are not taken). Each kernel takes
the whole cluster table in one launch (the TPU package's shards are a VMEM
budget); ``_merge`` folds results over cluster ranges exactly, should a
caller cut the table (in whole blocks: ``block_ranges``).

A paired sub-cluster table (``config.cluster_pack = 2``: K sub-cluster
boxes over K / 2 blocks, ``models/cluster.pack_paired_blocks``) breaks the
one box to one block map every other engine indexes by, so only fused1
takes it: ``"auto"`` means ``"fused1"`` there on every device, and any
other engine raises ``ValueError``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuda_raytracer_tpu_torch.models.scene import Scene, derived
from cuda_raytracer_tpu_torch.ops.intersect import MISS
from cuda_raytracer_tpu_torch.ops.kernels import cull, fused, fused1, sweep
from cuda_raytracer_tpu_torch.ops.traverse import _safe_inv_dir

DEFAULT_TILE = 128
DEFAULT_CAP = 16
DEFAULT_SWEEP_CHUNK = 64
# Ray rows per cull step: bounds the transient (rows, K) slab matrix.
CULL_ROWS = 1 << 13
HIT_THRESH = cull.MISS_ENTRY * 0.5  # a cull entry below it: some ray hits
# The "pallas" engine's round-1 sweep width: nearest clusters per tile by
# slab entry.
ROUND1_NEAREST = 4
BACKENDS = ("auto", "xla", "fused", "fused1", "pallas")


def resolve_backend(backend: str, device: torch.device, pack: int = 1) -> str:
    """``"auto"`` → ``"fused1"`` for a paired table (``pack`` > 1), else
    ``"fused"`` (cull + fused) on CUDA and ``"xla"`` elsewhere; unknown
    names raise ValueError. A render pass of 10 or more rays per pixel has
    already turned "auto" into ``"fused1"`` on CUDA
    (``render/pipeline._regime_scene``), so "fused" is what the sparse
    passes (fewer rays per pixel, the train step) and direct calls get."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown packet backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        if pack > 1:
            return "fused1"
        return "fused" if device.type == "cuda" else "xla"
    return backend


def block_ranges(K: int, shards: int, pack: int = 1):
    """``shards`` contiguous box ranges ``(lo, hi)`` over K boxes, cut at
    whole blocks of ``pack`` boxes, so a block's sub-clusters never split."""
    Kb = K // pack
    return [((Kb * s // shards) * pack, (Kb * (s + 1) // shards) * pack)
            for s in range(shards)]


def _cull_tile_mask(origin, inv_dir, tmax, cmin, cmax, tile: int):
    """Slab-test a ray chunk against every box, reduced per ``tile``-ray
    tile → ((r // tile, K) bool any-hit, (r // tile, K) float32 min entry,
    +inf where unhit). Dead rays carry tmax < 0 and hit nothing."""
    K = cmin.shape[0]
    hit, tmin = cull.slab_window(origin[:, None], inv_dir[:, None], tmax,
                                 cmin[None], cmax[None])
    entry = torch.where(hit, tmin, float("inf")).reshape(-1, tile, K).amin(dim=1)
    return hit.reshape(-1, tile, K).any(dim=1), entry


def _mt_tile_blocks(po, pd, blocks) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense Möller–Trumbore of each tile's rays (g, tile, 3) against its
    cluster block (g, 16, C) → per-ray (best t, first slot reaching it)."""
    o = tuple(po[..., a:a + 1] for a in range(3))
    d = tuple(pd[..., a:a + 1] for a in range(3))
    tri9 = tuple(blocks[:, i, None, :] for i in range(9))
    t = fused.mt_t_plane(o, d, tri9)
    best, slot = torch.min(t, dim=-1)
    return best, slot.to(torch.int32)


def _pad_rays(origin, direction, closest, tile):
    pad = (-origin.shape[0]) % tile
    if not pad:
        return origin, direction, closest
    return (
        torch.nn.functional.pad(origin, (0, 0, 0, pad)),
        torch.nn.functional.pad(direction, (0, 0, 0, pad), value=1.0),
        torch.nn.functional.pad(closest, (0, pad), value=-1.0),
    )


def _merge(out, t_s, tri_s):
    """Fold one shard's (t, tri) into the running result: smaller t wins,
    equal t goes to the larger triangle id (the kernels' own fold)."""
    if out is None:
        return t_s, tri_s
    t_p, tri_p = out
    upd = (t_s < t_p) | ((t_s == t_p) & (tri_s > tri_p))
    return torch.where(upd, t_s, t_p), torch.where(upd, tri_s, tri_p)


def closest_hit_packet(
    scene: Scene,
    origin: torch.Tensor,  # (R, 3)
    direction: torch.Tensor,  # (R, 3)
    closest: torch.Tensor,  # (R,) incoming best (spheres); negative for dead rays
    hit_index: torch.Tensor,  # (R,) int32
    tile: int = DEFAULT_TILE,
    cap: int = DEFAULT_CAP,
    sweep_chunk: int = DEFAULT_SWEEP_CHUNK,
    backend: str = "xla",
    two_round: bool = False,  # fused / pallas: front-to-back two-round sweep
    skip: bool = False,  # fused: slab-entry early-out
):
    """Update (closest, hit_index) with the nearest triangle hit. Returns
    (closest, hit_index, suspect): ``suspect`` counts rays whose result a
    pair budget could have changed (the xla engine's per-tile cap, the
    pallas engine's global budget; 0 for the fused engines)."""
    pack = scene.config.cluster_pack
    backend = resolve_backend(backend, origin.device, pack)
    if pack > 1 and backend != "fused1":
        raise ValueError(f"cluster_pack > 1 requires the fused1 backend, got {backend!r}")
    R = origin.shape[0]
    K = scene.num_clusters
    S = scene.cluster_min.shape[0] // max(K, 1)  # cull_split sub-boxes per cluster
    origin_p, direction_p, closest_p = _pad_rays(origin, direction, closest, tile)
    T = origin_p.shape[0] // tile

    if backend == "pallas":
        return _pallas_engine(scene, origin_p, direction_p, closest_p, closest, hit_index,
                              R, T, tile, cap, S, two_round)
    if backend in ("fused", "fused1"):
        od8 = cull.make_od8(origin_p, direction_p, closest_p, tile)
        t_tile, tri_tile = packet_tiles(scene, od8, backend, two_round, skip)
        return _finalize(scene, t_tile, tri_tile, None, closest, hit_index, R, tile)

    inv_dir = _safe_inv_dir(direction_p)

    # ---- Phase A: tile-level cull mask + entry distances (T, K) -----------
    rows = max(min(CULL_ROWS, origin_p.shape[0]) // tile * tile, tile)
    masks, entries = [], []
    for lo in range(0, origin_p.shape[0], rows):
        m, e = _cull_tile_mask(origin_p[lo:lo + rows], inv_dir[lo:lo + rows],
                               closest_p[lo:lo + rows], scene.cluster_min,
                               scene.cluster_max, tile)
        if S > 1:
            m = m.reshape(-1, K, S).any(dim=2)
            e = e.reshape(-1, K, S).amin(dim=2)
        masks.append(m)
        entries.append(e)
    tile_mask, tile_entry = torch.cat(masks), torch.cat(entries)

    # ---- Phase B: each tile's `cap` nearest hit clusters ------------------
    # Clusters ranked by entry (stable: ties by id). If a tile drops
    # clusters, `cutoff` (its nearest dropped entry) certifies the result
    # per ray: a final hit at t < cutoff cannot live in a dropped cluster.
    counts = tile_mask.sum(dim=1)
    order = torch.argsort(tile_entry, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    entry_sorted = torch.gather(tile_entry, 1, order)
    if cap < K:
        cutoff = torch.where(counts > cap, entry_sorted[:, cap], float("inf"))
    else:
        cutoff = torch.full((T,), float("inf"), device=origin.device)
    keep = tile_mask & (rank < cap)

    # ---- Phase C: sweep the kept pairs, sweep_chunk at a time -------------
    pair_tile, pair_k = torch.nonzero(keep, as_tuple=True)
    o_tiles = origin_p.reshape(T, tile, 3)
    d_tiles = direction_p.reshape(T, tile, 3)
    C = scene.cluster_tris
    bests, tris = [], []
    for lo in range(0, pair_tile.shape[0], sweep_chunk):
        pt = pair_tile[lo:lo + sweep_chunk]
        pc = pair_k[lo:lo + sweep_chunk]
        best, slot = _mt_tile_blocks(o_tiles[pt], d_tiles[pt], scene.cluster_blocks[pc])
        bests.append(best)
        tris.append(scene.cluster_slot_tri[pc[:, None] * C + slot])

    # ---- Phase D: per-tile reduction: min t, larger id among equal t ------
    if bests:
        t_tile, tri_tile = fused.fold_pairs(T, tile, pair_tile, torch.cat(bests),
                                            torch.cat(tris), origin.device)
    else:
        t_tile = torch.full((T, tile), MISS, dtype=torch.float32, device=origin.device)
        tri_tile = torch.full((T, tile), -1, dtype=torch.int32, device=origin.device)
    return _finalize(scene, t_tile, tri_tile, cutoff, closest, hit_index, R, tile)


def packet_tiles(scene: Scene, od8: torch.Tensor, backend: str, two_round: bool = False,
                 skip: bool = False):
    """The fused or fused1 engine on (T, 8, tile) ray tiles (``cull.make_od8``,
    or the set-up kernel's, ``rays.rays_setup``) → each ray's raw (t, tri) as
    (T, tile), (``MISS``, -1) where no triangle lies inside its window; the
    caller folds them over its sphere hits (``_finalize``)."""
    pack = scene.config.cluster_pack
    if pack > 1 and backend != "fused1":
        raise ValueError(f"cluster_pack > 1 requires the fused1 backend, got {backend!r}")
    K = scene.num_clusters
    S = scene.cluster_min.shape[0] // max(K, 1)  # cull_split sub-boxes per cluster
    if backend == "fused1":
        if S != 1:
            raise ValueError("fused1 backend requires cull_split == 1")
        # cull_hier == 0 means G = 16 here; negative forces the flat cull.
        G = scene.config.cull_hier or 16
        G = max(G, 0)
        if G and fused1.CHUNK % G:
            raise ValueError(f"cull_hier={G} must divide {fused1.CHUNK}")
        gate = G if (G and K > fused1.CHUNK) else 0
        # The supers stay over sub-cluster boxes; a paired table has
        # K / pack blocks.
        return fused1.fused1_closest_hit(
            od8, box_table(scene), scene.cluster_blocks[:K // pack].contiguous(),
            sup=super_table(scene, gate) if gate else None, gate_g=gate, pack=pack,
        )
    blocks = scene.cluster_blocks[:K].contiguous()

    def fused_sweep(select, entry, maskw):
        return fused.fused_closest_hit(
            od8, blocks, fused.pack_words(select),
            entry=entry.contiguous() if skip else None,
            hitmask=maskw.contiguous() if skip else None,
        )

    entry, maskw = _block_cull(scene, od8, S, skip)
    hit = entry < HIT_THRESH
    if not two_round or K <= 1:
        return fused_sweep(hit, entry, maskw)
    # Front to back: round 1 sweeps each tile's nearest-entry cluster(s);
    # round 2 re-culls with each ray's window tightened to its round-1 hit (a
    # box whose [0, t_best] slab misses cannot hold a closer hit) and sweeps
    # the rest.
    sel1 = hit & (entry <= entry.amin(dim=1, keepdim=True))
    t1, tri1 = fused_sweep(sel1, entry, maskw)
    window2 = od8.clone()
    window2[:, 6] = torch.minimum(od8[:, 6], t1)
    entry2, maskw2 = _block_cull(scene, window2, S, skip)
    t2, tri2 = fused_sweep((entry2 < HIT_THRESH) & ~sel1, entry2, maskw2)
    return _merge((t1, tri1), t2, tri2)


def box_table(scene: Scene) -> torch.Tensor:
    """The (8, K * S) box table of the scene's cluster (sub-)boxes, built
    once per scene (``models.scene.derived``)."""
    box_min, box_max = scene.cluster_min, scene.cluster_max
    return derived(("box_table",), (box_min, box_max),
                   lambda: cull.box_table(box_min, box_max))


def super_table(scene: Scene, gate: int) -> torch.Tensor:
    """fused1's (ceil(K / gate), 6) super boxes over ``gate`` consecutive
    cluster boxes, built once per scene and gate."""
    box_min, box_max = scene.cluster_min, scene.cluster_max
    return derived(("super_table", gate), (box_min, box_max),
                   lambda: fused1.shard_supers(box_min, box_max, gate))


def _block_cull(scene: Scene, od8: torch.Tensor, S: int, with_mask: bool):
    """``_cull`` reduced from sub-boxes to clusters → ((T, K) entry, the
    (T, W, K) hit words or None): min entry, OR of the bits."""
    entry, maskw = _cull(scene, od8, S, with_mask)
    if S > 1:
        T, K = entry.shape[0], entry.shape[1] // S
        entry = entry.reshape(T, K, S).amin(dim=2)
        if maskw is not None:
            m = maskw.reshape(T, maskw.shape[1], K, S)
            maskw = m[..., 0]
            for s in range(1, S):
                maskw = maskw | m[..., s]
    return entry, maskw


def extract_pairs(select: torch.Tensor, P: int):
    """(T, K) bool pair selection → the pair list of the sweep, in
    row-major (tile-major) order, without a host sync: (pairs (2, P) int32
    ``[tile; cluster]`` with (T, 0) sentinels past the selected count,
    min(count, P) as one int32, the count of pairs dropped past the budget
    ``P``)."""
    T, K = select.shape
    flat = select.reshape(-1)
    dest = torch.cumsum(flat, dim=0) - 1
    total = flat.sum()
    overflow = torch.clamp_min(total - P, 0)
    # Unselected and over-budget pairs all land in the extra slot P.
    dest = torch.where(flat & (dest < P), dest, P)
    pair_flat = torch.full((P + 1,), T * K, dtype=torch.int64, device=select.device)
    pair_flat[dest] = torch.arange(T * K, device=select.device)
    pair_flat = pair_flat[:P]
    pairs = torch.stack([pair_flat // K, pair_flat % K]).to(torch.int32).contiguous()
    return pairs, torch.clamp_max(total, P).to(torch.int32), overflow


def _pallas_engine(scene, origin_p, direction_p, closest_p, closest, hit_index,
                   R, T, tile, cap, S, two_round):
    """The cull kernel, the pair extraction and the pair sweep kernel, one
    or two rounds → (closest, hit_index, suspect)."""
    K = scene.num_clusters
    P = T * cap
    rays = sweep.make_rays_tiles(origin_p, direction_p, tile)
    blocks = scene.cluster_blocks.contiguous()

    def extract_and_sweep(select):
        pairs, total, overflow = extract_pairs(select, P)
        t_tile, tri_tile = sweep.sweep_pairs(rays, blocks, pairs, total, tile)
        return t_tile[:T], tri_tile[:T], overflow

    def block_entry(window):
        return _block_cull(scene, cull.make_od8(origin_p, direction_p, window, tile),
                           S, False)[0]

    entry = block_entry(closest_p)
    hit = entry < HIT_THRESH
    if not two_round or K <= ROUND1_NEAREST:
        t_tile, tri_tile, overflow = extract_and_sweep(hit)
    else:
        # Front to back: round 1 sweeps each tile's ROUND1_NEAREST nearest
        # clusters by slab entry; round 2 re-culls with the windows
        # tightened to round 1's hits and sweeps what is left.
        nth = torch.kthvalue(entry, ROUND1_NEAREST, dim=1, keepdim=True).values
        sel1 = hit & (entry <= nth)
        t1, tri1, ovf1 = extract_and_sweep(sel1)
        entry2 = block_entry(torch.minimum(closest_p.reshape(T, tile), t1).reshape(-1))
        t2, tri2, ovf2 = extract_and_sweep((entry2 < HIT_THRESH) & ~sel1)
        t_tile, tri_tile = _merge((t1, tri1), t2, tri2)
        overflow = ovf1 + ovf2
    # All or nothing: a dropped pair may hide any ray's hit.
    cutoff = torch.where(overflow > 0, float("-inf"), float("inf")).expand(T)
    return _finalize(scene, t_tile, tri_tile, cutoff, closest, hit_index, R, tile)


def _cull(scene: Scene, od8: torch.Tensor, S: int, with_mask: bool):
    """The fused engine's cull over the (K * S) sub-boxes → (T, K * S) entry
    and, with ``with_mask``, (T, W, K * S) per-ray hit words (else None).

    With ``config.cull_hier`` = G > 0 and at least two gate chunks of boxes,
    the cull is hierarchical: tight super boxes, one per G * S consecutive
    sub-boxes (the cluster cut's order keeps BVH siblings adjacent), gate the
    128-box chunks of the main cull, which tests a tile against only the
    chunks one of its super boxes is hit in; the gated kernel tests the
    supers itself (``cull.cull_tiles_hier``), so it is one launch. A sub-box
    hit implies its super box's, so the result is bit-equal to the flat
    cull's."""
    box_min, box_max = scene.cluster_min, scene.cluster_max
    KS = box_min.shape[0]
    G = scene.config.cull_hier
    if not (G > 0 and KS >= 2 * cull.GATE_CHUNK):
        aabb = box_table(scene)
        if with_mask:
            return cull.cull_tiles(od8, aabb, with_mask=True)
        return cull.cull_tiles(od8, aabb), None
    aabb_p, sup_aabb = derived(("hier_tables", G * S), (box_min, box_max),
                               lambda: hier_tables(box_min, box_max, G * S))
    out = cull.cull_tiles_hier(od8, aabb_p, sup_aabb, with_mask=with_mask)
    if with_mask:
        return out[0][:, :KS], out[1][:, :, :KS]
    return out[:, :KS], None


def hier_tables(box_min: torch.Tensor, box_max: torch.Tensor, group: int):
    """(KS, 3) boxes → the (8, Kp) box table padded to whole gate chunks
    with far point boxes at 1e17 (which no ray hits), and the (8, Kp /
    group) table of tight super boxes over ``group`` consecutive boxes
    (padding left out; an all-padding group keeps the far point box)."""
    if group <= 0 or cull.GATE_CHUNK % group:
        raise ValueError(f"cull_hier*cull_split = {group} must divide {cull.GATE_CHUNK}")
    KS = box_min.shape[0]
    Kp = -(-KS // cull.GATE_CHUNK) * cull.GATE_CHUNK
    far = torch.full((Kp - KS, 3), 1e17, dtype=torch.float32, device=box_min.device)
    box_min, box_max = torch.cat([box_min, far]), torch.cat([box_max, far])
    sup = fused1.shard_supers(box_min, box_max, group)
    return cull.box_table(box_min, box_max), cull.box_table(sup[:, :3], sup[:, 3:])


def hier_gates(od8: torch.Tensor, sup_aabb: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """The super-box pre-pass as its own ops (the JAX package's form): a flat
    cull of the super boxes (``cull.cull_tiles``) → the (T * Wg,) int32 gate
    words of ``cull.cull_tiles_gated``, bit i of tile t's words set when some
    ray of the tile hits a super box of chunk i."""
    T = od8.shape[0]
    hit = cull.cull_tiles(od8, sup_aabb) < cull.MISS_ENTRY * 0.5
    return cull.pack_bits(hit.reshape(T, n_chunks, -1).any(dim=2)[:, :, None]).reshape(-1)


def _finalize(scene, t_tile, tri_tile, cutoff, closest, hit_index, R, tile):
    t_ray = t_tile.reshape(-1)[:R]
    tri_ray = tri_tile.reshape(-1)[:R]
    better = (t_ray < closest) & (tri_ray >= 0)
    new_closest = torch.where(better, t_ray, closest)
    new_index = torch.where(better, scene.sphere_count + tri_ray, hit_index)
    if cutoff is None:  # the kernels sweep every culled pair: exact
        return new_closest, new_index, 0
    # Exactness certificate: a ray is suspect if its final closest hit is at
    # or beyond its tile's nearest dropped cluster (`>=`: an equal-t hit
    # there could win the tie).
    cutoff_ray = cutoff.repeat_interleave(tile)[:R]
    return new_closest, new_index, (new_closest >= cutoff_ray).sum()
