"""Packet-intersector tile cull: wrapper of ``csrc/cull.cu``.

Counterpart of ``cuda_raytracer_tpu/ops/pallas/cull.py`` (``cull_tiles``,
``cull_tiles_gated``), and of the JAX package's hierarchical cull
(``packet_intersect._cull`` with ``cull_hier``: a super-box pre-pass, then the
gated kernel) as the one launch ``cull_tiles_hier``. ``cull_tiles``
slab-tests every ray tile against every cluster box with the windowed
Tavian test and returns the (T, K) tile-min
entry distance (``MISS_ENTRY`` where no ray of the tile hits) and, with
``with_mask``, the (T, W, K) per-ray hit bits (bit r of word w: ray 32 w + r
hits). ``cull_tiles_gated`` does the same over a table padded to whole
``GATE_CHUNK``-box chunks, but tests chunk i of tile t only when its gate bit
is set (bit i % 32 of word ``t * Wg + i // 32``); a gated-off chunk reads
``MISS_ENTRY`` and zero words, which is what the flat cull gives for a chunk
no ray hits, so a conservative gate leaves the output bit-equal.
``cull_tiles_hier`` is the gated cull with each chunk's gate computed in the
kernel: set when some ray of the tile slab-hits one of the chunk's super
boxes (tight boxes over consecutive boxes, so a box hit implies its super's).

Ray layout (``make_od8``): (T, 8, tile) float32 component rows
``[ox oy oz dx dy dz window 0]``, the per-ray search window in row 6. Dead
and padded rays carry a negative window and hit no box.

- On a CUDA tensor each launches its hand-written kernel and counts the
  launch (``LAUNCHES``; ``LAUNCHES_GATED`` for both gated forms). None falls
  back.
- On a CPU tensor they run ``plain_cull``, ``plain_cull_gated`` and
  ``plain_cull_hier``, the same expression tree in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_raytracer_tpu_torch.ops.kernels import build
from cuda_raytracer_tpu_torch.ops.traverse import _safe_inv_dir

MISS_ENTRY = 1e30
# Boxes per gated chunk of cull_tiles_gated: the kernel's chunk (rt::kChunk).
GATE_CHUNK = 128
# Rays per step of the plain version: bounds its (rays, K) slab matrices.
PLAIN_ROWS = 1 << 13

# Kernel launches made by cull_tiles, and by cull_tiles_gated and
# cull_tiles_hier, in this process (CUDA tensors only).
LAUNCHES = 0
LAUNCHES_GATED = 0


def make_od8(
    origin: torch.Tensor, direction: torch.Tensor, window: torch.Tensor, tile: int
) -> torch.Tensor:
    """(R, 3), (R, 3), (R,) with R a multiple of ``tile`` → (T, 8, tile)
    component-row tiles ``[ox oy oz dx dy dz window 0]``."""
    T = origin.shape[0] // tile
    comps = [
        origin[:, 0], origin[:, 1], origin[:, 2],
        direction[:, 0], direction[:, 1], direction[:, 2],
        window, torch.zeros_like(window),
    ]
    return torch.stack([c.reshape(T, tile) for c in comps], dim=1).contiguous()


def box_table(box_min: torch.Tensor, box_max: torch.Tensor) -> torch.Tensor:
    """(K, 3) min and max corners → the (8, K) table ``[min xyz, max xyz, 0, 0]``."""
    zeros = torch.zeros((2, box_min.shape[0]), dtype=torch.float32, device=box_min.device)
    return torch.cat([box_min.T, box_max.T, zeros]).contiguous()


def slab_window(origin, inv_dir, window, box_min, box_max):
    """Windowed Tavian slab test, broadcasting rays (n, 1, 3) against boxes
    (1, K, 3) → (hit (n, K), tmin (n, K)). The running window starts at
    [0, window] and narrows axis by axis (reference ray_aabb_intersection,
    scene.cu:107-132)."""
    tmin = torch.zeros(torch.broadcast_shapes(origin.shape, box_min.shape)[:-1],
                       dtype=torch.float32, device=origin.device)
    tmax = torch.broadcast_to(window[:, None], tmin.shape)
    for a in range(3):
        t1 = (box_min[..., a] - origin[..., a]) * inv_dir[..., a]
        t2 = (box_max[..., a] - origin[..., a]) * inv_dir[..., a]
        tmin = torch.minimum(torch.maximum(t1, tmin), torch.maximum(t2, tmin))
        tmax = torch.maximum(torch.minimum(t1, tmax), torch.minimum(t2, tmax))
    return tmin <= tmax, tmin


def pack_bits(hit: torch.Tensor) -> torch.Tensor:
    """(..., n, K) bool over n rays → (..., ceil(n / 32), K) int32 words, bit
    r of word w set iff ray 32 w + r hits."""
    n = hit.shape[-2]
    words = -(-n // 32)
    pad = words * 32 - n
    if pad:
        hit = torch.nn.functional.pad(hit, (0, 0, 0, pad))
    shifts = torch.arange(32, dtype=torch.int64, device=hit.device)[:, None]
    bits = hit.reshape(hit.shape[:-2] + (words, 32, hit.shape[-1])).to(torch.int64)
    packed = (bits << shifts).sum(dim=-2)
    return torch.where(packed >= 1 << 31, packed - (1 << 32), packed).to(torch.int32)


def plain_cull(od8: torch.Tensor, aabb: torch.Tensor, with_mask: bool = False):
    """The kernel's plain PyTorch version, same inputs and outputs."""
    T, _, tile = od8.shape
    K = aabb.shape[1]
    box_min = aabb[0:3].T[None]
    box_max = aabb[3:6].T[None]
    step = max(1, PLAIN_ROWS // tile)
    entries, masks = [], []
    for lo in range(0, T, step):
        rows = od8[lo:lo + step]
        n = rows.shape[0]
        origin = rows[:, 0:3].permute(0, 2, 1).reshape(-1, 3)
        direction = rows[:, 3:6].permute(0, 2, 1).reshape(-1, 3)
        window = rows[:, 6].reshape(-1)
        hit, tmin = slab_window(origin[:, None], _safe_inv_dir(direction)[:, None],
                                window, box_min, box_max)
        entry = torch.where(hit, tmin, MISS_ENTRY).reshape(n, tile, K).amin(dim=1)
        entries.append(entry)
        if with_mask:
            masks.append(pack_bits(hit.reshape(n, tile, K)))
    entry = torch.cat(entries) if entries else torch.empty((0, K), device=od8.device)
    if not with_mask:
        return entry
    W = -(-tile // 32)
    mask = (torch.cat(masks) if masks
            else torch.empty((0, W, K), dtype=torch.int32, device=od8.device))
    return entry, mask


def gate_words(n_chunks: int) -> int:
    """Gate words per tile (Wg) for a table of ``n_chunks`` chunks."""
    return -(-n_chunks // 32)


def unpack_gates(gates: torch.Tensor, T: int, n_chunks: int) -> torch.Tensor:
    """(T * Wg,) int32 gate words → (T, n_chunks) bool, read as unsigned so
    a set bit 31 is just bit 31."""
    words = (gates.reshape(T, gate_words(n_chunks)).to(torch.int64) & 0xFFFFFFFF)[:, :, None]
    shifts = torch.arange(32, dtype=torch.int64, device=gates.device)
    return ((words >> shifts) & 1).reshape(T, -1)[:, :n_chunks] != 0


def plain_cull_gated(od8: torch.Tensor, aabb: torch.Tensor, gates: torch.Tensor,
                     with_mask: bool = False):
    """The gated kernel's plain PyTorch version: the plain cull of each
    chunk over the tiles whose gate bit is set, ``MISS_ENTRY`` and zero
    words elsewhere."""
    T, _, tile = od8.shape
    Kp = aabb.shape[1]
    n_chunks = Kp // GATE_CHUNK
    live = unpack_gates(gates, T, n_chunks)
    entry = torch.full((T, Kp), MISS_ENTRY, dtype=torch.float32, device=od8.device)
    mask = torch.zeros((T, -(-tile // 32), Kp), dtype=torch.int32, device=od8.device)
    for i in range(n_chunks):
        tiles = torch.nonzero(live[:, i]).reshape(-1)
        if tiles.numel() == 0:
            continue
        cols = slice(i * GATE_CHUNK, (i + 1) * GATE_CHUNK)
        e, m = plain_cull(od8[tiles], aabb[:, cols].contiguous(), with_mask=True)
        entry[tiles, cols] = e
        mask[tiles, :, cols] = m
    return (entry, mask) if with_mask else entry


def plain_cull_hier(od8: torch.Tensor, aabb: torch.Tensor, sup: torch.Tensor,
                    with_mask: bool = False):
    """The one-launch hierarchical cull's plain version: the plain gated cull
    behind the plain super-box pre-pass (bit i of tile t's gate words set
    when some ray of the tile hits one of chunk i's super boxes of the
    (8, n_sup) table ``sup``)."""
    T = od8.shape[0]
    n_chunks = aabb.shape[1] // GATE_CHUNK
    hit = plain_cull(od8, sup) < MISS_ENTRY * 0.5
    gates = pack_bits(hit.reshape(T, n_chunks, -1).any(dim=2)[:, :, None]).reshape(-1)
    return plain_cull_gated(od8, aabb, gates, with_mask)


def check_rays(od8: torch.Tensor) -> None:
    if od8.dtype != torch.float32 or od8.dim() != 3 or od8.shape[1] != 8:
        raise ValueError(f"od8 must be (T, 8, tile) float32, got {od8.dtype} "
                         f"{tuple(od8.shape)}")
    if not 1 <= od8.shape[2] <= 1024:
        raise ValueError(f"tile must be 1..1024 rays, got {od8.shape[2]}")
    if not od8.is_contiguous():
        raise ValueError("od8 must be contiguous")


def check_boxes(aabb: torch.Tensor, od8: torch.Tensor) -> None:
    if aabb.dtype != torch.float32 or aabb.dim() != 2 or aabb.shape[0] != 8:
        raise ValueError(f"aabb must be (8, K) float32, got {aabb.dtype} "
                         f"{tuple(aabb.shape)}")
    if not aabb.is_contiguous():
        raise ValueError("aabb must be contiguous")
    if aabb.device != od8.device:
        raise ValueError(f"aabb on {aabb.device}, rays on {od8.device}")


def device_kind(x: torch.Tensor, name: str) -> str:
    """"cpu" (run the plain version) or "cuda" (launch); anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or the CPU, not {x.device}")
    return x.device.type


def raise_on_error(lib, err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: {lib.rt_error_string(err).decode()}")


def library() -> build.Built:
    """Build (at first use) and bind ``csrc/cull.cu``."""
    built = build.load("cull")
    fn = built.lib.rt_cull_tiles
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = built.lib.rt_cull_tiles_gated
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    built.lib.rt_error_string.argtypes = [ctypes.c_int]
    built.lib.rt_error_string.restype = ctypes.c_char_p
    return built


def cull_tiles(od8: torch.Tensor, aabb: torch.Tensor, with_mask: bool = False):
    """→ (T, K) float32 tile-min slab entry, ``MISS_ENTRY`` where no ray of
    the tile hits; with ``with_mask``, (entry, (T, ceil(tile / 32), K)
    int32 per-ray hit bits)."""
    global LAUNCHES
    check_rays(od8)
    check_boxes(aabb, od8)
    if device_kind(od8, "cull_tiles") == "cpu":
        return plain_cull(od8, aabb, with_mask)
    T, _, tile = od8.shape
    K = aabb.shape[1]
    entry = torch.empty((T, K), dtype=torch.float32, device=od8.device)
    mask = (torch.empty((T, -(-tile // 32), K), dtype=torch.int32, device=od8.device)
            if with_mask else None)
    lib = library().lib
    with torch.cuda.device(od8.device):
        err = lib.rt_cull_tiles(
            od8.data_ptr(), aabb.data_ptr(), entry.data_ptr(),
            mask.data_ptr() if with_mask else None, T, K, tile,
            torch.cuda.current_stream(od8.device).cuda_stream,
        )
    raise_on_error(lib, err, "cull")
    LAUNCHES += 1
    return (entry, mask) if with_mask else entry


def _chunks(aabb: torch.Tensor) -> int:
    Kp = aabb.shape[1]
    if Kp % GATE_CHUNK:
        raise ValueError(f"gated cull table width {Kp} % {GATE_CHUNK} != 0")
    return Kp // GATE_CHUNK


def _launch_gated(od8, aabb, gates, sup, with_mask):
    """One launch of the gated kernel, its gate read from ``gates`` or (gates
    None) computed from ``sup``."""
    global LAUNCHES_GATED
    T, _, tile = od8.shape
    Kp = aabb.shape[1]
    entry = torch.empty((T, Kp), dtype=torch.float32, device=od8.device)
    mask = (torch.empty((T, -(-tile // 32), Kp), dtype=torch.int32, device=od8.device)
            if with_mask else None)
    lib = library().lib
    with torch.cuda.device(od8.device):
        err = lib.rt_cull_tiles_gated(
            od8.data_ptr(), aabb.data_ptr(), None if gates is None else gates.data_ptr(),
            None if sup is None else sup.data_ptr(), 0 if sup is None else sup.shape[1],
            entry.data_ptr(), mask.data_ptr() if with_mask else None, T, Kp, tile,
            torch.cuda.current_stream(od8.device).cuda_stream,
        )
    raise_on_error(lib, err, "cull_gated")
    LAUNCHES_GATED += 1
    return (entry, mask) if with_mask else entry


def cull_tiles_gated(od8: torch.Tensor, aabb: torch.Tensor, gates: torch.Tensor,
                     with_mask: bool = False):
    """The cull over a (8, Kp) table, Kp a multiple of ``GATE_CHUNK``, with
    chunk i of tile t tested only when bit i % 32 of ``gates[t * Wg + i //
    32]`` is set (gates (T * Wg,) int32, Wg = ceil(Kp / GATE_CHUNK / 32)) →
    (T, Kp) entry, and with ``with_mask`` (entry, (T, ceil(tile / 32), Kp)
    words); gated-off chunks read ``MISS_ENTRY`` and zero words."""
    check_rays(od8)
    check_boxes(aabb, od8)
    T = od8.shape[0]
    Wg = gate_words(_chunks(aabb))
    if gates.dtype != torch.int32 or gates.shape != (T * Wg,):
        raise ValueError(f"gates must be flat (T * Wg,) = ({T} * {Wg},) int32 words, got "
                         f"{gates.dtype} {tuple(gates.shape)}")
    if gates.device != od8.device or not gates.is_contiguous():
        raise ValueError(f"gates must be contiguous on {od8.device}")
    if device_kind(od8, "cull_tiles_gated") == "cpu":
        return plain_cull_gated(od8, aabb, gates, with_mask)
    return _launch_gated(od8, aabb, gates, None, with_mask)


def cull_tiles_hier(od8: torch.Tensor, aabb: torch.Tensor, sup: torch.Tensor,
                    with_mask: bool = False):
    """The hierarchical cull in one launch: ``cull_tiles_gated`` over the (8,
    Kp) table with each chunk's gate set when some ray of the tile hits one
    of its super boxes, ``sup`` an (8, n_sup) box table of n_sup / (Kp /
    GATE_CHUNK) supers a chunk, each over consecutive boxes of its chunk (a
    box's hit must imply its super's: ``packet_intersect.hier_tables``)."""
    check_rays(od8)
    check_boxes(aabb, od8)
    check_boxes(sup, od8)
    n_chunks = _chunks(aabb)
    if sup.shape[1] == 0 or sup.shape[1] % n_chunks:
        raise ValueError(f"{sup.shape[1]} super boxes do not split evenly over "
                         f"{n_chunks} chunks")
    if device_kind(od8, "cull_tiles_hier") == "cpu":
        return plain_cull_hier(od8, aabb, sup, with_mask)
    return _launch_gated(od8, aabb, None, sup, with_mask)
