"""The mesh wavefront's per-ray set-up, sort-key and draw kernels: wrappers of ``csrc/rays.cu``.

The forward mesh bounce (``render/packed.trace_packed``) holds its
wavefront as one (R, 16) float32 buffer of rows ``[origin direction
transmitted collected ray_id pad]`` (``wavefront.pack_rows``). Around its
closest-hit and shading kernels it used to issue a few dozen torch ops a
bounce; these kernels take their place (the cullhit key joins them for
``sort_key="cullhit"``):

- ``rays_setup``: each row's alive bit, its closest sphere hit with ``t =
  -1`` on a dead ray (``wavefront.closest_hit``'s sphere part; JAX
  ``render/wavefront.py`` ``closest_hit``) and, for the packet kernels, the
  (T, 8, tile) ray tiles (``packet_intersect._pad_rays`` + ``cull.make_od8``;
  JAX ``ops/pallas/cull.py``'s ray tiles); given a ``live`` counter, the
  live rows added to it (``utils/metrics``' ``rays.live``), and to a second,
  ``tail``, where given too (``rays.live_tail``).
- ``ray_keys``: each row's Morton sort key (``morton.ray_sort_keys``; JAX
  ``ops/morton.py`` ``ray_sort_keys``), the "count" engine's clamped bucket
  where asked, its sort chunk's index in the high 32 bits (one flat stable
  sort then orders each chunk on its own), and the live count as one int32.
- ``cullhit_keys``: the same for the packet scenes' "cullhit" key, each
  row's first two distinct slab-hit cluster ids (``morton.first2_cluster_keys``;
  JAX ``ops/morton.py`` ``first2_cluster_keys``).
- ``pcg_draws``: each ray's first raw PCG draws, (n, R) int64 holding
  uint32, its stream seeded with ``ray_id * ray_mult + seed_add`` mod 2^32
  (``rng.uniforms``; JAX ``ops/rng.py`` ``uniforms``): the camera's jitter
  of a trace that builds a graph (``camera.generate_rays``, two) and the
  training shading's five draws a bounce (``bounce_draws``:
  ``rng.uniforms(bounce_seeds(...), 5)``).
- ``camera_rows``: a forward trace's packed starting rows, the camera rays
  ``[ray_lo, ray_lo + n)`` of a block at full throughput (``pack_rows`` of
  ``wavefront.make_initial_state``; JAX ``ops/camera.py`` ``generate_rays``
  and ``render/wavefront.py`` ``make_initial_state``), the jitter's draws
  folded in. It reads the camera as 14 words on the device
  (``camera_words``, built once per camera).
- ``reorder_rows``: the reorder's row move, ``spare[i] = cur[order[i]]`` on
  the sorted prefix and ``spare[i] = cur[i]`` on the settled suffix after it
  (``torch.index_select`` and a slice copy, its plain version), in one
  launch; four lanes a row, while recording its rows count as
  ``reorder.rows``.

Each but the row move is one thread per ray, and each counts its launches
(``LAUNCHES_SETUP``, ``LAUNCHES_KEYS``, ``LAUNCHES_CULLHIT``,
``LAUNCHES_DRAWS``, ``LAUNCHES_CAMERA``, ``LAUNCHES_REORDER``). On a CUDA
tensor it launches its kernel or raises; on a CPU tensor it runs its plain
PyTorch version, with the same outputs bit for bit.

The two key kernels write the live count themselves, through two words of
scratch per device and stream (``live_scratch``) that every launch leaves
zero, so no memset precedes them. The cullhit key reads the scene's box
table in the kernel's layout with a gate (super-box) over each
``CULLHIT_GATE`` boxes (``cullhit_tables``), built once per scene.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cuda_raytracer_tpu_torch.models.scene import derived
from cuda_raytracer_tpu_torch.ops import intersect, morton, rng
from cuda_raytracer_tpu_torch.ops.kernels import build
from cuda_raytracer_tpu_torch.ops.kernels.cull import device_kind, make_od8, raise_on_error
from cuda_raytracer_tpu_torch.utils import metrics as recording

ROW_WORDS = 16  # a packed wavefront row (rt::kRowWords)
COUNT_BUCKET_SHIFT = 23  # the count engine: the key's top bits (rt::kCountShift)
COUNT_BUCKETS = 256  # ... bucket 255 for dead rays, live ones clamped to 254
CHUNK_SHIFT = 32  # the sort chunk's index sits above the 32-bit key
CULLHIT_GATE = 32  # box rows a gate of the cullhit key covers (rt::kGate)
BOX_WORDS = 8  # a row of the cullhit key's box and gate tables (rt::kBoxWords)

# Kernel launches made in this process (CUDA tensors only).
LAUNCHES_SETUP = 0
LAUNCHES_KEYS = 0
LAUNCHES_CULLHIT = 0
LAUNCHES_DRAWS = 0
LAUNCHES_CAMERA = 0
LAUNCHES_REORDER = 0


def rows_alive(rows: torch.Tensor) -> torch.Tensor:
    """(n,) bool: a row is alive while its transmitted weight is nonzero."""
    return torch.any(rows[:, 6:9] != 0.0, dim=-1)


def _check_rows(rows: torch.Tensor) -> None:
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != ROW_WORDS:
        raise ValueError(f"rows must be (n, {ROW_WORDS}) float32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("rows must be contiguous and 16-byte aligned")


def library() -> build.Built:
    """Build (at first use) and bind ``csrc/rays.cu``."""
    built = build.load("rays")
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    built.lib.rt_rays_setup.argtypes = [p, i, i, i, p, p, i, p, p, p, p, p, p, p]
    built.lib.rt_ray_keys.argtypes = [p, i, p, p, i, i, p, p, p, p]
    built.lib.rt_cullhit_keys.argtypes = [p, i, p, p, i, i, i, i, i, i, p, p, p, p, p]
    built.lib.rt_pcg_draws.argtypes = [p, i, u, u, i, p, p]
    built.lib.rt_camera_rows.argtypes = [p, i, i, i, i, u, p, p]
    built.lib.rt_reorder_rows.argtypes = [p, p, i, i, i, p, p]
    for name in ("rt_rays_setup", "rt_ray_keys", "rt_cullhit_keys", "rt_pcg_draws",
                 "rt_camera_rows", "rt_reorder_rows"):
        getattr(built.lib, name).restype = ctypes.c_int
    built.lib.rt_error_string.argtypes = [ctypes.c_int]
    built.lib.rt_error_string.restype = ctypes.c_char_p
    return built


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# (device index, stream) → the two uint32 words of the key kernels' live
# count on that stream (held as int32).
_LIVE_SCRATCH = {}


def live_scratch(x: torch.Tensor) -> torch.Tensor:
    """The key kernels' scratch for launches on ``x``'s device and current
    stream: zeroed once, left zero by every launch (its last block resets
    it). Launches on one stream run in order, so they never share it
    concurrently; another stream gets its own."""
    key = (x.device.index, _stream(x))
    scratch = _LIVE_SCRATCH.get(key)
    if scratch is None:
        scratch = _LIVE_SCRATCH[key] = torch.zeros(2, dtype=torch.int32, device=x.device)
    return scratch


# ---- rays_setup ------------------------------------------------------------


def plain_rays_setup(rows: torch.Tensor, sphere_center: torch.Tensor,
                     sphere_radius: torch.Tensor, tile: int = 0, live: torch.Tensor = None,
                     tail: torch.Tensor = None):
    """The set-up kernel's plain PyTorch version → (alive, t, index, od8):
    the torch code of the port's closest hit (alive mask,
    ``intersect_spheres``, ``t = -1`` where dead, ``_pad_rays`` +
    ``make_od8``); ``od8`` is None when ``tile`` is 0. The live rows are
    added to ``live`` when given, and then to ``tail`` when given."""
    origin, direction = rows[:, 0:3], rows[:, 3:6]
    alive = rows_alive(rows)
    if live is not None:
        n_live = alive.sum()
        live += n_live
        if tail is not None:
            tail += n_live
    t, index = intersect.intersect_spheres(origin, direction, sphere_center, sphere_radius)
    t = torch.where(alive, t, -1.0)
    od8 = None
    if tile:
        pad = (-rows.shape[0]) % tile
        od8 = make_od8(torch.nn.functional.pad(origin, (0, 0, 0, pad)),
                       torch.nn.functional.pad(direction, (0, 0, 0, pad), value=1.0),
                       torch.nn.functional.pad(t, (0, pad), value=-1.0), tile)
    return alive, t, index, od8


def setup_args(rows, sphere_center, sphere_radius, tile, alive, t, index, od8,
               live=None, tail=None) -> list:
    """The arguments of ``rt_rays_setup`` (and of its host build), without the stream."""
    n = rows.shape[0]
    total = od8.shape[0] * tile if od8 is not None else n
    return [rows.data_ptr(), n, max(tile, 1), total, sphere_center.data_ptr(),
            sphere_radius.data_ptr(), sphere_center.shape[0], alive.data_ptr(),
            t.data_ptr(), index.data_ptr(), od8.data_ptr() if od8 is not None else None,
            live.data_ptr() if live is not None else None,
            tail.data_ptr() if tail is not None else None]


def setup_outputs(rows: torch.Tensor, tile: int):
    """Empty (alive, t, index, od8) for ``n`` rows (od8 None without a tile)."""
    n, dev = rows.shape[0], rows.device
    od8 = (torch.empty((-(-n // tile), 8, tile), dtype=torch.float32, device=dev)
           if tile else None)
    return (torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev), od8)


def rays_setup(rows: torch.Tensor, sphere_center: torch.Tensor, sphere_radius: torch.Tensor,
               tile: int = 0, live: torch.Tensor = None, tail: torch.Tensor = None):
    """(n, 16) packed rows → (alive (n,) bool, t (n,) float32 with -1 on dead
    rays, sphere index (n,) int32 with -1 on a miss, and with ``tile`` > 0 the
    (ceil(n / tile), 8, tile) ray tiles, else None). ``live``, a (1,) int64
    tensor on the rows' device, gets the live rows added to it; so does
    ``tail``, another such tensor, which needs ``live``."""
    global LAUNCHES_SETUP
    _check_rows(rows)
    if sphere_center.shape != (sphere_radius.shape[0], 3) or not (
            sphere_center.is_contiguous() and sphere_radius.is_contiguous()):
        raise ValueError("sphere tables must be contiguous (S, 3) and (S,)")
    for name, counter in (("live", live), ("tail", tail)):
        if counter is not None and (counter.dtype != torch.int64 or counter.shape != (1,)
                                    or counter.device != rows.device):
            raise ValueError(f"{name} must be a (1,) int64 tensor on the rows' device")
    if tail is not None and live is None:
        raise ValueError("tail needs live")
    if device_kind(rows, "rays_setup") == "cpu":
        return plain_rays_setup(rows, sphere_center, sphere_radius, tile, live, tail)
    outs = setup_outputs(rows, tile)
    lib = library().lib
    recording.launching()  # ends the device idle of a live-count read, if one is open
    with torch.cuda.device(rows.device):
        err = lib.rt_rays_setup(*setup_args(rows, sphere_center, sphere_radius, tile, *outs,
                                            live, tail), _stream(rows))
    raise_on_error(lib, err, "rays_setup")
    LAUNCHES_SETUP += 1
    return outs


# ---- ray_keys --------------------------------------------------------------


def plain_ray_keys(rows: torch.Tensor, min_coord: torch.Tensor, inv_extent: torch.Tensor,
                   count: bool, chunk: int):
    """The key kernel's plain PyTorch version → (keys (n,) int64, live count
    (1,) int32): ``morton.ray_sort_keys``, the count engine's bucket where
    ``count``, plus ``(i // chunk) << 32``."""
    alive = rows_alive(rows)
    keys = morton.ray_sort_keys(rows[:, 0:3], rows[:, 3:6], alive, min_coord, inv_extent)
    return _finish_keys(keys, alive, count, chunk)


def _finish_keys(keys: torch.Tensor, alive: torch.Tensor, count: bool, chunk: int):
    """32-bit keys → the key kernels' outputs: with ``count`` the count
    engine's bucket (live: min(key >> 23, 254); dead: 255), plus ``(i //
    chunk) << 32``; and the live count, (1,) int32."""
    if count:
        keys = torch.where(alive, torch.clamp(keys >> COUNT_BUCKET_SHIFT,
                                              max=COUNT_BUCKETS - 2), COUNT_BUCKETS - 1)
    chunks = torch.arange(keys.shape[0], device=keys.device) // chunk
    return keys | (chunks << CHUNK_SHIFT), alive.sum().to(torch.int32).reshape(1)


def keys_args(rows, min_coord, inv_extent, count, chunk, keys, live, scratch=None) -> list:
    """The arguments of ``rt_ray_keys`` (and of its host build, which takes
    no scratch), without the stream."""
    return [rows.data_ptr(), rows.shape[0], min_coord.data_ptr(), inv_extent.data_ptr(),
            int(bool(count)), chunk, keys.data_ptr(), live.data_ptr(),
            scratch.data_ptr() if scratch is not None else None]


def ray_keys(rows: torch.Tensor, min_coord: torch.Tensor, inv_extent: torch.Tensor,
             count: bool, chunk: int):
    """(n, 16) packed rows → (keys (n,) int64, live rows (1,) int32). A key
    is row i's Morton key (``morton.DEAD_RAY_KEY`` on a dead row), or with
    ``count`` its bucket (live: min(key >> 23, 254); dead: 255), plus
    ``(i // chunk) << 32``."""
    global LAUNCHES_KEYS
    _check_keys(rows, chunk)
    for name, x in (("min_coord", min_coord), ("inv_extent", inv_extent)):
        if x.dtype != torch.float32 or x.shape != (3,) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (3,) float32")
    if device_kind(rows, "ray_keys") == "cpu":
        return plain_ray_keys(rows, min_coord, inv_extent, count, chunk)
    keys = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    live = torch.empty(1, dtype=torch.int32, device=rows.device)
    lib = library().lib
    with torch.cuda.device(rows.device):
        err = lib.rt_ray_keys(*keys_args(rows, min_coord, inv_extent, count, chunk, keys, live,
                                         live_scratch(rows)), _stream(rows))
    raise_on_error(lib, err, "ray_keys")
    LAUNCHES_KEYS += 1
    return keys, live


def _check_keys(rows: torch.Tensor, chunk: int) -> None:
    _check_rows(rows)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")


# ---- cullhit_keys ----------------------------------------------------------


def plain_cullhit_keys(rows: torch.Tensor, box_min: torch.Tensor, box_max: torch.Tensor,
                       num_clusters: int, cull_split: int, count: bool, chunk: int):
    """The cullhit key kernel's plain PyTorch version → (keys (n,) int64,
    live count (1,) int32): ``morton.first2_cluster_keys`` of the rows, the
    count engine's bucket where ``count``, plus ``(i // chunk) << 32``."""
    alive = rows_alive(rows)
    keys = morton.first2_cluster_keys(rows[:, 0:3], rows[:, 3:6], alive, box_min, box_max,
                                      num_clusters, cull_split)
    return _finish_keys(keys, alive, count, chunk)


def cullhit_tables(box_min: torch.Tensor, box_max: torch.Tensor, n_boxes: int):
    """The cullhit key kernel's tables of the first ``n_boxes`` cluster boxes
    → (boxes (n_boxes, 8), gates (ceil(n_boxes / CULLHIT_GATE), 8)) float32,
    each row ``[min xyz 0 max xyz 0]``. Gate g is the super-box of box rows
    g * CULLHIT_GATE .. (g + 1) * CULLHIT_GATE - 1: per axis the least and
    the greatest of BOTH corners of every member, so it holds each member as
    the slab test sees it (an inverted box's corners swap per axis; far
    point boxes stay in)."""
    gate = CULLHIT_GATE
    lo, hi = box_min[:n_boxes], box_max[:n_boxes]
    boxes = torch.zeros((n_boxes, BOX_WORDS), dtype=torch.float32, device=lo.device)
    boxes[:, 0:3], boxes[:, 4:7] = lo, hi
    n_gates = -(-n_boxes // gate)
    pad = n_gates * gate - n_boxes
    least = torch.nn.functional.pad(torch.minimum(lo, hi), (0, 0, 0, pad), value=float("inf"))
    most = torch.nn.functional.pad(torch.maximum(lo, hi), (0, 0, 0, pad), value=float("-inf"))
    gates = torch.zeros((n_gates, BOX_WORDS), dtype=torch.float32, device=lo.device)
    gates[:, 0:3] = least.reshape(n_gates, gate, 3).amin(dim=1)
    gates[:, 4:7] = most.reshape(n_gates, gate, 3).amax(dim=1)
    return boxes, gates


def cullhit_args(rows, boxes, gates, cull_split, num_clusters, count, chunk, keys, live,
                 scratch=None, tests=None) -> list:
    """The arguments of ``rt_cullhit_keys`` (and of its host build, which
    takes no scratch), without the stream."""
    return [rows.data_ptr(), rows.shape[0], boxes.data_ptr(), gates.data_ptr(),
            boxes.shape[0], gates.shape[0], cull_split, num_clusters, int(bool(count)), chunk,
            keys.data_ptr(), live.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            tests.data_ptr() if tests is not None else None]


def cullhit_keys(rows: torch.Tensor, box_min: torch.Tensor, box_max: torch.Tensor,
                 num_clusters: int, cull_split: int, count: bool, chunk: int,
                 tests: torch.Tensor = None):
    """(n, 16) packed rows and the scene's cluster boxes (at least
    ``num_clusters * cull_split`` rows of (3,) min and max corners) → (keys
    (n,) int64, live rows (1,) int32). A key is row i's first two distinct
    slab-hit cluster ids packed ``fh << 21 | sh << 10``
    (``morton.DEAD_RAY_KEY`` on a dead row), or with ``count`` its bucket,
    plus ``(i // chunk) << 32``. ``tests``, a (1,) int64 tensor on the card,
    gets the gates and boxes the rays tested added to it. The kernel's
    tables (``cullhit_tables``) are built once per pair of box tensors."""
    global LAUNCHES_CULLHIT
    _check_keys(rows, chunk)
    n_boxes = num_clusters * cull_split
    if num_clusters < 1 or cull_split < 1:
        raise ValueError("num_clusters and cull_split must be positive")
    for name, x in (("box_min", box_min), ("box_max", box_max)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] < n_boxes or x.shape[1] != 3:
            raise ValueError(f"{name} must be a ({n_boxes}, 3) float32 (or longer)")
        if x.device != rows.device:
            raise ValueError(f"{name} is on {x.device}, the rows on {rows.device}")
    if device_kind(rows, "cullhit_keys") == "cpu":
        if tests is not None:
            raise ValueError("tests counts the kernel's work: CUDA tensors only")
        return plain_cullhit_keys(rows, box_min[:n_boxes], box_max[:n_boxes], num_clusters,
                                  cull_split, count, chunk)
    if tests is not None and (tests.dtype != torch.int64 or tests.shape != (1,)
                              or tests.device != rows.device):
        raise ValueError("tests must be a (1,) int64 tensor on the rows' device")
    boxes, gates = derived(("cullhit_tables", n_boxes), (box_min, box_max),
                           lambda: cullhit_tables(box_min, box_max, n_boxes))
    keys = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    live = torch.empty(1, dtype=torch.int32, device=rows.device)
    lib = library().lib
    with torch.cuda.device(rows.device):
        err = lib.rt_cullhit_keys(*cullhit_args(rows, boxes, gates, cull_split, num_clusters,
                                                count, chunk, keys, live, live_scratch(rows),
                                                tests), _stream(rows))
    raise_on_error(lib, err, "cullhit_keys")
    LAUNCHES_CULLHIT += 1
    return keys, live


def flat_box_tests(rows: torch.Tensor, box_min: torch.Tensor, box_max: torch.Tensor,
                   num_clusters: int, cull_split: int, rays_a_step: int = 2048) -> int:
    """The box tests a flat ascending scan needs for the cullhit keys of
    ``rows``: each live ray tests boxes in order until its second distinct
    hit id (all ``num_clusters * cull_split`` when it has none); summed over
    live rays. The work the cullhit key's bound counts, whatever the kernel
    skips."""
    n_boxes = num_clusters * cull_split
    lo, hi = box_min[:n_boxes], box_max[:n_boxes]
    live_rows = rows[rows_alive(rows)]
    index = torch.arange(n_boxes, device=rows.device)
    ids = index // cull_split
    total = 0
    for r0 in range(0, live_rows.shape[0], rays_a_step):
        part = live_rows[r0:r0 + rays_a_step]
        o, d = part[:, 0:3], part[:, 3:6]
        inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
        t1 = (lo[None] - o[:, None]) * inv[:, None]
        t2 = (hi[None] - o[:, None]) * inv[:, None]
        near = torch.clamp_min(torch.minimum(t1, t2).amax(dim=2), 0.0)
        hit = near <= torch.maximum(t1, t2).amin(dim=2)
        first = torch.where(hit, index, n_boxes).amin(dim=1)
        first_id = torch.where(first < n_boxes, first // cull_split, -1)
        second = torch.where(hit & (ids[None] != first_id[:, None]), index, n_boxes).amin(dim=1)
        total += int(torch.where(second < n_boxes, second + 1, n_boxes).sum())
    return total


# ---- pcg_draws -------------------------------------------------------------

BOUNCE_RAY_MULT = 4137874753  # a bounce's per-ray seed (raytracing.cu:89):
BOUNCE_SEED_MULT = 279220567  # ray_id * 4137874753 + 279220567 * (pass_seed * 20 + bounce)
PASS_STRIDE = 20


def bounce_seed_add(pass_seed, bounce: int) -> int:
    """The per-bounce term of a bounce's seeds, ``279220567 * (pass_seed *
    20 + bounce)`` mod 2^32."""
    scalar = ((int(pass_seed) & rng.MASK32) * PASS_STRIDE + bounce) & rng.MASK32
    return (BOUNCE_SEED_MULT * scalar) & rng.MASK32


def bounce_seeds(ray_id: torch.Tensor, pass_seed, bounce: int) -> torch.Tensor:
    """Per-ray 32-bit seeds of one bounce (int64 holding uint32 values):
    ``ray_id * 4137874753 + 279220567 * (pass_seed * 20 + bounce)`` mod 2^32."""
    return (rng.mul32(rng.as_u32(ray_id), BOUNCE_RAY_MULT)
            + bounce_seed_add(pass_seed, bounce)) & rng.MASK32


def plain_pcg_draws(ray_id: torch.Tensor, ray_mult: int, seed_add: int, n: int) -> torch.Tensor:
    """The draw kernel's plain PyTorch version: the 32-bit-limb PCG of the
    seeds ``ray_id * ray_mult + seed_add`` mod 2^32."""
    seeds = (rng.mul32(rng.as_u32(ray_id), ray_mult) + seed_add) & rng.MASK32
    return rng.uniforms(seeds, n)


def draws_args(ray_id, ray_mult, seed_add, n, draws) -> list:
    """The arguments of ``rt_pcg_draws`` (and of its host build), without the stream."""
    return [ray_id.data_ptr(), ray_id.shape[0], int(ray_mult) & rng.MASK32,
            int(seed_add) & rng.MASK32, n, draws.data_ptr()]


def pcg_draws(ray_id: torch.Tensor, ray_mult: int, seed_add: int, n: int) -> torch.Tensor:
    """(R,) int32 ray ids → the (n, R) int64 first raw draws of each ray's
    PCG stream seeded with ``ray_id * ray_mult + seed_add`` mod 2^32
    (``rng.uniforms`` of those seeds)."""
    global LAUNCHES_DRAWS
    if ray_id.dtype != torch.int32 or ray_id.dim() != 1 or not ray_id.is_contiguous():
        raise ValueError(f"ray_id must be a contiguous (R,) int32, got {ray_id.dtype} "
                         f"{tuple(ray_id.shape)}")
    if device_kind(ray_id, "pcg_draws") == "cpu":
        return plain_pcg_draws(ray_id, ray_mult, seed_add, n)
    draws = torch.empty((n, ray_id.shape[0]), dtype=torch.int64, device=ray_id.device)
    lib = library().lib
    with torch.cuda.device(ray_id.device):
        err = lib.rt_pcg_draws(*draws_args(ray_id, ray_mult, seed_add, n, draws),
                               _stream(ray_id))
    raise_on_error(lib, err, "pcg_draws")
    LAUNCHES_DRAWS += 1
    return draws


def bounce_draws(ray_id: torch.Tensor, pass_seed, bounce: int) -> torch.Tensor:
    """The five raw draws of ``bounce`` per ray, (5, R) int64:
    ``rng.uniforms(bounce_seeds(ray_id, pass_seed, bounce), 5)``."""
    return pcg_draws(ray_id, BOUNCE_RAY_MULT, bounce_seed_add(pass_seed, bounce), 5)


def plain_bounce_draws(ray_id: torch.Tensor, pass_seed, bounce: int) -> torch.Tensor:
    return plain_pcg_draws(ray_id, BOUNCE_RAY_MULT, bounce_seed_add(pass_seed, bounce), 5)


# ---- camera_rows -------------------------------------------------------------

CAMERA_WORDS = 14  # [position top_left scaled_right scaled_up inv_width inv_height]


class CameraWords(NamedTuple):
    """The fields of a camera that ``camera.generate_rays`` reads, as views
    of its 14 words."""

    position: torch.Tensor
    near_plane_top_left: torch.Tensor
    scaled_right: torch.Tensor
    scaled_up: torch.Tensor
    inv_width: torch.Tensor
    inv_height: torch.Tensor


def camera_words(camera) -> torch.Tensor:
    """A camera's 14 float32 words on its device, in the layout of the
    shade kernel's head (``shade.pack_table``), built once per set of camera
    tensors."""
    fields = CameraWords(*(getattr(camera, name) for name in CameraWords._fields))
    return derived(("camera_words",), tuple(fields), lambda: torch.cat(
        [x.detach().reshape(-1) for x in fields]).to(torch.float32))


def words_camera(words: torch.Tensor) -> CameraWords:
    return CameraWords(words[0:3], words[3:6], words[6:9], words[9:12], words[12], words[13])


def plain_camera_rows(words: torch.Tensor, ray_lo: int, n: int, rays_per_pixel: int,
                      width: int, pass_seed) -> torch.Tensor:
    """The camera kernel's plain PyTorch version: the ray ids, their camera
    rays (``camera.generate_rays`` with the torch PCG), the initial state
    at full throughput and ``pack_rows`` of it."""
    from cuda_raytracer_tpu_torch.render import wavefront

    ray_id = ray_lo + torch.arange(n, dtype=torch.int32, device=words.device)
    state = wavefront.initial_state(words_camera(words), width, ray_id, rays_per_pixel,
                                    pass_seed, plain=True)
    return wavefront.pack_rows(state)


def camera_args(words, ray_lo, n, rays_per_pixel, width, pass_seed, rows) -> list:
    """The arguments of ``rt_camera_rows`` (and of its host build), without the stream."""
    return [words.data_ptr(), ray_lo, n, rays_per_pixel, width, int(pass_seed) & rng.MASK32,
            rows.data_ptr()]


def camera_rows(words: torch.Tensor, ray_lo: int, n: int, rays_per_pixel: int, width: int,
                pass_seed, out: torch.Tensor = None) -> torch.Tensor:
    """The (n, 16) float32 packed starting rows of camera rays ``ray_lo ..
    ray_lo + n - 1`` (``rays_per_pixel`` a pixel, pixel-major, an image
    ``width`` pixels wide): ``[origin direction 1 1 1 0 0 0 ray_id 0 0 0]``
    with the ray id's int32 bits in column 12, as ``pack_rows`` lays out
    ``make_initial_state``. ``words``: ``camera_words`` of the camera.
    ``out``, a contiguous (n, 16) float32 tensor on the words' device, takes
    the rows and is returned."""
    global LAUNCHES_CAMERA
    if words.dtype != torch.float32 or words.shape != (CAMERA_WORDS,) or not (
            words.is_contiguous()):
        raise ValueError(f"camera words must be a contiguous ({CAMERA_WORDS},) float32, got "
                         f"{words.dtype} {tuple(words.shape)}")
    if n < 0 or ray_lo < 0 or ray_lo + n > 2 ** 31 or rays_per_pixel < 1 or width < 1:
        raise ValueError(f"bad camera rows: ray_lo={ray_lo} n={n} "
                         f"rays_per_pixel={rays_per_pixel} width={width}")
    if out is not None:
        _check_rows(out)
        if out.shape[0] != n or out.device != words.device:
            raise ValueError(f"out must hold {n} rows on {words.device}, got "
                             f"{tuple(out.shape)} on {out.device}")
    if device_kind(words, "camera_rows") == "cpu":
        rows = plain_camera_rows(words, ray_lo, n, rays_per_pixel, width, pass_seed)
        return rows if out is None else out.copy_(rows)
    rows = out if out is not None else torch.empty((n, ROW_WORDS), dtype=torch.float32,
                                                   device=words.device)
    lib = library().lib
    with torch.cuda.device(words.device):
        err = lib.rt_camera_rows(*camera_args(words, ray_lo, n, rays_per_pixel, width,
                                              pass_seed, rows), _stream(words))
    raise_on_error(lib, err, "camera_rows")
    LAUNCHES_CAMERA += 1
    return rows


# ---- reorder_rows ------------------------------------------------------------


def plain_reorder_rows(cur: torch.Tensor, order: torch.Tensor, n: int, settled: int,
                       spare: torch.Tensor) -> torch.Tensor:
    """The row move's plain PyTorch version: the settled suffix's slice copy
    and ``torch.index_select`` of the prefix."""
    if n < settled:
        spare[n:settled] = cur[n:settled]
    torch.index_select(cur[:n], 0, order, out=spare[:n])
    return spare


def reorder_args(cur, order, n, settled, spare) -> list:
    """The arguments of ``rt_reorder_rows`` (and of its host build), without the stream."""
    return [cur.data_ptr(), order.data_ptr(), order.element_size(), n, settled,
            spare.data_ptr()]


def reorder_rows(cur: torch.Tensor, order: torch.Tensor, n: int, settled: int,
                 spare: torch.Tensor) -> torch.Tensor:
    """The reorder's row move between a buffer pair of (R, 16) rows: ``spare[i]
    = cur[order[i]]`` for ``i < n`` and ``spare[i] = cur[i]`` for ``n <= i <
    settled``, bit for bit; the rows from ``settled`` on are untouched.
    ``order``: a contiguous (n,) int64 or int32 permutation of ``[0, n)``.
    Returns ``spare``."""
    global LAUNCHES_REORDER
    _check_rows(cur)
    _check_rows(spare)
    if order.dtype not in (torch.int64, torch.int32) or order.shape != (n,) or not (
            order.is_contiguous()):
        raise ValueError(f"order must be a contiguous ({n},) int64 or int32, got {order.dtype} "
                         f"{tuple(order.shape)}")
    if not 0 <= n <= settled <= min(cur.shape[0], spare.shape[0]):
        raise ValueError(f"need 0 <= n <= settled <= the rows of both buffers, got n={n} "
                         f"settled={settled} for {cur.shape[0]} and {spare.shape[0]} rows")
    if not cur.device == order.device == spare.device:
        raise ValueError(f"cur, order and spare must share a device, got {cur.device}, "
                         f"{order.device} and {spare.device}")
    row_bytes = ROW_WORDS * 4
    if (cur.data_ptr() < spare.data_ptr() + settled * row_bytes
            and spare.data_ptr() < cur.data_ptr() + settled * row_bytes):
        raise ValueError("cur and spare overlap")
    if device_kind(cur, "reorder_rows") == "cpu":
        return plain_reorder_rows(cur, order, n, settled, spare)
    lib = library().lib
    with torch.cuda.device(cur.device):
        err = lib.rt_reorder_rows(*reorder_args(cur, order, n, settled, spare), _stream(cur))
    raise_on_error(lib, err, "reorder_rows")
    LAUNCHES_REORDER += 1
    recording.count("reorder.rows", settled)
    return spare
