"""A block's bounces as CUDA graphs (``wavefront.trace_packed`` on the card).

The packed forward trace of a mesh block issues its work bounce by bounce
from Python: the set-up kernel, the BVH walk, the bounce kernel and, while
sorted, the key kernel, a stable sort, a gather and a copy of the rows past
the live prefix. A launch costs the host about the same at a few hundred
rows as at 262,140, and on an H100 the card sat idle for most of a 100-spp
image between them (PERF.md §5). Here those launches are captured once and
replayed as CUDA graphs.

A block reads its live count back after each sorted bounce of a one-chunk
wavefront: the next bounce's prefix depends on it. Those reads cut the
block's bounces into segments. What a segment enqueues is fixed by host
values known before the block starts: its rows R, the bounces it runs, each
one's prefix rows, the rows the buffer pair shares on entry (``settled``),
the sort and tail schedule. ``segment_plan`` lists every segment a block of
R rows can need, whatever its live counts, and ``BlockGraphs`` captures
each one the first time a block shape is traced, so later traces of the
shape (a timed render after its warm-up among them) capture nothing. A block
then runs as the camera launch, one replay a segment with the reads between
them, and the accumulate. Inside a segment the live count goes to pinned host
memory and an external CUDA event is recorded as soon as the key kernel has
written it, so the host reads it while the segment's sort and gather run and
queues the next segment behind them. The pass seed, the one value that
changes between blocks of a shape and that a kernel reads, comes to the
bounce kernel as a device word, written once per pass.

Which traces replay graphs follows what the code can observe (``applies``):
a CUDA device, the kernels (not ``plain``) and the BVH walk as the closest
hit. The packet engines size their work on the host (``torch.nonzero``),
which a graph cannot hold, and stay eager, as do the CPU, ``plain`` and a
trace that builds an autograd graph (``wavefront.trace_rays``). A capture
that fails raises.

The records (``utils/metrics``) read as the eager trace's: a segment's host
counters (``hit.rows``, ``hit.walk_rows``, ``rays.launched``,
``bounces.packed``), counted once while capturing, are added at each replay;
the device counters (``rays.live``, ``rays.live_tail``,
``shade.dielectric``) are summed into the shape's static counts (the first
segment zeroes them) and added to the recorder's after a block's last
replay, while recording; the reads stay reads. The bounce kernel's counting
instance runs in every graph: its rows are the same, at one atomic a warp.
The kernels' ``LAUNCHES`` counters go up by the launches each replay runs.
This module adds ``bounces.graphed`` (bounces run inside a replay) and
``graph.captures``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from cuda_raytracer_tpu_torch.models.scene import Scene, derived
from cuda_raytracer_tpu_torch.ops.kernels import bounce as bounce_kernel
from cuda_raytracer_tpu_torch.ops.kernels import rays as rays_kernel
from cuda_raytracer_tpu_torch.ops.kernels import traverse as traverse_kernel
from cuda_raytracer_tpu_torch.render import wavefront
from cuda_raytracer_tpu_torch.utils import metrics as recording

# The device counters a graphed block sums into its static counts, in order.
COUNTED = ("rays.live", "rays.live_tail", "shade.dielectric")
# The kernel modules whose LAUNCHES counters a segment's launches raise.
_LAUNCHING = (rays_kernel, traverse_kernel, bounce_kernel)


class Segment(NamedTuple):
    """Bounces ``first`` to ``end - 1`` of a block, replayed as one graph:
    each on its prefix of ``rows`` rows, the buffer pair sharing the rows
    from ``settled`` on as it starts; ``reads``: the live count is read
    after its last bounce."""

    first: int
    rows: Tuple[int, ...]
    settled: int
    reads: bool

    @property
    def end(self) -> int:
        return self.first + len(self.rows)


def segment_plan(R: int, sorted_bounces, compact: bool, sizes,
                 static_rows=None) -> Dict[Tuple[int, int, int], Segment]:
    """Every segment a trace of ``R`` rows can run → {(its first bounce, that
    bounce's prefix rows, the settled rows on entry): segment}.
    ``sorted_bounces``: per bounce, whether the trace reorders after it;
    ``compact``: the live count is read after each sorted bounce; ``sizes``:
    the live prefix sizes, descending from R; ``static_rows``: each bounce's
    prefix under a static schedule, else None, where after a read the prefix
    may be any size up to the last bounce's (the live rows lie in it). A
    segment that sorts nothing copies nothing, so its ``settled`` is its
    first prefix, whatever it was entered with."""
    bounces = len(sorted_bounces)
    plan: Dict[Tuple[int, int, int], Segment] = {}
    todo = [(0, static_rows[0] if static_rows else R, R)] if bounces else []
    while todo:
        key = todo.pop()
        if key in plan:
            continue
        first, n, settled = key
        rows, shared, sorts, b = [], settled, False, first
        while b < bounces:
            rows.append(static_rows[b] if static_rows else n)
            sorts = sorts or sorted_bounces[b]
            shared = rows[-1] if sorted_bounces[b] else max(shared, rows[-1])
            b += 1
            if compact and sorted_bounces[b - 1]:
                break
        reads = compact and sorted_bounces[b - 1]
        plan[key] = Segment(first, tuple(rows), settled if sorts else rows[0], reads)
        if b < bounces:
            nexts = [static_rows[b]] if static_rows else [m for m in sizes if m <= rows[-1]]
            todo.extend((b, m, shared) for m in nexts)
    return plan


def applies(scene: Scene, plain: bool = False) -> bool:
    """True when a forward trace of ``scene`` replays graphs: the kernels on
    a CUDA device, closest hits through the BVH walk."""
    return (not plain and scene.device.type == "cuda"
            and wavefront.resolved_intersector(scene) == "bvh")


def _sources(scene: Scene) -> tuple:
    """The scene tensors a segment reads, directly or through a table built
    from them; the graphs are captured again when one changes."""
    return (scene.sphere_center, scene.sphere_radius, scene.tri_p1, scene.tri_e1,
            scene.tri_e2, scene.tri_normal, scene.material_index, scene.bvh_min,
            scene.bvh_max, scene.bvh_child1, scene.bvh_child2, scene.environment_map,
            scene.min_coord, scene.inv_extent) + tuple(
        getattr(scene.materials, name) for name in bounce_kernel.MATERIAL_FIELDS)


def block_graphs(scene: Scene, R: int, bounces: int, sort_rays: bool) -> "BlockGraphs":
    """The graphs of an R-row block of ``scene`` traced through ``bounces``
    bounces (``sort_rays`` resolved), captured at the first call. Kept with
    the scene's tensors (``models/scene.derived``), keyed by every host
    value the segments hold: a scene from ``with_config`` of another
    sample count shares them."""
    cfg = scene.config
    key = (R, bounces, sort_rays, cfg.sort_depth, tuple(cfg.live_schedule), cfg.packet_tile,
           cfg.sort_engine, scene.sphere_count, scene.max_leaf_size)
    shapes = derived(("block_graphs",), _sources(scene), dict)
    block = shapes.get(key)
    if block is None:
        block = shapes[key] = BlockGraphs(scene, R, bounces, sort_rays)
    return block


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    live: Optional[torch.Tensor]  # the live count on the card (the read takes its host copy)
    counters: Dict[str, float]  # host counters a replay adds
    launches: Tuple[tuple, ...]  # (module, LAUNCHES name, launches a replay adds)


def _launch_counts() -> dict:
    return {(module, name): value for module in _LAUNCHING
            for name, value in vars(module).items() if name.startswith("LAUNCHES")}


class BlockGraphs:
    """One block shape's graphs and the static state they hold: the packed
    row pair (``buffers``), the device counters, the seed word, and one
    captured graph a segment of ``segment_plan``. It holds no reference to
    the scene (its cache entry lives while the scene's tensors do) but keeps
    the tables the graphs read."""

    def __init__(self, scene: Scene, R: int, bounces: int, sort_rays: bool):
        device = scene.device
        self.bounces = bounces
        self.sorted_bounces = wavefront._sort_schedule(scene, sort_rays, bounces)
        self.chunk = wavefront.sort_chunk_size(R)
        compact = sort_rays and self.chunk == R
        static_rows = None
        if compact and scene.config.live_schedule:
            static_rows = [wavefront.prefix_rows(scene, R, b, R, True)[0]
                           for b in range(bounces)]
        self.plan = segment_plan(R, self.sorted_bounces, compact,
                                 wavefront.live_prefix_sizes(scene, R), static_rows)
        pair = 2 if any(self.sorted_bounces) else 1
        self.buffers = tuple(torch.zeros((R, rays_kernel.ROW_WORDS), dtype=torch.float32,
                                         device=device) for _ in range(pair)) + (None,) * (2 - pair)
        self.counts = torch.zeros(len(COUNTED), dtype=torch.int64, device=device)
        self.counters = tuple(self.counts[i:i + 1] for i in range(len(COUNTED)))
        self.seed = torch.zeros(1, dtype=torch.int32, device=device)
        self.seed_value = None
        # The live count's host copy and the event a segment records once it
        # is made (mid-graph: an external event), read while the sort runs.
        self.copied = (torch.zeros(1, dtype=torch.int32, pin_memory=device.type == "cuda"),
                       torch.cuda.Event(external=True))
        # Built before any capture (building them syncs), kept while the graphs are.
        self.tables = (traverse_kernel.walk_tables(scene), bounce_kernel.material_table(scene))
        self.graphs: Dict[Segment, _Captured] = {}
        self._capture_all(scene)

    def _pair(self, bounce: int):
        """(cur, spare) as bounce ``bounce`` finds them: swapped after each sorted bounce."""
        flips = sum(self.sorted_bounces[:bounce]) % 2
        return self.buffers[flips], self.buffers[1 - flips]

    def _enqueue(self, scene: Scene, segment: Segment):
        """Issue the segment's bounces (``wavefront.packed_bounce``) → the
        live count of its last one, or None unsorted."""
        if segment.first == 0:
            self.counts.zero_()
        live, tail, dielectric = self.counters
        settled, count = segment.settled, None
        for b, n in enumerate(segment.rows, segment.first):
            cur, spare = self._pair(b)
            do_sort = self.sorted_bounces[b]
            _, count = wavefront.packed_bounce(
                scene, cur, spare, n, settled, b, do_sort, min(self.chunk, n), self.seed,
                live=live, tail=tail if b >= self.bounces // 2 else None,
                dielectric=dielectric,
                copied=self.copied if segment.reads and b == segment.end - 1 else None)
            settled = n if do_sort else max(settled, n)
        return count

    def _capture_all(self, scene: Scene) -> None:
        """Capture every segment of the plan into one memory pool: replays
        run one after another on one stream and leave nothing live in the
        pool but each segment's live count, which stays allocated."""
        device = scene.device
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            rays_kernel.live_scratch(self.seed)  # the key kernels' scratch, made before capturing
            for segment in dict.fromkeys(self.plan.values()):
                self.graphs[segment] = self._capture(scene, segment, pool)
        torch.cuda.current_stream(device).wait_stream(stream)

    def _capture(self, scene: Scene, segment: Segment, pool) -> _Captured:
        """One segment run once on the all-dead buffers (loading every kernel
        it launches), then captured. Neither counts in ``LAUNCHES``: the
        capture launches nothing, and the run is set-up, not a render's."""
        before = _launch_counts()
        with recording.attached(recording.Metrics()):
            self._enqueue(scene, segment)
        warm = _launch_counts()
        held = recording.Metrics()
        graph = torch.cuda.CUDAGraph()
        with recording.attached(held):
            graph.capture_begin(pool=pool)
            try:
                live = self._enqueue(scene, segment)
            finally:
                graph.capture_end()
        launches = tuple((module, name, value - warm[(module, name)])
                         for (module, name), value in _launch_counts().items()
                         if value != warm[(module, name)])
        for (module, name), value in before.items():
            setattr(module, name, value)
        recording.count("graph.captures", 1)
        return _Captured(graph, live, dict(held.counters), launches)

    def start(self, rows: torch.Tensor, pass_seed):
        """Before a block's first replay: its rows into the first buffer
        (unless they are in it) and the pass seed into the seed word →
        (cur, spare)."""
        if rows is not self.buffers[0]:
            self.buffers[0].copy_(rows)
        seed = int(pass_seed) & 0xFFFFFFFF
        if seed != self.seed_value:
            self.seed.fill_(seed - (1 << 32) if seed >= 1 << 31 else seed)  # the word's bits
            self.seed_value = seed
        return self.buffers

    def replay(self, bounce: int, n: int, settled: int):
        """Replay the segment that starts at ``bounce`` on ``n`` rows with
        ``settled`` rows shared → (segment, its live count or None)."""
        segment = self.plan[(bounce, n, settled)]
        captured = self.graphs[segment]
        captured.graph.replay()
        for module, name, launches in captured.launches:
            setattr(module, name, getattr(module, name) + launches)
        rec = recording.recorder()
        if rec is not None:
            for name, value in captured.counters.items():
                rec.count(name, value)
            rec.count("bounces.graphed", len(segment.rows))
        return segment, captured.live

    def finish(self) -> None:
        """After a block's last replay: its device counts into the recorder's."""
        rec = recording.recorder()
        if rec is not None:
            for name, count in zip(COUNTED, self.counters):
                rec.device_counter(name, count).add_(count)
