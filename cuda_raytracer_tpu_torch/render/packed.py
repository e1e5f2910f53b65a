"""The forward trace on packed rows, and its bounce loop's CUDA graphs.

A forward trace (detached mode, no autograd graph to build) keeps its
wavefront as one (R, 16) buffer of rows (``wavefront.pack_rows``), from a
block's camera rows written by one kernel (``trace_camera``). Each bounce
is ``wavefront.packed_bounce`` on its prefix of the rows, as the trace's
``wavefront.bounce_schedule`` says: the rule ``wavefront.trace_rays``, the
trace that builds a graph, follows too, with the same bits.

The live count is read back after each sorted bounce of a compact schedule,
the host's one sync: the next bounce's prefix depends on it. The walk on a
CUDA device sorts nothing (``wavefront.reorder_is_useful``), so there a
block is one segment and reads nothing; the CPU's walk and the packet
engines keep the reorder and its reads. The reads cut a trace into
segments, and what a segment enqueues is fixed by host values known before
the trace starts: the schedule, the segment's first bounce,
its prefix rows and the rows the buffer pair shares (``settled``).
``segment_plan`` lists every segment a schedule can need, whatever its live
counts; ``run_segment`` issues one. Two executors run them, with one
interface (``start``, ``run``, ``finish``):

- ``BlockGraphs`` replays each segment as a CUDA graph where ``applies``: a
  CUDA device, the kernels (not ``plain``) and the BVH walk. A launch costs
  the host about the same at a few hundred rows as at 262,140, and on an
  H100 the card sat idle between them (PERF.md §5). A block shape's
  segments are captured the first time it is traced. Inside a segment the
  live count goes to pinned host memory and an external CUDA event is
  recorded once the key kernel has written it, so the host reads it while
  the sort and gather run and queues the next segment behind them. The pass
  seed, the one value a kernel reads that changes between blocks of a
  shape, is a device word. A capture that fails raises.
- ``Eager`` issues each segment as it comes, on the caller's rows and a
  buffer of its own: the CPU, ``plain``, and the packet engines, which size
  their work on the host (``torch.nonzero``), which a graph cannot hold.

The records (``utils/metrics``) read the same on both. Each bounce opens an
``rt.bounce`` span (and from ``bounces // 2`` on an ``rt.tail`` span inside
it); a segment is issued inside the spans of its first bounce. A bounce
counts itself (``bounces.packed``; ``bounces.sorted`` too where the rows
are reordered after it), its prefix's rows (``rays.launched``) and, on the
device, its live rows (``rays.live``; ``rays.live_tail`` in the
tail), the rows scattered off a dielectric (``shade.dielectric``) and those
whose hit material emits (``shade.emissive``), into counts of the trace's
own that its end folds into the recorder's with the live rows' tests of the
scene's spheres (``hit.sphere_tests``, ``fold_counts``); a
sorted bounce's row move on the card counts its rows (``reorder.rows``); a read
counts ``sync.host`` and the device idle until the next launch
(``sync.device_idle_s``). A graph's host counters, counted once while
capturing, are added at each replay, with ``bounces.graphed``; its device
counters go to the shape's static counts, added to the recorder's after a
block's last replay; ``graph.captures`` counts captures. The kernels'
``LAUNCHES`` counters go up by the launches each replay runs.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from cuda_raytracer_tpu_torch.models.scene import Scene, derived
from cuda_raytracer_tpu_torch.ops.kernels import bounce as bounce_kernel
from cuda_raytracer_tpu_torch.ops.kernels import rays as rays_kernel
from cuda_raytracer_tpu_torch.ops.kernels import traverse as traverse_kernel
from cuda_raytracer_tpu_torch.render import wavefront
from cuda_raytracer_tpu_torch.render.wavefront import BounceSchedule, RayState
from cuda_raytracer_tpu_torch.utils import metrics as recording

_NO_SPAN = contextlib.nullcontext()  # the head bounces' stand-in for the rt.tail span
# The device counters a trace sums its bounces into, in order.
COUNTED = ("rays.live", "rays.live_tail", "shade.dielectric", "shade.emissive")
# The kernel modules whose LAUNCHES counters a segment's launches raise.
_LAUNCHING = (rays_kernel, traverse_kernel, bounce_kernel)


def trace_wavefront(
    scene: Scene,
    state: RayState,
    pass_seed,
    bounces: int,
    sort_rays: bool,
    reparam: bool = False,
    checkpoint_bounces: bool = True,
) -> Tuple[RayState, int]:
    """March the wavefront through ``bounces`` scatter events, as
    ``wavefront.bounce_schedule`` says. Returns (state, suspect),
    ``suspect`` summed over bounces. A forward trace (detached mode, no
    graph to build) runs packed (``trace_packed``); one that builds a graph
    runs on the ``RayState`` (``wavefront.trace_rays``)."""
    if not reparam and not wavefront._needs_graph(scene, state):
        return trace_packed(scene, state, pass_seed, bounces, sort_rays)
    return wavefront.trace_rays(scene, state, pass_seed, bounces, sort_rays, reparam=reparam,
                                checkpoint_bounces=checkpoint_bounces)


def trace_camera(
    scene: Scene, ray_lo: int, rays: int, rays_per_pixel: int, pass_seed, bounces: int,
    sort_rays: bool, reparam: bool = False, checkpoint_bounces: bool = True,
) -> Tuple[RayState, int]:
    """``trace_wavefront`` of the camera rays ``[ray_lo, ray_lo + rays)``. A
    forward trace starts from the camera kernel's rows (``rays.camera_rows``:
    one launch, the bits of ``pack_rows(make_initial_state(...))``), written
    straight into the graphs' first buffer where they replay; one that builds
    a graph starts from ``make_initial_state``."""
    if not reparam and not wavefront._needs_graph(scene):
        executor = _executor(scene, wavefront.bounce_schedule(scene, rays, bounces, sort_rays))
        with recording.span("rt.camera"):
            rows = rays_kernel.camera_rows(rays_kernel.camera_words(scene.camera), ray_lo,
                                           rays, rays_per_pixel, scene.config.width, pass_seed,
                                           executor.buffers[0])
        return trace_packed(scene, rows, pass_seed, bounces, sort_rays, executor=executor)
    ray_id = ray_lo + torch.arange(rays, dtype=torch.int32, device=scene.device)
    state = wavefront.make_initial_state(scene, ray_id, rays_per_pixel, pass_seed)
    return trace_wavefront(scene, state, pass_seed, bounces, sort_rays, reparam=reparam,
                           checkpoint_bounces=checkpoint_bounces)


def trace_packed(
    scene: Scene, state, pass_seed, bounces: int, sort_rays: bool,
    plain: bool = False, bounds: list = None, executor=None,
) -> Tuple[RayState, int]:
    """The forward ``trace_wavefront`` on one packed (R, 16) buffer: ``state``
    is a ``RayState`` (packed with ``pack_rows``) or such rows. Bit-identical
    to ``trace_rays``. Where its segments replay as CUDA graphs the rows are
    copied into the block shape's own buffer pair, and the returned state is
    a view of it, valid until the next trace of that shape; elsewhere the
    trace overwrites ``state``'s rows. ``plain`` is ``bounce_rows``';
    ``bounds``, a list, gets each bounce's entering live bound;
    ``executor``: the rows' (``_executor``) where a caller has made it, else
    made here."""
    rows = state if isinstance(state, torch.Tensor) else wavefront.pack_rows(state)
    R = rows.shape[0]
    if executor is None:
        executor = _executor(scene, wavefront.bounce_schedule(scene, R, bounces, sort_rays), plain)
    schedule = executor.schedule
    executor.start(rows, pass_seed)
    live_bound = settled = R
    suspect_total = 0
    segment = count = None
    for bounce, do_sort in enumerate(schedule.sorted):
        in_tail = bounce >= bounces // 2
        with recording.span("rt.bounce"), recording.span("rt.tail") if in_tail else _NO_SPAN:
            n, left_out = schedule.rows(bounce, live_bound)
            if bounds is not None:
                bounds.append(live_bound)
            if segment is None or bounce == segment.end:
                segment = executor.plan[(bounce, n, settled)]
                count, suspect = executor.run(segment)
                suspect_total = suspect_total + suspect
            suspect_total = suspect_total + left_out
            live_bound = min(live_bound, n)
            if do_sort and schedule.compact:
                live_bound = recording.read_live(count, executor.copied)
            settled = n if do_sort else max(settled, n)
    if schedule.sorted:
        executor.finish()
    return wavefront.unpack_rows(_pair(executor.buffers, schedule, bounces)[0]), suspect_total


def trace_live_bounds(
    scene: Scene, state: RayState, pass_seed, bounces: int, sort_rays: bool
) -> list:
    """Per-bounce entering live bounds of a trace on the dynamic live prefix
    (``trace_packed`` without a static schedule): the calibration input for
    config.live_schedule."""
    bounds = []
    trace_packed(scene.with_config(live_schedule=()), state, pass_seed, bounces, sort_rays,
                 bounds=bounds)
    return bounds


class Segment(NamedTuple):
    """Bounces ``first`` to ``end - 1`` of a trace, each on its prefix of
    ``rows`` rows, the buffer pair sharing the rows from ``settled`` on as it
    starts; ``reads``: the live count is read after its last bounce."""

    first: int
    rows: Tuple[int, ...]
    settled: int
    reads: bool

    @property
    def end(self) -> int:
        return self.first + len(self.rows)


def segment_plan(schedule: BounceSchedule) -> Dict[Tuple[int, int, int], Segment]:
    """Every segment a trace on ``schedule`` can run → {(its first bounce,
    that bounce's prefix rows, the settled rows on entry): segment}. After a
    read the prefix is the static schedule's, or any live prefix size up to
    the last bounce's (the live rows lie in it). A segment that sorts nothing
    copies nothing, so its ``settled`` is its first prefix, whatever it was
    entered with."""
    sorted_bounces, static_rows = schedule.sorted, schedule.static_rows
    bounces, R = len(sorted_bounces), schedule.sizes[0]
    plan: Dict[Tuple[int, int, int], Segment] = {}
    todo = [(0, static_rows[0] if static_rows else R, R)] if bounces else []
    while todo:
        key = todo.pop()
        if key in plan:
            continue
        first, n, settled = key
        rows, shared, b = [], settled, first
        while b < bounces:
            rows.append(static_rows[b] if static_rows else n)
            shared = rows[-1] if sorted_bounces[b] else max(shared, rows[-1])
            b += 1
            if schedule.compact and sorted_bounces[b - 1]:
                break
        plan[key] = Segment(first, tuple(rows), settled if any(sorted_bounces[first:b]) else
                            rows[0], schedule.compact and sorted_bounces[b - 1])
        if b < bounces:
            nexts = ([static_rows[b]] if static_rows else
                     [m for m in schedule.sizes if m <= rows[-1]])
            todo.extend((b, m, shared) for m in nexts)
    return plan


def _pair(buffers, schedule: BounceSchedule, bounce: int):
    """(cur, spare) of a buffer pair as bounce ``bounce`` finds them: swapped
    after each sorted bounce."""
    flips = sum(schedule.sorted[:bounce]) % 2
    return buffers[flips], buffers[1 - flips]


def run_segment(scene: Scene, schedule: BounceSchedule, segment: Segment, buffers, pass_seed,
                counters, plain: bool = False, copied=None):
    """Issue a segment's bounces (``wavefront.packed_bounce`` each) on a
    buffer pair → (the live count of its last bounce on the device, or None
    unsorted; the suspect count over its bounces). ``counters``: those of
    ``COUNTED``, each a (1,) int64 or None; ``copied``: ``packed_bounce``'s,
    taken by the last bounce of a segment that reads."""
    live, tail, dielectric, emissive = counters
    bounces = len(schedule.sorted)
    settled, count, suspect = segment.settled, None, 0
    for b, n in enumerate(segment.rows, segment.first):
        cur, spare = _pair(buffers, schedule, b)
        do_sort = schedule.sorted[b]
        s, count = wavefront.packed_bounce(
            scene, cur, spare, n, settled, b, do_sort, min(schedule.chunk, n), pass_seed, plain,
            live, tail if b >= bounces // 2 else None, dielectric, emissive,
            copied if segment.reads and b == segment.end - 1 else None)
        suspect = suspect + s
        settled = n if do_sort else max(settled, n)
    return count, suspect


def fold_counts(counts: Optional[torch.Tensor], spheres: int) -> None:
    """A trace's device counts (one int64 a name of ``COUNTED``) into the
    recorder's, and its live rows times the scene's ``spheres`` into
    ``hit.sphere_tests``: the ray-sphere tests its closest hit needs."""
    rec = recording.recorder()
    if rec is None or counts is None:
        return
    for i, name in enumerate(COUNTED):
        rec.device_counter(name, counts).add_(counts[i:i + 1])
    if spheres:
        rec.device_counter("hit.sphere_tests", counts).add_(counts[0:1], alpha=spheres)


def _counters(counts: Optional[torch.Tensor]) -> tuple:
    """``run_segment``'s counters: views of ``counts``, or None each."""
    return tuple(None if counts is None else counts[i:i + 1] for i in range(len(COUNTED)))


class Eager:
    """A trace's segments issued as they come; while recording, into device
    counts of its own, which ``finish`` folds into the recorder's."""

    buffers = (None, None)  # the caller's rows and a buffer of its own, once started
    copied = None  # the live count is read from the device

    def __init__(self, scene: Scene, schedule: BounceSchedule, plain: bool = False):
        self.scene, self.schedule, self.plain = scene, schedule, plain
        self.plan = segment_plan(schedule)

    def start(self, rows: torch.Tensor, pass_seed) -> None:
        self.buffers = (rows, torch.empty_like(rows) if any(self.schedule.sorted) else None)
        self.seed = pass_seed
        self.counts = (None if recording.recorder() is None else
                       torch.zeros(len(COUNTED), dtype=torch.int64, device=rows.device))
        self.counters = _counters(self.counts)

    def run(self, segment: Segment):
        return run_segment(self.scene, self.schedule, segment, self.buffers, self.seed,
                           self.counters, self.plain)

    def finish(self) -> None:
        fold_counts(self.counts, self.scene.sphere_count)


def applies(scene: Scene, plain: bool = False) -> bool:
    """True when a forward trace of ``scene`` replays graphs: the kernels on
    a CUDA device, closest hits through the BVH walk."""
    return (not plain and scene.device.type == "cuda"
            and wavefront.resolved_intersector(scene) == "bvh")


def _executor(scene: Scene, schedule: BounceSchedule, plain: bool = False):
    """The executor of a forward trace on ``schedule``: the block's CUDA
    graphs (``block_graphs``) where it replays them, else ``Eager``."""
    return block_graphs(scene, schedule) if applies(scene, plain) else Eager(scene, schedule, plain)


def _sources(scene: Scene) -> tuple:
    """The scene tensors a segment reads, directly or through a table built
    from them; the graphs are captured again when one changes."""
    return (scene.sphere_center, scene.sphere_radius, scene.tri_p1, scene.tri_e1,
            scene.tri_e2, scene.tri_normal, scene.material_index, scene.bvh_min,
            scene.bvh_max, scene.bvh_child1, scene.bvh_child2, scene.environment_map,
            scene.min_coord, scene.inv_extent) + tuple(
        getattr(scene.materials, name) for name in bounce_kernel.MATERIAL_FIELDS)


def block_graphs(scene: Scene, schedule: BounceSchedule) -> "BlockGraphs":
    """The graphs of a block traced on ``schedule``, captured at the first
    call. Kept with the scene's tensors (``models/scene.derived``), keyed by
    the schedule and the host values only the kernels read."""
    key = (schedule, scene.config.sort_engine, scene.sphere_count, scene.max_leaf_size)
    shapes = derived(("block_graphs",), _sources(scene), dict)
    block = shapes.get(key)
    if block is None:
        block = shapes[key] = BlockGraphs(scene, schedule)
    return block


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    live: Optional[torch.Tensor]  # the live count on the card (the read takes its host copy)
    suspect: int
    counters: Dict[str, float]  # host counters a replay adds
    launches: Tuple[tuple, ...]  # (module, LAUNCHES name, launches a replay adds)


def _launch_counts() -> dict:
    return {(module, name): value for module in _LAUNCHING
            for name, value in vars(module).items() if name.startswith("LAUNCHES")}


class BlockGraphs:
    """One block shape's graphs, one a segment of ``segment_plan``, and the
    static state they hold: the row pair (``buffers``), the device counters,
    the seed word and the tables the graphs read. It holds no reference to
    the scene (its cache entry lives while the scene's tensors do)."""

    def __init__(self, scene: Scene, schedule: BounceSchedule):
        device = scene.device
        self.schedule, self.plan = schedule, segment_plan(schedule)
        pair = 2 if any(schedule.sorted) else 1
        self.buffers = tuple(torch.zeros((schedule.sizes[0], rays_kernel.ROW_WORDS),
                                         dtype=torch.float32, device=device)
                             for _ in range(pair)) + (None,) * (2 - pair)
        self.counts = torch.zeros(len(COUNTED), dtype=torch.int64, device=device)
        self.counters = _counters(self.counts)
        self.spheres = scene.sphere_count
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

    def _issue(self, scene: Scene, segment: Segment):
        """``run_segment`` into the static counts, which the first segment
        zeroes: what a graph holds."""
        if segment.first == 0:
            self.counts.zero_()
        return run_segment(scene, self.schedule, segment, self.buffers, self.seed, self.counters,
                           copied=self.copied)

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
        """One segment captured. The capture launches nothing, so it does not
        count in ``LAUNCHES``: each replay adds the launches it runs."""
        before = _launch_counts()
        held = recording.Metrics()
        graph = torch.cuda.CUDAGraph()
        with recording.attached(held):
            graph.capture_begin(pool=pool)
            try:
                live, suspect = self._issue(scene, segment)
            finally:
                graph.capture_end()
        launches = tuple((module, name, value - before[(module, name)])
                         for (module, name), value in _launch_counts().items()
                         if value != before[(module, name)])
        for (module, name), value in before.items():
            setattr(module, name, value)
        recording.count("graph.captures", 1)
        return _Captured(graph, live, suspect, dict(held.counters), launches)

    def start(self, rows: torch.Tensor, pass_seed) -> None:
        """Before a block's first replay: its rows into the first buffer
        (unless they are in it) and the pass seed into the seed word."""
        if rows is not self.buffers[0]:
            self.buffers[0].copy_(rows)
        seed = int(pass_seed) & 0xFFFFFFFF
        if seed != self.seed_value:
            self.seed.fill_(seed - (1 << 32) if seed >= 1 << 31 else seed)  # the word's bits
            self.seed_value = seed

    def run(self, segment: Segment):
        """Replay the segment's graph → (its live count or None, its suspect count)."""
        recording.launching()  # ends the device idle of a live-count read, if one is open
        captured = self.graphs[segment]
        captured.graph.replay()
        for module, name, launches in captured.launches:
            setattr(module, name, getattr(module, name) + launches)
        rec = recording.recorder()
        if rec is not None:
            for name, value in captured.counters.items():
                rec.count(name, value)
            rec.count("bounces.graphed", len(segment.rows))
        return captured.live, captured.suspect

    def finish(self) -> None:
        """After a block's last replay: its device counts into the recorder's."""
        fold_counts(self.counts, self.spheres)
