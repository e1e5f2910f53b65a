"""The bounce loop's CUDA graphs (``render/packed.py``), on the CPU.

- ``segment_plan`` lists the segments a block can run, cut at the live-count
  reads: with the dynamic live prefix every prefix up to the last one after
  each read, with a static schedule one segment a read, without reads one
  segment of every bounce; a segment that sorts nothing keys one graph
  whatever the rows it was entered with.
- ``applies`` takes the BVH walk on a CUDA device with the kernels, and
  nothing else.
- With graphs stood in for on the CPU (a capture runs the segment on the
  all-dead buffers, a replay runs it again outside the recorder), a
  multi-block, multi-pass render of the small glass torus through the walk,
  on the dynamic prefix and on a static schedule, gives the eager trace's
  framebuffer and counters bit for bit, and ``trace_live_bounds`` its
  bounds; a second render captures nothing. This holds the graph path's host
  side (the plan's keys, the buffer pair, the seed word, the static counts,
  the live count's host copy) to the eager loop; ``test_torch_cuda_graphs.py`` holds the real graphs on
  the card.
- ``camera_rows`` writes into ``out`` and checks it.
"""

import contextlib
import types

import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene
from cuda_raytracer_tpu_torch.models import scene_dsl
from cuda_raytracer_tpu_torch.ops.kernels import rays
from cuda_raytracer_tpu_torch.render import packed, pipeline, wavefront
from cuda_raytracer_tpu_torch.utils import metrics

SORTED = [True] * 5 + [False] * 5  # the default schedule at 10 bounces


def _schedule(R, sorted_bounces, compact, sizes, static_rows=None):
    """A ``wavefront.BounceSchedule`` of R rows in one sort chunk."""
    return wavefront.BounceSchedule(tuple(sorted_bounces), R, compact, tuple(sizes),
                                    None if static_rows is None else tuple(static_rows))


def test_segment_plan_on_the_dynamic_prefix():
    sizes = [256, 64, 16, 8]
    plan = packed.segment_plan(_schedule(256, SORTED, True, sizes))
    segments = set(plan.values())
    assert plan[(0, 256, 256)] == packed.Segment(0, (256,), 256, True)
    assert {k for k in plan if k[0] == 1} == {(1, m, 256) for m in sizes}
    for b in (2, 3, 4):
        assert {k for k in plan if k[0] == b} == {
            (b, m, s) for s in sizes for m in sizes if m <= s}
    for (b, n, s), seg in plan.items():
        assert seg.first == b and seg.rows[0] == n and seg.reads == (b < 5)
        assert seg.rows == ((n,) if b < 5 else (n,) * 5)
        assert seg.settled == (s if b < 5 else n)
    # the tail sorts nothing: one graph a prefix, whatever bounce 4 ran on
    assert len(segments) == 1 + 4 + 3 * 10 + 4


def test_segment_plan_on_a_static_schedule():
    rows = [256, 128, 64, 64, 32, 32, 16, 16, 16, 16]
    plan = packed.segment_plan(_schedule(256, SORTED, True, [256, 64, 16, 8], rows))
    assert list(plan.values()) == [
        packed.Segment(0, (256,), 256, True), packed.Segment(1, (128,), 256, True),
        packed.Segment(2, (64,), 128, True), packed.Segment(3, (64,), 64, True),
        packed.Segment(4, (32,), 64, True), packed.Segment(5, (32,) + (16,) * 4, 32, False)]
    assert list(plan) == [(s.first, s.rows[0], prev) for s, prev in
                          zip(plan.values(), [256, 256, 128, 64, 64, 32])]


@pytest.mark.parametrize("sorted_bounces,compact", [
    (SORTED, False), ([False] * 10, True), ([], True)])
def test_segment_plan_without_reads_is_one_segment(sorted_bounces, compact):
    plan = packed.segment_plan(_schedule(300, sorted_bounces, compact, [300, 76]))
    if not sorted_bounces:
        assert plan == {}
    else:
        assert plan == {(0, 300, 300): packed.Segment(0, (300,) * 10, 300, False)}


def _stub(device, intersector, triangles=770, **config):
    return types.SimpleNamespace(
        device=torch.device(device), triangle_count=triangles, bvh_node_count=9,
        config=types.SimpleNamespace(intersector=intersector, **config))


@pytest.mark.parametrize("device,intersector,triangles,plain,want", [
    ("cuda", "auto", 770, False, True), ("cuda", "bvh", 770, False, True),
    ("cuda", "bvh", 770, True, False), ("cuda", "packet", 770, False, False),
    ("cuda", "auto", 500, False, False), ("cpu", "bvh", 770, False, False)])
def test_applies_to_the_walk_on_the_card(device, intersector, triangles, plain, want):
    assert packed.applies(_stub(device, intersector, triangles), plain) == want


@pytest.mark.parametrize("triangles", [500, 770])
@pytest.mark.parametrize("intersector", ["auto", "bvh", "packet"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_the_walk_on_the_card_is_never_reordered(device, intersector, triangles):
    """A 256-row trace of 10 bounces: the first 5 sorted and compacted
    wherever the reorder was useful before, save the walk on the card."""
    sc = _stub(device, intersector, triangles, sort_depth=5, packet_tile=8,
               live_schedule=(1, 2, 4))
    mode = wavefront.resolved_intersector(sc)
    useful = mode != "brute" and not (mode == "bvh" and device == "cuda")
    assert wavefront.reorder_is_useful(sc) == useful
    assert useful == (mode == "packet" or (mode, device) == ("bvh", "cpu"))
    schedule = wavefront.bounce_schedule(sc, 256, 10, True)
    assert schedule.sorted == tuple(useful and b < 5 for b in range(10))
    assert schedule.compact == useful and (schedule.static_rows is not None) == useful
    assert wavefront.wavefront_ordered(sc, 256, 10, True) == (not useful)
    assert not any(wavefront.bounce_schedule(sc, 256, 10, False).sorted)


class _Stream:
    cuda_stream = 0

    def wait_stream(self, other):
        pass


class _Graph:
    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass


class _Event:
    def __init__(self, **kwargs):
        pass

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs stood in for on the CPU; ``stand_in(True)`` turns them on for
    a walk, ``stand_in(False)`` off."""
    for name, value in (("Stream", lambda device: _Stream()),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("current_stream", lambda device=None: _Stream()),
                        ("graph_pool_handle", lambda: None), ("CUDAGraph", _Graph),
                        ("Event", _Event)):
        monkeypatch.setattr(torch.cuda, name, value)
    capture = packed.BlockGraphs._capture

    def capture_and_stand_in(block, sc, segment, pool):
        captured = capture(block, sc, segment, pool)

        def replay():
            with metrics.attached(metrics.Metrics()):
                live, _ = block._issue(sc, segment)
            if live is not None:
                captured.live.copy_(live)
        return captured._replace(graph=types.SimpleNamespace(replay=replay))

    monkeypatch.setattr(packed.BlockGraphs, "_capture", capture_and_stand_in)

    def use(on: bool):
        monkeypatch.setattr(packed, "applies", lambda sc, plain=False: on and not plain and (
            wavefront.resolved_intersector(sc) == "bvh"))
    yield use
    for key in [k for k in scene._DERIVED if k[0] == ("block_graphs",)]:
        scene._DERIVED.pop(key)  # the stand-ins hold their scene


def _glass(**overrides):
    parsed = builtin_scenes.parse_mesh_scene("glass_torus", builtin_scenes.SMALL)
    cfg = dict(width=16, height=16, rays_per_pixel=8, max_rays_per_pixel_per_pass=4,
               bounces=7, intersector="bvh", packet_tile=8)
    cfg.update(overrides)
    return scene_dsl.assemble_scene(parsed, config_overrides=cfg, device="cpu")


def _render(sc):
    m = metrics.Metrics()
    fb = pipeline.render_framebuffer(sc, metrics=m)
    return fb, m.resolve().counters


@pytest.mark.parametrize("schedule", [(), (1, 1, 1.1, 1.2, 2.4, 2.4, 2.4)])
def test_stand_in_graphs_give_the_eager_bits_and_records(stand_in, monkeypatch, schedule):
    """Two passes (pass seeds 4 and 0) of blocks of 400, 400 and 224 rays,
    7 bounces (5 sorted, the tail from bounce 3)."""
    monkeypatch.setattr(pipeline, "RAY_BLOCK", 400)
    sc = _glass(live_schedule=schedule)
    stand_in(False)
    fb, eager = _render(sc)
    assert "bounces.graphed" not in eager and "graph.captures" not in eager
    assert eager["bounces.packed"] == 2 * 3 * 7 and eager["shade.dielectric"] > 0
    stand_in(True)
    first_fb, first = _render(sc)
    again_fb, again = _render(sc)
    assert torch.equal(first_fb, fb) and torch.equal(again_fb, fb)
    plan_graphs = sum(len(set(block.plan.values())) for block in
                      next(v[2] for k, v in scene._DERIVED.items()
                           if k[0] == ("block_graphs",)).values())
    assert first.pop("graph.captures") == plan_graphs and "graph.captures" not in again
    for counters in (first, again):
        assert counters.pop("bounces.graphed") == counters["bounces.packed"]
        assert counters == eager


def test_stand_in_graphs_give_the_eager_live_bounds(stand_in):
    sc = _glass(rays_per_pixel=4)
    ids = torch.arange(16 * 16 * 4, dtype=torch.int32)
    state = wavefront.make_initial_state(sc, ids, 4, 3)
    stand_in(False)
    want = packed.trace_live_bounds(sc, state, 3, 7, True)
    stand_in(True)
    assert packed.trace_live_bounds(sc, state, 3, 7, True) == want
    assert want[0] == 1024 and want[-1] < want[1]


def test_camera_rows_into_out():
    words = rays.camera_words(_glass().camera)
    want = rays.camera_rows(words, 40, 64, 4, 16, 7)
    out = torch.full((64, 16), float("nan"))
    assert rays.camera_rows(words, 40, 64, 4, 16, 7, out) is out
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="out must hold"):
        rays.camera_rows(words, 40, 64, 4, 16, 7, torch.empty((63, 16)))
