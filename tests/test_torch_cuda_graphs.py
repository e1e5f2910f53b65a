"""The bounce loop's CUDA graphs (``render/packed.py``) on the GPU, against the eager loop.

Marked ``cuda``: skipped on a machine without a GPU. On the GPU machine,
which has no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py -q

The small torus and glass torus (768 triangles: "auto" walks the BVH on the
card) at 160×120 × 20 rays a pixel, 10 bounces: a pass of 384,000 rays is a
full block of 262,140 rays and a last block of 121,860. The eager loop is
the same trace with ``packed.applies`` turned off. The walk on the card
reorders nothing by default, so a block is one segment with no read; the
tests of the graphs' segments, reads and row moves give it the sorted
schedule it has on the CPU (``sorted_walk``). Held bit for bit:

- the default render of the torus (no reorder): one replay a block, no
  read, no key or row-move launch, the framebuffer of the sorted schedule
  and the eager loop's framebuffer and records;
- ``trace_packed`` graphed (capturing on its first call, then replaying),
  at a full block, at the pass's last block and at a full block whose rows
  are all dead but one in 64 (its live prefix falls to R / 64), at two pass
  seeds: its rows, suspect count and entering live bounds;
- ``render_framebuffer``, first (capturing) and again (capturing nothing),
  and at another sample count (two passes, other pass seeds; the same block
  shapes, so nothing captured): framebuffers, every counter of the loop's
  records, and the kernels' ``LAUNCHES`` counts over a render;
- a static ``live_schedule`` (a tight one, whose suspect count is not 0)
  and ``trace_live_bounds``;
- the reorder's row move (``rays.reorder_rows``) bit-equal to its plain
  version (``torch.index_select`` and the suffix's slice copy) on a full
  block's rows, the rows past the settled ones untouched; and an 8-spp
  torus and a glass block rendered through it, graphed, bit-identical to
  the eager render with the plain version in its place, ``reorder.rows``
  the settled rows of every sorted bounce;
- the desk lamp (the benchmark's ``desk_lamp`` scene, small, seen from
  close to its glass bulb) rendered graphed, eager while recording and
  eager without a recorder, the same framebuffer each way, and its
  ``shade.emissive`` count the same graphed and eager, equal to a recount
  of the live rows whose hit material emits made from each eager bounce's
  hits as the bounce kernel is handed them.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.ops.kernels import bounce, rays
from cuda_raytracer_tpu_torch.ops.kernels import traverse as traverse_kernel
from cuda_raytracer_tpu_torch.render import packed, pipeline, wavefront
from cuda_raytracer_tpu_torch.utils import metrics

from test_torch_lamp import CAMERAS, CONFIG, DETAIL, LAMP

pytestmark = pytest.mark.cuda

FULL, LAST = 262_140, 384_000 - 262_140
# Counters that differ by path: the graph path's own, and device seconds.
GRAPH_ONLY = ("bounces.graphed", "graph.captures", "sync.device_idle_s")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.fixture
def sorted_walk(monkeypatch):
    """The walk's schedules sorted as on the CPU: reordered after each of
    the first five bounces, the live count read after each."""
    monkeypatch.setattr(wavefront, "reorder_is_useful", lambda scene: True)


@pytest.fixture
def eager(monkeypatch):
    """``eager(True)`` turns the graphs off, ``eager(False)`` back on."""
    applies = packed.applies

    def use(on: bool):
        monkeypatch.setattr(packed, "applies", (lambda *a, **k: False) if on else applies)
    return use


def _scene(device, name="torus", **overrides):
    parsed = builtin_scenes.parse_mesh_scene(name, builtin_scenes.SMALL)
    cfg = dict(width=160, height=120, rays_per_pixel=20, bounces=10, **overrides)
    scene = scene_dsl.assemble_scene(parsed, config_overrides=cfg, device=device)
    assert wavefront.resolved_intersector(scene) == "bvh" and packed.applies(scene)
    return scene


def _block_rows(scene, case: str, seed: int):
    lo, n = (FULL, LAST) if case == "last" else (0, FULL)
    rows = rays.camera_rows(rays.camera_words(scene.camera), lo, n, 20, 160, seed)
    if case == "sparse":
        rows[torch.arange(n, device=rows.device) % 64 != 0, 6:9] = 0.0
    return rows


def _trace(scene, rows, seed):
    """``trace_packed`` of a copy of ``rows`` → (its rows, copied out of the
    block's buffers; suspect; entering bounds)."""
    bounds = []
    out, suspect = packed.trace_packed(scene, rows.clone(), seed, 10, True, bounds=bounds)
    rows = torch.cat(list(out[:4]) + [out.ray_id.view(torch.float32)[:, None]], dim=1)
    return rows.view(torch.int32).clone(), int(suspect), bounds


@pytest.mark.parametrize("name", ["torus", "glass_torus"])
@pytest.mark.parametrize("case", ["full", "last", "sparse"])
def test_trace_packed_graphed_is_the_eager_trace(cuda, eager, sorted_walk, name, case):
    scene = _scene(cuda, name)
    for seed in (60, 2**31 + 5):
        rows = _block_rows(scene, case, seed)
        eager(True)
        want = _trace(scene, rows, seed)
        eager(False)
        for _ in range(2):
            got = _trace(scene, rows, seed)
            assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    R = rows.shape[0]
    sizes = wavefront.live_prefix_sizes(scene, R)
    if case == "sparse":
        assert want[2][1] <= R // 64 and sizes[-1] >= want[2][-1]
    assert want[2][0] == R and want[2][-1] < R


def _launches():
    return (rays.LAUNCHES_SETUP, rays.LAUNCHES_KEYS, rays.LAUNCHES_CAMERA,
            rays.LAUNCHES_REORDER, traverse_kernel.LAUNCHES, bounce.LAUNCHES)


def _render(scene):
    m = metrics.Metrics()
    before = _launches()
    fb = pipeline.render_framebuffer(scene, metrics=m)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(_launches(), before))
    return fb, m.resolve().counters, launched


@pytest.mark.parametrize("name", ["torus", "glass_torus"])
def test_render_graphed_is_the_eager_render(cuda, eager, sorted_walk, name):
    scene = _scene(cuda, name)
    other = scene.with_config(rays_per_pixel=40)  # passes at seeds 20 and 0
    eager(True)
    want = {s: _render(s) for s in (scene, other)}
    eager(False)
    first = _render(scene)
    assert first[1]["graph.captures"] > 0
    for s, got in ((scene, first), (scene, _render(scene)), (other, _render(other))):
        fb, counters, launched = want[s]
        assert torch.equal(got[0], fb)
        graphed = {k: v for k, v in got[1].items() if k not in GRAPH_ONLY}
        assert graphed == {k: v for k, v in counters.items() if k not in GRAPH_ONLY}
        assert got[1]["bounces.graphed"] == counters["bounces.packed"] == 10 * (
            2 * s.config.rays_per_pixel // 20)
        assert "bounces.graphed" not in counters
        if got is not first:
            assert "graph.captures" not in got[1] and got[2] == launched
    assert (want[scene][1]["shade.dielectric"] > 0) == (name == "glass_torus")


def test_default_walk_replays_once_a_block_and_reads_nothing(cuda, eager, monkeypatch):
    """The torus at 20 rays a pixel (blocks of 262,140 and 121,860 rays),
    graphed, against the eager loop and against the sorted schedule."""
    scene = _scene(cuda)
    replays = []
    run = packed.BlockGraphs.run

    def counted(block, segment):
        replays.append(segment)
        return run(block, segment)

    monkeypatch.setattr(packed.BlockGraphs, "run", counted)
    fb, counters, launched = _render(scene)
    assert [s.rows for s in replays] == [(FULL,) * 10, (LAST,) * 10]
    assert counters.get("sync.host", 0) == 0 and counters["bounces.sorted"] == 0
    assert counters["bounces.graphed"] == counters["bounces.packed"] == 20
    assert counters["rays.launched"] == 10 * (FULL + LAST) and "reorder.rows" not in counters
    assert launched[1] == launched[3] == 0  # no key kernel, no row move
    eager(True)
    eager_fb, eager_counters, _ = _render(scene)
    eager(False)
    assert torch.equal(eager_fb, fb)
    assert ({k: v for k, v in eager_counters.items() if k not in GRAPH_ONLY}
            == {k: v for k, v in counters.items() if k not in GRAPH_ONLY})
    monkeypatch.setattr(wavefront, "reorder_is_useful", lambda sc: True)
    sorted_fb, sorted_counters, sorted_launched = _render(scene)
    assert torch.equal(sorted_fb, fb)
    assert sorted_counters["bounces.sorted"] == sorted_counters["sync.host"] == 10
    assert sorted_counters["rays.live"] == counters["rays.live"]
    assert sorted_launched[1] == sorted_launched[3] == 10
    assert len(replays) == 2 + 2 * 6  # a segment a read, and the tail


def settled_rows(scene, R: int, bounces: int, bounds) -> int:
    """The rows the row moves of an R-row trace write, given its entering
    live bounds: at each sorted bounce the rows settled on entry, its prefix
    and the suffix of earlier prefixes the buffer pair must share."""
    schedule = wavefront.bounce_schedule(scene, R, bounces, True)
    settled, total = R, 0
    for b, do_sort in enumerate(schedule.sorted):
        n, _ = schedule.rows(b, bounds[b])
        total += settled if do_sort else 0
        settled = n if do_sort else max(settled, n)
    return total


@pytest.mark.parametrize("index", [torch.int64, torch.int32])
def test_reorder_rows_is_index_select(cuda, index):
    """A full block's bounced rows sorted and moved: the prefix of all
    262,140 rows, and a prefix of 100,001 with a suffix up to 200,003."""
    scene = _scene(cuda)
    rows = _block_rows(scene, "full", 60)
    wavefront.bounce_rows(scene, rows, 60, 0)
    order, _ = wavefront.sort_order(scene, rows, FULL)
    g = torch.Generator(device=cuda).manual_seed(5)
    for n, settled in ((FULL, FULL), (100_001, 200_003)):
        perm = order if n == FULL else torch.randperm(n, generator=g, device=cuda)
        spare = torch.full((FULL + 7, rays.ROW_WORDS), -7.0, device=cuda)
        before = rays.LAUNCHES_REORDER
        got = rays.reorder_rows(rows, perm.to(index), n, settled, spare.clone())
        want = rays.plain_reorder_rows(rows, perm.to(index), n, settled, spare.clone())
        torch.cuda.synchronize()
        assert rays.LAUNCHES_REORDER == before + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert (got[settled:] == -7.0).all() and not torch.equal(got[:n], rows[:n])


@pytest.mark.parametrize("name", ["torus", "glass_torus"])
def test_render_through_the_row_move_is_the_index_select_render(cuda, eager, monkeypatch,
                                                                  sorted_walk, name):
    """One 153,600-ray block of 8 spp a pixel, graphed and eager with the
    row move's plain version; then the block's trace on its own, the
    counter against the live bounds."""
    scene = _scene(cuda, name).with_config(rays_per_pixel=8)
    R = 160 * 120 * 8
    got = _render(scene)
    kernel = rays.reorder_rows
    monkeypatch.setattr(rays, "reorder_rows", rays.plain_reorder_rows)
    eager(True)
    want = _render(scene)
    monkeypatch.setattr(rays, "reorder_rows", kernel)
    assert torch.equal(got[0], want[0]) and "reorder.rows" not in want[1]
    assert got[1]["reorder.rows"] > R
    eager(False)
    m, bounds = metrics.Metrics(), []
    rows = rays.camera_rows(rays.camera_words(scene.camera), 0, R, 8, 160, 20)
    with metrics.attached(m):
        packed.trace_packed(scene, rows, 20, 10, True, bounds=bounds)
    assert m.resolve().counters["reorder.rows"] == settled_rows(scene, R, 10, bounds)


def test_static_schedule_and_live_bounds(cuda, eager, sorted_walk):
    scene = _scene(cuda, "glass_torus")
    rows = _block_rows(scene, "full", 40)
    tight = scene.with_config(live_schedule=(1, 4, 16, 64))
    ids = torch.arange(FULL, dtype=torch.int32, device=cuda)
    state = wavefront.make_initial_state(scene, ids, 20, 40)
    eager(True)
    want = _trace(tight, rows, 40), packed.trace_live_bounds(scene, state, 40, 10, True)
    eager(False)
    got = _trace(tight, rows, 40), packed.trace_live_bounds(scene, state, 40, 10, True)
    assert torch.equal(got[0][0], want[0][0]) and got[0][1:] == want[0][1:]
    assert got[1] == want[1] and want[0][1] > 0


def _lamp(device):
    """The lamp at detail 0.05 (4,730 triangles) at 160×120 × 20 rays a pixel
    and 10 bounces, seen from close to its bulb, so paths reach the
    filament through the glass; the configuration's render settings."""
    params = dict(CONFIG["scene_params"], detail=DETAIL, camera=CAMERAS["bulb"])
    text, _ = LAMP.generate(params, np.random.default_rng(3))
    parsed = scene_dsl.parse_scene_text(text + "image 160 120 20 10 0.1\n", filename="lamp")
    scene = scene_dsl.assemble_scene(parsed, config_overrides=CONFIG["render"], device=device)
    assert wavefront.resolved_intersector(scene) == "bvh" and packed.applies(scene)
    return scene


def test_lamp_emissive_count_graphed_and_eager(cuda, eager, monkeypatch):
    scene = _lamp(cuda)
    emits = (scene.materials.emitted.detach() > 0).any(dim=1)
    recount = torch.zeros(1, dtype=torch.int64, device=cuda)
    kernel = bounce.shade_rows

    def recounted(scene_, rows, t, index, *args, **kwargs):
        alive = (rows[:, 6:9] != 0).any(dim=1)
        material = scene_.material_index[index.clamp_min(0).long()].long()
        recount.add_((alive & (index >= 0) & emits[material]).sum())
        return kernel(scene_, rows, t, index, *args, **kwargs)

    eager(True)
    unrecorded = pipeline.render_framebuffer(scene)
    monkeypatch.setattr(bounce, "shade_rows", recounted)
    fb, counters, _ = _render(scene)
    monkeypatch.setattr(bounce, "shade_rows", kernel)
    eager(False)
    graphed = _render(scene)
    assert torch.equal(fb, unrecorded) and torch.equal(graphed[0], unrecorded)
    assert counters["shade.emissive"] == graphed[1]["shade.emissive"] == int(recount)
    assert 0 < int(recount) < counters["rays.live"]
