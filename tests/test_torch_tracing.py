"""The render and train loops' spans and counters (``utils/metrics``).

- Recording is off without a profiler or an attached registry: the
  process-wide registry stays empty, and framebuffers and train-step losses
  are bit-identical with recording on (attached, or under the profiler).
- Under a CPU ``torch.profiler`` the ``rt.*`` spans appear in the trace,
  nested pass > block > camera / bounce / accumulate, bounce > tail,
  reorder and the live count's read, and go to ``PROFILED``.
- Per block of a small mesh scene, ``rays.live`` counts the live rows
  entering each bounce (against the ``RayState`` trace's own count, and
  ``trace_live_bounds`` where that bound is exact), ``rays.launched`` the
  prefix each bounce ran on, and ``sync.host`` the sorted bounces.
- A train step records its three ``rt.step.*`` spans.
- The CLI's ``--metrics`` line carries the loop counters and spans.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch import cli
from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.render import diff, packed, pipeline, wavefront
from cuda_raytracer_tpu_torch.utils import metrics

LOOP_SPANS = ("rt.pass", "rt.block", "rt.camera", "rt.bounce", "rt.tail", "rt.reorder",
              "rt.accumulate")
STEP_SPANS = ("rt.step.forward", "rt.step.backward", "rt.step.adam")


def _torus(**overrides):
    parsed = builtin_scenes.parse_mesh_scene("torus", builtin_scenes.SMALL)
    cfg = dict(width=16, height=16, rays_per_pixel=4, bounces=5)
    cfg.update(overrides)
    return scene_dsl.assemble_scene(parsed, config_overrides=cfg, device="cpu")


@pytest.fixture
def profiled(monkeypatch):
    """A fresh process-wide registry for the test."""
    fresh = metrics.Metrics()
    monkeypatch.setattr(metrics, "PROFILED", fresh)
    return fresh


def _empty(m: metrics.Metrics) -> bool:
    return not (m.phases or m.counters or m.series or m._device or m._idle)


def test_recording_off_is_empty_and_bit_identical_to_on(profiled):
    scene = _torus()
    assert metrics.recorder() is None
    off = pipeline.render_framebuffer(scene)
    assert _empty(profiled)
    attached = metrics.Metrics()
    on = pipeline.render_framebuffer(scene, metrics=attached)
    assert _empty(profiled) and attached.resolve().counters["rays.live"] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        assert metrics.recorder() is profiled
        traced = pipeline.render_framebuffer(scene)
    assert metrics.recorder() is None
    assert profiled.resolve().counters == attached.counters
    assert torch.equal(off, on) and torch.equal(off, traced)


def _train(scene, steps_metrics):
    """Two train steps from the same start → (losses, final leaves)."""
    true = diff.params_to_numpy(diff.split_params(scene)[0])
    true["materials.diffuse_albedo"][0] *= 0.5
    params = diff.params_from_numpy(true, "cpu", requires_grad=True)
    target = diff.render_radiance(diff.split_params(scene)[0], scene, 3, 2, 3).detach()
    opt = torch.optim.Adam(diff.param_leaves(params), lr=0.02)
    step = diff.make_train_step(scene, opt, rays_per_pixel=2, bounces=3,
                                metrics=steps_metrics)
    losses = [step(params, target, 5 + k) for k in range(2)]
    return losses, [p.detach().clone() for p in diff.param_leaves(params)]


def test_train_step_records_three_spans_and_keeps_its_bits(profiled):
    scene = _torus(width=8, height=8)
    off_losses, off_leaves = _train(scene, None)
    assert _empty(profiled)
    attached = metrics.Metrics()
    on_losses, on_leaves = _train(scene, attached)
    for name in STEP_SPANS + ("rt.bounce", "rt.reorder"):
        assert attached.phases[name] > 0, name
    assert attached.phases["rt.step.forward"] > attached.phases["rt.bounce"]
    # the live count's read after each sorted bounce (3 bounces: 2 sorted) a step
    assert attached.counters["sync.host"] == 2 * 2
    assert all(torch.equal(a, b) for a, b in zip(off_losses, on_losses))
    assert all(torch.equal(a, b) for a, b in zip(off_leaves, on_leaves))
    assert _empty(profiled)


def _inside(inner, outer) -> bool:
    return (inner.thread == outer.thread and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_spans_nest_under_the_profiler(profiled):
    scene = _torus(rays_per_pixel=2)
    fb = pipeline.render_framebuffer(scene)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline.render_image(scene, framebuffer=pipeline.render_framebuffer(scene))
    events = {}
    for e in prof.events():
        if e.name.startswith("rt.") or e.name == "aten::item":
            events.setdefault(e.name, []).append(e)
    reads = [e for e in events.pop("aten::item") if any(_inside(e, b) for b in events["rt.bounce"])]
    assert set(events) == set(LOOP_SPANS) | {"rt.post"}
    parent = {"rt.block": "rt.pass", "rt.camera": "rt.block", "rt.bounce": "rt.block",
              "rt.accumulate": "rt.block", "rt.reorder": "rt.bounce", "rt.tail": "rt.bounce"}
    for name, outer in parent.items():
        for e in events[name]:
            assert any(_inside(e, o) for o in events[outer]), (name, outer)
    assert not any(_inside(p, b) for p in events["rt.post"] for b in events["rt.pass"])
    # one pass of one block, 5 bounces of which 4 are sorted: a live-count read each;
    # the tail is bounces 2-4
    assert [len(events[n]) for n in ("rt.pass", "rt.block", "rt.bounce", "rt.tail")] + [
        len(reads)] == [1, 1, 5, 3, 4]
    assert set(profiled.phases) == set(LOOP_SPANS) | {"rt.post"}
    assert torch.equal(fb, pipeline.render_framebuffer(scene))


def _live_entering(scene, lo, rays, rpp, seed, bounces):
    """The live rows entering bounces 0..bounces-1 of a block, counted by a
    torch reduction over the ``RayState`` trace's wavefront."""
    ray_id = lo + torch.arange(rays, dtype=torch.int32)
    state = wavefront.make_initial_state(scene, ray_id, rpp, seed)
    counts = []
    for k in range(bounces):
        out, _ = wavefront.trace_rays(scene, state, seed, k, sort_rays=True)
        counts.append(int(torch.any(out.transmitted != 0, dim=-1).sum()))
    return counts


@pytest.mark.parametrize("block", [0, 1])
def test_live_rays_per_bounce_match_an_independent_count(block):
    rpp, seed, bounces, rays = 4, 11, 5, 512
    scene = _torus(rays_per_pixel=rpp, bounces=bounces)
    lo = block * rays
    want = _live_entering(scene, lo, rays, rpp, seed, bounces)
    schedule = wavefront.bounce_schedule(scene, rays, bounces, True)
    totals = []
    for k in range(1, bounces + 1):
        m = metrics.Metrics()
        with metrics.attached(m):
            packed.trace_camera(scene, lo, rays, rpp, seed, k, sort_rays=True)
        totals.append(m.resolve().counters)
        assert m.counters.get("sync.host", 0) == sum(
            wavefront.bounce_schedule(scene, rays, k, True).sorted)
    live = [t["rays.live"] for t in totals]
    launched = [t["rays.launched"] for t in totals]
    per_bounce = [live[0]] + [b - a for a, b in zip(live, live[1:])]
    rows = [launched[0]] + [b - a for a, b in zip(launched, launched[1:])]
    assert per_bounce == want and want[-1] < want[0]
    assert all(n in schedule.sizes and n >= w for n, w in zip(rows, want))
    ray_id = lo + torch.arange(rays, dtype=torch.int32)
    bounds = packed.trace_live_bounds(
        scene, wavefront.make_initial_state(scene, ray_id, rpp, seed), seed, bounces, True)
    assert bounds[0] == want[0] == rays
    for b in range(1, bounces):
        if schedule.sorted[b - 1]:
            assert bounds[b] == want[b]


def test_cli_metrics_line_carries_the_loop_counters(tmp_path, capsys):
    scene = tmp_path / "torus.scene"
    scene.write_text(builtin_scenes.torus(builtin_scenes.SMALL))
    assert cli.main([str(scene), "cpu", "no_gpu", "--width", "16", "--height", "16",
                     "--spp", "2", "--bounces", "3", "--metrics",
                     "--out", str(tmp_path / "t.png")]) == 0
    line = json.loads([s for s in capsys.readouterr().err.splitlines() if s.startswith("{")][-1])
    assert line["counters"]["sync.host"] >= 2  # two sorted bounces, and the suspect count
    assert line["counters"]["rays.launched"] >= line["counters"]["rays.live"] > 0
    assert {"rt.pass", "rt.block", "rt.bounce", "rt.post"} <= set(line["phases"])
