"""The per-layer readers of what the program records about itself
(``rtbench/core/program.py``: the port's ``utils/metrics.PROFILED``).

Each reader gives nothing for a trace that saw no device operation (a CPU
run), or for a version of the program without the registry. With the registry filled by toy renders and train steps on the
CPU under the profiler, and a stand-in device event list, each gives its
record over the trace's images or steps.
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtbench.core import spec
from rtbench.core.trace import Trace
from rtbench.tests.conftest import REPO

IMAGE = {"loop.host_syncs": ("counters", "sync.host", 1.0),
         "loop.sync_idle_ms": ("counters", "sync.device_idle_s", 1e3),
         "loop.live_ray_bounces": ("counters", "rays.live", 1e-6)}
TRAIN = {"diff.forward_ms": ("phases", "rt.step.forward", 1e3),
         "diff.backward_ms": ("phases", "rt.step.backward", 1e3)}
READERS = sorted(IMAGE) + ["loop.rows_per_live_ray"] + sorted(TRAIN)
UNITS = 2
STAND_IN = [("stand_in_kernel", 0.0, 1.0)]


def _reader(name: str):
    return spec.load_module(REPO / "rtbench" / "metrics" / f"{name}.py")


def _trace(kind: str, events) -> Trace:
    return Trace(kind, UNITS, list(events), 1e-6, 1.0, [], 0.0)


def _torus(**cfg):
    from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl

    parsed = builtin_scenes.parse_mesh_scene("torus", builtin_scenes.SMALL)
    return scene_dsl.assemble_scene(parsed, config_overrides=dict(cfg, bounces=5),
                                    device="cpu")


def _fill(fill):
    """A registry that ``fill`` filled as the process-wide one."""
    from cuda_raytracer_tpu_torch.utils import metrics

    with pytest.MonkeyPatch.context() as m:
        m.setattr(metrics, "PROFILED", metrics.Metrics())
        fill()
        return metrics.PROFILED.resolve()


def _images():
    from cuda_raytracer_tpu_torch.render import pipeline
    from cuda_raytracer_tpu_torch.utils import metrics

    scene = _torus(width=16, height=16, rays_per_pixel=4)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(UNITS):
            pipeline.render_image(scene, framebuffer=pipeline.render_framebuffer(scene))
    # no card here, so no event pairs: a stand-in for the device idle
    metrics.PROFILED.count("sync.device_idle_s", 0.004)


def _steps():
    from cuda_raytracer_tpu_torch.render import diff

    scene = _torus(width=8, height=8)
    params = diff.make_leaves(diff.split_params(scene)[0])
    target = torch.zeros((scene.num_pixels, 3))
    step = diff.make_train_step(scene, torch.optim.Adam(diff.param_leaves(params), lr=0.02),
                                rays_per_pixel=2, bounces=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(UNITS):
            step(params, target, k)


@pytest.fixture(scope="module")
def images():
    return _fill(_images)


@pytest.fixture(scope="module")
def steps():
    return _fill(_steps)


@pytest.fixture
def use(monkeypatch):
    """Make a filled registry the process-wide one for the test."""
    from cuda_raytracer_tpu_torch.utils import metrics

    def put(registry):
        monkeypatch.setattr(metrics, "PROFILED", registry)
        return registry
    return put


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_device_events(images, use, name):
    use(images)
    for kind in ("image", "train"):
        assert _reader(name).read(_trace(kind, [])) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_from_a_program_without_the_registry(monkeypatch, name):
    from cuda_raytracer_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "PROFILED")
    for kind in ("image", "train"):
        assert _reader(name).read(_trace(kind, STAND_IN)) is None


@pytest.mark.parametrize("name", sorted(IMAGE))
def test_image_readers_give_the_record_per_image(images, use, name):
    section, key, scale = IMAGE[name]
    want = getattr(use(images), section)[key] / UNITS * scale
    assert want > 0
    assert _reader(name).read(_trace("image", STAND_IN)) == pytest.approx(want, rel=1e-12)
    assert _reader(name).read(_trace("train", STAND_IN)) is None
    if name == "loop.host_syncs":  # 4 sorted bounces of one block, and the suspect count
        assert _reader(name).read(_trace("image", STAND_IN)) == 5


def test_rows_per_live_ray(images, use):
    c = use(images).counters
    got = _reader("loop.rows_per_live_ray").read(_trace("image", STAND_IN))
    assert got == pytest.approx(c["rays.launched"] / c["rays.live"], rel=1e-12) and got >= 1


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_readers_give_the_span_per_step(steps, use, name):
    section, key, scale = TRAIN[name]
    want = getattr(use(steps), section)[key] / UNITS * scale
    assert want > 0
    assert _reader(name).read(_trace("train", STAND_IN)) == pytest.approx(want, rel=1e-12)
    assert _reader(name).read(_trace("image", STAND_IN)) is None
