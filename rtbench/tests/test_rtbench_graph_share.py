"""The ``loop.graph_share`` and ``loop.graph_captures`` readers
(``rtbench/metrics/``): the share of an image's packed bounces that ran
inside a CUDA graph's replay, and the graphs captured per image, from the
program's ``bounces.graphed``, ``bounces.packed`` and ``graph.captures``
counters.

Both give nothing for a trace that saw no device operation, for a train
trace, for a program without the registry, and for a registry without the
counters (the program before its graphs). From a toy registry they give the
share and the count per image; from toy CPU renders under the profiler
(the CPU traces bounce by bounce) a share of 0 and no captures.
"""

from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

from rtbench.tests.test_rtbench_program_metrics import (STAND_IN, UNITS, _fill,
                                                        _reader, _torus, _trace)

NAMES = ("loop.graph_share", "loop.graph_captures")


@pytest.fixture
def use(monkeypatch):
    """Make a registry the process-wide one for the test."""
    from cuda_raytracer_tpu_torch.utils import metrics

    def put(registry):
        monkeypatch.setattr(metrics, "PROFILED", registry)
        return registry
    return put


def _toy(**counters):
    from cuda_raytracer_tpu_torch.utils import metrics

    registry = metrics.Metrics()
    for name, value in counters.items():
        registry.count(name.replace("_", "."), value)
    return registry


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_device_events_or_from_a_train_trace(use, name):
    use(_toy(bounces_packed=40, bounces_graphed=40, graph_captures=6))
    assert _reader(name).read(_trace("image", [])) is None
    assert _reader(name).read(_trace("train", STAND_IN)) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_from_a_program_without_the_registry_or_the_counters(monkeypatch, use, name):
    from cuda_raytracer_tpu_torch.utils import metrics

    use(_toy(rays_launched=4096.0))
    assert _reader(name).read(_trace("image", STAND_IN)) is None
    monkeypatch.delattr(metrics, "PROFILED")
    assert _reader(name).read(_trace("image", STAND_IN)) is None


@pytest.mark.parametrize("counters,share,captures", [
    (dict(bounces_packed=40, bounces_graphed=40), 1.0, 0.0),
    (dict(bounces_packed=40, bounces_graphed=30, graph_captures=6), 0.75, 6 / UNITS),
    (dict(bounces_packed=40), 0.0, 0.0)])
def test_share_and_captures_from_a_toy_registry(use, counters, share, captures):
    use(_toy(**counters))
    assert _reader("loop.graph_share").read(_trace("image", STAND_IN)) == share
    assert _reader("loop.graph_captures").read(_trace("image", STAND_IN)) == captures


def test_cpu_renders_replay_no_graph(use):
    from cuda_raytracer_tpu_torch.render import pipeline

    def images():
        scene = _torus(width=8, height=8, rays_per_pixel=4)
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(UNITS):
                pipeline.render_image(scene, framebuffer=pipeline.render_framebuffer(scene))

    registry = use(_fill(images))
    assert registry.counters["bounces.packed"] == 5 * UNITS
    assert _reader("loop.graph_share").read(_trace("image", STAND_IN)) == 0.0
    assert _reader("loop.graph_captures").read(_trace("image", STAND_IN)) == 0.0
