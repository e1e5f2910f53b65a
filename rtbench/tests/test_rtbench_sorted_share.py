"""The ``loop.sorted_share`` reader (``rtbench/metrics/``): the share of an
image's packed bounces after which the wavefront was reordered, from the
program's ``bounces.sorted`` and ``bounces.packed`` counters.

It gives nothing for a trace that saw no device operation, for a train
trace, for a program without the registry, for a registry with no packed
bounce and for one without ``bounces.sorted`` (the program before the
counter). From a toy registry it gives 0 where the counter reads 0 and the
ratio otherwise; from toy CPU renders under the profiler (the CPU's walk
and packet engines keep the reorder) the sorted bounces of the schedule.
"""

from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

from rtbench.tests.test_rtbench_graph_share import _toy
from rtbench.tests.test_rtbench_program_metrics import (STAND_IN, UNITS, _fill,
                                                        _reader, _torus, _trace)

NAME = "loop.sorted_share"


@pytest.fixture
def use(monkeypatch):
    """Make a registry the process-wide one for the test."""
    from cuda_raytracer_tpu_torch.utils import metrics

    def put(registry):
        monkeypatch.setattr(metrics, "PROFILED", registry)
        return registry
    return put


def test_nothing_without_device_events_or_from_a_train_trace(use):
    use(_toy(bounces_packed=40, bounces_sorted=20))
    assert _reader(NAME).read(_trace("image", [])) is None
    assert _reader(NAME).read(_trace("train", STAND_IN)) is None


@pytest.mark.parametrize("counters", [
    dict(rays_launched=4096.0), dict(bounces_sorted=0.0), dict(bounces_packed=40)])
def test_nothing_without_packed_bounces_or_the_counter(use, counters):
    use(_toy(**counters))
    assert _reader(NAME).read(_trace("image", STAND_IN)) is None


def test_nothing_from_a_program_without_the_registry(monkeypatch):
    from cuda_raytracer_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "PROFILED")
    assert _reader(NAME).read(_trace("image", STAND_IN)) is None


@pytest.mark.parametrize("sorted_bounces,share", [(0.0, 0.0), (20, 0.5), (30, 0.75)])
def test_share_from_a_toy_registry(use, sorted_bounces, share):
    use(_toy(bounces_packed=40, bounces_sorted=sorted_bounces))
    assert _reader(NAME).read(_trace("image", STAND_IN)) == share


@pytest.mark.parametrize("intersector", ["auto", "bvh"])
def test_cpu_renders_keep_the_reorder(use, intersector):
    """5 bounces, the first 4 sorted (never after the last one)."""
    from cuda_raytracer_tpu_torch.render import pipeline

    def images():
        scene = _torus(width=8, height=8, rays_per_pixel=4, intersector=intersector)
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(UNITS):
                pipeline.render_image(scene, framebuffer=pipeline.render_framebuffer(scene))

    registry = use(_fill(images))
    assert registry.counters["bounces.sorted"] == 4 * UNITS
    assert _reader(NAME).read(_trace("image", STAND_IN)) == 0.8
