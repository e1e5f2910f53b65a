"""The glass-teapot cell's files (``glass_teapot_torus``): its scene
generator, its readers and a toy version of the cell run on the CPU.

- ``rtbench/scenes/glass_torus.py`` is seeded: the same seed gives the same
  text and sky, and another seed changes only the glass's tint line and the
  sky (the sun), never a triangle or the camera.
- The readers ``shade.dielectric_share``, ``loop.tail_share`` and
  ``loop.tail_ms`` give nothing for a trace that saw no device operation,
  for a train trace or for a program without the registry, and their value
  on a registry filled by hand.
- A toy glass cell, added by files only to a copy of the benchmark, runs
  ``run.main`` on the CPU to ``correct`` true, and to false with the
  framebuffer altered by 5 %.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from rtbench.core import spec
from rtbench.tests.conftest import REPO, make_toy_root
from rtbench.tests.test_rtbench_faults import IMAGE_FAULTS
from rtbench.tests.test_rtbench_program_metrics import STAND_IN, _reader, _trace
from rtbench.tests.test_rtbench_run import drive

CELL = "glass_teapot_torus.final_100spp"
TOY = "toy_glass.image"
READERS = ("shade.dielectric_share", "loop.tail_share", "loop.tail_ms")


def _params(**shrink):
    return dict(spec.load_cell(REPO, CELL).config["scene_params"], **shrink)


def test_scene_generator_is_seeded_and_moves_only_the_light():
    gen = spec.load_cell(REPO, CELL).scene_module()
    params = _params(ring=12, tube=8, sky_size=16)
    a, sky_a = gen.generate(params, np.random.default_rng(7))
    b, sky_b = gen.generate(params, np.random.default_rng(7))
    other, sky_other = gen.generate(params, np.random.default_rng(8))
    assert a == b and np.array_equal(sky_a["sky.pfm"], sky_b["sky.pfm"])
    lines, other_lines = a.splitlines(), other.splitlines()
    changed = [i for i, (x, y) in enumerate(zip(lines, other_lines)) if x != y]
    assert len(lines) == len(other_lines) and changed == [0]
    assert lines[0].startswith(f"material {gen.OBJECT_MATERIAL} diffuse ")
    assert lines[0].endswith(f" ior {gen.IOR}")
    tint = [float(v) for v in lines[0].split()[3:6]]
    assert all(0.85 <= v <= 1.0 for v in tint)
    assert not np.array_equal(sky_a["sky.pfm"], sky_other["sky.pfm"])
    assert sum(line.startswith("triangle glass ") for line in lines) == 12 * 8 * 2


@pytest.fixture
def registry(monkeypatch):
    """A registry filled by hand as the process-wide one: 2 images of 1,000
    live ray-bounces, 400 dielectric scatters, 70 tail bounces and 0.5 s in
    the tail."""
    from cuda_raytracer_tpu_torch.utils import metrics

    filled = metrics.Metrics()
    filled.counters.update({"rays.live": 2000.0, "shade.dielectric": 800.0,
                            "rays.live_tail": 140.0})
    filled.phases["rt.tail"] = 1.0
    monkeypatch.setattr(metrics, "PROFILED", filled)
    return filled


@pytest.mark.parametrize("name,want", zip(READERS, (0.4, 0.07, 500.0)))
def test_reader_values(registry, name, want):
    assert _reader(name).read(_trace("image", STAND_IN)) == pytest.approx(want)
    assert _reader(name).read(_trace("image", [])) is None
    assert _reader(name).read(_trace("train", STAND_IN)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_without_the_records(monkeypatch, name):
    from cuda_raytracer_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics, "PROFILED", metrics.Metrics())  # a program without them
    assert _reader(name).read(_trace("image", STAND_IN)) is None
    monkeypatch.delattr(metrics, "PROFILED")
    assert _reader(name).read(_trace("image", STAND_IN)) is None


@pytest.fixture(scope="module")
def glass_root(tmp_path_factory):
    """A copy of the benchmark with the toy cells and a toy glass cell, a
    16 × 12 × 25-spp × 10-bounce image of a 384-triangle glass torus with
    the real cell's limits, added as files and entries only."""
    root = make_toy_root(tmp_path_factory.mktemp("glassroot"))
    rt = root / "rtbench"
    cfg = json.loads((rt / "configs" / "glass_teapot_torus.json").read_text())
    cfg.update(name="toy_glass", width=16, height=12)
    cfg["scene_params"].update(ring=24, tube=8, sky_size=32)
    (rt / "configs" / "toy_glass.json").write_text(json.dumps(cfg))
    limits = json.loads((rt / "workloads" / f"{CELL}.json").read_text())
    limits["check_pixels"] = 64
    (rt / "workloads" / f"{TOY}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="toy_glass", source="toy", reduced=[], why="test",
                                 file="rtbench/configs/toy_glass.json"))
    bench["workloads"].append(dict(name=TOY, config="toy_glass", traffic="toy_image", chips=1,
                                   why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TOY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_toy_glass_cell_matches_the_reference(glass_root):
    rc, result, err = drive(glass_root, TOY, 2 ** 31 + 19)
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]
    assert {"image_s", "setup_s"} <= set(result["metrics"])


def test_toy_glass_cell_catches_an_altered_framebuffer(glass_root, monkeypatch):
    IMAGE_FAULTS["framebuffer_altered"](monkeypatch)
    rc, result, err = drive(glass_root, TOY, 23)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
