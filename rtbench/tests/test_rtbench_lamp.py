"""The desk-lamp cell's files (``desk_lamp``): its scene generator, its
reader and a toy version of the cell run on the CPU.

- ``rtbench/scenes/desk_lamp.py`` is seeded: the same seed gives the same
  text, and another seed changes only the floor's, the wall's and the
  filament's material lines, never a triangle, the sky or the camera.
- ``triangle_count`` counts the ``triangle`` lines the generator writes,
  and at ``detail`` 1 it is the configuration's ``triangles``, the
  upstream lamp's 619,350 primitives.
- At a small ``detail`` and at the published one, at least 99 % of the
  triangles lie in the lamp's box, at most 1.5 on a side, no triangle is
  degenerate in float32, and the glass bulb's triangles face out.
- The reader ``shade.emitter_share`` gives nothing for a trace that saw no
  device operation, for a train trace or for a program without the
  registry or the counter, and its value on a registry filled by hand.
- A toy lamp cell, added by files only to a copy of the benchmark, runs
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

CELL = "desk_lamp.final_100spp"
TOY = "toy_lamp.image"
READER = "shade.emitter_share"
DETAIL = 0.05
ROOM = ("floor", "wall")


def _config() -> dict:
    return spec.load_cell(REPO, CELL).config


def _generator():
    return spec.load_cell(REPO, CELL).scene_module()


def _params(detail: float) -> dict:
    return dict(_config()["scene_params"], detail=detail)


def test_scene_generator_is_seeded_and_moves_only_three_materials():
    gen = _generator()
    a, files = gen.generate(_params(DETAIL), np.random.default_rng(7))
    b, _ = gen.generate(_params(DETAIL), np.random.default_rng(7))
    other, _ = gen.generate(_params(DETAIL), np.random.default_rng(8))
    assert a == b and files == {}
    lines, other_lines = a.splitlines(), other.splitlines()
    changed = [i for i, (x, y) in enumerate(zip(lines, other_lines)) if x != y]
    assert len(lines) == len(other_lines)
    assert [lines[i].split()[1] for i in changed] == ["floor", "wall", "filament"]
    params = _params(DETAIL)
    for i in changed[:2]:
        albedo = [float(v) for v in lines[i].split()[3:6]]
        assert all(lo <= v <= hi for v, lo, hi in zip(albedo, params["albedo_low"],
                                                      params["albedo_high"]))
    emit = [float(v) for v in lines[changed[2]].split()[-3:]]
    tint = np.array(emit) / params["emit"]
    assert ((tint >= np.array(params["filament_tint_low"]) - 1e-6)
            & (tint <= np.array(params["filament_tint_high"]) + 1e-6)).all()
    assert sum(line.startswith("material ") for line in lines) == 8
    assert [line.split()[0] for line in lines if not line.startswith(("material", "triangle"))] \
        == ["sky", "camera"]


@pytest.mark.parametrize("detail", [DETAIL, 0.08])
def test_triangle_count_is_the_triangle_lines(detail):
    gen = _generator()
    text, _ = gen.generate(_params(detail), np.random.default_rng(1))
    lines = sum(line.startswith("triangle ") for line in text.splitlines())
    assert lines == gen.triangle_count(_params(detail)) < 10_000


def test_triangle_count_at_the_published_size():
    count = _generator().triangle_count(_params(1.0))
    assert count == _config()["triangles"] == 619_350
    assert _config()["scene_params"]["detail"] == 1.0 and _config()["reduced"] == []


@pytest.mark.parametrize("detail", [DETAIL, 1.0])
def test_lamp_geometry_is_compact_and_sound(detail):
    parts = _generator().parts(_params(detail))
    tris = np.concatenate([t for _, _, t in parts]).astype(np.float32).reshape(-1, 3, 3)
    lamp = np.concatenate([t for _, m, t in parts if m not in ROOM]).reshape(-1, 3, 3)
    lo, hi = lamp.reshape(-1, 3).min(0), lamp.reshape(-1, 3).max(0)
    assert (hi - lo <= 1.5).all()
    inside = ((tris >= lo - 1e-6) & (tris <= hi + 1e-6)).all(axis=(1, 2))
    assert inside.mean() >= 0.99
    cross = np.cross(tris[:, 2] - tris[:, 0], tris[:, 1] - tris[:, 0])
    assert (np.linalg.norm(cross, axis=-1) > 0).all()
    assert sorted({m for _, m, _ in parts}) == sorted(
        ["floor", "wall", "black_metal", "chrome", "reflector", "glass", "filament", "cable"])
    (bulb,) = [t.reshape(-1, 3, 3) for _, m, t in parts if m == "glass"]
    centre = bulb.reshape(-1, 3).mean(0)
    outward = np.cross(bulb[:, 2] - bulb[:, 0], bulb[:, 1] - bulb[:, 0])
    assert (np.sum(outward * (bulb.mean(axis=1) - centre), -1) > 0).all()


@pytest.fixture
def registry(monkeypatch):
    """A registry filled by hand as the process-wide one: 2 images of 1,000
    live ray-bounces and 30 rows on an emitter."""
    from cuda_raytracer_tpu_torch.utils import metrics

    filled = metrics.Metrics()
    filled.counters.update({"rays.live": 2000.0, "shade.emissive": 60.0})
    monkeypatch.setattr(metrics, "PROFILED", filled)
    return filled


def test_reader_value(registry):
    assert _reader(READER).read(_trace("image", STAND_IN)) == pytest.approx(0.03)
    assert _reader(READER).read(_trace("image", [])) is None
    assert _reader(READER).read(_trace("train", STAND_IN)) is None


def test_reader_gives_nothing_without_the_records(monkeypatch):
    from cuda_raytracer_tpu_torch.utils import metrics

    without = metrics.Metrics()
    without.counters["rays.live"] = 2000.0  # a program without the counter
    monkeypatch.setattr(metrics, "PROFILED", without)
    assert _reader(READER).read(_trace("image", STAND_IN)) is None
    monkeypatch.delattr(metrics, "PROFILED")
    assert _reader(READER).read(_trace("image", STAND_IN)) is None


@pytest.fixture(scope="module")
def lamp_root(tmp_path_factory):
    """A copy of the benchmark with the toy cells and a toy lamp cell, a
    16 × 12 × 25-spp × 10-bounce image of the lamp at detail 0.05 (4,730
    triangles) with the real cell's limits, added as files and entries
    only."""
    root = make_toy_root(tmp_path_factory.mktemp("lamproot"))
    rt = root / "rtbench"
    cfg = json.loads((rt / "configs" / "desk_lamp.json").read_text())
    cfg.update(name="toy_lamp", width=16, height=12)
    cfg["scene_params"].update(detail=DETAIL)
    (rt / "configs" / "toy_lamp.json").write_text(json.dumps(cfg))
    limits = json.loads((rt / "workloads" / f"{CELL}.json").read_text())
    limits["check_pixels"] = 64
    (rt / "workloads" / f"{TOY}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="toy_lamp", source="toy", reduced=[], why="test",
                                 file="rtbench/configs/toy_lamp.json"))
    bench["workloads"].append(dict(name=TOY, config="toy_lamp", traffic="toy_image", chips=1,
                                   why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TOY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_toy_lamp_cell_matches_the_reference(lamp_root):
    rc, result, err = drive(lamp_root, TOY, 2 ** 31 + 19)
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]
    assert {"image_s", "setup_s"} <= set(result["metrics"])


def test_toy_lamp_cell_catches_an_altered_framebuffer(lamp_root, monkeypatch):
    IMAGE_FAULTS["framebuffer_altered"](monkeypatch)
    rc, result, err = drive(lamp_root, TOY, 23)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
