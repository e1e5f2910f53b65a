"""The *Ray Tracing in One Weekend* cell's files (``rtiow_final``): its
scene generator, its two readers and a toy version of the cell run on the
CPU.

- ``rtbench/scenes/rtiow_final.py`` keeps the book's rules: 22 × 22
  candidates of radius 0.2 at ``(a + 0.9 u, 0.2, b + 0.9 v)``, those within
  0.9 of (4, 0.2, 0) skipped, the ground and the three large spheres, one
  material a sphere, the kinds and fuzz of the layout seed, the count the
  configuration writes beside it; the run's seed moves only the small
  spheres' albedos, within the book's ranges; the sky map is the book's
  gradient; the mirrored world puts the metal sphere on the right of the
  image and the Lambertian one on the left, as in the book.
- ``hit.sphere_ms`` sums the set-up kernel and any sphere kernel over the
  trace's images, and ``hit.sphere_roofline`` is the larger bound of the
  recorded tests and rows over that time; both give nothing for a train
  trace, a trace without their kernels, or a program without the records.
- A toy cell of the scene (a 4 × 4 candidate grid, 16 × 9 pixels, 25
  samples, 50 bounces), added by files only to a copy of the benchmark,
  runs ``run.main`` on the CPU to ``correct`` true, and to false with the
  framebuffer altered by 5 %.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from rtbench.core import spec
from rtbench.reference import dsl as ref_dsl
from rtbench.tests.conftest import REPO, make_toy_root
from rtbench.tests.test_rtbench_faults import IMAGE_FAULTS
from rtbench.tests.test_rtbench_program_metrics import STAND_IN, UNITS, _reader, _trace
from rtbench.tests.test_rtbench_run import drive

CELL = "rtiow_final.final_500spp"
TOY = "toy_rtiow.image"


def _cell():
    return spec.load_cell(REPO, CELL)


def _params(**overrides) -> dict:
    return dict(_cell().config["scene_params"], **overrides)


def _generate(seed: int, **overrides):
    return _cell().scene_module().generate(_params(**overrides), np.random.default_rng(seed))


def test_config_is_the_books_settings():
    cell = _cell()
    cfg, traffic = cell.config, cell.traffic
    assert (cfg["width"], cfg["height"], cfg["bounces"]) == (1200, 675, 50)
    assert traffic == dict(json.loads((REPO / "rtbench" / "traffic" /
                                       "final_100spp.json").read_text()), rays_per_pixel=500)
    assert cfg["reduced"] == [] and cfg["triangles"] == 0 and cell.chips == 1
    assert cfg["scene_params"]["camera"] == dict(lookfrom=[13.0, 2.0, 3.0],
                                                 lookat=[0.0, 0.0, 0.0],
                                                 vup=[0.0, 1.0, 0.0], vfov=20)
    assert cell.limits["check_pixels"] == 4096


def test_layout_follows_the_books_rules():
    gen = _cell().scene_module()
    params = _params()
    spheres = gen.layout(params)
    assert len(spheres) == params["spheres"] == 485
    assert spheres[0] == ("diffuse", (0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5), None)
    assert spheres[-3:] == [("glass", (0.0, 1.0, 0.0), 1.0, None, None),
                            ("diffuse", (-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1), None),
                            ("metal", (4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0)]
    small = spheres[1:-3]
    centres = np.array([c for _, c, _, _, _ in small])
    assert all(r == 0.2 and albedo is None for _, _, r, albedo, _ in small)
    assert (centres[:, 1] == 0.2).all()
    cell_x, cell_z = np.floor(centres[:, 0]), np.floor(centres[:, 2])
    assert ((centres[:, 0] - cell_x <= 0.9) & (centres[:, 2] - cell_z <= 0.9)).all()
    assert cell_x.min() >= -11 and cell_x.max() <= 10 and cell_z.min() >= -11 \
        and cell_z.max() <= 10
    assert len({(x, z) for x, z in zip(cell_x, cell_z)}) == len(small)  # one a candidate
    assert (np.linalg.norm(centres - [4.0, 0.2, 0.0], axis=1) > 0.9).all()
    assert 484 - len(small) == 3  # candidates the skip radius took
    kinds = [k for k, _, _, _, _ in small]
    assert (kinds.count("diffuse"), kinds.count("metal"), kinds.count("glass")) == (383, 73, 25)
    fuzz = [f for k, _, _, _, f in small if k == "metal"]
    assert all(0.0 <= f < 0.5 for f in fuzz) and len(set(fuzz)) == len(fuzz)
    assert all(f is None for k, _, _, _, f in small if k != "metal")


def test_skip_rule_is_the_distance_to_the_skip_centre():
    """Another layout seed: every candidate the grid has left out lay within
    0.9 of (4, 0.2, 0), and the same draws give the same layout."""
    gen = _cell().scene_module()
    for seed in (3, 4):
        params = _params(layout_seed=seed)
        assert gen.layout(params) == gen.layout(params)
        rng = np.random.default_rng(seed)
        kept = set()
        for a in range(-11, 11):
            for b in range(-11, 11):
                choose, u, v = rng.random(), rng.random(), rng.random()
                centre = np.array([a + 0.9 * u, 0.2, b + 0.9 * v])
                if np.linalg.norm(centre - [4.0, 0.2, 0.0]) > 0.9:
                    kept.add(tuple(centre))
                    if 0.8 <= choose < 0.95:
                        rng.uniform(0.0, 0.5)
        assert {c for _, c, _, _, _ in gen.layout(params)[1:-3]} == kept


def test_text_has_one_material_a_sphere_and_the_seed_moves_only_albedos():
    a, files = _generate(7)
    b, again = _generate(7)
    other, _ = _generate(8)
    assert a == b and list(files) == ["sky.pfm"] and np.array_equal(files["sky.pfm"],
                                                                    again["sky.pfm"])
    lines, other_lines = a.splitlines(), other.splitlines()
    assert len(lines) == len(other_lines) == 2 * 485 + 2
    materials = [line.split() for line in lines if line.startswith("material ")]
    spheres = [line.split() for line in lines if line.startswith("sphere ")]
    assert len(materials) == len(spheres) == len({m[1] for m in materials}) == 485
    assert [s[1] for s in spheres] == [m[1] for m in materials]
    changed = [(x, y) for x, y in zip(lines, other_lines) if x != y]
    assert changed and all(x.startswith("material ") for x, _ in changed)
    kinds = [k for k, _, _, _, _ in _cell().scene_module().layout(_params())]
    assert len(changed) == sum(k != "glass" for k in kinds[1:-3])
    for words, kind in zip(materials, kinds):
        if kind == "glass":
            assert words[2:] == ["diffuse", "1", "1", "1", "specular", "1", "1", "1", "ior",
                                 "1.5"]
        elif kind == "diffuse":
            albedo = [float(v) for v in words[3:6]]
            assert words[2] == "diffuse" and words[6:] == ["metallicity", "0"]
            assert all(0.0 <= v < 1.0 for v in albedo)
        else:
            assert words[2] == "specular" and words[6:8] == ["metallicity", "1"]
            assert all(0.5 <= float(v) <= 1.0 for v in words[3:6])
            assert 0.0 <= float(words[9]) < 0.5


def test_sky_map_is_the_books_gradient():
    _, files = _generate(1, sky_size=32)
    sky = files["sky.pfm"]
    assert sky.shape == (32, 32, 3) and sky.dtype == np.float32
    a = (1.0 - sky[..., 0]) / 0.5
    assert np.allclose(sky[..., 1], 1.0 - 0.3 * a, atol=1e-6)
    assert np.allclose(sky[..., 2], 1.0, atol=1e-6)
    assert a.min() < 0.05 and a.max() > 0.95
    gen = _cell().scene_module()
    ys, xs = np.meshgrid((np.arange(32) + 0.5) / 32, (np.arange(32) + 0.5) / 32, indexing="ij")
    up = gen._torus._square_to_sphere(xs, ys)[..., 2]
    assert np.allclose(a, 0.5 * (up + 1.0), atol=1e-6)


def test_mirrored_world_shows_the_books_view():
    """The metal sphere (4, 1, 0) lies right of the image's centre and the
    Lambertian one (-4, 1, 0) left, the glass one (0, 1, 0) between, as in
    the book's image; the up vector is square to the view."""
    text, _ = _generate(1)
    (cam,) = [line.split() for line in text.splitlines() if line.startswith("camera ")]
    position = np.array([float(v) for v in cam[2:5]])
    forward = np.array([float(v) for v in cam[6:9]])
    up = np.array([float(v) for v in cam[10:13]])
    assert abs(forward @ up) < 1e-7 and cam[-1] == "20"
    basis = ref_dsl.camera_basis(position, forward, up, np.deg2rad(20.0), 1200, 675)
    right = basis["scaled_right"] / np.linalg.norm(basis["scaled_right"])

    def side(centre):
        return float((np.array(centre) * [1.0, 1.0, -1.0] - position) @ right)
    assert side((4.0, 1.0, 0.0)) > side((0.0, 1.0, 0.0)) > side((-4.0, 1.0, 0.0))
    assert side((4.0, 1.0, 0.0)) > 0 > side((-4.0, 1.0, 0.0))


SETUP = "void (anonymous namespace)::rays_setup_kernel(float const*, int)"
EVENTS = [(SETUP, 0.0, 300.0), ("bounce_rows_kernel<false>", 300.0, 400.0),
          (SETUP, 400.0, 500.0), ("sphere_bvh_kernel", 500.0, 600.0),
          ("Memset (Device)", 600.0, 650.0)]


def test_sphere_ms_sums_the_sphere_kernels():
    reader = _reader("hit.sphere_ms")
    assert reader.read(_trace("image", EVENTS)) == pytest.approx(500.0 * 1e-3 / UNITS)
    assert reader.read(_trace("image", STAND_IN)) is None
    assert reader.read(_trace("train", EVENTS)) is None


@pytest.fixture
def registry(monkeypatch):
    """A registry filled by hand as the process-wide one: 2 images of 10⁹
    rows, half of them live, each live row tested against 485 spheres."""
    from cuda_raytracer_tpu_torch.utils import metrics

    filled = metrics.Metrics()
    filled.counters.update({"rays.launched": 2e9, "rays.live": 1e9,
                            "hit.sphere_tests": 1e9 * 485})
    monkeypatch.setattr(metrics, "PROFILED", filled)
    return filled


def test_sphere_roofline_value(registry):
    reader = _reader("hit.sphere_roofline")
    ms = 500.0 * 1e-3 / UNITS
    flops = 0.5e9 * 485 * 21 / 67e12
    assert flops > 1e9 * 57 / 3.35e12  # these counts are bound by the operations
    assert reader.read(_trace("image", EVENTS)) == pytest.approx(flops / (ms * 1e-3))
    registry.counters["hit.sphere_tests"] = 1e9  # one sphere: bound by the bytes
    assert reader.read(_trace("image", EVENTS)) == pytest.approx(
        1e9 * 57 / 3.35e12 / (ms * 1e-3))
    assert reader.read(_trace("image", STAND_IN)) is None
    assert reader.read(_trace("train", EVENTS)) is None


def test_sphere_roofline_nothing_without_the_records(monkeypatch):
    from cuda_raytracer_tpu_torch.utils import metrics

    without = metrics.Metrics()
    without.counters["rays.launched"] = 2e9  # a program without the test counter
    monkeypatch.setattr(metrics, "PROFILED", without)
    assert _reader("hit.sphere_roofline").read(_trace("image", EVENTS)) is None
    monkeypatch.delattr(metrics, "PROFILED")
    assert _reader("hit.sphere_roofline").read(_trace("image", EVENTS)) is None
    assert _reader("hit.sphere_ms").read(_trace("image", EVENTS)) is not None


@pytest.fixture(scope="module")
def rtiow_root(tmp_path_factory):
    """A copy of the benchmark with the toy cells and a toy RTIOW cell: a
    16 × 9 × 25-spp × 50-bounce image of the scene cut to a 4 × 4 candidate
    grid (20 spheres) with the real cell's limits, added as files and
    entries only."""
    root = make_toy_root(tmp_path_factory.mktemp("rtiowroot"))
    rt = root / "rtbench"
    cfg = json.loads((rt / "configs" / "rtiow_final.json").read_text())
    cfg.update(name="toy_rtiow", width=16, height=9)
    cfg["scene_params"].update(grid_lo=-2, grid=4, sky_size=32)
    (rt / "configs" / "toy_rtiow.json").write_text(json.dumps(cfg))
    limits = json.loads((rt / "workloads" / f"{CELL}.json").read_text())
    limits["check_pixels"] = 64
    (rt / "workloads" / f"{TOY}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="toy_rtiow", source="toy", reduced=[], why="test",
                                 file="rtbench/configs/toy_rtiow.json"))
    bench["workloads"].append(dict(name=TOY, config="toy_rtiow", traffic="toy_image",
                                   chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TOY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_toy_rtiow_cell_matches_the_reference(rtiow_root):
    rc, result, err = drive(rtiow_root, TOY, 2 ** 31 + 29)
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]
    assert {"image_s", "setup_s"} <= set(result["metrics"])


def test_toy_rtiow_cell_catches_an_altered_framebuffer(rtiow_root, monkeypatch):
    IMAGE_FAULTS["framebuffer_altered"](monkeypatch)
    rc, result, err = drive(rtiow_root, TOY, 31)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
