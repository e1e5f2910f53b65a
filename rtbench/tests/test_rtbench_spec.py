"""BENCHMARK.json against the benchmark's contract, and the harness's files
found by name."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest

from rtbench.core import spec

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "cuda_raytracer_tpu"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rtbench"]
    assert BENCH["command"] == ["python3", "rtbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith("rtbench/")
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
        names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(REPO, cell)
    assert c.kind in ("image", "train")
    assert c.scene_module().generate
    reported = {m.name for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m.moves in reported, (m.name, m.moves)
        assert c.reader(m.name).MOVES == m.moves


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert (REPO / "rtbench" / "metrics" / f"{m['name']}.py").is_file()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_nothing_imports_jax_and_the_reference_imports_no_program():
    for path in (REPO / "rtbench").rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if "reference" in path.parts:
            assert "cuda_raytracer_tpu_torch" not in tops, path


def test_import_check_compares_whole_top_level_names():
    from rtbench.core import cells
    import sys

    assert "cuda_raytracer_tpu_torch" not in cells.FORBIDDEN
    before = set(sys.modules)
    sys.modules["cuda_raytracer_tpu_torch_probe"] = object()
    try:
        assert cells.forbidden_modules() == sorted({m.split(".", 1)[0] for m in before}
                                                   & set(cells.FORBIDDEN))
    finally:
        del sys.modules["cuda_raytracer_tpu_torch_probe"]


@pytest.mark.parametrize("cell", ["teapot_torus.final_100spp", "cornell.final_100spp"])
def test_scene_generators_are_seeded(cell):
    c = spec.load_cell(REPO, cell)
    params = dict(c.config["scene_params"])
    if "ring" in params:
        params.update(ring=12, tube=8, sky_size=16)
    gen = c.scene_module().generate
    a, fa = gen(params, np.random.default_rng(7))
    b, fb = gen(params, np.random.default_rng(7))
    other, _ = gen(params, np.random.default_rng(8))
    assert a == b and fa.keys() == fb.keys()
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert a != other
    assert sum(line.startswith(("triangle", "quad")) for line in a.splitlines()) == \
        sum(line.startswith(("triangle", "quad")) for line in other.splitlines())
