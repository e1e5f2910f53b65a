"""A throwaway checkout root holding toy cells, made by adding files only.

``toy_root`` copies ``BENCHMARK.json`` and ``rtbench/`` into a temporary
directory and adds three cells at sizes the CPU runs in seconds: a torus
image, a Cornell image and a torus train step, each a new configuration,
traffic and limits file and new entries in the copy's ``BENCHMARK.json``.
The toy cells take the comparison limits of the real cells they shrink,
so a run here is held to what a run on the card is held to.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TOYS = {
    # cell: (config it shrinks, real cell whose limits it takes, traffic)
    "toy_torus.image": ("teapot_torus", "teapot_torus.final_100spp", "toy_image"),
    "toy_cornell.image": ("cornell", "cornell.final_100spp", "toy_image"),
    "toy_torus.train": ("teapot_torus", "teapot_torus.invrender_step", "toy_train"),
}


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _dump(obj, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_toy_root(dest: Path) -> Path:
    shutil.copytree(REPO / "rtbench", dest / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _load(REPO / "BENCHMARK.json")
    rt = dest / "rtbench"
    for name, shrink in (("teapot_torus", dict(ring=24, tube=16, sky_size=32)),
                         ("cornell", {})):
        cfg = _load(rt / "configs" / f"{name}.json")
        cfg.update(name=f"toy_{name}", width=16, height=12, bounces=4)
        cfg["scene_params"].update(shrink)
        _dump(cfg, rt / "configs" / f"toy_{name}.json")
        bench["configs"].append(dict(name=f"toy_{name}", source="toy", reduced=[], why="test",
                                     file=f"rtbench/configs/toy_{name}.json"))
    _dump({"kind": "image", "rays_per_pixel": 25}, rt / "traffic" / "toy_image.json")
    train = _load(rt / "traffic" / "invrender_step.json")
    train.update(width=12, height=8)
    _dump(train, rt / "traffic" / "toy_train.json")
    for cell, (config, real, traffic) in TOYS.items():
        limits = _load(rt / "workloads" / f"{real}.json")
        if "check_pixels" in limits:
            limits["check_pixels"] = 64
        _dump(limits, rt / "workloads" / f"{cell}.json")
        bench["workloads"].append(dict(name=cell, config=f"toy_{config}", traffic=traffic,
                                       chips=1, why="test"))
        twin = {w["name"]: w for w in bench["workloads"]}[real]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if twin["name"] in m.get("workloads", []):
                m["workloads"].append(cell)
    _dump(bench, dest / "BENCHMARK.json")
    return dest


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory) -> Path:
    return make_toy_root(tmp_path_factory.mktemp("toyroot"))
