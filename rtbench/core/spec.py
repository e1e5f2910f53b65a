"""What a run is asked to do, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Everything else is a file found by name under ``rtbench/``:

- the configuration: the ``file`` its ``configs`` entry names (scene
  generator, its parameters, image size, bounces, render settings);
- the scene generator: ``rtbench/scenes/<scene>.py``;
- the traffic mix: ``rtbench/traffic/<traffic>.json``;
- the cell's comparison limits: ``rtbench/workloads/<cell>.json``;
- each per-layer metric's reader: ``rtbench/metrics/<metric>.py``.

So a later change adds a configuration, a cell or a metric by adding
files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    source: str
    moves: str = ""
    workloads: List[str] = None


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path
    chips: int = 1

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def scene_module(self) -> ModuleType:
        return load_module(self.root / "rtbench" / "scenes" / f"{self.config['scene']}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / "rtbench" / "metrics" / f"{metric}.py")


def load_module(path: Path) -> ModuleType:
    """Import the file at ``path`` under a name of its own."""
    name = "rtbench_file_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metrics(entries, cell: str, reported: set) -> List[Metric]:
    """The metrics of ``entries`` that ``cell`` reports: those listing it,
    and those without a list whose ``moves`` the cell reports."""
    out = []
    for e in entries:
        listed = e.get("workloads")
        if listed is not None and cell not in listed:
            continue
        if listed is None and "moves" in e and e["moves"] not in reported:
            continue
        out.append(Metric(e["name"], e["unit"], e["source"], e.get("moves", ""), listed))
    return out


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read_json(root / "BENCHMARK.json")
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[cell["config"]]["file"])
    traffic = _read_json(root / "rtbench" / "traffic" / f"{cell['traffic']}.json")
    limits = _read_json(root / "rtbench" / "workloads" / f"{name}.json")
    end_to_end = _metrics(bench["end_to_end"], name, set())
    per_layer = _metrics(bench["per_layer"], name, {m.name for m in end_to_end})
    return Cell(name, config, traffic, limits, end_to_end, per_layer, root, cell["chips"])
