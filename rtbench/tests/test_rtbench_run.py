"""Toy cells driven end to end on the CPU through the port's plain paths,
held against the reference, and the result line's shape."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from rtbench import run
from rtbench.tests.conftest import REPO, TOYS

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def drive(root: Path, cell: str, seed: int, trace: int = 0, seconds: float = 0.3):
    """run.main on the CPU → (exit code, result dict or None, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=root, device="cpu",
                      started=time.perf_counter())
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.mark.parametrize("cell", sorted(TOYS))
def test_toy_cell_matches_the_reference(toy_root, cell):
    rc, result, err = drive(toy_root, cell, 2 ** 31 + 11)
    assert rc == 0, err
    assert set(result) == KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    want = {"image": {"image_s", "setup_s"}, "train": {"step_s", "setup_s"}}[cell.split(".")[1]]
    assert want <= set(result["metrics"])
    assert all(m["value"] > 0 for m in result["metrics"].values())
    # the compared numbers are the last lines on standard error
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[1] for line in tail] == list(result["checks"])


def test_traced_toy_run_reports_per_layer_metrics(toy_root):
    rc, result, err = drive(toy_root, "toy_torus.image", 5, trace=1)
    assert rc == 0, err
    assert result["correct"] is True
    # no device here: only the host-clock readers find something to read
    assert set(result["metrics"]) == {"post.ms", "setup.scene_s"}


def test_refuses_without_a_card():
    proc = subprocess.run([sys.executable, str(REPO / "rtbench" / "run.py"), "--workload",
                           "cornell.final_100spp", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, cwd=REPO, timeout=300)
    if proc.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert proc.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); from rtbench import run; "
            "sys.exit(run.main(['--workload', 'cornell.final_100spp', '--seed', '1', "
            "'--seconds', '1'], root=__import__('pathlib').Path('.'), device='cpu', "
            "started=time.perf_counter()))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_toy_cells_were_added_by_files_only(toy_root):
    for path in (REPO / "rtbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = toy_root / path.relative_to(REPO)
            assert copy.read_bytes() == path.read_bytes(), path
