"""The control (the reference in bfloat16, in the program's place) and the
planted train faults fail the cells' limits: at toy size on the CPU, and
at the cells' own size on the card."""

from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch

from rtbench import control
from rtbench.core import spec
from rtbench.tests.conftest import REPO, TOYS


def readings(root, cell, seeds, device):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        control.main(["--workload", cell, "--seeds", ",".join(map(str, seeds))], root=root,
                     device=device)
    return [json.loads(line)["numbers"] for line in out.getvalue().splitlines()]


def fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in numbers)


def _check_cell(root, cell, seeds, device):
    limits = spec.load_cell(root, cell).limits["limits"]
    for numbers in readings(root, cell, seeds, device):
        if "control" in numbers:  # the train cell: the control and each fault
            assert all(fails(n, limits) for n in numbers.values()), numbers
        else:
            assert fails(numbers, limits), numbers


@pytest.mark.parametrize("cell", sorted(TOYS))
def test_control_fails_at_toy_size(toy_root, cell):
    _check_cell(toy_root, cell, [3, 4], "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["teapot_torus.final_100spp", "cornell.final_100spp",
                                  "teapot_torus.preview_1spp", "teapot_torus.invrender_step"])
def test_control_fails_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells' own sizes run on the card")
    _check_cell(REPO, cell, [5], "cuda")
