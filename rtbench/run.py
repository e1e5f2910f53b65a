"""Run one cell of the benchmark once.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration, traffic, limits and per-layer readers
are files under ``rtbench/`` found by name (``rtbench/core/spec.py``).
Set-up (scene, kernels, warm-up) runs first and counts as ``setup_s``;
then whole images or train steps run back to back for ``--seconds`` and
the one in flight finishes. With ``--trace 1`` the profiler holds the
first images or steps of the window and the run reports the cell's
per-layer metrics instead of its end-to-end ones. After the window the
run compares what the window produced with the plain reference
(``rtbench/reference``) and prints each number compared beside its limit,
as the last lines on standard error and under ``checks`` in the result.
The last line on standard output is the result's JSON object.

It exits with a code other than 0, printing no result, without a CUDA
device (or fewer than the cell asks for), without the program, or if
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from rtbench.core import cells, spec  # noqa: E402


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def _fail(message: str, code: int) -> int:
    print(f"rtbench: {message}", file=sys.stderr)
    return code


def main(argv=None, root: Path = ROOT, device=None, started: float = STARTED) -> int:
    """Run the cell; ``device`` None asks for the cell's CUDA devices
    (tests pass ``"cpu"`` to drive the rest of a run without a card)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = spec.load_cell(Path(root), args.workload)
    if device is None:
        if not torch.cuda.is_available():
            return _fail("no CUDA device", 2)
        if torch.cuda.device_count() < cell.chips:
            return _fail(f"{cell.name} needs {cell.chips} CUDA devices, "
                         f"{torch.cuda.device_count()} present", 2)
        device = "cuda"
    device = torch.device(device)
    try:
        import cuda_raytracer_tpu_torch  # noqa: F401
    except ImportError as exc:
        return _fail(f"the program under test cannot be imported: {exc}", 3)
    try:
        out = cells.RUNNERS[cell.kind](cell, args.seed, args.seconds, bool(args.trace),
                                       device, started)
    except cells.ForbiddenModules as exc:
        return _fail(f"modules of JAX or the JAX package were loaded: {exc}", 4)
    found = cells.forbidden_modules()
    if found:
        return _fail(f"modules of JAX or the JAX package were loaded: {found}", 4)

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m.name).read(out.trace)
            if value is not None:
                metrics[m.name] = {"value": float(value), "unit": m.unit}
    else:
        metrics = {m.name: {"value": float(out.metrics[m.name]), "unit": m.unit}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    if device.type == "cuda":
        dev["power_limit"] = _power_limit()
    result = {"correct": out.failed == 0 and all(c["value"] <= c["limit"]
                                                 for c in out.checks.values()),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if args.trace and out.traced is not None:
        dev["busy_s"] = out.traced["busy_s"]
        dev["window_s"] = out.traced["window_s"]
        result["breakdown"] = out.traced["breakdown"]
    result["checks"] = out.checks
    sys.stdout.flush()
    for name, c in out.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
