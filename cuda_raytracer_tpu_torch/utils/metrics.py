"""Structured metrics and phase timing (counterpart of ``cuda_raytracer_tpu/utils/metrics.py``).

Every phase of a render job is timed into a registry that can be emitted as
one JSON line: the reference's BVH / CPU / GPU wall-clock lines, machine
readable, plus throughput (paths/s) and recorded series (samples done per
pass, suspect rays).
"""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


@dataclass
class Metrics:
    """Append-only metric registry; one per render job."""

    phases: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    series: Dict[str, List[float]] = field(default_factory=dict)

    @contextmanager
    def phase(self, name: str):
        """Time a phase on the host clock: ``with metrics.phase("x"): ...``.
        Work queued on the GPU inside it is counted only if the block
        synchronises before it ends."""
        start = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - start)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def record(self, name: str, value: float) -> None:
        self.series.setdefault(name, []).append(float(value))

    def throughput(self, name: str, units: float, phase: str) -> Optional[float]:
        """units / phase seconds, also stored as a counter."""
        seconds = self.phases.get(phase)
        if not seconds:
            return None
        rate = units / seconds
        self.counters[name] = rate
        return rate

    def emit(self, stream=None, **extra) -> str:
        """Print one JSON line with everything (to stderr by default) and
        return it."""
        line = json.dumps(
            dict(phases=self.phases, counters=self.counters, series=self.series, **extra),
            sort_keys=True,
        )
        print(line, file=stream or sys.stderr)
        return line


def live_fraction(transmitted: torch.Tensor) -> float:
    """Fraction of rays of a wavefront state still alive (nonzero
    throughput)."""
    return float(torch.any(transmitted != 0, dim=-1).float().mean())
