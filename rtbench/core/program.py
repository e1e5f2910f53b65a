"""What the program recorded about itself while the profiler held it.

The port's render and train loops record spans and counters into its
process-wide registry (``cuda_raytracer_tpu_torch.utils.metrics.PROFILED``)
while a ``torch.profiler`` records, which in a traced run is over the
traced images or steps alone. The per-layer readers of those records
(``rtbench/metrics/loop.host_syncs.py`` and the rest) read it here, per
image or step of the trace. A program without the registry, or without the
record asked for, gives None: the metric is left out.
"""

from __future__ import annotations

from typing import Optional


def registry():
    """The port's ``PROFILED`` registry with its device values folded in
    (``resolve``), or None for a program that has none."""
    try:
        from cuda_raytracer_tpu_torch.utils import metrics
    except ImportError:
        return None
    profiled = getattr(metrics, "PROFILED", None)
    if profiled is None or not hasattr(profiled, "resolve"):
        return None
    return profiled.resolve()


def per_unit(trace, kind: str, section: str, name: str) -> Optional[float]:
    """The registry's ``section`` (``"counters"`` or ``"phases"``) entry
    ``name`` over the trace's images or steps, for a trace of ``kind``
    that saw the device; else None."""
    if trace.kind != kind or not trace.device_events or trace.units == 0:
        return None
    reg = registry()
    value = None if reg is None else getattr(reg, section).get(name)
    return None if value is None else value / trace.units
