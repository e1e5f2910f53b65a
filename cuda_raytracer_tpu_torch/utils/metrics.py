"""Structured metrics, phase timing and the render loops' spans and counters (counterpart of ``cuda_raytracer_tpu/utils/metrics.py``).

Every phase of a render job is timed into a registry that can be emitted as
one JSON line: the reference's BVH / CPU / GPU wall-clock lines, machine
readable, plus throughput (paths/s) and recorded series (samples done per
pass, suspect rays).

The render and train loops record into a registry through one switch
(``recorder``): while a caller has attached one (``attached``, which
``render_framebuffer(metrics=...)`` and a train step built with
``metrics=`` use), and otherwise while a ``torch.profiler`` is recording,
into the process-wide ``PROFILED``. With the switch off a span or counter
point costs that check alone. The loops' records:

- spans (``span``, the same timer as ``phase``: host seconds under
  ``phases``, and a profiler span of the same name while the profiler
  records): ``rt.pass``, ``rt.block``, ``rt.camera``, ``rt.bounce``,
  ``rt.tail`` (inside ``rt.bounce``, on the packed forward trace's bounces
  ``bounces // 2`` on), ``rt.reorder``, ``rt.accumulate``, ``rt.post``,
  ``rt.step.forward``, ``rt.step.backward``, ``rt.step.adam``;
- counters: ``sync.host`` (host reads of device values in the loops: the
  live counts, ``read_live``), ``rays.live`` (live rays entering each bounce of the
  packed forward trace, summed on the device by the set-up kernel into
  ``device_counter``), ``rays.live_tail`` (those of them entering bounces
  ``bounces // 2`` on, summed the same way), ``shade.dielectric`` (rows the
  bounce kernel scattered off a dielectric, reflected or refracted, summed
  on the device by that kernel), ``shade.emissive`` (live rows whose hit
  material emits, the rows the bounce kernel adds light from, summed the
  same way), ``rays.launched`` (rows the bounce kernels
  ran over), ``hit.sphere_tests`` (ray-sphere tests the closest hit needs:
  ``rays.live`` times the scene's spheres, folded in with it after each
  packed trace; the set-up kernel tests dead rows and padding rows too),
  ``sync.device_idle_s`` (device idle between the event recorded
  before each ``read_live`` and the one recorded at the next launch,
  ``launching``), ``hit.rows`` (rows handed to a triangle closest hit),
  ``hit.walk_rows`` (those of them the BVH walk took), ``bounces.packed``
  (bounces of the packed forward trace), ``bounces.sorted`` (bounces after
  which the wavefront was reordered, in either trace), ``bounces.graphed``
  (those of them run inside a CUDA graph's replay, ``render/packed.py``),
  ``graph.captures`` (graphs captured) and ``reorder.rows`` (rows the
  reorder's row move kernel wrote, ``rays.reorder_rows``: the sorted prefix
  and the settled suffix of each sorted bounce on the card).

Values that live on the device (the accumulators, the event pairs) are
kept as they are and folded into ``counters`` when the registry is read
(``resolve``, which ``emit`` calls), so recording adds no sync inside a
render.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

# A profiler span made in C++: about 2 µs under the profiler where
# record_function, which goes through the dispatcher, takes about 20; the
# loops open some 7,000 spans an image. record_function where it is absent.
_MARK = getattr(torch._C._profiler, "_RecordFunctionFast", _profiler.record_function)


class _Span:
    """One ``Metrics.phase`` (or ``span``): host seconds into ``phases``
    and, while the profiler records, a profiler span of the same name."""

    __slots__ = ("phases", "name", "mark", "start")

    def __init__(self, phases: Dict[str, float], name: str):
        self.phases, self.name, self.mark = phases, name, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.mark = _MARK(self.name)
            self.mark.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.phases[self.name] = self.phases.get(self.name, 0.0) + (
            time.perf_counter() - self.start)
        if self.mark is not None:
            self.mark.__exit__(*exc)
            self.mark = None
        return False


@dataclass
class Metrics:
    """Append-only metric registry; one per render job."""

    phases: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    series: Dict[str, List[float]] = field(default_factory=dict)
    # Device values not yet read: accumulators by (counter, device), the
    # (start, end, device) event pairs of sync.device_idle_s, the (start,
    # end, stream, device) of the one still open, and read events to reuse
    # by device.
    _device: Dict[Tuple[str, torch.device], torch.Tensor] = field(
        default_factory=dict, repr=False)
    _idle: List[tuple] = field(default_factory=list, repr=False)
    _open: Optional[tuple] = field(default=None, repr=False)
    _events: Dict[torch.device, list] = field(default_factory=dict, repr=False)

    def phase(self, name: str) -> _Span:
        """Time a phase on the host clock: ``with metrics.phase("x"): ...``;
        while a torch.profiler records, also a profiler span of that name.
        Work queued on the GPU inside it is counted only if the block
        synchronises before it ends."""
        return _Span(self.phases, name)

    span = phase

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def record(self, name: str, value: float) -> None:
        self.series.setdefault(name, []).append(float(value))

    def device_counter(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The (1,) int64 accumulator of counter ``name`` on ``like``'s
        device, zeroed when first asked for; kernels and plain versions add
        into it, and ``resolve`` adds it to ``counters``."""
        key = (name, like.device)
        acc = self._device.get(key)
        if acc is None:
            acc = self._device[key] = torch.zeros(1, dtype=torch.int64, device=like.device)
        return acc

    def read_live(self, value: torch.Tensor, copied=None) -> int:
        """``int(value)`` of a live count on the device, counted as
        ``sync.host``; with ``copied`` (``_read``) from its host copy. On a
        CUDA device an event goes on the stream first; ``launching`` records
        its pair, which ``resolve`` reads."""
        self.count("sync.host", 1)
        if value.is_cuda:
            self._drop_open()
            stream = torch.cuda.current_stream(value.device)
            start, end = self._event(value.device), self._event(value.device)
            # A new event is made on its first record: make the pair's end
            # here, while the device still runs, and not in the idle it times.
            end.record(stream)
            start.record(stream)
            self._open = (start, end, stream, value.device)
        return _read(value, copied)

    def launching(self) -> None:
        """Call before the first launch after a ``read_live``: records the
        event that closes the device idle the read's round trip caused."""
        if self._open is None:
            return
        start, end, stream, device = self._open
        end.record(stream)
        self._idle.append((start, end, device))
        self._open = None

    def _event(self, device: torch.device):
        free = self._events.setdefault(device, [])
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def _drop_open(self) -> None:
        if self._open is not None:  # a read no launch followed
            self._events[self._open[3]] += self._open[:2]
            self._open = None

    def resolve(self) -> "Metrics":
        """Fold the device values into ``counters``: waits for them. The
        event pairs' elapsed times go to ``sync.device_idle_s`` and their
        events back to the pool."""
        for (name, _), acc in self._device.items():
            self.count(name, int(acc.item()))
        self._device.clear()
        for start, end, device in self._idle:
            end.synchronize()
            self.count("sync.device_idle_s", start.elapsed_time(end) * 1e-3)
            self._events[device] += [start, end]
        self._idle.clear()
        self._drop_open()
        return self

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
        self.resolve()
        line = json.dumps(
            dict(phases=self.phases, counters=self.counters, series=self.series, **extra),
            sort_keys=True,
        )
        print(line, file=stream or sys.stderr)
        return line


# What the loops record into while a torch.profiler records and no caller
# has attached a registry; the benchmark's per-layer readers read it.
PROFILED = Metrics()
_ATTACHED: contextvars.ContextVar = contextvars.ContextVar("rt_metrics", default=None)
_OFF = contextlib.nullcontext()


def recorder() -> Optional[Metrics]:
    """The registry the loops record into now: the attached one, else
    ``PROFILED`` while the profiler records, else None (recording off)."""
    attached = _ATTACHED.get()
    if attached is not None:
        return attached
    return PROFILED if _profiler._is_profiler_enabled else None


@contextmanager
def attached(metrics: Optional[Metrics]):
    """Record into ``metrics`` inside the block (nothing changes for None)."""
    if metrics is None:
        yield
        return
    token = _ATTACHED.set(metrics)
    try:
        yield
    finally:
        _ATTACHED.reset(token)


def span(name: str):
    """``recorder().span(name)``, or a no-op while recording is off."""
    rec = recorder()
    return _OFF if rec is None else rec.span(name)


def count(name: str, value: float) -> None:
    rec = recorder()
    if rec is not None:
        rec.count(name, value)


def device_counter(name: str, like: torch.Tensor) -> Optional[torch.Tensor]:
    """``recorder().device_counter(name, like)``, or None while recording is off."""
    rec = recorder()
    return None if rec is None else rec.device_counter(name, like)


def _read(value: torch.Tensor, copied) -> int:
    """``int(value)``; with ``copied``, a host tensor and the CUDA event
    recorded once ``value`` was copied into it, from the copy after waiting
    for that event alone (not for work queued on the stream after it)."""
    if copied is None:
        return int(value.item())
    host, ready = copied
    ready.synchronize()
    return int(host.item())


def read_live(value: torch.Tensor, copied=None) -> int:
    """``int(value)`` (from ``copied`` as ``_read``), through
    ``Metrics.read_live`` while recording."""
    rec = recorder()
    return _read(value, copied) if rec is None else rec.read_live(value, copied)


def launching() -> None:
    rec = recorder()
    if rec is not None:
        rec.launching()
