"""loop.sync_idle_ms: device milliseconds an image's card waits on the
host's reads of the live count (the program's ``sync.device_idle_s``: CUDA
events from just before each read to just before the next launch after it),
over the traced images."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    value = program.per_unit(trace, "image", "counters", "sync.device_idle_s")
    return None if value is None else value * 1e3
