"""loop.host_syncs: host reads of device values an image's pass and bounce
loops make (the program's ``sync.host`` counter: the live count read after
each sorted bounce of render/wavefront.trace_packed, the host waiting on
the card each time), over the traced images."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    return program.per_unit(trace, "image", "counters", "sync.host")
