"""loop.rows_per_live_ray: rows the bounce kernels ran over per live ray
entering a bounce (the program's ``rays.launched`` over ``rays.live``): what
the live-prefix compaction of render/wavefront.trace_packed leaves of the
dead rows, 1 when it leaves none."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    launched = program.per_unit(trace, "image", "counters", "rays.launched")
    live = program.per_unit(trace, "image", "counters", "rays.live")
    if launched is None or not live:
        return None
    return launched / live
