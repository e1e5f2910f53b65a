"""loop.tail_share: the share of an image's live ray-bounces that fall in
the trace's tail, bounces ``bounces // 2`` on (the program's
``rays.live_tail`` counter over ``rays.live``, both summed on the card by
the set-up kernel of render/wavefront.trace_packed), over the traced
images: how much of the work the long paths carry. Fixed for a given render
and seed. A program without the counter gives nothing."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    live = program.per_unit(trace, "image", "counters", "rays.live")
    tail = program.per_unit(trace, "image", "counters", "rays.live_tail")
    if not live or tail is None:
        return None
    return tail / live
