"""loop.sorted_share: the share of an image's packed bounces after which the
wavefront was reordered (the program's ``bounces.sorted`` counter over
``bounces.packed``, both counted in render/wavefront.packed_bounce), over
the traced images: 0 where no bounce pays for a sort key, an argsort and a
row move, 0.5 at the default ``sort_depth`` of 5 sorted bounces in 10. The
program counts ``bounces.sorted`` at 0 on a bounce it does not reorder, so
a trace without packed bounces, or from a program without the counter,
gives nothing."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    packed = program.per_unit(trace, "image", "counters", "bounces.packed")
    sorted_ = program.per_unit(trace, "image", "counters", "bounces.sorted")
    if not packed or sorted_ is None:
        return None
    return sorted_ / packed
