"""hit.walk_share: the share of an image's closest-hit rows that the BVH
walk took (the program's ``hit.walk_rows`` over ``hit.rows``, counted in
render/wavefront.triangle_hit and bounce_rows), over the traced images: 1
where every bounce walks the BVH, 0 where the packet engines take them
all. A program without these counters gives nothing."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    rows = program.per_unit(trace, "image", "counters", "hit.rows")
    if not rows:
        return None
    return (program.per_unit(trace, "image", "counters", "hit.walk_rows") or 0.0) / rows
