"""loop.live_ray_bounces: millions of live rays entering the bounces of an
image (the program's ``rays.live`` counter, summed on the card by the
set-up kernel of render/wavefront.trace_packed), over the traced images.
Every exact tracer on the same PCG streams traces these rays: the work
count, whatever the implementation, fixed for a given render and seed. A
move of it means the render changed, not that it got faster."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    value = program.per_unit(trace, "image", "counters", "rays.live")
    return None if value is None else value * 1e-6
