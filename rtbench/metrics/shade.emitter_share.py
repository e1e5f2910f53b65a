"""shade.emitter_share: the share of the live rays entering an image's
bounces whose hit material emits, the rows the bounce kernel adds light
from (the program's ``shade.emissive`` counter, summed on the card by
csrc/bounce.cu, over ``rays.live``), over the traced images. A path lit by
a mesh emitter ends on it, so the share says how much of the render reaches
its light. Like ``loop.live_ray_bounces`` it is fixed for a given render
and seed: a move of it means the render changed. A program without the
counter gives nothing."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    live = program.per_unit(trace, "image", "counters", "rays.live")
    emissive = program.per_unit(trace, "image", "counters", "shade.emissive")
    if not live or emissive is None:
        return None
    return emissive / live
