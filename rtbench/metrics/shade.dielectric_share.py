"""shade.dielectric_share: the share of the live rays entering an image's
bounces that the bounce kernel scattered off a dielectric, reflected or
refracted (the program's ``shade.dielectric`` counter, summed on the card
by csrc/bounce.cu, over ``rays.live``), over the traced images. Like
``loop.live_ray_bounces`` it is fixed for a given render and seed: a move
of it means the render changed. A program without the counter gives
nothing."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    live = program.per_unit(trace, "image", "counters", "rays.live")
    dielectric = program.per_unit(trace, "image", "counters", "shade.dielectric")
    if not live or dielectric is None:
        return None
    return dielectric / live
