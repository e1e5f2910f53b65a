"""loop.tail_ms: host milliseconds an image spends in the tail bounces of
render/wavefront.trace_packed, bounces ``bounces // 2`` on (the program's
``rt.tail`` span, inside each of those bounces' ``rt.bounce``), over the
traced images. A program without the span gives nothing."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    value = program.per_unit(trace, "image", "phases", "rt.tail")
    return None if value is None else value * 1e3
