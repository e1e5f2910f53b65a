"""loop.graph_share: the share of an image's packed bounces that ran inside a
CUDA graph's replay (the program's ``bounces.graphed`` counter over
``bounces.packed``, both counted in render/wavefront.trace_packed and
render/graphs.py), over the traced images: 1 where every bounce of the
mesh wavefront replays a captured graph, 0 where each is launched from
Python. A program without these counters gives nothing."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    packed = program.per_unit(trace, "image", "counters", "bounces.packed")
    if not packed:
        return None
    return (program.per_unit(trace, "image", "counters", "bounces.graphed") or 0.0) / packed
