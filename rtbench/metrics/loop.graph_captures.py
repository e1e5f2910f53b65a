"""loop.graph_captures: CUDA graphs the program captured per traced image
(its ``graph.captures`` counter, render/graphs.py): 0 where set-up captured
every graph the images replay, so the timed window captures nothing. A
program that counts no packed bounces (``bounces.packed``) gives nothing."""

from rtbench.core import program

MOVES = "image_s"


def read(trace):
    if not program.per_unit(trace, "image", "counters", "bounces.packed"):
        return None
    return program.per_unit(trace, "image", "counters", "graph.captures") or 0.0
