"""diff.backward_ms: host milliseconds a train step of render/diff's
make_train_step spends in ``loss.backward()``, walking the autograd graph
(the program's ``rt.step.backward`` span), over the traced steps."""

from rtbench.core import program

MOVES = "step_s"


def read(trace):
    value = program.per_unit(trace, "train", "phases", "rt.step.backward")
    return None if value is None else value * 1e3
