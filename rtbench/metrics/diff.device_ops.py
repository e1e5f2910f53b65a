"""diff.device_ops: device operations a train step of render/diff's
make_train_step launches (forward with its graph, backward, Adam), from
the profiler's trace over whole steps."""

MOVES = "step_s"


def read(trace):
    if trace.kind != "train" or not trace.device_events or trace.units == 0:
        return None
    return len(trace.device_events) / trace.units
