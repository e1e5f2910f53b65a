"""device.idle_share.step: the share of the traced window in which no
operation ran on the card, over whole train steps (forward with its
graph, backward, Adam)."""

MOVES = "step_s"


def read(trace):
    if trace.kind != "train" or not trace.device_events or trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
