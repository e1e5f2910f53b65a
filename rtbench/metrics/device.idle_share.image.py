"""device.idle_share.image: the share of the traced window in which no
operation (kernel, memset or copy) ran on the card, over whole images.
The host clock's window against the union of the device's intervals in
the profiler's trace; what is left is time the pass and bounce loops
spent on the host between launches."""

MOVES = "image_s"


def read(trace):
    if trace.kind != "image" or not trace.device_events or trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
