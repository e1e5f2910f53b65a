"""shade.device_ms: device milliseconds an image spends in the shading
kernels: the brute megakernel (csrc/shade.cu, which also finds its own
hits) and the packed bounce kernel (csrc/bounce.cu, shade_rows), from the
profiler's trace over whole images."""

import re

MOVES = "image_s"
KERNELS = re.compile(r"\b(shade_kernel|bounce_rows_kernel)\b")


def read(trace):
    if trace.kind != "image" or trace.units == 0:
        return None
    spans = [(s, e) for name, s, e in trace.device_events if KERNELS.search(name)]
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / trace.units
