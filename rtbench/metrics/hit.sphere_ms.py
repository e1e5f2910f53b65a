"""hit.sphere_ms: device milliseconds an image spends in the kernels that
test rays against spheres, from the profiler's trace over whole images:
the wavefront's set-up kernel (csrc/rays.cu, rays_setup_kernel, whose loop
over every sphere row is a brute scene's closest hit) and any kernel named
for spheres. A scene whose closest hit runs inside another kernel (the
brute megakernel) launches none of them, and the metric is left out."""

import re

MOVES = "image_s"
KERNELS = re.compile(r"\brays_setup_kernel\b|sphere", re.IGNORECASE)


def read(trace):
    if trace.kind != "image" or trace.units == 0:
        return None
    spans = [(s, e) for name, s, e in trace.device_events if KERNELS.search(name)]
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / trace.units
