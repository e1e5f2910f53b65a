"""hit.device_ms: device milliseconds an image spends in the closest-hit
kernels (ops/packet_intersect → ops/kernels/{fused1, cull, fused, sweep,
traverse}: csrc/fused1.cu, cull.cu, fused.cu, sweep.cu, traverse.cu and
packet.cuh's key kernels), from the profiler's trace over whole images.
A scene whose closest hit runs inside another kernel (the brute
megakernel) launches none of them, and the metric is left out."""

import re

MOVES = "image_s"
KERNELS = re.compile(r"\b(fused1_kernel|fused1_split_kernel|cull_kernel|cull_gated_kernel|"
                     r"fused_kernel|sweep_kernel|bvh_walk_kernel|init_keys|finish_keys)\b")


def read(trace):
    if trace.kind != "image" or trace.units == 0:
        return None
    spans = [(s, e) for name, s, e in trace.device_events if KERNELS.search(name)]
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / trace.units
