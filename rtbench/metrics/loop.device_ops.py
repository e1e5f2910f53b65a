"""loop.device_ops: device operations (kernels, memsets, copies) an image
launches, from the profiler's trace over whole images. Each costs the
host an enqueue, so the pass loop (render/pipeline.render_pass,
_render_block) and the bounce loop (render/wavefront.trace_packed) are
as fast as this count lets them be."""

MOVES = "image_s"


def read(trace):
    if trace.kind != "image" or not trace.device_events or trace.units == 0:
        return None
    return len(trace.device_events) / trace.units
