"""post.ms: host milliseconds of render/pipeline.render_image on a
finished framebuffer (ops/bloom, ops/tonemap and the copy of the uint8
image to the host), the mean over the traced run's images; the
framebuffer is synchronised first, so the post-pass is timed alone."""

MOVES = "image_s"


def read(trace):
    if trace.kind != "image" or not trace.post_ms:
        return None
    return sum(trace.post_ms) / len(trace.post_ms)
