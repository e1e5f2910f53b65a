"""Render orchestration: wavefront path tracer and pass loop."""
