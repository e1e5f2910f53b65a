"""setup.scene_s: host seconds of the scene's load through the program
(models/scene_dsl.parse_scene_text and assemble_scene: the native BVH
build, models/cluster's tables, the upload), ending in a synchronise."""

MOVES = "setup_s"


def read(trace):
    return trace.scene_s if trace.scene_s > 0 else None
