"""Checkpoint / resume for long renders (counterpart of ``cuda_raytracer_tpu/utils/checkpoint.py``).

Every pass boundary of the pass loop can be persisted: the framebuffer's raw
sums, the samples done, a scene fingerprint and the exactness certificate's
running suspect count. A restart resumes at the exact pass seed (pass seeds
derive from the remaining-sample count), so a resumed render is bit-identical
to an uninterrupted one.

The file is a plain ``.npz`` with the JAX package's keys and types
(``framebuffer`` float32, ``samples_done`` int64, ``fingerprint`` bytes,
``suspects`` int64), so a checkpoint written by either package loads in the
other when the fingerprints agree.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from cuda_raytracer_tpu_torch.models.scene import Scene


def scene_fingerprint(scene: Scene) -> str:
    """Stable hash of the scene's identity: the render config and checksums
    of three scene arrays. Guards against resuming another scene or
    resolution."""
    h = hashlib.sha256()
    h.update(json.dumps(dataclasses.asdict(scene.config), sort_keys=True).encode())
    for name in ("sphere_center", "tri_p1", "material_index"):
        arr = getattr(scene, name).detach().cpu().numpy()
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes()[:4096])
    return h.hexdigest()[:16]


def save_checkpoint(
    path: str,
    framebuffer: np.ndarray,
    samples_done: int,
    fingerprint: str,
    suspects: int = 0,
) -> None:
    """Atomic write (temporary file + rename), so a crash mid-save never
    leaves a corrupt checkpoint. ``suspects`` persists the certificate's
    running count, which a resumed render must re-enforce over the passes it
    does not re-run."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                framebuffer=np.asarray(framebuffer, np.float32),
                samples_done=np.int64(samples_done),
                fingerprint=np.bytes_(fingerprint.encode()),
                suspects=np.int64(suspects),
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, fingerprint: str) -> Optional[Tuple[np.ndarray, int, int]]:
    """(framebuffer, samples_done, suspects), or None when the file is absent
    or belongs to another scene. A file without ``suspects`` loads with 0."""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        if bytes(data["fingerprint"]).decode() != fingerprint:
            return None
        suspects = int(data["suspects"]) if "suspects" in data.files else 0
        return data["framebuffer"].copy(), int(data["samples_done"]), suspects
