#!/usr/bin/env python3
"""Time the two sort-key kernels (``csrc/rays.cu``: the Morton key and the cullhit key) on one GPU, for comparing two trees in turns.

    python3 chip_keys.py --label NAME [--tree DIR] [--lamp]

Runs ``chip_smoke.py`` phase 13e's checks and timings on the 126,000-
triangle torus's centre 20-spp block (1000×1000, 10 bounces), traced with
``sort_key="cullhit"``: on the rows entering bounces 0-3 the cullhit key
kernel, bit-equal to its plain version (keys and live count, both count
modes; a mismatch exits non-zero) and timed, and on bounce 1's rows the
Morton key kernel timed on copies out of L2, as phase 6c times it.
``--lamp`` adds the lamp-scale torus's (``chip_smoke.LAMP_SIZE``) bounces
0-1. Prints the card's name and power limit, then one JSON line.

``--tree DIR`` imports ``cuda_raytracer_tpu_torch`` from DIR (default: this
file's directory). The helpers use only calls every tree since the cullhit
key's port has, so an older tree unpacked with ``git archive`` can be timed
beside this one in turns (A, B, B, A), each in its own process.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke


def timed_bounces(base, last: int, label: str) -> list:
    """The cullhit key checked on bounces 0..``last`` of ``base``'s centre
    block → [(bounce, rows, ``chip_smoke._key_times``)]."""
    out = []
    for scene, block_lo, b, rows in chip_smoke._cullhit_rows(base, last):
        chip_smoke._key_check(scene, rows, f"{label} centre block lo={block_lo} bounce={b}")
        out.append((b, rows.shape[0], chip_smoke._key_times(scene, rows)))
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    parser.add_argument("--label", required=True)
    parser.add_argument("--lamp", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("chip_keys: no CUDA device", file=sys.stderr)
        return 1
    from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl

    smi = chip_smoke._smi()
    print(smi, flush=True)
    device = torch.device("cuda")
    # The cullhit key keys a packet scene's reorder ("auto" walks the BVH).
    packet = dict(intersector="packet")
    torus = scene_dsl.assemble_scene(builtin_scenes.parse_mesh_scene("torus"),
                                     config_overrides=packet, device=device)
    bounces = timed_bounces(torus, 3, "torus")
    result = dict(label=args.label, card=smi, rows=[n for _, n, _ in bounces],
                  cullhit_ms=[t["ms"] for _, _, t in bounces],
                  ray_keys_ms=bounces[1][2]["ray_keys_ms"])
    if args.lamp:
        lamp = scene_dsl.assemble_scene(
            builtin_scenes.parse_mesh_scene("torus", chip_smoke.LAMP_SIZE),
            config_overrides=packet, device=device)
        result["lamp_clusters"] = lamp.num_clusters
        result["lamp_cullhit_ms"] = timed_bounces(lamp, 1, "lamp-scale torus")[1][2]["ms"]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
