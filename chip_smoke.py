#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (cuda_raytracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths: forward renders at the reference benchmark
shape (1000×1000, 100 rays per pixel in five passes of 20, 10 bounces) of a
brute scene through the shade kernel and of a 126,000-triangle mesh through
the packet kernels (``intersector="packet"``: fused1 for passes of 10 or
more rays a pixel, cull + fused below, with the gated cull behind
``cull_hier``, and with pack=2 for a paired sub-cluster table) and through
"auto", which walks the BVH on the card, on the packed forward wavefront
(set-up, bounce and sort-key kernels), the command-line renderer, the
inverse-rendering train step on that mesh at the JAX package's
forward+backward shape (256×256, 2 rays per pixel, 10 bounces) through both
packet engines that reach a TPU kernel (cull + fused, and cull + the pair
sweep), sharded rendering and training over torch.distributed, and the
same render and train step through the BVH intersector (a per-ray walk
kernel) and the render reordered by the "cullhit" key (a key kernel), and
checks them all. The mesh phases 6-11 and 13 pin ``intersector="packet"``
on their scenes; the CLI (9) and sharding (12) take "auto". Phases, one
line each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile ``csrc/shade.cu``, ``cull.cu`` (flat and gated cull),
   ``fused.cu``, ``fused1.cu``, ``sweep.cu``, ``bounce.cu``, ``rays.cu`` and
   ``traverse.cu`` with nvcc, all eight at once, and the native BVH builder with g++; print
   seconds and registers;
3. kernel vs plain: each built-in scene at 64×64, 4 rays per pixel and 10
   bounces, plus an unaligned block (ray ids 100..359): per-ray agreement
   with the plain PyTorch version (max |Δ| < 1e-3 on ≥ 99.9 % of rays, none
   non-finite);
4. main path: ``render_timed`` of the Cornell- and spheres-style scenes,
   each after one untimed warm-up render; the kernel must launch exactly 5
   times per timed render, the framebuffer must be finite and the mean
   display value sane;
5. timing: one 20 M-ray Cornell pass — the kernel on its persistent grid
   and at one block per SM (the two outputs bit-identical; each timed as
   every kernel is, CUDA events around back-to-back launches queued behind
   a device sleep, divided by their count), the plain version over the same
   pass in 2^18-ray blocks and at one 2^18 block, the live ray-bounces it
   holds, the FP32 bound they imply, and the kernel held against the plain
   version at that full shape (rays outside the gate, max |Δ|); then the
   kernel alone on a cornell_plus and a spheres pass;
6. packet kernels vs plain: the torus and glass torus (126,000 triangles)
   at 64×64, 4 rays per pixel, the wavefront entering bounces 0-3 (coherent
   primary rays, then Morton-sorted bounced ones), cut to an unaligned ray
   count: cull (with and without hit words), fused (with and without the
   skip test, one and two shards) and fused1 (flat and gated, one and two
   shards, one block per tile and split) must equal their plain versions
   bit for bit; (b) the bounce kernel against its plain version (the torch
   shading) on the torus, the glass torus and the spheres scene under the
   substitute sky at 64×64 × 4 spp, and on the torus's centre 2^18-ray block
   of a 20-spp pass, each entering bounces 0-9: the shade kernel's gate;
   (c) the forward trace's row kernels on that block traced as the packed
   trace traces it, bounces 0-9: the set-up kernel (alive bit, sphere hit,
   ray tiles), the sort keys and live count (both engines, and the sorted
   permutation), the PCG draws (a bounce's; the camera's at bounce 0) and
   the reorder's row move (the block bounced and sorted, int64 and int32
   permutations, with and without a settled suffix, the rows past it
   untouched) bit-equal to their plain versions, the live counts of three
   back-to-back launches of each key kernel right, the packed bounce
   kernel against the torch shading at the shade gate; the camera kernel
   (a block's packed starting rows) bit-equal to its plain version on the
   first, centre and last (short) blocks of a pass and rank 1 of 2's first
   block, at 20 and 8 rays a pixel, for pass seeds 80 and 2^31 + 80; then
   their times (each call on rows out of L2), plain times and bounds, the
   camera kernel's beside the sequence it replaced (its device operations,
   device and host time) and torch.cat of the rows' columns; the row move
   after bounce 0 (rows out of L2 and in it) beside torch.index_select
   on the same rows, and the grid and block of each one's device kernel;
7. mesh main path: the torus at 1000×1000 and 10 bounces after small
   warm-ups, timed as ``render_timed`` times it, in turns: 100 and then 8
   rays per pixel, each through fused1 and through cull + fused (fused1,
   cull + fused, cull + fused, fused1), then once through "auto" (on the
   card the BVH walk, ``wavefront.resolve_intersector``); launch
   counts per kernel (> 0 for the regime's kernels, the walk's in "auto",
   and the forward kernels: camera rows, set-up, bounce, sort
   keys, row move; 0 for the other closest-hit kernels and the PCG draws;
   the camera kernel once a block), finite framebuffers, sane mean
   display values, every packet image of a spp identical, and the "auto"
   image within ±1 of them on at least WALK_IMAGE_SHARE of its bytes (the
   walk keeps the first of two tied triangles, the packet engines the
   larger id);
8. packet timing: the 2^18-ray block of the 20-rays-per-pixel pass that
   holds the image centre,
   entering bounce 0 and bounce 1 (sorted): each kernel and its plain
   version, the slab tests of live rays and the
   Möller–Trumbore tests of live rays against real (unpadded) triangles
   that the kernel did, the bound they imply, and bit-equality at that full
   shape; (b) the bounce kernel's time, its plain version's, the bytes the
   block needs and its bound; then the cull (0 mismatched elements against
   plain_cull, timed beside its bound), fused (with its skip test, as
   the cull + fused engine calls it) and the pair sweep (over the same
   culled pairs, timed only) on the same block traced as a render traces
   it (live prefix, Morton sort), entering bounces 0-9, fused at one block
   per tile and at the chosen split, both bit-equal to plain_fused, both
   timed; and fused1 on those rays, one block per tile and at the chosen
   split, both bit-equal to the plain version, both timed, with its bound
   and share, each bounce on one line beside cull + fused and the sweep on
   the same rays; then that block's whole trace (10 bounces)
   under torch.profiler, through fused1 with the bounce kernel and with the
   torch shading (the plain version called by name), and through cull +
   fused: device time by kernel, the packet kernels' time per bounce, the
   device operations per block and per bounce and the device's idle share;
9. the command-line renderer: the full-size torus and the Cornell scene
   written as ``.scene`` files; (a) ``python -m cuda_raytracer_tpu_torch
   torus.scene --spp 8 --metrics`` as a subprocess (exit 0, the PNG,
   paths/s; its load_scene seconds with the native BVH, render seconds and
   metrics line, whose launch counters must show the walk and the
   forward kernels: "auto" walks the BVH on the card); (b) ``cli.main`` in
   process on the same render with ``--cull-hier 16``: the walk and the
   forward kernels launch and no other kernel, stderr warns that the
   packet option has no effect on a walk render, and the PNG is
   byte-identical to 9a's; (c)
   the gated cull kernel's path: the 8-spp torus through cull + fused with
   ``cull_hier=16`` and with the flat cull, in turns: the gated cull
   launches in every gated render and the flat cull in none (not even for
   the super boxes), the reverse in the flat renders, every image
   identical; then the one-launch hierarchical cull (the super boxes tested
   in the kernel) against the flat cull and against the plain gated cull
   behind the super-box pre-pass, and the gate-word form against its plain
   version, on the torus centre block at bounces 0-3, with and without hit
   words, at an unaligned ray count and at the full block (0 mismatched
   elements); its time on bounces 0 and 1 beside the two-step form
   (pre-pass + gate-word kernel) and the flat cull; and the centre block's
   profile through cull + fused with ``cull_hier=16`` (device kernels per
   bounce); (d) a 128×128 render stopped after two
   passes and resumed from its checkpoint, bit-identical to an
   uninterrupted one; (e) ``cli.main`` with the ``cpu`` flag on the Cornell
   scene at 64×64: the GPU and CPU images agree within 1 per channel on >=
   99.9 % of the bytes;
10. differentiable rendering: (a) the pair sweep kernel against its plain
   version on the torus centre block entering bounces 0-3, at an unaligned
   ray count and at the full block: one-round, both rounds of the two-round
   sweep and an overflowing pair budget, bit-equal in rows [:T]; the
   one-round list at the kernel's own range count, at one range per pair
   and at SWEEP_CUT_RANGES ranges (which cut tiles' runs of pairs),
   tile-major and shuffled, there and on the train step's pass entering
   bounces 0-3, bit-equal; then the
   "pallas" engine's closest hit against the "fused" engine's, bit-equal;
   (b) the sweep's time on bounces 0 and 1 with its bound and plain time,
   beside the fused kernel on the same rays; the cull (held to plain_cull)
   and fused at one block per tile and at the chosen split on the train
   step's pass (131,072 rays, bounces 0-9), bit-equal to plain_fused; (c)
   the wavefront's one-hot material
   lookup bit-equal to the row gathers on the card, with TF32 allowed and
   not; then
   the train step (``diff.make_train_step``, Adam) at 256×256 × 2 spp × 10
   bounces on the full torus, for packet_backend "auto" and "pallas", with
   and without per-bounce checkpointing: the pallas audit first (doubling
   ``packet_cap`` until no ray is suspect), 2 warm-up steps and 5 timed ones
   (seconds per step, paths/s, peak memory), a finite and falling loss,
   finite gradients, closest-hit launches per step equal to the forward
   pass's own (the backward launches none), no bounce or set-up kernel in a
   step (training shades with torch, its PCG draws and sort keys from their
   kernels), the device kernels of one step, the audit (which shades with the bounce
   kernel) keeping or dropping the calibrated live schedule as it does
   under the torch shading, the step's scene reporting no suspect ray under
   the step's own shading, one checkpointed step of each engine under
   torch.profiler (device busy and idle share), and the two engines'
   gradients within 1e-3 of the largest; (d) the inverse-rendering example
   at its default size must recover the walls (error < 0.15);
11. paired sub-cluster tables: the full torus built with ``cluster_pack=2``
   (blocks of 256 lanes, sub-clusters of 128); (a) the pack-2 fused1 kernel
   against its plain version at 64×64 × 4 spp entering bounces 0-3, at an
   unaligned ray count, flat and gated, one shard and two block-aligned
   shards, and against the pack-1 kernel on the torus cut at 128 (0
   mismatched elements); (b) its time on the centre block of a 20-spp pass
   at bounces 0 and 1, its counters and bound,
   its plain time and bit-equality at that shape, beside the pack-1 kernel
   of phase 8 on the same rays, its profile, and bounces 0-9 as in phase
   8, beside phase 8's cull + fused, sweep and pack-1 times on the same
   rays; (c) the main path: the packed and the unpacked torus at 1000×1000,
   100 spp, 10 bounces in turns (packed, unpacked, unpacked, packed):
   pack-2 launches and no other packet kernel's in the packed renders,
   fused1 (pack 1) in the unpacked ones,
   finite framebuffers bit-identical to phase 7's, seconds and Mrays/s;
12. sharding: (a) phase 9a's command with ``--mesh 1``, in one process
   (an entry that fails the run if a rank is spawned): exit 0, its wall and
   render_sharded seconds beside 9a's, 9a's kernels launched, a PNG
   byte-identical to phase 9a's; (b) two ranks on the one card, joined by
   gloo, on the Cornell scene and the torus at 256×256 × 2 spp × 10
   bounces, the torus through "auto" and through ``intersector="packet"``:
   the sharded framebuffer against the single-device one, one
   sharded train step's loss (the same bits on both ranks) against the
   single-device loss, the summed gradients against
   ``diff.render_and_grad``'s, and in both ranks the walk's launches on
   the "auto" torus, cull + fused's on the packet one (SHARD_SCENES);
   (c) ``scaling_report`` on the size-1 mesh;
13. the BVH intersector (``intersector="bvh"``, the walk kernel of
   ``csrc/traverse.cu``) and the "cullhit" sort key (the key kernel of
   ``csrc/rays.cu``): (a) the walk against its plain version (the lockstep
   walk) on the torus's centre 2^18-ray block of a 20-spp pass, traced
   through the BVH as a render traces it, at every bounce 0-9 (the live
   prefix the render hands the walk), and on the glass torus's at bounces
   0-3, at the rays a warp the kernel picks and at WALK_LANES: t and index
   bit-equal; on each of these bounces each launch's time, the live count,
   the mean and largest pops per live ray, the slab and triangle tests per
   live ray (its counting variant), the bound they imply and its share,
   and on the torus's bounce 1 the plain walk's time; then the lamp-scale
   torus (LAMP_SIZE, 619,500 triangles): its set-up seconds, the walk
   bit-equal on its centre block's bounces 0, 1 and 3, bounces 1 and 3
   timed as above;
   (b) the walk against the packet engine (cull + fused) on the
   torus's bounces 0, 1 and 3: t within rtol / atol 1e-5 and under 1 % of
   live rays on another triangle (JAX's BVH-against-scan standard), the
   mismatches and how many are equal-distance ties; (c) the torus at
   1000×1000 × 10 bounces through the BVH and through the packet
   intersector (fused1 at 100 spp, cull + fused at 8) in turns (bvh,
   packet, packet, bvh) at 100 and at 8 spp: seconds, Mrays/s, the walk launching in the BVH renders and no
   packet kernel, the mean display value, the images' mean |Δ| and share of
   bytes within ±1 (printed, not gated: tie rays take other paths); then
   the centre block's profile through the BVH; (d) the train step at phase
   10c's shape, checkpointed, through the BVH and through the packet
   intersector (cull + fused) in turns:
   seconds per step, a falling loss, finite gradients, the walk's launches
   per step equal to the forward pass's; (e) the cullhit key against its
   plain version on the centre block's bounces 0-3 (traced with that key)
   and on the lamp-scale torus's bounce 1 (3,486 clusters: squeezed ids, a
   table staged above 48 KB), keys and live count bit-equal in both count
   modes, on each bounce 1 its time beside ``ray_keys``', the gates and
   boxes it tested beside the box tests a flat scan needs, and its bound
   (17 operations a test it made); then the torus at 1000×1000 × 8 spp with
   ``sort_key="cullhit"`` and with the Morton key in turns (morton,
   cullhit, cullhit, morton): framebuffers bit-identical.

Then one line per kernel, ranked by launches × (ms − bound ms), one JSON
line per the kernel table, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. Without a
CUDA device it exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

AGREE_TOL = 1e-3  # per-ray max |Δ| counted as agreeing
AGREE_MIN = 0.999  # fraction of rays that must agree
FULL = dict(width=1000, height=1000, rays_per_pixel=100, bounces=10)
SMALL = dict(width=64, height=64)
SMALL_RPP = 4
SMALL_BOUNCES = 10

# _cuda_ms's device sleep: SM cycles per second (the H100 SXM's 1.98 GHz
# boost clock, rounded up, so the sleep lasts at least as long as asked) and
# its cap.
SLEEP_CYCLES_PER_S = 2.0e9
SLEEP_MAX_S = 2.0

# H100 SXM published peaks (dense, at the 700 W power limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# FP32 arithmetic per unit of work, counted from csrc/shade.cu (each add,
# sub, mul, div, sqrt, max, sin, cos and int→float convert is one
# operation; compares and selects are not counted):
#   sphere test   3 sub, mhb 3 mul + 2 add, qc 4 mul + 3 add/sub,
#                 qd 1 mul + 1 sub, max, sqrt, near/far 2           = 21
#   triangle test h 6 mul + 3 sub, det 3 mul + 2 add, 1 div,
#                 f 3 sub, u 4 mul + 2 add, q 9, v 6, t 6, u+v 1    = 46
#   shading (per live bounce that hits): 5 converts + 5 scales,
#                 two on-sphere points 2×8, hit point 6, normal 3,
#                 facing 5, rough normal 16, cos 5, emission 6,
#                 ior/Schlick 15, scatter direction ~13, tint 3     = 98
#   camera ray (once per ray): 2 converts, 2 scales, 2 add, 2 mul,
#                 direction 12, normalise 9                         = 29
SPHERE_OPS = 21
TRI_OPS = 46
SHADE_OPS = 98
CAMERA_OPS = 29

# Mesh path. FP32 operations per test, counted from csrc/packet.cuh:
#   slab test per (live ray, box), in rt::slab_ordered's form (slab()'s
#                 values): 3 axes × (2 sub, 2 mul), the entry's max
#                 over 0 and 3 near planes 3, the exit's min over the
#                 window and 3 far planes 3, the entry's running
#                 minimum 1                                          = 19
#                 (the safe inverse, 3 per ray, is amortised over K)
#   super-box slab test of the one-launch gated cull (rt::slab_signed),
#                 and fused1's box and super-box test (rt::slab_sorted)
#                 per (live ray, box): 3 axes × (2 sub, 2 mul), the
#                 entry's max 3, the exit's min 3, no running minimum = 18
#   Möller–Trumbore terms (rt::mt_terms) per (live ray, real triangle of
#                 a swept cluster; padding slots excluded): h 6 mul +
#                 3 sub, det 3 mul + 2 add, f 3 sub, ud 5, q 9, vd 5,
#                 td 5                                               = 41
#     fused (rt::mt_t's sign-folded acceptance): |det| 1,
#                 us vs ts 3 mul, us+vs 1, eps·|det| 1               = 47
#     the sweep and fused1 (rt::mt_accept_terms): ud+vd 1, eps·det 1 = 43
#                 (+1 division per accepted hit, not counted)
SLAB_OPS = 19
SUPER_SLAB_OPS = 18
MT_OPS = 47
SWEEP_MT_OPS = 43
FUSED1_OPS = (SUPER_SLAB_OPS, SWEEP_MT_OPS)  # fused1: (per slab test, per MT test)
MESH_FULL_SPP = 100
MESH_FEW_SPP = 8  # one pass: the sparse-sample render
MESH_SMALL_RPP = 4
MESH_SMALL_BOUNCES = 4
TRAIN = dict(width=256, height=256, rays_per_pixel=2, bounces=10)  # phase 10c
TRAIN_SEED = 7
TRAIN_LR = 2e-2
TRAIN_WARMUP = 2
TRAIN_STEPS = 5
GRAD_TOL = 1e-3  # phase 10c: engines' gradients within GRAD_TOL * max |g| (+1e-6)
EXAMPLE_BAR = 0.15  # phase 10d: the example's own bar
CLI_SPP = 8  # phase 9: one pass (9c renders it through cull + fused, the gated cull's path)
CLI_GATE = 16  # --cull-hier: clusters per super box
# The kernels every forward mesh render launches beside its closest hit: the
# camera rows and the packed trace's set-up and bounce kernels;
# and the one it must not: the PCG draws (a graph-building trace's camera,
# the training shading).
FORWARD_KERNELS = ("camera_rows", "rays_setup", "shade_rows")
FORWARD_NOT = ("pcg_draws",)
# A render that reorders its wavefront (wavefront.reorder_is_useful: the
# packet engines; never the walk on the card) adds its Morton key kernel and
# the row move (_reorder_kernels).
REORDER_KERNELS = ("ray_keys", "reorder_rows")
# The closest-hit kernels of packet_backend "auto" on the card
# (packet_intersect.resolve_backend) in a pass of fewer than 10 rays per
# pixel: cull + fused; a pass of 10 or more takes fused1 (the pass regime,
# pipeline._regime_scene; _auto_kernels).
AUTO_KERNELS = ("cull_tiles", "fused_closest_hit")
FLAT_KERNELS = AUTO_KERNELS + FORWARD_KERNELS + REORDER_KERNELS
# Kernels the 8-spp CLI render must launch (phases 9a, 9b, 12a): "auto" walks
# the BVH on the card, unsorted, and no cull option changes that.
CLI_KERNELS = ("bvh_walk",) + FORWARD_KERNELS
# Share of an "auto" (walk) image's bytes within ±1 of the packet images
# (phase 7): they differ on tie rays alone.
WALK_IMAGE_SHARE = 0.9999
# ... and with --cull-hier 16 (cull_hier, phase 9c): the gated cull in one
# launch a cull, no flat cull (not even of the super boxes).
GATED_KERNELS = ("cull_gated", "fused_closest_hit") + FORWARD_KERNELS + REORDER_KERNELS
CPU_GATE = 0.999  # phase 9e: share of image bytes within 1 of the CPU render
# Phase 10a: a pair-range count of the sweep whose ranges cut tiles' runs of
# pairs (the tile-major list has a few pairs a tile).
SWEEP_CUT_RANGES = 97
BLOCK_ROWS = 10  # rows of a (16, C) cluster block the sweep reads (rt::kBlockRows)
BOX_ROWS = 6  # rows of the (8, K) box table the slab test reads

PACK_TRIS = 256  # phase 11: lanes per packed block (two sub-clusters of 128)
PACK_GATE = 16  # phase 11: sub-cluster boxes per super box
SHARD_RANKS = 2  # phase 12b
SHARD_TIMEOUT = 600  # phase 12b: seconds before the ranks are killed
SHARD_FB_TOL = dict(rtol=1e-5, atol=1e-4)  # phase 12b: framebuffer vs one device
SHARD_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # phase 12b: gradients vs one device
LOSS_RTOL = 1e-5  # phase 12b: loss vs one device
SCALING_RPP = 4  # phase 12c

# The bounce kernel (csrc/bounce.cu), per live ray that hits: SHADE_OPS as
# above; per live ray that misses, the environment fetch: rotation 6,
# projection ~24, texel index 8, the radiance add 6 = 44 FP32 operations.
# Bytes per ray: state in 4 x 12, ray id, hit distance, hit index 12, state
# out 48.
ENV_OPS = 44
# Bytes the packed bounce needs per ray (wavefront.pack_rows rows): a dead
# ray its transmitted weight (12); a live ray its hit (sphere t and index,
# triangle t and index: 16) and, on a miss, direction, transmitted and
# collected in (36) and transmitted and collected out (24); on a hit, origin,
# direction, transmitted, collected and ray id in (52) and the four out (48).
BOUNCE_DEAD_BYTES = 12
BOUNCE_MISS_BYTES = 16 + 36 + 24
BOUNCE_HIT_BYTES = 16 + 52 + 48
# The set-up and key kernels read a row's origin, direction and transmitted
# weight (48 bytes); the key is ~18 FP32 operations per live ray (origin
# normalised 6, direction mapped 6, scaled 6).
ROW_STATE_BYTES = 48
KEY_OPS = 18

# Phase 13: FP32 operations per test of the BVH walk (csrc/traverse.cuh),
# counted at the least the function needs, not at the kernel's form:
#   slab test per child box, in the sign-picked form (as SUPER_SLAB_OPS):
#                 3 axes × (2 sub, 2 mul), the entry's max over 0 and 3
#                 near planes 3, the exit's min over the window and 3 far
#                 planes 3 (rt::slab's own form has 18 min / max)      = 18
#   Möller–Trumbore (ops/intersect.moller_trumbore's form) per triangle:
#                 rt::mt_terms 41, 1 / det 1, u, v, t scaled 3, u+v 1  = 46
#   (the safe inverse direction, 3 per live ray, counted once per ray)
# and per box the cullhit key's unwindowed test (rt::first2_span's values):
# 3 axes × (2 sub, 2 mul), the entry's max over 0 and 3 near planes 3, the
# exit's min over 3 far planes 2 = 17, counted over the gates and boxes the
# kernel's rays test (its counter); flat_bound_ms counts instead the boxes a
# flat ascending scan tests (rays.flat_box_tests), for comparison.
BVH_SLAB_OPS = 18
BVH_MT_OPS = 46
CULLHIT_BOX_OPS = 17
# 13a: the rays a warp timed beside the walk kernel's own pick (the fewest
# that keep its grid within two waves), and the size of the lamp-scale torus
# (segments around the ring and tube).
WALK_LANES = (1, 32)
LAMP_SIZE = (1239, 250)
# 13e (and chip_keys.py): the traced block's samples a pixel and seed, as 6c's.
KEY_RPP, KEY_SEED = 20, 80
# Closest-hit kernels of the packet engines and the brute megakernel: none
# may launch in a BVH render (phase 13c).
PACKET_LAUNCH_NAMES = ("cull_tiles", "fused_closest_hit", "fused1_closest_hit",
                       "fused1_closest_hit_pack2", "cull_gated", "sweep_pairs", "shade_trace")
KERNEL_SOURCES = ("shade", "cull", "fused", "fused1", "sweep", "bounce", "rays", "traverse")
# Device kernels of one fused1 call in a profile: the unsplit and the split
# kernel (fused1_kernel, fused1_split_kernel), the split's key set-up and
# finishing pass.
FUSED1_KERNELS = ("fused1_", "init_keys", "finish_keys")
# (name, source, the TPU kernel it replaces) of the mesh path's kernels.
PACKET_KERNELS = (
    ("cull_tiles", "cuda_raytracer_tpu_torch/csrc/cull.cu",
     "cuda_raytracer_tpu/ops/pallas/cull.py:76"),
    ("fused_closest_hit", "cuda_raytracer_tpu_torch/csrc/fused.cu",
     "cuda_raytracer_tpu/ops/pallas/fused.py:527"),
    ("fused1_closest_hit", "cuda_raytracer_tpu_torch/csrc/fused1.cu",
     "cuda_raytracer_tpu/ops/pallas/fused1.py:148"),
)


def _smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def _agreement(a, b):
    """(fraction of rays with max |Δ| < AGREE_TOL, worst |Δ|, all finite)."""
    import torch

    diff = (a - b).abs().amax(dim=1)
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    return float((diff < AGREE_TOL).float().mean()), float(diff.max()), finite


def _cuda_ms(fn, runs: int = 20):
    """Device milliseconds per call of ``fn``, a kernel's wrapper: CUDA
    events around ``runs`` back-to-back calls, divided by ``runs``, after a
    warm-up call. The calls are queued behind a device sleep long enough
    for the host to enqueue them all, so the events time the device's work
    and not the wrapper's host time between launches (one call between two
    events would time the host for a kernel shorter than its wrapper)."""
    import torch

    fn()
    torch.cuda.synchronize()
    host = time.perf_counter()
    fn()
    host = time.perf_counter() - host  # enqueue time of one call
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(SLEEP_MAX_S, 3 * runs * host + 2e-3) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / runs


def _plain_ms(fn, runs: int = 3):
    """Median milliseconds of one call of ``fn``, a plain PyTorch version,
    between CUDA events, after one warm-up call: the plain versions launch
    hundreds of ops and some synchronise, so this is their wall time."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _mismatch(got, want):
    """(mismatched elements, max |Δ|) between two tuples of tensors: a
    kernel's outputs and its plain version's."""
    bad = sum(int((g != w).sum()) for g, w in zip(got, want))
    worst = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    return bad, worst


def _scene(name: str, overrides: dict, device):
    from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl

    parsed = scene_dsl.parse_scene_text(builtin_scenes.SCENES[name], filename=name)
    return scene_dsl.assemble_scene(parsed, config_overrides=overrides, device=device)


def phase_kernel_vs_plain(device) -> None:
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import shade

    for name in ("cornell", "cornell_plus", "spheres"):
        scene = _scene(name, SMALL, device)
        rays = SMALL["width"] * SMALL["height"] * SMALL_RPP
        for lo, n in ((0, rays), (100, 260)):
            ray_id = lo + torch.arange(n, dtype=torch.int32, device=device)
            got = shade.shade_trace(scene, ray_id, SMALL_RPP, 3, SMALL_BOUNCES)
            ref = shade.plain_trace(scene, ray_id, SMALL_RPP, 3, SMALL_BOUNCES)
            torch.cuda.synchronize()
            agree, worst, finite = _agreement(got, ref)
            print(f"phase 3 kernel vs plain: {name} block_lo={lo} rays={n} "
                  f"agree={agree:.6f} max_abs_err={worst:.3g} finite={finite}")
            if not finite or agree < AGREE_MIN:
                raise SystemExit(f"phase 3 failed: {name} block_lo={lo}")


def phase_main_path(device) -> dict:
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import shade
    from cuda_raytracer_tpu_torch.render import pipeline

    results = {"launches": 0}
    for name in ("cornell", "spheres"):
        scene = _scene(name, FULL, device)
        # Warm-up render (allocator blocks, clocks), outside the timed run;
        # its framebuffer is checked below.
        framebuffer = pipeline.render_framebuffer(scene)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        shade.LAUNCHES = 0
        image, seconds = pipeline.render_timed(scene)
        launches = shade.LAUNCHES
        results["launches"] += launches
        peak = torch.cuda.max_memory_allocated(device)
        finite = bool(torch.isfinite(framebuffer).all())
        mean = float(image.mean())
        same = bool((pipeline.render_image(scene, framebuffer=framebuffer) == image).all())
        rays = scene.num_pixels * scene.config.rays_per_pixel
        print(f"phase 4 main path: {name} {scene.config.width}x{scene.config.height} "
              f"spp={scene.config.rays_per_pixel} bounces={scene.config.bounces} "
              f"seconds={seconds:.4f} Mrays/s={rays / seconds / 1e6:.1f} "
              f"launches={launches} peak_mem_MiB={peak / 2**20:.1f} "
              f"finite={finite} mean_display={mean:.2f} rerender_identical={same}")
        if launches != 5 or not finite or not 20.0 <= mean <= 235.0:
            raise SystemExit(f"phase 4 failed: {name}")
    return results


def phase_timing(device) -> dict:
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import rays as rays_kernel
    from cuda_raytracer_tpu_torch.ops.kernels import shade
    from cuda_raytracer_tpu_torch.render import pipeline, wavefront

    scene = _scene("cornell", FULL, device)
    rpp, bounces, seed = 20, scene.config.bounces, 80
    rays = scene.num_pixels * rpp
    block = pipeline.RAY_BLOCK
    ray_id = torch.arange(rays, dtype=torch.int32, device=device)

    kernel_ms = _cuda_ms(lambda: shade.shade_trace(scene, ray_id, rpp, seed, bounces), 5)
    got = shade.shade_trace(scene, ray_id, rpp, seed, bounces)
    # The persistent grid against one block per SM: the same bits.
    per_sm, sms = shade.persistent_grid(scene)
    one_per_sm = shade.trace_on_grid(scene, ray_id, rpp, seed, bounces, sms)
    grid_bad, grid_err = _mismatch((one_per_sm,), (got,))
    one_per_sm_ms = _cuda_ms(
        lambda: shade.trace_on_grid(scene, ray_id, rpp, seed, bounces, sms), 5)
    print(f"phase 5 grid: cornell pass rays={rays} persistent_blocks={per_sm * sms} "
          f"({per_sm} per SM x {sms} SMs) kernel_ms={kernel_ms:.3f} one_block_per_sm="
          f"{sms} kernel_ms={one_per_sm_ms:.3f} mismatched={grid_bad} max_abs_err={grid_err:.3g}")
    if grid_bad:
        raise SystemExit("phase 5 failed: the shade kernel's output depends on its grid")

    block_ms = _plain_ms(lambda: shade.plain_trace(scene, ray_id[:block], rpp, seed, bounces))

    def plain_pass():
        return [shade.plain_trace(scene, ray_id[lo:lo + block], rpp, seed, bounces)
                for lo in range(0, rays, block)]

    plain_ms = _plain_ms(plain_pass, 1)

    # The same pass once more, the plain version bounce by bounce, counting
    # the live rays that enter each bounce: the work the kernel actually has
    # to do.
    live = torch.zeros((), dtype=torch.int64, device=device)
    ref = torch.empty_like(got)
    for lo in range(0, rays, block):
        rows = wavefront.pack_rows(wavefront.make_initial_state(
            scene, ray_id[lo:lo + block], rpp, seed, plain=True))
        for b in range(bounces):
            live += rays_kernel.rows_alive(rows).sum()
            wavefront.bounce_rows(scene, rows, seed, b, plain=True)
        ref[lo:lo + block] = rows[:, 9:12]
    live = int(live)
    agree, worst, finite = _agreement(got, ref)
    outside = int(((got - ref).abs().amax(dim=1) >= AGREE_TOL).sum())

    per_bounce = SPHERE_OPS * scene.sphere_count + TRI_OPS * scene.triangle_count + SHADE_OPS
    ops = rays * CAMERA_OPS + live * per_bounce
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = rays * (4 + 12) / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"phase 5 timing: cornell pass rays={rays} kernel_ms={kernel_ms:.3f} "
          f"plain_pass_ms={plain_ms:.1f} plain_block_ms={block_ms:.3f} (rays={block}) "
          f"live_ray_bounces_per_ray={live / rays:.4f} ops_per_live_bounce={per_bounce} "
          f"fp32_bound_ms={ops_ms:.3f} bytes_bound_ms={bytes_ms:.4f} "
          f"bound_share={bound_ms / kernel_ms:.3f} full_shape_agree={agree:.6f} "
          f"rays_outside_gate={outside} max_abs_err={worst:.3g} finite={finite}")
    if not finite or agree < AGREE_MIN:
        raise SystemExit("phase 5 failed: kernel disagrees with plain at full shape")
    for name in ("cornell_plus", "spheres"):
        other = _scene(name, FULL, device)
        ms = _cuda_ms(lambda: shade.shade_trace(other, ray_id, rpp, seed, bounces), 5)
        print(f"phase 5 timing: {name} pass rays={rays} kernel_ms={ms:.3f}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                max_abs_err=worst, agreement=agree,
                grid=dict(persistent_blocks=per_sm * sms, one_per_sm_ms=one_per_sm_ms,
                          mismatched=grid_bad))


def _mesh_scene(name: str, device):
    """A full-size mesh scene (1000×1000, 100 spp, 10 bounces) on the card,
    through the packet intersector. Parsing and the native BVH build are
    set-up, outside every timed scope."""
    from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl

    start = time.perf_counter()
    scene = scene_dsl.assemble_scene(builtin_scenes.parse_mesh_scene(name),
                                     config_overrides=dict(intersector="packet"),
                                     device=device)
    table = scene.cluster_blocks
    print(f"phase 6 setup: {name} triangles={scene.triangle_count} "
          f"clusters={scene.num_clusters} cluster_tris={scene.cluster_tris} "
          f"table_MB={table.numel() * table.element_size() / 1e6:.2f} "
          f"setup_seconds={time.perf_counter() - start:.1f}")
    return scene


def _resized(scene, width: int, height: int):
    """The scene seen at another resolution (camera basis rebuilt)."""
    from cuda_raytracer_tpu_torch.models.scene import precompute_camera

    cam = scene.camera
    camera = precompute_camera(
        cam.position.cpu().numpy(), cam.forward.cpu().numpy(), cam.up.cpu().numpy(),
        cam.vertical_fov, width, height, device=scene.device,
    )
    return scene.replace(camera=camera).with_config(width=width, height=height)


def _packet_rays(scene, state, tile: int):
    """od8 of a wavefront as closest_hit builds it: the sphere hit (or 1e30)
    as window, -1 for dead rays, padded to whole tiles."""
    import torch
    from cuda_raytracer_tpu_torch.ops import intersect, packet_intersect
    from cuda_raytracer_tpu_torch.ops.kernels import cull

    alive = torch.any(state.transmitted != 0.0, dim=-1)
    t, _ = intersect.intersect_spheres(state.origin, state.direction,
                                       scene.sphere_center, scene.sphere_radius)
    window = torch.where(alive, t, -1.0)
    padded = packet_intersect._pad_rays(state.origin, state.direction, window, tile)
    return cull.make_od8(*padded, tile)


def _sharded(fn, K: int, shards: int, pack: int = 1):
    """Run ``fn(lo, hi)`` over ``shards`` box ranges cut at whole blocks of
    ``pack`` boxes, and merge."""
    from cuda_raytracer_tpu_torch.ops import packet_intersect

    out = None
    for lo, hi in packet_intersect.block_ranges(K, shards, pack):
        out = packet_intersect._merge(out, *fn(lo, hi))
    return out


def _packet_cases(scene, od8):
    """Every kernel variant of the mesh path on one ray batch, each against
    its plain version → {kernel: (cases, mismatched elements, max |Δ|)}."""
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import cull, fused, fused1

    K = scene.num_clusters
    cmin, cmax = scene.cluster_min, scene.cluster_max
    aabb = cull.box_table(cmin, cmax)
    blocks = scene.cluster_blocks[:K].contiguous()
    entry, mask = cull.cull_tiles(od8, aabb, with_mask=True)
    entry_only = cull.cull_tiles(od8, aabb)
    e_ref, m_ref = cull.plain_cull(od8, aabb, with_mask=True)
    select = e_ref < cull.MISS_ENTRY * 0.5
    ref = fused.plain_fused(od8, blocks, fused.pack_words(select))
    ref1 = fused1.plain_fused1(od8, aabb, blocks)
    out = {"cull_tiles": [_mismatch((entry, mask), (e_ref, m_ref)),
                          _mismatch((entry_only,), (e_ref,))],
           "fused_closest_hit": [], "fused1_closest_hit": [
               _mismatch(ref1, ref)]}  # the two plain versions agree too
    for skip in (False, True):
        for shards in (1, 2):
            got = _sharded(lambda lo, hi: fused.fused_closest_hit(
                od8, blocks[lo:hi].contiguous(), fused.pack_words(select[:, lo:hi]),
                entry[:, lo:hi].contiguous() if skip else None,
                mask[:, :, lo:hi].contiguous() if skip else None), K, shards)
            out["fused_closest_hit"].append(_mismatch(got, ref))
    for gate in (0, 16):
        for shards in (1, 2):
            for splits in (1, None):  # one block per tile; split_plan's choice
                got = _sharded(lambda lo, hi: fused1.fused1_closest_hit(
                    od8, cull.box_table(cmin[lo:hi], cmax[lo:hi]), blocks[lo:hi].contiguous(),
                    fused1.shard_supers(cmin[lo:hi], cmax[lo:hi], gate) if gate else None,
                    gate, splits=splits), K, shards)
                out["fused1_closest_hit"].append(_mismatch(got, ref1))
    torch.cuda.synchronize()
    return {k: (len(v), sum(b for b, _ in v), max(w for _, w in v)) for k, v in out.items()}


def phase_packet_vs_plain(scenes) -> dict:
    import torch
    from cuda_raytracer_tpu_torch.render import wavefront

    worst = {}
    for name, full in scenes.items():
        scene = _resized(full, 64, 64)
        rays = 64 * 64 * MESH_SMALL_RPP
        ray_id = torch.arange(rays, dtype=torch.int32, device=scene.device)
        state = wavefront.make_initial_state(scene, ray_id, MESH_SMALL_RPP, 3)
        for bounce in range(MESH_SMALL_BOUNCES):
            cut = wavefront.RayState(*(leaf[:rays - 37] for leaf in state))  # unaligned
            results = _packet_cases(scene, _packet_rays(scene, cut, scene.config.packet_tile))
            for kernel, (cases, bad, err) in results.items():
                print(f"phase 6 kernel vs plain: {name} bounce={bounce} rays={rays - 37} "
                      f"{kernel} cases={cases} mismatched={bad} max_abs_err={err:.3g}")
                if bad:
                    raise SystemExit(f"phase 6 failed: {kernel} differs from its plain "
                                     f"version ({name}, bounce {bounce})")
                worst[kernel] = max(worst.get(kernel, 0.0), err)
            state = _next_state(scene, state, 3, bounce)
    return worst


def _next_state(scene, state, seed: int, b: int):
    """``state`` after bounce ``b`` as the forward trace runs it
    (``wavefront.bounce_rows`` on its packed rows), Morton-sorted."""
    from cuda_raytracer_tpu_torch.render import wavefront

    rows = wavefront.pack_rows(state)
    wavefront.bounce_rows(scene, rows, seed, b)
    return wavefront.reorder_rays(scene, wavefront.unpack_rows(rows))


def _bounce_vs_plain(scene, state, seed: int, bounces: int, label: str) -> float:
    """The bounce kernel against its plain version on ``state`` entering
    bounces 0..bounces-1 (the same closest hit for both), the kernel's
    output carried on and reordered where a render reorders; fails below the
    gate → the worst |Δ|."""
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import bounce
    from cuda_raytracer_tpu_torch.render import wavefront

    worst = 0.0
    for b in range(bounces):
        alive, t, hit_index, _ = wavefront.closest_hit_of(scene, state, b)
        got, ref = wavefront.pack_rows(state), wavefront.pack_rows(state)
        bounce.shade_rows(scene, got, t, hit_index, seed, b)
        bounce.plain_shade_rows(scene, ref, t, hit_index, seed, b)
        torch.cuda.synchronize()
        agree, err, finite = _agreement(got[:, :12], ref[:, :12])
        print(f"phase 6b bounce vs plain: {label} bounce={b} rays={t.shape[0]} "
              f"live={int(alive.sum())} hits={int((alive & (hit_index >= 0)).sum())} "
              f"agree={agree:.6f} max_abs_err={err:.3g} finite={finite}")
        if not finite or agree < AGREE_MIN:
            raise SystemExit(f"phase 6b failed: {label} bounce {b}")
        worst = max(worst, err)
        got = wavefront.unpack_rows(got)
        state = (wavefront.reorder_rays(scene, got) if wavefront.reorder_is_useful(scene)
                 else got)
    return worst


def phase_bounce_vs_plain(scenes, device) -> dict:
    """6b: the bounce kernel against its plain version: the torus, the glass
    torus and the spheres scene under the substitute sky (brute intersector,
    texel fetches) at 64×64 × 4 spp, and the torus's centre 2^18-ray block of
    a 20-spp pass, entering bounces 0-9 (max |Δ| < 1e-3 on ≥ 99.9 % of
    rays, every component of the next state, none non-finite)."""
    import torch
    from cuda_raytracer_tpu_torch.models import builtin_scenes, procedural, scene_dsl
    from cuda_raytracer_tpu_torch.render import wavefront

    parsed = scene_dsl.parse_scene_text(builtin_scenes.SPHERES, filename="spheres")
    parsed.environment_map = procedural.substitute_envmap()
    sky = scene_dsl.assemble_scene(parsed, config_overrides=SMALL, device=device)
    small = {name: _resized(full, 64, 64) for name, full in scenes.items()}
    small["spheres_sky"] = sky
    worst = 0.0
    for name, scene in small.items():
        rays = 64 * 64 * MESH_SMALL_RPP
        ids = torch.arange(rays, dtype=torch.int32, device=device)
        state = wavefront.make_initial_state(scene, ids, MESH_SMALL_RPP, 3)
        worst = max(worst, _bounce_vs_plain(scene, state, 3, SMALL_BOUNCES,
                                            f"{name} 64x64 spp={MESH_SMALL_RPP}"))
    rpp, seed = 20, 80
    scene = scenes["torus"].with_config(rays_per_pixel=rpp)
    block_lo, block = _centre_block(scene, rpp)
    ids = block_lo + torch.arange(block, dtype=torch.int32, device=device)
    state = wavefront.make_initial_state(scene, ids, rpp, seed)
    worst = max(worst, _bounce_vs_plain(scene, state, seed, scene.config.bounces,
                                        f"torus centre block lo={block_lo}"))
    return dict(max_abs_err=worst)


def _timed_framebuffer(scene):
    """``render_timed``'s scope (the pass loop, ending when the device has
    finished) → (framebuffer, uint8 image, seconds)."""
    import torch
    from cuda_raytracer_tpu_torch.render import pipeline

    torch.cuda.synchronize()
    start = time.perf_counter()
    framebuffer = pipeline.render_framebuffer(scene)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return framebuffer, pipeline.render_image(scene, framebuffer=framebuffer), seconds


def _reorder_kernels(scene) -> tuple:
    """The kernels a forward render of ``scene`` reorders its wavefront
    with: its key kernel and the row move where its schedule sorts
    (``wavefront.reorder_is_useful``), else none."""
    from cuda_raytracer_tpu_torch.render import wavefront

    if not (scene.config.sort_rays and wavefront.reorder_is_useful(scene)):
        return ()
    key = "cullhit_keys" if wavefront.sort_key_mode(scene) == "cullhit" else "ray_keys"
    return (key, "reorder_rows")


def _turns(turns, must: dict, must_not: dict, phase: str, tag: str) -> list:
    """Render each (label, scene) in order, launch counts set to 0 just
    before each and read just after → [(label, framebuffer, image, seconds,
    counts)]. A render must launch the kernels of ``must[label]`` and its
    reorder's (``_reorder_kernels``), none of ``must_not[label]`` and no
    reorder kernel besides, and give a finite framebuffer and a sane image."""
    import torch

    out = []
    for turn, (label, scene) in enumerate(turns):
        reorder = _reorder_kernels(scene)
        need = must[label] + reorder
        banned = must_not[label] + tuple(
            k for k in ("cullhit_keys",) + REORDER_KERNELS if k not in reorder)
        _zero_launch_counts()
        framebuffer, image, secs = _timed_framebuffer(scene)
        counts = _launch_counts()
        finite = bool(torch.isfinite(framebuffer).all())
        mean = float(image.mean())
        rays = scene.num_pixels * scene.config.rays_per_pixel
        print(f"phase {phase} {tag}: torus {scene.config.width}x{scene.config.height} "
              f"spp={scene.config.rays_per_pixel} bounces={scene.config.bounces} turn={turn} "
              f"{label} seconds={secs:.4f} Mrays/s={rays / secs / 1e6:.2f} "
              f"launches={json.dumps(counts)} finite={finite} mean_display={mean:.2f}")
        ok = all(counts[k] > 0 for k in need) and all(counts[k] == 0 for k in banned)
        if not (ok and finite and 20.0 <= mean <= 235.0):
            raise SystemExit(f"phase {phase} failed: {label} render, turn {turn}")
        out.append((label, framebuffer, image, secs, counts))
    return out


def _seconds_by_label(out) -> dict:
    """{label: [seconds of its turns]} of ``_turns``' renders."""
    seconds = {}
    for label, _, _, secs, _ in out:
        seconds.setdefault(label, []).append(secs)
    return seconds


def _render_turns(label_scenes, regimes, phase: str, tag: str):
    """``_turns`` of packet-regime renders → ({label: [seconds]}, and in
    order the framebuffers, the images and the launch counts). Every render
    must launch its regime's kernels and the forward kernels, and no other
    closest-hit kernel."""
    must = {label: regime + FORWARD_KERNELS for label, regime in regimes.items()}
    must_not = {label: tuple(k for k in PACKET_LAUNCH_NAMES if k not in regime) + FORWARD_NOT
                for label, regime in regimes.items()}
    out = _turns(label_scenes, must, must_not, phase, tag)
    return (_seconds_by_label(out), [o[1] for o in out], [o[2] for o in out],
            [o[4] for o in out])


def phase_mesh_main_path(full) -> tuple:
    """Phase 7: the torus at 1000×1000, 10 bounces, after small warm-ups:
    100 spp, then 8 spp, each through fused1 (``packet_backend="fused1"``)
    and through cull + fused (``"fused"``) in turns (fused1, cull + fused,
    cull + fused, fused1), and once through ``intersector="auto"`` (the BVH
    walk on the card). Every packet image of a spp must be identical, and
    the "auto" image within ±1 of them on WALK_IMAGE_SHARE of its bytes →
    (the kernel table's launches, the 100-spp fused1 framebuffer)."""
    import numpy as np
    from cuda_raytracer_tpu_torch.render import pipeline

    small = _resized(full, 128, 128).with_config(rays_per_pixel=20)
    for cfg in (dict(packet_backend="fused1"), dict(packet_backend="fused"),
                dict(intersector="auto")):  # kernels, allocator and clocks warm
        pipeline.render_framebuffer(small.with_config(**cfg))
    configs = {"fused1": dict(packet_backend="fused1"), "cull+fused": dict(packet_backend="fused"),
               "auto": dict(intersector="auto")}
    order = ("fused1", "cull+fused", "cull+fused", "fused1", "auto")
    launches, reference = {}, None
    for spp in (MESH_FULL_SPP, MESH_FEW_SPP):
        turns = [(label, full.with_config(rays_per_pixel=spp, **configs[label]))
                 for label in order]
        regimes = {"fused1": ("fused1_closest_hit",),
                   "cull+fused": ("cull_tiles", "fused_closest_hit"),
                   "auto": _auto_kernels(turns[-1][1])}
        seconds, fbs, images, counts = _render_turns(turns, regimes, "7", "mesh main path")
        same = all(np.array_equal(img, images[0]) for img in images[:-1])
        gap = np.abs(images[-1].astype(np.int32) - images[0].astype(np.int32))
        walk_share = float((gap <= 1).mean())
        blocks = _render_blocks(turns[0][1])
        once_a_block = all(c["camera_rows"] == blocks for c in counts)
        print(f"phase 7 mesh main path: spp={spp} seconds " + " ".join(
            f"{label}={[round(x, 4) for x in secs]}" for label, secs in seconds.items())
            + f" packet_images_identical={same} auto_vs_packet: "
            f"{_image_gap(images[-1], images[0])} blocks={blocks} "
            f"camera_rows_launches={[c['camera_rows'] for c in counts]}")
        if not same:
            raise SystemExit(f"phase 7 failed: the {spp}-spp images differ between regimes")
        if walk_share < WALK_IMAGE_SHARE:
            raise SystemExit(f"phase 7 failed: the {spp}-spp walk image is off the packet one")
        if not once_a_block:
            raise SystemExit("phase 7 failed: the camera kernel did not launch once a block")
        # The kernel table's launches on their paths: the "auto" render (the
        # last turn) at 100 spp for the walk and the forward kernels, the
        # first fused1 turn for fused1, and the 8-spp cull + fused turn.
        if spp == MESH_FULL_SPP:
            reference = fbs[0]  # phase 11c's reference: the fused1 render
            launches.update({k: counts[-1][k] for k in ("bvh_walk",) + FORWARD_KERNELS
                             + REORDER_KERNELS + FORWARD_NOT})
            launches["fused1_closest_hit"] = counts[0]["fused1_closest_hit"]
        else:
            launches.update({k: counts[1][k] for k in AUTO_KERNELS})
    return launches, reference


def _render_blocks(scene) -> int:
    """The wavefront blocks of a render of ``scene``: per pass of at most
    ``max_rays_per_pixel_per_pass`` rays a pixel, its rays in blocks of
    whole pixels of at most ``pipeline.RAY_BLOCK`` rays."""
    from cuda_raytracer_tpu_torch.render import pipeline

    cfg, blocks, remaining = scene.config, 0, scene.config.rays_per_pixel
    while remaining > 0:
        rpp = min(cfg.max_rays_per_pixel_per_pass, remaining)
        remaining -= rpp
        block = max(rpp, (pipeline.RAY_BLOCK // rpp) * rpp)
        blocks += -(-scene.num_pixels * rpp // block)
    return blocks


def _centre_block(scene, rpp: int):
    """(first ray id, rays) of the pass block that holds the image centre:
    the pipeline's own blocking, at a block that sees the mesh."""
    from cuda_raytracer_tpu_torch.render import pipeline

    block = (pipeline.RAY_BLOCK // rpp) * rpp
    centre = (scene.config.height // 2 * scene.config.width + scene.config.width // 2) * rpp
    return centre // block * block, block


@contextlib.contextmanager
def _torch_shading():
    """Within it, forward bounces shade with the bounce kernel's plain
    version, called by name (``bounce.plain_shade_rows``) where
    ``wavefront.bounce_rows`` calls the wrapper: the torch shading, for the
    profile beside the kernel's."""
    from cuda_raytracer_tpu_torch.ops.kernels import bounce

    wrapper = bounce.shade_rows
    bounce.shade_rows = bounce.plain_shade_rows
    try:
        yield
    finally:
        bounce.shade_rows = wrapper


def phase_mesh_profile(full) -> None:
    """Where one pass block's time goes: the centre block of a 20-spp pass,
    10 bounces, under torch.profiler, through the fused1 regime with the
    bounce kernel and with the torch shading, and through cull + fused
    (device time by kernel, the packet kernels' time per bounce, device busy
    share of the wall time, device kernels)."""
    scene = full.with_config(rays_per_pixel=20)
    _profile_block(scene.with_config(packet_backend="fused1"), "fused1", FUSED1_KERNELS)
    with _torch_shading():
        _profile_block(scene.with_config(packet_backend="fused1"), "fused1 torch-shading",
                       FUSED1_KERNELS)
    _profile_block(scene.with_config(packet_backend="fused"), "fused",
                   ("cull_kernel", "fused_kernel"))


def _profiled(fn):
    """``fn()`` once under torch.profiler → (profile, wall ms, [(device ms,
    count, kernel name)] sorted by device time). Only device-side events
    count: an aten op's own row repeats the time of the kernels it
    launched, so a sum over every row would count those twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return prof, wall_ms, rows


def _profile_block(scene, backend: str, kernels, phase: str = "8") -> None:
    import torch
    from torch.autograd import DeviceType

    from cuda_raytracer_tpu_torch.render import packed, pipeline, wavefront

    rpp, seed = scene.config.rays_per_pixel, 80
    block_lo, block = _centre_block(scene, rpp)
    ids = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    bounds = packed.trace_live_bounds(
        scene, wavefront.make_initial_state(scene, ids, rpp, seed), seed,
        scene.config.bounces, True)
    framebuffer = torch.zeros((scene.num_pixels, 3), device=scene.device)

    def run():
        pipeline._render_block(scene, framebuffer, seed, block_lo, rpp, block,
                               scene.config.bounces, True)

    run()
    prof, wall_ms, rows = _profiled(run)
    busy_ms = sum(r[0] for r in rows)
    kernel_ms = sum(r[0] for r in rows if any(k in r[2] for k in kernels))
    bounce_ms = sum(r[0] for r in rows if "bounce_rows_kernel" in r[2])
    device_kernels = sum(r[1] for r in rows)
    print(f"phase {phase} profile: torus centre block packet_backend={backend} rays={block} "
          f"bounces={scene.config.bounces} live_bounds={bounds} wall_ms={wall_ms:.2f} "
          f"device_busy_ms={busy_ms:.2f} device_idle_share={1 - busy_ms / wall_ms:.3f} "
          f"packet_kernels_ms={kernel_ms:.3f} bounce_kernel_ms={bounce_ms:.3f} "
          f"device_ops_per_block={device_kernels} "
          f"device_ops_per_bounce={device_kernels / scene.config.bounces:.1f}")
    for dev_ms, count, key in rows[:8]:
        print(f"phase {phase} profile: {backend} top device time {dev_ms:.3f} ms x{count} "
              f"{key[:90]}")
    for name in kernels:
        per_launch = [e.time_range.elapsed_us() for e in prof.events()
                      if name in e.name and e.device_type != DeviceType.CPU]
        if per_launch:
            print(f"phase {phase} profile: {backend} {name} ms per bounce "
                  + " ".join(f"{us / 1e3:.3f}" for us in per_launch))


def phase_packet_timing(full) -> dict:
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import cull, fused, fused1
    from cuda_raytracer_tpu_torch.render import pipeline, wavefront

    rpp, seed = 20, 80
    scene = full.with_config(rays_per_pixel=rpp)
    block_lo, block = _centre_block(scene, rpp)
    ray_id = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    state0 = wavefront.make_initial_state(scene, ray_id, rpp, seed)
    state1 = _next_state(scene, state0, seed, 0)
    K, C, tile = scene.num_clusters, scene.cluster_tris, scene.config.packet_tile
    cmin, cmax = scene.cluster_min, scene.cluster_max
    aabb = cull.box_table(cmin, cmax)
    blocks = scene.cluster_blocks[:K].contiguous()
    sup = fused1.shard_supers(cmin, cmax, 16)
    real = (blocks[:, 9, :] >= 0).sum(dim=1)  # real (unpadded) triangles per cluster
    f4 = 4  # bytes per float32 / int32 word
    results = {}
    for bounce, state in ((0, state0), (1, state1)):
        od8 = _packet_rays(scene, state, tile)
        T = od8.shape[0]
        entry, mask = cull.cull_tiles(od8, aabb, with_mask=True)
        select = entry < cull.MISS_ENTRY * 0.5
        words = fused.pack_words(select)
        stats = torch.zeros(3, dtype=torch.int64, device=scene.device)
        stats1 = torch.zeros(3, dtype=torch.int64, device=scene.device)
        runs = {
            "cull_tiles": (lambda: cull.cull_tiles(od8, aabb, with_mask=True),
                           lambda: cull.plain_cull(od8, aabb, with_mask=True)),
            "fused_closest_hit": (
                lambda: fused.fused_closest_hit(od8, blocks, words, entry, mask),
                lambda: fused.plain_fused(od8, blocks, words)),
            "fused1_closest_hit": (
                lambda: fused1.fused1_closest_hit(od8, aabb, blocks, sup, 16),
                lambda: fused1.plain_fused1(od8, aabb, blocks)),
        }
        fused.fused_closest_hit(od8, blocks, words, entry, mask, stats=stats)
        fused1.fused1_closest_hit(od8, aabb, blocks, sup, 16, stats=stats1)
        live = int(torch.any(state.transmitted != 0.0, dim=-1).sum())
        live_tile = (od8[:, 6, :] >= 0).sum(dim=1)  # live rays per tile
        pairs = int(select.sum())
        # The Möller–Trumbore tests every culled pair needs (what the plain
        # version's sweep does, less dead rays and padding slots).
        pair_mts = int((select * live_tile[:, None] * real).sum())
        od8_bytes = od8.numel() * f4
        out_bytes = T * tile * 2 * f4
        box_bytes = BOX_ROWS * K * f4
        # The rows the sweep reads, once, of every cluster some tile selects.
        table_bytes = int(select.any(dim=0).sum()) * BLOCK_ROWS * C * f4
        work = {  # (slab tests, MT tests, bytes) the data needs and the kernel did
            "cull_tiles": (int(live_tile.sum()) * K, 0,
                           od8_bytes + box_bytes + (entry.numel() + mask.numel()) * f4),
            "fused_closest_hit": (0, int(stats[2]),
                                  od8_bytes + table_bytes + words.numel() * f4
                                  + (entry.numel() + mask.numel()) * f4 + out_bytes),
            "fused1_closest_hit": (int(stats1[0]), int(stats1[2]),
                                   od8_bytes + box_bytes + sup.numel() * f4
                                   + table_bytes + out_bytes),
        }
        ops = {"cull_tiles": (SLAB_OPS, 0), "fused_closest_hit": (0, MT_OPS),
               "fused1_closest_hit": FUSED1_OPS}  # per slab test, per MT test
        swept = {"cull_tiles": 0, "fused_closest_hit": int(stats[1]),
                 "fused1_closest_hit": int(stats1[1])}
        for name, (kernel, plain) in runs.items():
            ms = _cuda_ms(kernel)
            plain_ms = _plain_ms(plain)
            bad, err = _mismatch(kernel(), plain())
            slabs, mts, nbytes = work[name]
            ops_ms = (slabs * ops[name][0] + mts * ops[name][1]) / PEAK_FP32_FLOPS * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            print(f"phase 8 timing: torus block lo={block_lo} rays={block} bounce={bounce} "
                  f"live={live} {name} ms={ms:.3f} plain_ms={plain_ms:.1f} slab_tests={slabs} "
                  f"mt_tests={mts} swept_pairs={swept[name]} culled_pairs={pairs} "
                  f"culled_pair_mt_tests={pair_mts} "
                  f"ops_bound_ms={ops_ms:.4f} bytes_bound_ms={bytes_ms:.4f} "
                  f"bound_share={bound_ms / ms:.3f} full_shape_mismatched={bad} "
                  f"max_abs_err={err:.3g}")
            if bad:
                raise SystemExit(f"phase 8 failed: {name} differs from its plain version")
            results[(name, bounce)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, max_abs_err=err,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    # The kernel table reports the sorted bounced block (bounce 1): bounces
    # 1-9 of every pass are sorted bounced wavefronts.
    out = {name: results[(name, 1)] for name in runs}
    out["shade_rows"] = [_bounce_timing(scene, st, seed, b)
                           for b, st in ((0, state0), (1, state1))][1]
    out["fused_closest_hit"]["tail"] = _fused_tail(scene, ray_id, rpp, seed,
                                                   f"centre block lo={block_lo}", "8")
    out["fused1_closest_hit"].update(_fused1_tail(scene, 1, 16, "8",
                                                  out["fused_closest_hit"]["tail"]))
    return out


def _row_hits(scene, rows):
    """The set-up kernel's sphere hit and ray tiles of packed rows, and
    fused1's raw triangle hit on them: the bounce kernel's inputs."""
    from cuda_raytracer_tpu_torch.ops import packet_intersect
    from cuda_raytracer_tpu_torch.ops.kernels import rays

    alive, t, index, od8 = rays.rays_setup(rows, scene.sphere_center, scene.sphere_radius,
                                           scene.config.packet_tile)
    t_tri, tri = packet_intersect.packet_tiles(scene, od8, "fused1")
    return alive, t, index, od8, t_tri, tri


def _bounce_timing(scene, state, seed: int, b: int) -> dict:
    """8b: the bounce kernel on a block entering bounce ``b``, its state
    packed into rows as the forward trace holds it: its time (each call on a
    fresh copy of the rows, since it shades in place) and its plain
    version's, the bytes and operations this block needs, the bound, and
    agreement at that shape."""
    import torch
    from cuda_raytracer_tpu_torch.ops import envmap, packet_intersect, vecmath
    from cuda_raytracer_tpu_torch.ops.kernels import bounce
    from cuda_raytracer_tpu_torch.render import wavefront

    rows = wavefront.pack_rows(state)
    alive, t, index, _, t_tri, tri = _row_hits(scene, rows)
    n = rows.shape[0]
    copies = [rows.clone() for _ in range(24)]
    calls = iter(range(10 ** 9))

    def run():
        bounce.shade_rows(scene, copies[next(calls) % len(copies)], t, index, seed, b,
                          t_tri, tri)

    ms = _cuda_ms(run)

    def plain():
        bounce.plain_shade_rows(scene, rows.clone(), t, index, seed, b, t_tri, tri)

    plain_ms = _plain_ms(plain)
    got, want = rows.clone(), rows.clone()
    bounce.shade_rows(scene, got, t, index, seed, b, t_tri, tri)
    bounce.plain_shade_rows(scene, want, t, index, seed, b, t_tri, tri)
    agree, err, finite = _agreement(got[:, :12], want[:, :12])
    _, hit_index, _ = packet_intersect._finalize(scene, t_tri, tri, None, t, index, n, 1)
    hits = alive & (hit_index >= 0)
    misses = alive & (hit_index < 0)
    # Each table row this block reads, once: the hit primitives' normals and
    # material ids, their materials' rows, the texels the misses fetch.
    prims = torch.unique(hit_index[hits].long())
    mats = int(torch.unique(scene.material_index[prims]).numel())
    env = scene.environment_map
    H, W = env.shape[0], env.shape[1]
    if H * W == 1:
        texels = int(bool(misses.any()))
    else:
        uv = envmap.equal_area_sphere_to_square(
            envmap.rotate_to_map_space(rows[:, 3:6][misses]))
        tx = torch.clamp((vecmath.clamp01(uv[:, 0]) * (W - 1) + 0.5).long(), 0, W - 1)
        ty = torch.clamp((vecmath.clamp01(uv[:, 1]) * (H - 1) + 0.5).long(), 0, H - 1)
        texels = int(torch.unique(ty * W + tx).numel())
    n_hits, n_misses = int(hits.sum()), int(misses.sum())
    nbytes = ((n - n_hits - n_misses) * BOUNCE_DEAD_BYTES + n_hits * BOUNCE_HIT_BYTES
              + n_misses * BOUNCE_MISS_BYTES + int(prims.numel()) * 16 + mats * 48
              + texels * 12)
    ops_ms = (n_hits * SHADE_OPS + n_misses * ENV_OPS) / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"phase 8b bounce timing: torus block rays={n} bounce={b} live={int(alive.sum())} "
          f"hits={n_hits} misses={n_misses} bounce_ms={ms:.4f} plain_ms={plain_ms:.2f} "
          f"bytes={nbytes} bytes_bound_ms={bytes_ms:.4f} ops_bound_ms={ops_ms:.4f} "
          f"bound_share={bound_ms / ms:.3f} agree={agree:.6f} max_abs_err={err:.3g} "
          f"finite={finite}")
    if not finite or agree < AGREE_MIN:
        raise SystemExit(f"phase 8b failed: the bounce kernel at the full block, bounce {b}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, max_abs_err=err, agreement=agree,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def _traced_rows(scene, ids, rpp: int, seed: int):
    """One block traced as ``packed.trace_packed`` traces it (the live
    prefix, the Morton sort) → yields (bounce, the live prefix's packed rows)
    before each bounce; the caller must not change them."""
    import torch
    from cuda_raytracer_tpu_torch.render import wavefront

    cur = wavefront.pack_rows(wavefront.make_initial_state(scene, ids, rpp, seed))
    R = live_bound = cur.shape[0]
    schedule = wavefront.bounce_schedule(scene, R, scene.config.bounces, True)
    for b, do_sort in enumerate(schedule.sorted):
        n, _ = schedule.rows(b, live_bound)
        yield b, cur[:n]
        rows = cur[:n].clone()
        wavefront.bounce_rows(scene, rows, seed, b)
        if do_sort:
            order, live = wavefront.sort_order(scene, rows, n)
            cur = torch.cat([rows[order], cur[n:]])
            live_bound = int(live.item())
        else:
            cur = torch.cat([rows, cur[n:]])


def _bits(x):
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _bit_mismatch(got, want):
    """(elements whose bits differ, the largest |Δ| among them) between two
    tuples of tensors."""
    bad, worst = 0, 0.0
    for g, w in zip(got, want):
        differ = _bits(g) != _bits(w)
        bad += int(differ.sum())
        if differ.any():
            worst = max(worst, float((g.double() - w.double()).abs()[differ].max()))
    return bad, worst


def phase_row_kernels(full) -> dict:
    """6c: the forward trace's row kernels against their plain versions on
    the torus's centre 2^18-ray block of a 20-spp pass, traced as the packed
    trace traces it, entering bounces 0-9: the set-up kernel (alive bit,
    sphere hit, ray tiles), the sort keys and live count (argsort and count
    engines; the sorted permutation too), the PCG draws (a bounce's, and
    at bounce 0 the camera's) and the row move (``_reorder_checks``)
    bit-equal (0 mismatched bits), the live count
    of three back-to-back launches of each key kernel (Morton and cullhit)
    right with no reset between them, the packed
    bounce kernel against the torch shading at the shade gate; the camera
    kernel against its plain version on blocks of passes (``_camera_checks``).
    Then their times at bounce 1 (the draws on the train step's 131,072 ray
    ids; the camera kernel on the centre block; the row move after bounce
    0), each beside its bound and plain time."""
    import torch
    from cuda_raytracer_tpu_torch.ops import camera
    from cuda_raytracer_tpu_torch.ops.kernels import bounce, rays
    from cuda_raytracer_tpu_torch.render import wavefront

    rpp, seed = 20, 80
    scene = full.with_config(rays_per_pixel=rpp, packet_backend="fused1")
    tile = scene.config.packet_tile
    block_lo, block = _centre_block(scene, rpp)
    ids = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    worst, at1, at0 = 0.0, None, None
    errs = dict.fromkeys(("rays_setup", "ray_keys", "pcg_draws", "reorder_rows"), 0.0)
    for b, rows in _traced_rows(scene, ids, rpp, seed):
        n = rows.shape[0]
        checks = {"rays_setup": [], "ray_keys": [], "pcg_draws": []}
        moved = rows.clone()
        wavefront.bounce_rows(scene, moved, seed, b)
        order, _ = wavefront.sort_order(scene, moved, n)
        checks["reorder_rows"] = _reorder_checks(moved, order, rows)
        setup = rays.rays_setup(rows, scene.sphere_center, scene.sphere_radius, tile)
        checks["rays_setup"].append(_bit_mismatch(setup, rays.plain_rays_setup(
            rows, scene.sphere_center, scene.sphere_radius, tile)))
        for count in (False, True):
            got = rays.ray_keys(rows, scene.min_coord, scene.inv_extent, count, n)
            want = rays.plain_ray_keys(rows, scene.min_coord, scene.inv_extent, count, n)
            checks["ray_keys"] += [_bit_mismatch(got, want), _bit_mismatch(
                (torch.argsort(got[0], stable=True),), (torch.argsort(want[0], stable=True),))]
        # Three back-to-back launches of each key kernel, no reset between
        # them: each leaves its scratch zero for the next.
        lives = [rays.ray_keys(rows, scene.min_coord, scene.inv_extent, False, n)[1]
                 for _ in range(3)]
        lives += [rays.cullhit_keys(rows, scene.cluster_min, scene.cluster_max,
                                    scene.num_clusters, scene.config.cull_split, False, n)[1]
                  for _ in range(3)]
        want_live = int(rays.rows_alive(rows).sum())
        bad_live = sum(int(x) != want_live for x in lives)
        rid = rows[:, 12].contiguous().view(torch.int32)
        checks["pcg_draws"].append(_bit_mismatch((rays.bounce_draws(rid, seed, b),),
                                                 (rays.plain_bounce_draws(rid, seed, b),)))
        if b == 0:  # the camera's jitter, seeded as camera.initial_ray_seeds
            seeding = (rid, camera.RAY_SEED_MULT, camera._seed_add(seed), 2)
            checks["pcg_draws"].append(_bit_mismatch((rays.pcg_draws(*seeding),),
                                                     (rays.plain_pcg_draws(*seeding),)))
        for name, results in checks.items():
            errs[name] = max([errs[name]] + [err for _, err in results])
        bad_setup, bad_keys, bad_draws, bad_moves = (sum(bad for bad, _ in checks[name])
                                                     for name in checks)
        alive, t, index, _, t_tri, tri = _row_hits(scene, rows)
        got, want = rows.clone(), rows.clone()
        bounce.shade_rows(scene, got, t, index, seed, b, t_tri, tri)
        bounce.plain_shade_rows(scene, want, t, index, seed, b, t_tri, tri)
        agree, err, finite = _agreement(got[:, :12], want[:, :12])
        same_ids = torch.equal(got[:, 12:], rows[:, 12:])
        torch.cuda.synchronize()
        print(f"phase 6c row kernels: torus centre block lo={block_lo} bounce={b} rays={n} "
              f"live={int(alive.sum())} rays_setup_mismatched={bad_setup} "
              f"ray_keys_mismatched={bad_keys} pcg_draws_mismatched={bad_draws} "
              f"reorder_rows_mismatched={bad_moves} "
              f"back_to_back_live_counts={json.dumps([int(x) for x in lives])} "
              f"max_abs_err={json.dumps({k: errs[k] for k in checks})} "
              f"bounce_agree={agree:.6f} bounce_max_abs_err={err:.3g} finite={finite} "
              f"id_columns_untouched={same_ids}")
        if (bad_setup or bad_keys or bad_draws or bad_moves or bad_live
                or not (finite and same_ids) or agree < AGREE_MIN):
            raise SystemExit(f"phase 6c failed: a row kernel differs from its plain version "
                             f"(bounce {b})")
        worst = max(worst, err)
        if b == 0:
            at0 = moved, order
        if b == 1:
            at1 = rows.clone()
    out = _row_timing(scene, at1)
    out["reorder_rows"] = _reorder_timing(*at0)
    for name, err in errs.items():
        out[name]["max_abs_err"] = err
    out["bounce_max_abs_err"] = worst
    out["camera_rows"] = _camera_timing(scene, block_lo, block, rpp, seed)
    out["camera_rows"]["max_abs_err"] = _camera_checks(scene)
    return out


def _reorder_checks(moved, order, other) -> list:
    """6c: the row move against its plain version (index_select and the
    slice copy) → [(mismatched elements, largest |Δ| among them)]: the
    bounced prefix ``moved`` gathered by its sort ``order`` (int64 and
    int32), with no settled suffix and with one of ``other``'s rows (all
    but 3), into a buffer 5 rows longer whose rows past the settled ones
    must keep their bits."""
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import rays

    n = moved.shape[0]
    cur = torch.cat([moved, other.flip(0)])
    results = []
    for index in (order, order.to(torch.int32)):
        for settled in (n, max(n, 2 * n - 3)):
            spare = torch.full((2 * n + 5, rays.ROW_WORDS), -7.0, device=moved.device)
            got = rays.reorder_rows(cur, index, n, settled, spare.clone())
            want = rays.plain_reorder_rows(cur, index, n, settled, spare.clone())
            results.append(_bit_mismatch((got,), (want,)))
    return results


def _kernel_shapes(fn) -> list:
    """``fn()`` once under torch.profiler → [(device kernel name, grid,
    block)] from the exported trace's kernel events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    return [(e["name"], e.get("args", {}).get("grid"), e.get("args", {}).get("block"))
            for e in events if e.get("cat") == "kernel"]


def _reorder_timing(moved, order) -> dict:
    """6c: the row move after bounce 0 of the centre block (every row
    sorted, no suffix): its time on rows out of L2 (``_cold_copies``), as
    ``ms``, and on rows in it (``warm_ms``: the bounce kernel has just
    written them on the path), with an int32 permutation too; beside it
    torch.index_select on the same rows (``library_ms``, also its plain
    version's call) both ways; the bytes it needs (64 read and 64 written
    a row, 8 of int64 permutation) and its bound; and the grid and block
    of each one's device kernel under the profiler."""
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import rays

    n = moved.shape[0]
    cold = _cold_copies(moved)
    order32 = order.to(torch.int32)
    spare = torch.empty_like(moved)
    kernel = lambda rows, index: rays.reorder_rows(rows, index, n, n, spare)
    library = lambda rows: torch.index_select(rows, 0, order, out=spare)
    ms = _cuda_ms(lambda: kernel(cold(), order))
    warm_ms = _cuda_ms(lambda: kernel(moved, order))
    int32_ms = _cuda_ms(lambda: kernel(cold(), order32))
    library_ms = _cuda_ms(lambda: library(cold()))
    library_warm_ms = _cuda_ms(lambda: library(moved))
    plain_ms = _plain_ms(lambda: rays.plain_reorder_rows(moved, order, n, n, spare))
    nbytes = n * (2 * rays.ROW_WORDS * 4 + 8)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    shapes = {"kernel": _kernel_shapes(lambda: kernel(moved, order)),
              "library": _kernel_shapes(lambda: library(moved))}
    print(f"phase 6c timing: reorder_rows rows={n} ms={ms:.4f} warm_ms={warm_ms:.4f} "
          f"int32_ms={int32_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"library_warm_ms={library_warm_ms:.4f} bytes={nbytes} bytes_bound_ms={bound_ms:.4f} "
          f"bound_share={bound_ms / ms:.3f} warm_bound_share={bound_ms / warm_ms:.3f} "
          f"library_bound_share={bound_ms / library_ms:.3f}")
    for label, found in shapes.items():
        for name, grid, block in found:
            print(f"phase 6c reorder launch shape: {label} {name[:80]} grid={grid} "
                  f"block={block}")
    return dict(ms=ms, warm_ms=warm_ms, int32_ms=int32_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_warm_ms=library_warm_ms, bound_ms=bound_ms,
                bound_by="bytes", launch_shapes=shapes)


def _camera_checks(scene) -> float:
    """6c: the camera kernel against its plain version run on the card, 0
    mismatched bits, at 20 and 8 rays a pixel and pass seeds 80 and 2^31 +
    80, on the first, centre and last (short) blocks of a pass and on the
    first block of rank 1 of 2 (a first ray no multiple of the block) →
    the largest |Δ| among mismatched bits (0.0)."""
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import rays
    from cuda_raytracer_tpu_torch.render import pipeline

    words = rays.camera_words(scene.camera)
    width, worst = scene.config.width, 0.0
    for rpp in (20, 8):
        block = (pipeline.RAY_BLOCK // rpp) * rpp
        total = scene.num_pixels * rpp
        starts = {"first": 0, "centre": _centre_block(scene, rpp)[0],
                  "last": (total - 1) // block * block,
                  "rank1of2": scene.num_pixels // 2 * rpp}
        for seed in (80, 2 ** 31 + 80):
            for label, lo in starts.items():
                n = min(block, total - lo)
                got = rays.camera_rows(words, lo, n, rpp, width, seed)
                want = rays.plain_camera_rows(words, lo, n, rpp, width, seed)
                bad, err = _bit_mismatch((got,), (want,))
                finite = bool(torch.isfinite(got[:, :12]).all()) and bool(
                    torch.isfinite(got[:, 13:]).all())  # all but the ray id's bits
                print(f"phase 6c camera rows: {label} block lo={lo} rays={n} rpp={rpp} "
                      f"seed={seed} lo_mod_block={lo % block} camera_rows_mismatched={bad} "
                      f"max_abs_err={err:.3g} finite={finite}")
                if bad or not finite:
                    raise SystemExit(f"phase 6c failed: camera_rows differs from its plain "
                                     f"version ({label} block, rpp {rpp}, seed {seed})")
                worst = max(worst, err)
    return worst


def _old_camera_rows(scene, block_lo: int, block: int, rpp: int, seed: int):
    """A block's starting rows as the pass loop made them before the camera
    kernel: the ids (arange + add), ``make_initial_state`` (the PCG draw
    kernel, then the jitter, direction and weights in torch) and
    ``pack_rows``."""
    import torch
    from cuda_raytracer_tpu_torch.render import wavefront

    ids = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    return wavefront.pack_rows(wavefront.make_initial_state(scene, ids, rpp, seed))


def _host_ms(fn, runs: int = 20) -> float:
    """Median host milliseconds to enqueue one call of ``fn`` (the device
    idle after each, so no call waits for room in the launch queue)."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _camera_timing(scene, block_lo: int, block: int, rpp: int, seed: int) -> dict:
    """6c: the camera kernel on the centre block: its time, its bound (64
    bytes written a row; CAMERA_OPS a ray), the sequence it replaced (its
    wall time between events, its device operations and device time under
    the profiler, its host time to enqueue) beside the kernel's, the plain
    version's time (the torch PCG) and torch.cat of the rows' columns (the
    packing only, the one call that does part of its work)."""
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import rays
    from cuda_raytracer_tpu_torch.render import wavefront

    words = rays.camera_words(scene.camera)
    width = scene.config.width
    kernel = lambda: rays.camera_rows(words, block_lo, block, rpp, width, seed)
    old = lambda: _old_camera_rows(scene, block_lo, block, rpp, seed)
    state = wavefront.unpack_rows(old())
    cols = [state.origin.contiguous(), state.direction.contiguous(),
            state.transmitted.contiguous(), state.collected.contiguous(),
            state.ray_id.view(torch.float32)[:, None],
            torch.zeros((block, 3), dtype=torch.float32, device=scene.device)]
    ms = _cuda_ms(kernel)
    old_ms = _plain_ms(old)
    plain_ms = _plain_ms(lambda: rays.plain_camera_rows(words, block_lo, block, rpp, width,
                                                        seed))
    library_ms = _cuda_ms(lambda: torch.cat(cols, dim=1))
    _, old_wall_ms, old_rows = _profiled(old)
    _, kernel_wall_ms, kernel_rows = _profiled(kernel)
    old_host_ms, kernel_host_ms = _host_ms(old), _host_ms(kernel)
    nbytes = block * 64 + rays.CAMERA_WORDS * 4
    ops_ms = block * CAMERA_OPS / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    old_ops, old_busy = sum(r[1] for r in old_rows), sum(r[0] for r in old_rows)
    kernel_ops, kernel_busy = sum(r[1] for r in kernel_rows), sum(r[0] for r in kernel_rows)
    print(f"phase 6c timing: camera_rows rays={block} ms={ms:.4f} plain_ms={old_ms:.3f} "
          f"plain_torch_pcg_ms={plain_ms:.3f} library_ms={library_ms:.4f} bytes={nbytes} "
          f"bytes_bound_ms={bytes_ms:.4f} ops_bound_ms={ops_ms:.4f} "
          f"bound_share={bound_ms / ms:.3f}")
    print(f"phase 6c camera rows vs the sequence it replaced: centre block rays={block} "
          f"old_device_ops={old_ops} old_device_busy_ms={old_busy:.4f} "
          f"old_profiled_wall_ms={old_wall_ms:.3f} old_host_enqueue_ms={old_host_ms:.4f} "
          f"kernel_device_ops={kernel_ops} kernel_device_busy_ms={kernel_busy:.4f} "
          f"kernel_profiled_wall_ms={kernel_wall_ms:.3f} "
          f"kernel_host_enqueue_ms={kernel_host_ms:.4f}")
    for dev_ms, count, key in old_rows:
        print(f"phase 6c camera rows: old sequence device time {dev_ms:.4f} ms x{count} "
              f"{key[:80]}")
    return dict(ms=ms, plain_ms=old_ms, plain_torch_pcg_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                old_device_ops=old_ops, old_device_busy_ms=old_busy,
                old_host_enqueue_ms=old_host_ms, host_enqueue_ms=kernel_host_ms)


def _cold_copies(rows):
    """A function returning the next of four copies of ``rows`` in turn:
    four being more than the 50 MB L2 holds, a kernel timed on them reads
    its rows from device memory as a bounce's would (its rows were written
    a bounce ago, with megabytes of tables read since)."""
    copies = [rows.clone() for _ in range(4)]
    calls = iter(range(10 ** 9))
    return lambda: copies[next(calls) % len(copies)]


def _row_timing(scene, rows) -> dict:
    """6c: the set-up and key kernels on the centre block's sorted bounce-1
    rows, and the draw kernel on the train step's ray ids (a bounce's five
    draws, as the training shading draws them): each kernel's time
    and its plain version's, the bytes and operations it needs, its bound;
    for the set-up kernel, torch.stack of its ray tiles' rows too (the one
    call that does part of its work: the packing)."""
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import rays

    n, tile = rows.shape[0], scene.config.packet_tile
    n_pad = -(-n // tile) * tile
    cold = _cold_copies(rows)
    spheres = scene.sphere_center.shape[0]
    live = int(rays.rows_alive(rows).sum())
    train_ids = torch.arange(TRAIN["width"] * TRAIN["height"] * TRAIN["rays_per_pixel"],
                             dtype=torch.int32, device=scene.device)
    comps = [rows[:, c] for c in range(6)] + [rows[:, 6], torch.zeros_like(rows[:, 6])]
    cases = {
        # (kernel, plain, bytes, FP32 operations, library call)
        "rays_setup": (
            lambda: rays.rays_setup(cold(), scene.sphere_center, scene.sphere_radius, tile),
            lambda: rays.plain_rays_setup(rows, scene.sphere_center, scene.sphere_radius, tile),
            n * ROW_STATE_BYTES + n * (1 + 4 + 4) + n_pad * 8 * 4 + spheres * 16,
            n * spheres * SPHERE_OPS,
            lambda: torch.stack([c.reshape(-1, tile) for c in
                                 (x[:n // tile * tile] for x in comps)], dim=1)),
        "ray_keys": (
            lambda: rays.ray_keys(cold(), scene.min_coord, scene.inv_extent, False, n),
            lambda: rays.plain_ray_keys(rows, scene.min_coord, scene.inv_extent, False, n),
            n * ROW_STATE_BYTES + n * 8 + 4, live * KEY_OPS, None),
        "pcg_draws": (
            lambda: rays.bounce_draws(train_ids, TRAIN_SEED, 1),
            lambda: rays.plain_bounce_draws(train_ids, TRAIN_SEED, 1),
            train_ids.numel() * (4 + 5 * 8), 0, None),
    }
    out = {}
    for name, (kernel, plain, nbytes, ops, library) in cases.items():
        ms = _cuda_ms(kernel)
        plain_ms = _plain_ms(plain)
        library_ms = _cuda_ms(library) if library else None
        ops_ms = ops / PEAK_FP32_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        rays_n = train_ids.numel() if name == "pcg_draws" else n
        print(f"phase 6c timing: {name} rays={rays_n} ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"library_ms={library_ms if library_ms is None else round(library_ms, 4)} "
              f"bytes={nbytes} bytes_bound_ms={bytes_ms:.4f} ops_bound_ms={ops_ms:.4f} "
              f"bound_share={bound_ms / ms:.3f}")
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    return out


def _traced_od8(scene, ids, rpp: int, seed: int, first: int = 0):
    """The ray tiles one block's closest hit gets at each bounce, the block
    traced as a render traces it (``_traced_rows``) → yields (bounce, rays,
    od8) for bounces ``first``.. of the scene's."""
    from cuda_raytracer_tpu_torch.render import wavefront

    for b, rows in _traced_rows(scene, ids, rpp, seed):
        if b >= first:
            yield b, rows.shape[0], _packet_rays(scene, wavefront.unpack_rows(rows),
                                                 scene.config.packet_tile)


def _fused1_tail(scene, pack: int, gate: int, phase: str, yard: list) -> dict:
    """The centre block of a 20-spp pass traced as a render traces it (the
    live prefix, the Morton sort): fused1 on the ray tiles entering bounces
    0-9, one block per tile (S = 1) and at split_plan's split, both
    bit-equal to plain_fused1; each timed (_cuda_ms), with the S = 1
    counters' bound, its share of the chosen split's time and the split's
    own counters; beside it ``yard``'s times on the same rays (phase 8's
    ``_fused_tail`` rows: the cull + fused engine, the pair sweep, and for
    pack 2 the pack-1 kernel over the unpacked table)."""
    import torch
    from cuda_raytracer_tpu_torch.ops import packet_intersect
    from cuda_raytracer_tpu_torch.ops.kernels import fused1

    rpp, seed = 20, 80
    scene = scene.with_config(rays_per_pixel=rpp)
    block_lo, block = _centre_block(scene, rpp)
    ids = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    K = scene.num_clusters
    aabb = packet_intersect.box_table(scene)
    sup = packet_intersect.super_table(scene, gate)
    blocks = scene.cluster_blocks[:K // pack].contiguous()
    same_rays = {r["bounce"]: r for r in yard}
    rows = []
    for b, n, od8 in _traced_od8(scene, ids, rpp, seed):
        T = od8.shape[0]
        splits = fused1.split_plan(T, K, gate)[0]
        ref = fused1.plain_fused1(od8, aabb, blocks, pack=pack)
        stats = {s_: torch.zeros(3, dtype=torch.int64, device=scene.device)
                 for s_ in (1, splits)}
        bad, ms = 0, {}
        for s_ in stats:
            run = (lambda s_=s_: fused1.fused1_closest_hit(od8, aabb, blocks, sup, gate,
                                                           pack=pack, splits=s_))
            bad += _mismatch(fused1.fused1_closest_hit(
                od8, aabb, blocks, sup, gate, stats=stats[s_], pack=pack, splits=s_),
                ref)[0]
            ms[s_] = _cuda_ms(run)
        s1 = stats[1]
        ops_ms = (int(s1[0]) * FUSED1_OPS[0] + int(s1[2]) * FUSED1_OPS[1]) / PEAK_FP32_FLOPS * 1e3
        live = int((od8[:, 6, :] >= 0).sum())
        live_tiles = int((od8[:, 6, :] >= 0).any(dim=1).sum())
        y = same_rays[b]
        beside = (f"cull_plus_fused_ms={y['cull_ms'] + y['ms_chosen']:.4f} "
                  f"sweep_ms={y['sweep_ms']:.4f}")
        if "fused1_ms" in y:
            beside += f" pack1_ms={y['fused1_ms']:.4f}"
        print(f"phase {phase} fused1 tail: pack={pack} bounce={b} rays={n} tiles={T} "
              f"live={live} live_tiles={live_tiles} splits={splits} "
              f"ms_split1={ms[1]:.4f} ms_split{splits}={ms[splits]:.4f} "
              f"ops_bound_ms={ops_ms:.4f} bound_share={ops_ms / ms[splits]:.3f} | same rays: "
              f"{beside} | counters_split1={s1.tolist()} "
              f"counters_split{splits}={stats[splits].tolist()} mismatched={bad}")
        if bad:
            raise SystemExit(f"phase {phase} failed: fused1 pack {pack} differs from its "
                             f"plain version at bounce {b}")
        rows.append(dict(bounce=b, tiles=T, splits=splits, ms_split1=ms[1],
                         ms_chosen=ms[splits], bound_ms=ops_ms))
    return dict(tail=rows)


def _fused_tail(scene, ids, rpp: int, seed: int, label: str, phase: str) -> list:
    """One block traced as a render traces it: at each of its bounces, the
    cull + fused engine's inputs (the cull's entries, hit bits and selection
    words; the cull held to plain_cull, 0 mismatched elements, and timed
    beside its bound), and the fused kernel with its skip test at one block per tile
    (S = 1) and at split_plan's split, both bit-equal to plain_fused (0
    mismatched elements); each timed (_cuda_ms), with the S = 1 counters'
    bound and the split's counters beside it."""
    import torch
    from cuda_raytracer_tpu_torch.ops import packet_intersect
    from cuda_raytracer_tpu_torch.ops.kernels import cull, fused, fused1, sweep

    K = scene.num_clusters
    aabb = packet_intersect.box_table(scene)
    blocks = scene.cluster_blocks[:K].contiguous()
    rows = []
    for b, n, od8 in _traced_od8(scene, ids, rpp, seed):
        T = od8.shape[0]
        entry, mask = cull.cull_tiles(od8, aabb, with_mask=True)
        cull_bad = _mismatch((entry, mask), cull.plain_cull(od8, aabb, with_mask=True))[0]
        cull_ms = _cuda_ms(lambda: cull.cull_tiles(od8, aabb, with_mask=True))
        cull_bound = int((od8[:, 6, :] >= 0).sum()) * K * SLAB_OPS / PEAK_FP32_FLOPS * 1e3
        print(f"phase {phase} cull: {label} bounce={b} rays={n} tiles={T} cull_ms={cull_ms:.4f} "
              f"ops_bound_ms={cull_bound:.4f} bound_share={cull_bound / cull_ms:.3f} "
              f"mismatched={cull_bad}")
        if cull_bad:
            raise SystemExit(f"phase {phase} failed: the cull differs from its plain version "
                             f"({label}, bounce {b})")
        words = fused.pack_words(entry < packet_intersect.HIT_THRESH)
        ref = fused.plain_fused(od8, blocks, words)
        splits = fused1.split_plan(T, K, unit=fused.SPLIT_UNIT)[0]
        stats = {s_: torch.zeros(3, dtype=torch.int64, device=scene.device)
                 for s_ in (1, splits)}
        bad, ms = 0, {}
        for s_ in stats:
            bad += _mismatch(fused.fused_closest_hit(od8, blocks, words, entry, mask,
                                                     stats=stats[s_], splits=s_), ref)[0]
            ms[s_] = _cuda_ms(lambda s_=s_: fused.fused_closest_hit(
                od8, blocks, words, entry, mask, splits=s_))
        s1 = stats[1]
        ops_ms = int(s1[2]) * MT_OPS / PEAK_FP32_FLOPS * 1e3
        live_tiles = int((od8[:, 6, :] >= 0).any(dim=1).sum())
        # The pair sweep over the same culled pairs (no window: timed only).
        select = entry < packet_intersect.HIT_THRESH
        pairs, total, _ = packet_intersect.extract_pairs(select, max(1, int(select.sum())))
        tile = od8.shape[2]
        rays_tiles = sweep.make_rays_tiles(od8[:, 0:3].permute(0, 2, 1).reshape(-1, 3),
                                           od8[:, 3:6].permute(0, 2, 1).reshape(-1, 3), tile)
        sweep_ms = _cuda_ms(lambda: sweep.sweep_pairs(rays_tiles, blocks, pairs, total, tile))
        print(f"phase {phase} fused tail: {label} bounce={b} rays={n} tiles={T} "
              f"live={int((od8[:, 6, :] >= 0).sum())} live_tiles={live_tiles} "
              f"selected_pairs={int((entry < packet_intersect.HIT_THRESH).sum())} "
              f"splits={splits} ms_split1={ms[1]:.4f} ms_split{splits}={ms[splits]:.4f} "
              f"ops_bound_ms={ops_ms:.4f} counters_split1={s1.tolist()} "
              f"counters_split{splits}={stats[splits].tolist()} mismatched={bad} "
              f"sweep_same_pairs_ms={sweep_ms:.4f}")
        if bad:
            raise SystemExit(f"phase {phase} failed: fused differs from its plain version "
                             f"({label}, bounce {b})")
        rows.append(dict(bounce=b, tiles=T, splits=splits, ms_split1=ms[1],
                         ms_chosen=ms[splits], bound_ms=ops_ms, cull_ms=cull_ms,
                         cull_bound_ms=cull_bound, sweep_ms=sweep_ms))
    return rows


def _auto_kernels(scene) -> tuple:
    """The closest-hit kernels a render of ``scene`` launches on the card
    with packet backend "auto": the walk where its intersector resolves to
    the BVH, else those of its passes' regime (``pipeline._regime_scene``;
    every pass of a render at up to 20 or at a multiple of 20 rays per
    pixel is in one regime)."""
    from cuda_raytracer_tpu_torch.render import pipeline, wavefront

    if wavefront.resolved_intersector(scene) == "bvh":
        return ("bvh_walk",)
    cfg = scene.config
    rpp = min(cfg.rays_per_pixel, cfg.max_rays_per_pixel_per_pass)
    regime = pipeline._regime_scene(scene, rpp).config.packet_backend
    return ("fused1_closest_hit",) if regime == "fused1" else AUTO_KERNELS


def _launch_counts() -> dict:
    from cuda_raytracer_tpu_torch.ops.kernels import counts

    return counts.launch_counts()


def _zero_launch_counts() -> None:
    from cuda_raytracer_tpu_torch.ops.kernels import counts

    counts.zero_launch_counts()


def _write_scenes(workdir: Path) -> dict:
    """The full-size torus and the Cornell scene as ``.scene`` files. The
    torus names a sky map that is not there, which gives it the substitute
    sky the mesh scenes get everywhere in this repository."""
    from cuda_raytracer_tpu_torch.models import builtin_scenes

    paths = {"torus": workdir / "torus.scene", "cornell": workdir / "cornell.scene"}
    paths["torus"].write_text(builtin_scenes.torus() + "sky_map envmap.pfm\n")
    paths["cornell"].write_text(builtin_scenes.CORNELL)
    return paths


def _subprocess_env() -> dict:
    """The environment of a ``python -m cuda_raytracer_tpu_torch`` child:
    this checkout first on its path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def phase_cli_subprocess(scenes: dict, workdir: Path) -> bytes:
    """9a: the real entry point, as a user runs it."""
    out = workdir / "gated.png"
    cmd = [sys.executable, "-m", "cuda_raytracer_tpu_torch", str(scenes["torus"]),
           "--spp", str(CLI_SPP), "--metrics", "--out", str(out)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=workdir, env=_subprocess_env(), capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - start
    metrics = [ln for ln in proc.stderr.splitlines() if ln.startswith("{")]
    print(f"phase 9a cli: python -m cuda_raytracer_tpu_torch torus.scene --spp {CLI_SPP} "
          f"--metrics rc={proc.returncode} wall_seconds={wall:.2f}")
    if proc.returncode != 0 or not out.exists() or "paths/s" not in proc.stderr or not metrics:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit("phase 9a failed: the CLI did not render the torus")
    m = json.loads(metrics[-1])
    phases = m["phases"]
    launched = {k: m["counters"].get(f"launches_{k}", 0) for k in CLI_KERNELS}
    print(f"phase 9a cli: load_scene_seconds={phases['load_scene']:.3f} (native BVH) "
          f"render_seconds={phases['render_accelerator']:.4f} "
          f"paths_per_s={m['counters']['paths_per_s_accelerator']:.6g} "
          f"post_seconds={phases['post_accelerator']:.4f} launches={json.dumps(launched)}")
    print(f"phase 9a cli metrics: {metrics[-1]}")
    if not all(launched.values()):
        raise SystemExit("phase 9a failed: the CLI render did not launch its kernels")
    return dict(png=out.read_bytes(), wall=wall, render=phases["render_accelerator"])


def phase_cli_in_process(scenes: dict, workdir: Path, subprocess_png: bytes) -> None:
    """9b: ``cli.main`` in this process with ``--cull-hier 16``, its launch
    counts set to 0 just before and read just after: "auto" walks the BVH
    on the card, so the walk and the forward kernels launch and no other
    kernel, stderr warns that the packet option has no effect, and the PNG
    equals phase 9a's byte for byte (9c drives the gated cull)."""
    import contextlib
    import io

    from cuda_raytracer_tpu_torch import cli

    out = workdir / "inproc.png"
    argv = [str(scenes["torus"]), "--spp", str(CLI_SPP), "--cull-hier", str(CLI_GATE),
            "--metrics", "--out", str(out)]
    err = io.StringIO()
    _zero_launch_counts()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    counts = _launch_counts()
    if rc != 0:
        print(err.getvalue()[-4000:], file=sys.stderr)
        raise SystemExit(f"phase 9b failed: cli.main returned {rc}")
    lines = err.getvalue().splitlines()
    m = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    warned = any(ln.startswith("Warning: --cull-hier") and "'bvh' on cuda" in ln
                 for ln in lines)
    launched = all(counts[k] > 0 for k in CLI_KERNELS) and not any(
        v for k, v in counts.items() if k not in CLI_KERNELS)
    same_sub = out.read_bytes() == subprocess_png
    print(f"phase 9b cli.main: torus spp={CLI_SPP} --cull-hier {CLI_GATE} rc={rc} "
          f"load_scene_seconds={m['phases']['load_scene']:.3f} "
          f"render_seconds={m['phases']['render_accelerator']:.4f} warned={warned} "
          f"identical_to_subprocess={same_sub} launches={json.dumps(counts)}")
    if not (launched and warned and same_sub):
        raise SystemExit("phase 9b failed: launches, warning or PNG bytes")


def phase_gated_render(full) -> int:
    """9c, the main path of the gated cull kernel: the torus at 1000×1000
    and 8 spp through cull + fused (``packet_backend="fused"``) with
    ``cull_hier=16`` and with the flat cull, in turns (gated, flat, flat,
    gated): the gated cull launches in every gated render and the flat cull
    in none (the super boxes are tested inside the gated kernel), the flat
    cull in every flat render and the gated one in none, every image
    identical → the first gated render's launches."""
    import numpy as np

    images, seconds, launches = [], {"gated": [], "flat": []}, []
    for turn, label in enumerate(("gated", "flat", "flat", "gated")):
        scene = full.with_config(rays_per_pixel=CLI_SPP, packet_backend="fused",
                                 cull_hier=CLI_GATE if label == "gated" else 0)
        _zero_launch_counts()
        _, image, secs = _timed_framebuffer(scene)
        counts = _launch_counts()
        images.append(image)
        seconds[label].append(secs)
        launches.append(counts["cull_gated"])
        print(f"phase 9c gated render: torus spp={CLI_SPP} turn={turn} {label} "
              f"seconds={secs:.4f} launches={json.dumps(counts)}")
        expected = GATED_KERNELS if label == "gated" else FLAT_KERNELS
        if not (all(counts[k] > 0 for k in expected)
                and not any(v for k, v in counts.items() if k not in expected)):
            raise SystemExit(f"phase 9c failed: launches of the {label} render")
    same = all(np.array_equal(img, images[0]) for img in images)
    print(f"phase 9c gated render: seconds gated={seconds['gated']} flat={seconds['flat']} "
          f"images_identical={same}")
    if not same:
        raise SystemExit("phase 9c failed: the gated and flat images differ")
    return launches[0]


def phase_gated_cull(full) -> dict:
    """9c: the hierarchical cull in one launch (``cull.cull_tiles_hier``, the
    gates computed in the kernel from the super boxes) against the flat cull
    and against the plain gated cull behind the super-box pre-pass
    (``plain_cull_gated`` of ``hier_gates``' words), the gate-word form
    (``cull_tiles_gated``) against its plain version, their times beside the
    two-step path (pre-pass + gate-word kernel) and the flat cull, and the
    centre block's profile through cull + fused with ``cull_hier=16``."""
    import torch
    from cuda_raytracer_tpu_torch.ops import packet_intersect
    from cuda_raytracer_tpu_torch.ops.kernels import cull
    from cuda_raytracer_tpu_torch.render import wavefront

    rpp, seed = 20, 80
    scene = full.with_config(rays_per_pixel=rpp)
    block_lo, block = _centre_block(scene, rpp)
    ray_id = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    tile = scene.config.packet_tile
    aabb_p, sup_aabb = packet_intersect.hier_tables(scene.cluster_min, scene.cluster_max,
                                                    CLI_GATE)
    Kp, n_sup = aabb_p.shape[1], sup_aabb.shape[1]
    n_chunks = Kp // cull.GATE_CHUNK
    aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
    K = aabb.shape[1]
    f4 = 4
    state = wavefront.make_initial_state(scene, ray_id, rpp, seed)
    worst, result = 0.0, None
    for bounce in range(4):
        for n in (block - 37, block):
            cut = wavefront.RayState(*(leaf[:n] for leaf in state))
            od8 = _packet_rays(scene, cut, tile)
            gates = packet_intersect.hier_gates(od8, sup_aabb, n_chunks)
            bad = {"one_launch": 0, "gate_words": 0, "vs_flat": 0}
            err = 0.0
            for with_mask in (False, True):
                want = cull.plain_cull_gated(od8, aabb_p, gates, with_mask=with_mask)
                flat = cull.cull_tiles(od8, aabb, with_mask=with_mask)
                one = cull.cull_tiles_hier(od8, aabb_p, sup_aabb, with_mask=with_mask)
                words = cull.cull_tiles_gated(od8, aabb_p, gates, with_mask=with_mask)
                want, flat, one, words = ((x if with_mask else (x,))
                                          for x in (want, flat, one, words))
                torch.cuda.synchronize()
                for label, got in (("one_launch", one), ("gate_words", words)):
                    b, e = _mismatch(got, want)
                    bad[label] += b
                    err = max(err, e)
                bad["vs_flat"] += _mismatch((one[0][:, :K],) + tuple(m[:, :, :K] for m in one[1:]),
                                            flat)[0]
            live_chunks = int(cull.unpack_gates(gates, od8.shape[0], n_chunks).sum())
            print(f"phase 9c gated vs plain: torus block lo={block_lo} bounce={bounce} "
                  f"rays={n} tiles={od8.shape[0]} gated_on_chunks={live_chunks} of "
                  f"{od8.shape[0] * n_chunks} mismatched={json.dumps(bad)} "
                  f"max_abs_err={err:.3g}")
            if any(bad.values()):
                raise SystemExit(f"phase 9c failed: the gated cull differs from its plain "
                                 f"version or the flat cull (bounce {bounce}, {n} rays)")
            worst = max(worst, err)
        if bounce <= 1:
            od8 = _packet_rays(scene, state, tile)
            T = od8.shape[0]
            gates = packet_intersect.hier_gates(od8, sup_aabb, n_chunks)
            on = cull.unpack_gates(gates, T, n_chunks)
            live_tile = (od8[:, 6, :] >= 0).sum(dim=1)
            gated_slabs = int((on.sum(dim=1) * live_tile).sum()) * cull.GATE_CHUNK
            super_slabs = int(live_tile.sum()) * n_sup
            flat_slabs = int(live_tile.sum()) * K
            W = -(-tile // 32)
            ms = _cuda_ms(lambda: cull.cull_tiles_hier(od8, aabb_p, sup_aabb, with_mask=True))
            kernel_ms = _cuda_ms(lambda: cull.cull_tiles_gated(od8, aabb_p, gates, True))
            prepass_ms = _cuda_ms(lambda: packet_intersect.hier_gates(od8, sup_aabb, n_chunks))
            flat_ms = _cuda_ms(lambda: cull.cull_tiles(od8, aabb, with_mask=True))
            plain_ms = _plain_ms(
                lambda: cull.plain_cull_hier(od8, aabb_p, sup_aabb, with_mask=True))
            # The slab tests this run's gates need: every live ray against the
            # supers, and against the 128 boxes of each chunk gated on.
            ops_ms = ((gated_slabs * SLAB_OPS + super_slabs * SUPER_SLAB_OPS)
                      / PEAK_FP32_FLOPS * 1e3)
            nbytes = (od8.numel() + BOX_ROWS * (Kp + n_sup) + T * Kp * (1 + W)) * f4
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            flat_bound_ms = flat_slabs * SLAB_OPS / PEAK_FP32_FLOPS * 1e3
            print(f"phase 9c timing: torus block lo={block_lo} rays={block} bounce={bounce} "
                  f"hier_cull_ms={ms:.4f} (one launch; bound_ms={bound_ms:.4f} "
                  f"bound_by={'operations' if ops_ms >= bytes_ms else 'bytes'} "
                  f"share={bound_ms / ms:.3f}) two_step_ms={kernel_ms + prepass_ms:.4f} "
                  f"(gate_words_kernel_ms={kernel_ms:.4f} prepass_ms={prepass_ms:.4f}) "
                  f"flat_cull_ms={flat_ms:.4f} (bound_ms={flat_bound_ms:.4f} "
                  f"share={flat_bound_ms / flat_ms:.3f}) plain_hier_ms={plain_ms:.1f} "
                  f"gated_on_chunks={int(on.sum())} of {T * n_chunks} slab_tests "
                  f"gated={gated_slabs} super={super_slabs} flat={flat_slabs} "
                  f"ops_bound_ms={ops_ms:.4f} bytes_bound_ms={bytes_ms:.4f}")
            if bounce == 1:  # the kernel table reports the sorted bounced block
                result = dict(ms=ms, kernel_ms=kernel_ms, prepass_ms=prepass_ms,
                              flat_ms=flat_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        state = _next_state(scene, state, seed, bounce)
    result["max_abs_err"] = worst
    _profile_block(scene.with_config(packet_backend="fused", cull_hier=CLI_GATE),
                   "fused cull_hier=16", ("cull_gated_kernel", "fused_kernel"), phase="9c")
    return result


class _Interrupt(Exception):
    pass


def phase_resume(full, workdir: Path) -> None:
    """9d: a render stopped after two passes and resumed from its
    checkpoint equals an uninterrupted one bit for bit."""
    import torch
    from cuda_raytracer_tpu_torch.render import pipeline
    from cuda_raytracer_tpu_torch.utils import checkpoint

    scene = _resized(full, 128, 128).with_config(
        rays_per_pixel=6, max_rays_per_pixel_per_pass=2, cull_hier=CLI_GATE)
    path = str(workdir / "resume.npz")
    straight = pipeline.render_framebuffer(scene)

    def stop_after_two(done, total):
        if done == 4:
            raise _Interrupt

    try:
        pipeline.render_framebuffer(scene, checkpoint_path=path, progress=stop_after_two)
        raise SystemExit("phase 9d failed: the render was not interrupted")
    except _Interrupt:
        pass
    saved = checkpoint.load_checkpoint(path, checkpoint.scene_fingerprint(scene))
    resumed = pipeline.render_framebuffer(scene, checkpoint_path=path)
    torch.cuda.synchronize()
    same = bool(torch.equal(resumed, straight))
    print(f"phase 9d resume: torus 128x128 spp=6 passes_of=2 checkpoint_samples={saved[1]} "
          f"resumed_bit_identical={same} max_abs_diff="
          f"{float((resumed - straight).abs().max()):.3g}")
    if saved[1] != 4 or not same:
        raise SystemExit("phase 9d failed: the resumed render differs")


def phase_cpu_flag(scenes: dict, workdir: Path) -> None:
    """9e: the ``cpu`` flag renders the scene on the GPU and on the CPU."""
    import numpy as np
    from cuda_raytracer_tpu_torch import cli
    from cuda_raytracer_tpu_torch.utils.png import read_png

    out = workdir / "out.png"
    rc = cli.main([str(scenes["cornell"]), "cpu", "--width", "64", "--height", "64",
                   "--spp", "4", "--out", str(out)])
    cpu_out = Path(str(out) + ".cpu.png")
    if rc != 0 or not out.exists() or not cpu_out.exists():
        raise SystemExit("phase 9e failed: the cpu flag did not write both images")
    gpu, cpu = (read_png(str(p)).astype(np.int32) for p in (out, cpu_out))
    diff = np.abs(gpu - cpu)
    within = float((diff <= 1).mean())
    print(f"phase 9e cpu flag: cornell 64x64 spp=4 rc={rc} bytes_within_1={within:.6f} "
          f"identical_bytes={float((diff == 0).mean()):.6f} max_byte_diff={int(diff.max())} "
          f"mean_gpu={gpu.mean():.2f} mean_cpu={cpu.mean():.2f}")
    if within < CPU_GATE:
        raise SystemExit("phase 9e failed: GPU and CPU images disagree")


def phase_cli(full) -> dict:
    """Phase 9: the command-line renderer on the card."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        workdir = Path(tmp)
        scenes = _write_scenes(workdir)
        plain_cli = phase_cli_subprocess(scenes, workdir)
        phase_cli_in_process(scenes, workdir, plain_cli["png"])
        launches = phase_gated_render(full)
        result = phase_gated_cull(full)
        phase_resume(full, workdir)
        phase_cpu_flag(scenes, workdir)
    result["launches"] = launches
    result["plain_cli"] = plain_cli  # phase 12a's reference
    return result


def _pallas_inputs(scene, state, n: int):
    """(od8, rays_tiles, padded window) of the first ``n`` rays of a
    wavefront, as the "pallas" engine builds them."""
    import torch
    from cuda_raytracer_tpu_torch.ops import packet_intersect
    from cuda_raytracer_tpu_torch.ops.kernels import cull, sweep

    tile = scene.config.packet_tile
    alive = torch.any(state.transmitted[:n] != 0.0, dim=-1)
    window = torch.where(alive, 1e30, -1.0)  # the torus scene has no spheres
    origin, direction, window = packet_intersect._pad_rays(
        state.origin[:n], state.direction[:n], window, tile)
    return (cull.make_od8(origin, direction, window, tile),
            sweep.make_rays_tiles(origin, direction, tile), window)


def _sweep_rounds(scene, od8, rays_tiles, window, cap: int):
    """The pallas engine's sweeps on one ray batch, the kernel and the plain
    version side by side on the same pair lists: one round, then round 1
    and round 2 of the two-round sweep (round 2's windows from the kernel's
    round 1) → [(label, pairs, total, overflow, kernel (t, tri), plain (t,
    tri))]."""
    import torch
    from cuda_raytracer_tpu_torch.ops import packet_intersect as pi
    from cuda_raytracer_tpu_torch.ops.kernels import cull, sweep

    T, _, tile = od8.shape
    P = T * cap
    blocks = scene.cluster_blocks.contiguous()
    origin = od8[:, 0:3].permute(0, 2, 1).reshape(-1, 3)
    direction = od8[:, 3:6].permute(0, 2, 1).reshape(-1, 3)
    entry = pi._block_cull(scene, od8, 1, False)[0]
    hit = entry < pi.HIT_THRESH
    nth = torch.kthvalue(entry, pi.ROUND1_NEAREST, dim=1, keepdim=True).values
    sel1 = hit & (entry <= nth)
    out = []
    for label, select in (("one_round", hit), ("round1", sel1)):
        pairs, total, overflow = pi.extract_pairs(select, P)
        out.append((label, pairs, total, overflow,
                    sweep.sweep_pairs(rays_tiles, blocks, pairs, total, tile),
                    sweep.plain_sweep(rays_tiles, blocks, pairs, total, tile)))
    t1 = out[-1][4][0][:T]
    window2 = torch.minimum(window.reshape(T, tile), t1).reshape(-1)
    entry2 = pi._block_cull(scene, cull.make_od8(origin, direction, window2, tile), 1,
                            False)[0]
    pairs, total, overflow = pi.extract_pairs((entry2 < pi.HIT_THRESH) & ~sel1, P)
    out.append(("round2", pairs, total, overflow,
                sweep.sweep_pairs(rays_tiles, blocks, pairs, total, tile),
                sweep.plain_sweep(rays_tiles, blocks, pairs, total, tile)))
    return out


def _sweep_ranges(scene, od8, rays_tiles, cap: int, label: str) -> float:
    """10a: the one-round pair list of a ray batch through the sweep kernel
    at its own range count, at one range per pair and at SWEEP_CUT_RANGES
    (whose ranges cut tiles' runs of pairs), tile-major and shuffled, against
    plain_sweep → the worst |Δ|; any mismatched element fails the run."""
    import torch
    from cuda_raytracer_tpu_torch.ops import packet_intersect as pi
    from cuda_raytracer_tpu_torch.ops.kernels import sweep

    T, _, tile = od8.shape
    blocks = scene.cluster_blocks.contiguous()
    entry = pi._block_cull(scene, od8, 1, False)[0]
    pairs, total, _ = pi.extract_pairs(entry < pi.HIT_THRESH, T * cap)
    k = int(total)
    gen = torch.Generator(device=od8.device).manual_seed(k)
    shuffled = pairs.clone()
    shuffled[:, :k] = pairs[:, torch.randperm(k, device=od8.device, generator=gen)]
    cut = (k * torch.arange(1, SWEEP_CUT_RANGES, device=od8.device)) // SWEEP_CUT_RANGES
    cut = cut[(cut > 0) & (cut < k)]
    cuts_runs = bool((pairs[0, cut - 1] == pairs[0, cut]).any()) if cut.numel() else False
    want = sweep.plain_sweep(rays_tiles, blocks, pairs, total, tile)
    bad, worst = {}, 0.0
    for order, pair_list in (("tile_major", pairs), ("shuffled", shuffled)):
        for name, ranges in (("kernel_choice", None), ("one_per_pair", max(k, 1)),
                             (f"cut{SWEEP_CUT_RANGES}", SWEEP_CUT_RANGES)):
            got = sweep.sweep_pairs(rays_tiles, blocks, pair_list, total, tile, ranges=ranges)
            torch.cuda.synchronize()
            bad[f"{order}:{name}"], err = _mismatch(got, want)
            worst = max(worst, err)
    print(f"phase 10a sweep ranges: {label} tiles={T} pairs={k} "
          f"cuts_tile_runs_at_{SWEEP_CUT_RANGES}={cuts_runs} mismatched={json.dumps(bad)}")
    if any(bad.values()) or (k > 2 * SWEEP_CUT_RANGES and not cuts_runs):
        raise SystemExit(f"phase 10a failed: the sweep at a range count or order differs "
                         f"from its plain version ({label})")
    return worst


def _train_sweep_ranges(full) -> float:
    """10a: ``_sweep_ranges`` on the train step's pass (the torus at 256×256
    × 2 spp, 131,072 rays) entering bounces 0-3."""
    import torch
    from cuda_raytracer_tpu_torch.render import wavefront

    base = _resized(full, TRAIN["width"], TRAIN["height"]).with_config(**TRAIN)
    rpp = TRAIN["rays_per_pixel"]
    n = base.num_pixels * rpp
    ids = torch.arange(n, dtype=torch.int32, device=base.device)
    state = wavefront.make_initial_state(base, ids, rpp, TRAIN_SEED)
    cap = min(base.config.packet_cap, base.num_clusters)
    worst = 0.0
    for bounce in range(4):
        od8, rays_tiles, _ = _pallas_inputs(base, state, n)
        worst = max(worst, _sweep_ranges(base, od8, rays_tiles, cap,
                                         f"train step pass bounce={bounce} rays={n}"))
        state = _next_state(base, state, TRAIN_SEED, bounce)
    return worst


def phase_sweep(full) -> dict:
    """10a and 10b: the pair sweep kernel against its plain version, the
    pallas engine against the fused one, and the sweep's time."""
    import torch
    from cuda_raytracer_tpu_torch.ops import packet_intersect
    from cuda_raytracer_tpu_torch.ops.kernels import cull, fused, sweep
    from cuda_raytracer_tpu_torch.render import wavefront

    rpp, seed = 20, 80
    scene = full.with_config(rays_per_pixel=rpp)
    block_lo, block = _centre_block(scene, rpp)
    ray_id = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    K, C = scene.num_clusters, scene.cluster_tris
    cap = min(scene.config.packet_cap, K)
    blocks = scene.cluster_blocks.contiguous()
    real = (blocks[:, 9, :] >= 0).sum(dim=1)  # real triangles per cluster
    aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
    f4 = 4
    state = wavefront.make_initial_state(scene, ray_id, rpp, seed)
    worst, result = 0.0, {}
    for bounce in range(4):
        for n in (block - 37, block):
            od8, rays_tiles, window = _pallas_inputs(scene, state, n)
            T = od8.shape[0]
            bad, err, counts, dropped = 0, 0.0, [], {}
            for small_cap in (cap, 1):  # a budget that holds, one that overflows
                for label, pairs, total, overflow, got, want in _sweep_rounds(
                        scene, od8, rays_tiles, window, small_cap):
                    dropped[(small_cap, label)] = int(overflow)
                    torch.cuda.synchronize()
                    bad += sum(int((g[:T] != w[:T]).sum()) for g, w in zip(got, want))
                    err = max([err] + [float((g[:T].double() - w[:T].double()).abs().max())
                                       for g, w in zip(got, want)])
                    counts.append(f"cap{small_cap}:{label}:pairs={int(total)}"
                                  f"+{int(overflow)}dropped")
            # The engines end to end: pallas (one and two rounds) against fused.
            alive = torch.any(state.transmitted[:n] != 0.0, dim=-1)
            args = (scene, state.origin[:n], state.direction[:n],
                    torch.where(alive, 1e30, -1.0),
                    torch.full((n,), -1, dtype=torch.int32, device=scene.device))
            ref = packet_intersect.closest_hit_packet(*args, tile=scene.config.packet_tile,
                                                      backend="fused", skip=True)
            engine_bad, suspects = 0, []
            for two_round in (False, True):
                got = packet_intersect.closest_hit_packet(
                    *args, tile=scene.config.packet_tile, cap=K, backend="pallas",
                    two_round=two_round)
                engine_bad += int((got[0] != ref[0]).sum()) + int((got[1] != ref[1]).sum())
                suspects.append(int(got[2]))
            over = packet_intersect.closest_hit_packet(*args, tile=scene.config.packet_tile,
                                                       cap=1, backend="pallas")
            err = max(err, _sweep_ranges(scene, od8, rays_tiles, cap,
                                         f"torus block lo={block_lo} bounce={bounce} rays={n}"))
            print(f"phase 10a sweep vs plain: torus block lo={block_lo} bounce={bounce} "
                  f"rays={n} tiles={T} mismatched={bad} max_abs_err={err:.3g} "
                  f"{' '.join(counts)} | pallas_vs_fused mismatched={engine_bad} "
                  f"suspects={suspects} overflow_cap1_suspects={int(over[2])}")
            # All or nothing: every ray is suspect exactly when pairs dropped.
            over_ok = int(over[2]) == (n if dropped[(1, "one_round")] else 0)
            if (bad or engine_bad or any(suspects) or dropped[(cap, "one_round")]
                    or not over_ok or (bounce == 0 and not dropped[(1, "one_round")])):
                raise SystemExit(f"phase 10a failed: bounce {bounce}, {n} rays")
            worst = max(worst, err)
        if bounce <= 1:  # 10b: time at the full block
            od8, rays_tiles, window = _pallas_inputs(scene, state, block)
            T, _, tile = od8.shape
            entry, mask = cull.cull_tiles(od8, aabb, with_mask=True)
            select = entry < packet_intersect.HIT_THRESH
            pairs, total, overflow = packet_intersect.extract_pairs(select, T * cap)
            words = fused.pack_words(select)
            k = int(total)
            live_tile = (od8[:, 6, :] >= 0).sum(dim=1)
            pt, pc = pairs[0, :k].long(), pairs[1, :k].long()
            mts = int((live_tile[pt] * real[pc]).sum())  # what the swept pairs need
            ms = _cuda_ms(lambda: sweep.sweep_pairs(rays_tiles, blocks, pairs, total, tile))
            plain_ms = _plain_ms(
                lambda: sweep.plain_sweep(rays_tiles, blocks, pairs, total, tile))
            fused_ms = _cuda_ms(
                lambda: fused.fused_closest_hit(od8, blocks[:K], words, entry, mask))
            extract_ms = _cuda_ms(lambda: packet_intersect.extract_pairs(select, T * cap))
            nbytes = (rays_tiles.numel() + 2 * k + 1 + T * tile * 2
                      + int(torch.unique(pc).numel()) * BLOCK_ROWS * C) * f4
            ops_ms = mts * SWEEP_MT_OPS / PEAK_FP32_FLOPS * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            print(f"phase 10b sweep timing: torus block lo={block_lo} rays={block} "
                  f"bounce={bounce} pairs={k} dropped={int(overflow)} sweep_ms={ms:.3f} "
                  f"plain_ms={plain_ms:.1f} mt_tests={mts} ops_bound_ms={ops_ms:.4f} "
                  f"bytes_bound_ms={bytes_ms:.4f} bound_share={bound_ms / ms:.3f} "
                  f"pair_extraction_ms={extract_ms:.3f} fused_same_rays_ms={fused_ms:.3f}")
            if bounce == 1:  # the kernel table reports the sorted bounced block
                result = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, fused_ms=fused_ms,
                              bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        state = _next_state(scene, state, seed, bounce)
    result["max_abs_err"] = max(worst, _train_sweep_ranges(full))
    return result


def _pallas_cap(scene) -> int:
    """The packet_cap at which the pallas engine's audit of one training
    pass reports no suspect ray, doubling from the config's."""
    from cuda_raytracer_tpu_torch.render import diff

    cap = scene.config.packet_cap
    while True:
        audited = scene.with_config(packet_backend="pallas", packet_cap=cap)
        suspects = diff.check_radiance_exact(audited, pass_seed=TRAIN_SEED)
        print(f"phase 10c audit: packet_backend=pallas packet_cap={cap} suspects={suspects}")
        if suspects == 0:
            return cap
        if cap >= scene.num_clusters:
            raise SystemExit("phase 10c failed: the pallas audit is not clean at any cap")
        cap = min(2 * cap, scene.num_clusters)


def _step_shading_suspects(scene, params, rpp: int, bounces: int) -> int:
    """The suspect count of one pass of the step's scene (its static live
    schedule) traced as the step traces it: with the parameters in the graph,
    so every bounce shades with torch. Launches no bounce kernel."""
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import bounce
    from cuda_raytracer_tpu_torch.render import diff, packed, wavefront

    merged = diff.merge_params(scene, params)
    ids = torch.arange(merged.num_pixels * rpp, dtype=torch.int32, device=merged.device)
    launches = bounce.LAUNCHES
    with torch.enable_grad():
        state = wavefront.make_initial_state(merged, ids, rpp, TRAIN_SEED)
        _, suspect = packed.trace_wavefront(merged, state, TRAIN_SEED, bounces,
                                            merged.config.sort_rays)
    if bounce.LAUNCHES != launches:
        raise SystemExit("phase 10c failed: a graph-building pass launched the bounce kernel")
    return int(suspect)


def phase_train(full) -> dict:
    """10c: the inverse-rendering train step on the full torus through
    both engines, with and without per-bounce checkpointing."""
    import torch
    from cuda_raytracer_tpu_torch.render import diff

    base = _resized(full, TRAIN["width"], TRAIN["height"]).with_config(**TRAIN)
    rpp, bounces = TRAIN["rays_per_pixel"], TRAIN["bounces"]
    rays = base.num_pixels * rpp
    true_params, _ = diff.split_params(base)
    with torch.no_grad():
        target = diff.render_radiance(true_params, base, TRAIN_SEED, rpp, bounces)
    # Start from greyed diffuse albedos: the loss must fall back.
    start = diff.params_to_numpy(true_params)
    start["materials.diffuse_albedo"][:] = 0.5
    schedule = diff.calibrate_live_schedule(base, seeds=(TRAIN_SEED, TRAIN_SEED + 1))
    print(f"phase 10c set-up: torus {base.config.width}x{base.config.height} spp={rpp} "
          f"bounces={bounces} rays={rays} triangles={base.triangle_count} "
          f"clusters={base.num_clusters} live_schedule={[round(d, 3) for d in schedule]}")
    scenes = {"auto": base, "pallas": base.with_config(packet_backend="pallas",
                                                       packet_cap=_pallas_cap(base))}
    engine_kernels = {"auto": ("cull_tiles", "fused_closest_hit"),
                      "pallas": ("cull_tiles", "sweep_pairs")}
    # A step's other kernels: the reorder's sort keys and the torch shading's
    # PCG draws (recomputed in the backward pass with checkpointing).
    step_kernels = ("ray_keys", "pcg_draws")
    results = {}
    for backend, checkpoint in (("auto", True), ("pallas", True), ("auto", False),
                                ("pallas", False)):
        params = diff.params_from_numpy(start, base.device, requires_grad=True)
        optimizer = torch.optim.Adam(diff.param_leaves(params), lr=TRAIN_LR)
        step = diff.make_train_step(scenes[backend], optimizer, rpp, bounces,
                                    live_schedule=schedule, checkpoint_bounces=checkpoint)
        # Calibration and the audit trace forward passes, which shade through
        # the bounce kernel; the step shades with torch. The audit must keep
        # or drop the schedule as it would under the torch shading, and the
        # scene the step renders (with the calibrated schedule if the audit
        # kept it, else the dynamic prefix) must be exact under the step's
        # own shading.
        kept = step.scene.config.live_schedule == tuple(schedule)
        with _torch_shading():
            kept_torch = diff.check_radiance_exact(
                scenes[backend].with_config(live_schedule=tuple(schedule)),
                rays_per_pixel=rpp, bounces=bounces) == 0
        suspects = _step_shading_suspects(step.scene, params, rpp, bounces)
        with torch.no_grad():  # the forward pass alone, for its launch count
            _zero_launch_counts()
            diff.render_radiance(params, step.scene, TRAIN_SEED, rpp, bounces)
            forward = _launch_counts()
        for _ in range(TRAIN_WARMUP):
            step(params, target, TRAIN_SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds, losses = [], []
        _zero_launch_counts()
        for _ in range(TRAIN_STEPS):
            start_t = time.perf_counter()
            loss = step(params, target, TRAIN_SEED)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start_t)
            losses.append(float(loss))
        counts = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
        finite = all(bool(torch.isfinite(p).all()) and bool(torch.isfinite(p.grad).all())
                     for p in diff.param_leaves(params))
        median = statistics.median(seconds)
        kernels = engine_kernels[backend]
        ok_launches = all(per_step[k] == forward[k] > 0 for k in kernels) and all(
            counts[k] > 0 for k in step_kernels) and all(
            counts[k] == 0 for k in counts if k not in kernels + step_kernels)
        falling = losses[-1] < losses[0] and all(map(lambda x: x == x, losses))
        print(f"phase 10c train step: torus packet_backend={backend} "
              f"checkpoint_bounces={checkpoint} seconds_per_step={median:.4f} "
              f"steps={[round(x, 4) for x in seconds]} paths_per_s={rays / median:.6g} "
              f"peak_mem_MiB={peak / 2**20:.1f} losses={[f'{x:.6g}' for x in losses]} "
              f"launches_per_step={json.dumps(per_step)} forward_launches={json.dumps(forward)} "
              f"finite={finite} loss_falling={falling} backward_launches_none={ok_launches} "
              f"schedule_kept={kept} schedule_kept_under_torch_shading={kept_torch} "
              f"step_shading_suspects={suspects}")
        if not (finite and falling and ok_launches and suspects == 0 and kept == kept_torch):
            raise SystemExit(f"phase 10c failed: packet_backend={backend} "
                             f"checkpoint_bounces={checkpoint}")
        results[(backend, checkpoint)] = dict(seconds=median, launches=counts, peak=peak)
        if checkpoint:  # where one step's time goes
            _, wall_ms, rows = _profiled(lambda: step(params, target, TRAIN_SEED))
            results[(backend, checkpoint)]["device_kernels"] = sum(r[1] for r in rows)
            busy_ms = sum(r[0] for r in rows)
            closest_ms = sum(r[0] for r in rows if any(
                k in r[2] for k in ("cull_kernel", "fused_kernel", "sweep_kernel")))
            print(f"phase 10c profile: packet_backend={backend} one step wall_ms={wall_ms:.2f} "
                  f"device_busy_ms={busy_ms:.2f} device_idle_share={1 - busy_ms / wall_ms:.3f} "
                  f"closest_hit_kernels_ms={closest_ms:.3f} "
                  f"device_kernels={sum(r[1] for r in rows)}")
            for dev_ms, count, key in rows[:6]:
                print(f"phase 10c profile: {backend} top device time {dev_ms:.3f} ms x{count} "
                      f"{key[:90]}")
    # The two engines' gradients at the same parameters.
    grads = {}
    for backend in ("auto", "pallas"):
        _, g = diff.render_and_grad(scenes[backend], target=target, pass_seed=TRAIN_SEED,
                                    rays_per_pixel=rpp, bounces=bounces)
        grads[backend] = diff.param_leaves(g)
    worst = 0.0
    for a, b in zip(grads["auto"], grads["pallas"]):
        tol = GRAD_TOL * float(a.abs().max()) + 1e-6
        worst = max(worst, float((a - b).abs().max()) / tol)
    print(f"phase 10c gradients auto vs pallas: worst |diff| / tolerance = {worst:.4g} "
          f"(tolerance {GRAD_TOL} * max|g| + 1e-6 per leaf)")
    if not worst <= 1.0:
        raise SystemExit("phase 10c failed: the engines' gradients disagree")
    return results


def phase_example(device) -> None:
    """10d: the inverse-rendering example at its default size."""
    from cuda_raytracer_tpu_torch.examples import inverse_render

    start = time.perf_counter()
    lines = []
    result = inverse_render.run(device=device, log=lines.append)
    seconds = time.perf_counter() - start
    print(f"phase 10d example: inverse_render 64x64 spp=8 steps=60 seconds={seconds:.2f} "
          f"loss_first={result['losses'][0]:.6g} loss_last={result['losses'][-1]:.6g} "
          f"wall_error={result['err']:.4f}")
    if not result["err"] < EXAMPLE_BAR:
        raise SystemExit("phase 10d failed: the example did not recover the walls")


def _train_block_tail(full) -> list:
    """10b: fused at S = 1 and at the chosen split on the train step's pass
    (the torus at 256×256 × 2 spp × 10 bounces, 131,072 rays, one block),
    bounces 0-9."""
    import torch

    base = _resized(full, TRAIN["width"], TRAIN["height"]).with_config(**TRAIN)
    rpp = TRAIN["rays_per_pixel"]
    ids = torch.arange(base.num_pixels * rpp, dtype=torch.int32, device=base.device)
    return _fused_tail(base, ids, rpp, TRAIN_SEED, "train step pass", "10b")


def phase_material_lookup(full) -> None:
    """10c: the wavefront's material lookup (a one-hot product) against the
    row gathers it replaced, on the card, with TF32 matmuls allowed and
    not: the same bits."""
    import torch
    from cuda_raytracer_tpu_torch.render import wavefront

    mats = full.materials
    M = mats.diffuse_albedo.shape[0]
    gen = torch.Generator(device=full.device).manual_seed(TRAIN_SEED)
    mat_i = torch.randint(0, M, (1 << 17,), device=full.device, generator=gen)
    gather = torch.cat([mats.diffuse_albedo[mat_i], mats.specular_albedo[mat_i],
                        mats.emitted[mat_i], mats.metallicity[mat_i, None],
                        mats.roughness[mat_i, None], mats.index_of_refraction[mat_i, None]], 1)
    allowed = torch.backends.cuda.matmul.allow_tf32
    bad = {}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            bad[tf32] = _mismatch((wavefront.material_rows(mats, mat_i),), (gather,))[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
    print(f"phase 10c material lookup: one-hot product vs gather rows={mat_i.shape[0]} "
          f"materials={M} mismatched={bad[False]} mismatched_with_tf32={bad[True]}")
    if any(bad.values()):
        raise SystemExit("phase 10c failed: the one-hot material lookup differs from the gather")


def phase_diff(full, device) -> dict:
    """Phase 10: differentiable rendering on the card."""
    result = phase_sweep(full)
    result["train_tail"] = _train_block_tail(full)
    phase_material_lookup(full)
    train = phase_train(full)
    phase_example(device)
    result["launches"] = train[("pallas", True)]["launches"]["sweep_pairs"]
    result["train_launches"] = train[("auto", True)]["launches"]
    return result


def _packed_scenes(device):
    """Phase 11 set-up: the full torus with ``cluster_pack=2`` (blocks of
    PACK_TRIS lanes, two sub-clusters of PACK_TRIS / 2 triangles each), and
    the same torus cut unpacked at PACK_TRIS / 2: the same sub-clusters."""
    from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl

    start = time.perf_counter()
    parsed = builtin_scenes.parse_mesh_scene("torus")
    packet = dict(intersector="packet")
    packed = scene_dsl.assemble_scene(parsed, config_overrides=dict(packet, cluster_pack=2),
                                      cluster_tris=PACK_TRIS, device=device)
    half = scene_dsl.assemble_scene(parsed, config_overrides=packet,
                                    cluster_tris=PACK_TRIS // 2, device=device)
    table = packed.cluster_blocks[:packed.num_clusters // 2]
    print(f"phase 11 setup: torus cluster_pack=2 cluster_tris={packed.cluster_tris} "
          f"sub_clusters={packed.num_clusters} blocks={table.shape[0]} "
          f"table_MB={table.numel() * table.element_size() / 1e6:.2f} "
          f"unpacked_at_{PACK_TRIS // 2}_clusters={half.num_clusters} "
          f"setup_seconds={time.perf_counter() - start:.1f}")
    return packed, half


def _pack_cases(packed, half, od8):
    """The pack-2 kernel on one ray batch (flat and gated, one shard and two
    block-aligned shards) against its plain version, and the pack-1 kernel
    on the torus cut at PACK_TRIS / 2 → [(case, mismatched, max |Δ|)]. The
    comparisons read the outputs back, which synchronises."""
    from cuda_raytracer_tpu_torch.ops.kernels import cull, fused1

    K = packed.num_clusters
    cmin, cmax = packed.cluster_min, packed.cluster_max
    blocks = packed.cluster_blocks[:K // 2].contiguous()
    ref = fused1.plain_fused1(od8, cull.box_table(cmin, cmax), blocks, pack=2)
    out = []
    for gate in (0, PACK_GATE):
        for shards in (1, 2):
            got = _sharded(lambda lo, hi: fused1.fused1_closest_hit(
                od8, cull.box_table(cmin[lo:hi], cmax[lo:hi]),
                blocks[lo // 2:hi // 2].contiguous(),
                fused1.shard_supers(cmin[lo:hi], cmax[lo:hi], gate) if gate else None,
                gate, pack=2), K, shards, pack=2)
            out.append((f"gate{gate}_shards{shards}", *_mismatch(got, ref)))
    hmin, hmax = half.cluster_min, half.cluster_max
    got = fused1.fused1_closest_hit(
        od8, cull.box_table(hmin, hmax), half.cluster_blocks[:half.num_clusters].contiguous(),
        fused1.shard_supers(hmin, hmax, PACK_GATE), PACK_GATE)
    out.append((f"pack1_at_{PACK_TRIS // 2}", *_mismatch(got, ref)))
    return out


def phase_pack_vs_plain(packed, half) -> float:
    """11a: the pack-2 kernel against its plain version and against pack 1
    at PACK_TRIS / 2, at 64×64 × 4 spp entering bounces 0-3, unaligned."""
    import torch
    from cuda_raytracer_tpu_torch.render import wavefront

    scene = _resized(packed, 64, 64)
    rays = 64 * 64 * MESH_SMALL_RPP
    ray_id = torch.arange(rays, dtype=torch.int32, device=scene.device)
    state = wavefront.make_initial_state(scene, ray_id, MESH_SMALL_RPP, 3)
    worst = 0.0
    for bounce in range(MESH_SMALL_BOUNCES):
        cut = wavefront.RayState(*(leaf[:rays - 37] for leaf in state))
        cases = _pack_cases(packed, half, _packet_rays(scene, cut, scene.config.packet_tile))
        print(f"phase 11a pack2 vs plain: torus 64x64 spp={MESH_SMALL_RPP} bounce={bounce} "
              f"rays={rays - 37} " + " ".join(f"{c}:mismatched={b}" for c, b, _ in cases)
              + f" max_abs_err={max(e for _, _, e in cases):.3g}")
        if any(b for _, b, _ in cases):
            raise SystemExit(f"phase 11a failed: bounce {bounce}")
        worst = max([worst] + [e for _, _, e in cases])
        state = _next_state(scene, state, 3, bounce)
    return worst


def phase_pack_timing(packed, full, yard: list) -> dict:
    """11b: the pack-2 kernel on the centre 2^18-ray block of a 20-spp pass,
    bounces 0 and 1: time, counters, bound, plain time, bit-equality; and
    the pack-1 kernel (phase 8's, C = 256) on the same rays; then bounces
    0-9 as phase 8 times them, beside ``yard``: phase 8's times on the same
    rays (the packed table traces the unpacked one's bits)."""
    import torch
    from cuda_raytracer_tpu_torch.ops import packet_intersect
    from cuda_raytracer_tpu_torch.ops.kernels import cull, fused1
    from cuda_raytracer_tpu_torch.render import wavefront

    rpp, seed = 20, 80
    scene = packed.with_config(rays_per_pixel=rpp)
    block_lo, block = _centre_block(scene, rpp)
    ray_id = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    state0 = wavefront.make_initial_state(scene, ray_id, rpp, seed)
    state1 = _next_state(scene, state0, seed, 0)
    K, C, tile = scene.num_clusters, scene.cluster_tris, scene.config.packet_tile
    cmin, cmax = scene.cluster_min, scene.cluster_max
    aabb = cull.box_table(cmin, cmax)
    blocks = scene.cluster_blocks[:K // 2].contiguous()
    sup = fused1.shard_supers(cmin, cmax, PACK_GATE)
    K1 = full.num_clusters
    aabb1 = cull.box_table(full.cluster_min, full.cluster_max)
    blocks1 = full.cluster_blocks[:K1].contiguous()
    sup1 = fused1.shard_supers(full.cluster_min, full.cluster_max, PACK_GATE)
    f4 = 4
    results = {}
    for bounce, state in ((0, state0), (1, state1)):
        od8 = _packet_rays(scene, state, tile)
        T = od8.shape[0]

        def kernel():
            return fused1.fused1_closest_hit(od8, aabb, blocks, sup, PACK_GATE, pack=2)

        def plain():
            return fused1.plain_fused1(od8, aabb, blocks, pack=2)

        stats = torch.zeros(3, dtype=torch.int64, device=scene.device)
        stats1 = torch.zeros(3, dtype=torch.int64, device=scene.device)
        fused1.fused1_closest_hit(od8, aabb, blocks, sup, PACK_GATE, stats=stats, pack=2)
        fused1.fused1_closest_hit(od8, aabb1, blocks1, sup1, PACK_GATE, stats=stats1)
        ms = _cuda_ms(kernel)
        plain_ms = _plain_ms(plain)
        pack1_ms = _cuda_ms(lambda: fused1.fused1_closest_hit(od8, aabb1, blocks1, sup1,
                                                              PACK_GATE))
        bad, err = _mismatch(kernel(), plain())
        # Every sub-cluster some tile's rays hit: its half block is read once.
        hit_subs = int((cull.cull_tiles(od8, aabb) < packet_intersect.HIT_THRESH)
                       .any(dim=0).sum())
        nbytes = (od8.numel() + BOX_ROWS * K + sup.numel() + hit_subs * BLOCK_ROWS * C // 2
                  + T * tile * 2) * f4
        ops_ms = ((int(stats[0]) * FUSED1_OPS[0] + int(stats[2]) * FUSED1_OPS[1])
                  / PEAK_FP32_FLOPS * 1e3)
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        ops1_ms = ((int(stats1[0]) * FUSED1_OPS[0] + int(stats1[2]) * FUSED1_OPS[1])
                   / PEAK_FP32_FLOPS * 1e3)
        print(f"phase 11b pack2 timing: torus block lo={block_lo} rays={block} bounce={bounce} "
              f"pack2_ms={ms:.3f} plain_ms={plain_ms:.1f} slab_tests={int(stats[0])} "
              f"swept_sub_pairs={int(stats[1])} mt_tests={int(stats[2])} "
              f"ops_bound_ms={ops_ms:.4f} bytes_bound_ms={bytes_ms:.4f} "
              f"bound_share={bound_ms / ms:.3f} full_shape_mismatched={bad} "
              f"max_abs_err={err:.3g} | pack1_same_rays_ms={pack1_ms:.3f} "
              f"pack1_slab_tests={int(stats1[0])} pack1_swept_pairs={int(stats1[1])} "
              f"pack1_mt_tests={int(stats1[2])} pack1_ops_bound_ms={ops1_ms:.4f}")
        if bad:
            raise SystemExit(f"phase 11b failed: pack2 differs from its plain version "
                             f"(bounce {bounce})")
        results[bounce] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, max_abs_err=err,
                               pack1_ms=pack1_ms,
                               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    # Where the packed block's time goes, beside phase 8's profile of the
    # unpacked one: the pack-2 kernel's time per bounce.
    _profile_block(scene, "fused1 pack=2", FUSED1_KERNELS, phase="11b")
    results[1].update(_fused1_tail(packed, 2, PACK_GATE, "11b", yard))
    return results[1]  # the kernel table reports the sorted bounced block


def phase_pack_main_path(packed, full, reference_fb) -> int:
    """11c: the packed torus and the unpacked one at 1000×1000, 100 spp, 10
    bounces, in turns (packed, unpacked, unpacked, packed), each timed as
    ``render_timed`` times it: the packed renders launch the pack-2 kernel
    and no other packet kernel, the unpacked ones fused1, and every
    framebuffer equals phase 7's unpacked one bit for bit → the first packed
    render's pack-2 launches."""
    import torch

    pack2, pack1 = ("fused1_closest_hit_pack2",), ("fused1_closest_hit",)
    scenes = {"packed": packed.with_config(rays_per_pixel=MESH_FULL_SPP),
              "unpacked": full.with_config(rays_per_pixel=MESH_FULL_SPP,
                                           packet_backend="fused1")}
    order = ("packed", "unpacked", "unpacked", "packed")
    seconds, fbs, _, counts = _render_turns([(label, scenes[label]) for label in order],
                                            {"packed": pack2, "unpacked": pack1}, "11c",
                                            "packed main path")
    same = [bool(torch.equal(fb, reference_fb)) for fb in fbs]
    print(f"phase 11c packed main path: seconds " + " ".join(
        f"{label}={[round(x, 4) for x in secs]}" for label, secs in seconds.items())
        + f" bit_identical_to_unpacked_phase7={same}")
    if not all(same):
        raise SystemExit("phase 11c failed: a framebuffer differs from phase 7's")
    return counts[0]["fused1_closest_hit_pack2"]


def phase_pack(full, device, yard: list):
    """Phase 11a-b: paired sub-cluster tables through the pack-2 kernel →
    (the packed torus, the kernel's numbers). ``yard``: phase 8's times per
    bounce on the same rays (cull + fused, the sweep, the pack-1 kernel)."""
    packed, half = _packed_scenes(device)
    worst = phase_pack_vs_plain(packed, half)
    result = phase_pack_timing(packed, full, yard)
    result["max_abs_err"] = max(worst, result["max_abs_err"])
    return packed, result


def phase_mesh_cli(plain_cli: dict) -> None:
    """12a: ``python -m cuda_raytracer_tpu_torch torus.scene`` with phase 9a's
    flags and ``--mesh 1``, run through a ``python -c`` entry that makes
    any spawned rank fail the run: a size-1 mesh renders in the calling
    process (as the JAX CLI does), and its PNG must equal phase 9a's byte
    for byte. Its wall and render seconds stand beside 9a's."""
    entry = ("import sys\n"
             "import torch.multiprocessing as mp\n"
             "def refuse(*args, **kwargs):\n"
             "    raise SystemExit('--mesh 1 spawned a rank')\n"
             "mp.start_processes = mp.spawn = refuse\n"
             "from cuda_raytracer_tpu_torch import cli\n"
             "sys.exit(cli.main(sys.argv[1:]))\n")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        workdir = Path(tmp)
        scenes = _write_scenes(workdir)
        out = workdir / "mesh1.png"
        cmd = [sys.executable, "-c", entry, str(scenes["torus"]),
               "--spp", str(CLI_SPP), "--mesh", "1",
               "--metrics", "--out", str(out)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, cwd=workdir, env=_subprocess_env(), capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - start
        metrics = [ln for ln in proc.stderr.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not out.exists() or not metrics:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit("phase 12a failed: the CLI did not render with --mesh 1 "
                             "in one process")
        m = json.loads(metrics[-1])
        same = out.read_bytes() == plain_cli["png"]
        launched = {k: m["counters"].get(f"launches_{k}", 0) for k in CLI_KERNELS}
        print(f"phase 12a cli --mesh 1: rc={proc.returncode} in_process=True "
              f"wall_seconds={wall:.2f} (plain 9a {plain_cli['wall']:.2f}) "
              f"load_scene_seconds={m['phases']['load_scene']:.3f} "
              f"render_sharded_seconds={m['phases']['render_sharded']:.4f} "
              f"(plain 9a render {plain_cli['render']:.4f}) "
              f"paths_per_s={m['counters']['paths_per_s_sharded']:.6g} "
              f"launches={json.dumps(launched)} png_identical_to_phase_9a={same}")
        if not same or not all(launched.values()):
            raise SystemExit("phase 12a failed: the --mesh 1 PNG differs from phase 9a's, "
                             "or a kernel of the path did not launch")


# Phase 12b's scenes: the torus through "auto" (the walk on the card) and
# pinned to the packet intersector (cull + fused, and the pair budget's
# suspect count that sharding certifies), each with the kernels both ranks
# must launch.
SHARD_SCENES = {"cornell": ("shade_trace",), "torus": CLI_KERNELS,
                "torus_packet": FLAT_KERNELS}


def _shard_scene(name: str, device):
    """A phase 12b scene at the train step's shape."""
    from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl

    if name == "cornell":
        return _scene("cornell", TRAIN, device)
    full = scene_dsl.assemble_scene(builtin_scenes.parse_mesh_scene("torus"), device=device)
    scene = _resized(full, TRAIN["width"], TRAIN["height"]).with_config(**TRAIN)
    return scene.with_config(intersector="packet") if name == "torus_packet" else scene


def _shard_rank(rank: int, coordinator: str, out_dir: str) -> None:
    """One of phase 12b's two ranks, both on cuda:0, joined by gloo: per
    scene the sharded framebuffer, the sharded gradients at the start
    parameters, one sharded train step's loss and the launch counts; rank 0
    adds the single-device framebuffer, loss and gradients."""
    import torch
    from cuda_raytracer_tpu_torch.parallel import mesh as mesh_mod
    from cuda_raytracer_tpu_torch.parallel import shard
    from cuda_raytracer_tpu_torch.render import diff, pipeline

    device = torch.device("cuda", 0)
    mesh = mesh_mod.init_group(coordinator, SHARD_RANKS, rank, device, backend="gloo")
    rpp, bounces = TRAIN["rays_per_pixel"], TRAIN["bounces"]
    results = {}
    try:
        for name in SHARD_SCENES:
            scene = _shard_scene(name, device)
            true_params, _ = diff.split_params(scene)
            with torch.no_grad():
                target = diff.render_radiance(true_params, scene, TRAIN_SEED, rpp, bounces)
            start = diff.params_to_numpy(true_params)
            start["materials.diffuse_albedo"][:] = 0.5
            start_scene = diff.merge_params(scene, diff.params_from_numpy(start, device))
            _zero_launch_counts()
            fb = shard.render_framebuffer_sharded(scene, mesh)
            loss_g, grads = shard.sharded_loss_and_grad(start_scene, mesh, target, TRAIN_SEED,
                                                        rpp, bounces)
            params = diff.params_from_numpy(start, device, requires_grad=True)
            optimizer = torch.optim.Adam(diff.param_leaves(params), lr=TRAIN_LR)
            step = shard.make_sharded_train_step(scene, mesh, optimizer, rpp, bounces)
            loss = step(params, target, TRAIN_SEED)
            torch.cuda.synchronize()
            entry = dict(fb=fb.cpu().numpy(), loss=float(loss), grad_loss=float(loss_g),
                         grads=diff.params_to_numpy(grads), launches=_launch_counts())
            if rank == 0:
                single_loss, single_grads = diff.render_and_grad(
                    start_scene, target=target, pass_seed=TRAIN_SEED, rays_per_pixel=rpp,
                    bounces=bounces)
                entry.update(single_fb=pipeline.render_framebuffer(scene).cpu().numpy(),
                             single_loss=float(single_loss),
                             single_grads=diff.params_to_numpy(single_grads))
            results[name] = entry
    finally:
        mesh_mod.shutdown()
    torch.save(results, Path(out_dir) / f"rank{rank}.pt")


def phase_two_ranks() -> None:
    """12b: two gloo ranks on the one card (NCCL takes one rank per GPU)
    against the single-device render, loss and gradients."""
    import socket

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            coordinator = f"localhost:{s.getsockname()[1]}"
        start = time.perf_counter()
        ctx = mp.start_processes(_shard_rank, args=(coordinator, tmp), nprocs=SHARD_RANKS,
                                 join=False, start_method="spawn")
        deadline = start + SHARD_TIMEOUT
        while not ctx.join(timeout=max(0.0, deadline - time.perf_counter())):
            if time.perf_counter() >= deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise SystemExit(f"phase 12b failed: ranks still running after "
                                 f"{SHARD_TIMEOUT} s")
        wall = time.perf_counter() - start
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(SHARD_RANKS)]
    ok = True
    for name, kernels in SHARD_SCENES.items():
        r0, r1 = ranks[0][name], ranks[1][name]
        fb_replicated = np.array_equal(r0["fb"], r1["fb"])
        fb_close = np.allclose(r0["fb"], r0["single_fb"], **SHARD_FB_TOL)
        fb_bits = np.array_equal(r0["fb"], r0["single_fb"])
        loss_same = r0["loss"] == r1["loss"] and r0["grad_loss"] == r1["grad_loss"]
        loss_close = abs(r0["loss"] - r0["single_loss"]) <= LOSS_RTOL * abs(r0["single_loss"])
        # Gradients per leaf: |Δ| / (rtol·|g| + atol) with SHARD_GRAD_TOL on
        # both scenes. The material rows' gradients are float64 sums (the
        # one-hot lookup's matmul), so where the two ranks split a sum of
        # ~1.3 M terms (the torus: 131,072 rays × 10 bounces) only the final
        # float32 roundings differ.
        leaves = []
        for k in r0["grads"]:
            got, want = r0["grads"][k], r0["single_grads"][k]
            delta = np.abs(got - want)
            leaves.append((k, float(np.abs(want).max()), float(delta.max()),
                           float(np.max(delta / (SHARD_GRAD_TOL["atol"]
                                                 + SHARD_GRAD_TOL["rtol"] * np.abs(want))))))
        grad_err = max(leaf[3] for leaf in leaves)
        grads_same = all(np.array_equal(r0["grads"][k], r1["grads"][k]) for k in r0["grads"])
        print(f"phase 12b gradients {name}: " + " ".join(
            f"{k}:max|g|={sc:.4g},max|d|={d:.3g},over_gate={lit:.3g}"
            for k, sc, d, lit in leaves))
        launched = all(r["launches"][k] > 0 for r in (r0, r1) for k in kernels)
        print(f"phase 12b two gloo ranks on cuda:0: {name} {TRAIN['width']}x{TRAIN['height']} "
              f"spp={TRAIN['rays_per_pixel']} bounces={TRAIN['bounces']} "
              f"fb_replicated={fb_replicated} fb_within_tol={fb_close} "
              f"fb_bit_identical_to_single={fb_bits} loss={r0['loss']:.9g} "
              f"single_loss={r0['single_loss']:.9g} loss_same_bits_on_ranks={loss_same} "
              f"loss_within_rtol={loss_close} grads_worst_over_gate={grad_err:.3g} "
              f"grads_replicated={grads_same} launches_rank0={json.dumps(r0['launches'])} "
              f"launches_rank1={json.dumps(r1['launches'])}")
        ok = ok and fb_replicated and fb_close and loss_same and loss_close and (
            grad_err <= 1.0) and grads_same and launched
    print(f"phase 12b two gloo ranks on cuda:0: wall_seconds={wall:.2f}")
    if not ok:
        raise SystemExit("phase 12b failed: the two ranks disagree with one device")


def phase_scaling(full) -> None:
    """12c: ``scaling_report`` on the size-1 mesh (no process group)."""
    from cuda_raytracer_tpu_torch.parallel import mesh as mesh_mod
    from cuda_raytracer_tpu_torch.parallel import shard

    mesh = mesh_mod.make_mesh()
    report = shard.scaling_report(full, mesh, rays_per_pixel=SCALING_RPP, repeats=3)
    print(f"phase 12c scaling_report: torus {full.config.width}x{full.config.height} "
          f"spp={SCALING_RPP} bounces={full.config.bounces} mesh_size={mesh.size} "
          f"paths_per_s={json.dumps(report)}")
    if not report["1dev"] > 0:
        raise SystemExit("phase 12c failed: no paths/s")


def phase_sharding(full, plain_cli: dict) -> None:
    """Phase 12: sharded rendering and training."""
    phase_mesh_cli(plain_cli)
    phase_two_ranks()
    phase_scaling(full)


def _walk_inputs(scene, rows):
    """The BVH walk's inputs from packed rows, as ``wavefront.bounce_rows``
    hands them over: the origin and direction columns (strided views) and
    the set-up kernel's sphere hit (-1 on a dead ray)."""
    from cuda_raytracer_tpu_torch.ops.kernels import rays

    alive, t, index, _ = rays.rays_setup(rows, scene.sphere_center, scene.sphere_radius, 0)
    return rows[:, 0:3], rows[:, 3:6], t, index, alive


def _walk_check(scene, rows, label: str, b: int, timed: bool, plain_timed: bool = False,
                lanes=()) -> dict:
    """13a: the walk kernel against its plain version on ``rows`` (0
    mismatched bits), at the rays a warp it picks and at each of ``lanes``;
    when ``timed``, each launch's time, the counted work (with the most pops
    of one ray) and the bound it implies, and with ``plain_timed`` the plain
    version's time."""
    import torch
    from cuda_raytracer_tpu_torch.ops import traverse
    from cuda_raytracer_tpu_torch.ops.kernels import traverse as traverse_kernel

    o, d, t0, i0, alive = _walk_inputs(scene, rows)
    launches = {"default": 0, **{f"lanes={k}": k for k in lanes}}
    want = traverse.plain_bvh_closest_hit(scene, o, d, t0, i0)
    bad, err = 0, 0.0
    for k in launches.values():
        m, e = _bit_mismatch(traverse_kernel.bvh_walk(scene, o, d, t0, i0, lanes=k), want)
        bad, err = bad + m, max(err, e)
    n, live = rows.shape[0], int(alive.sum())
    line = (f"phase 13a walk vs plain: {label} bounce={b} rays={n} live={live} "
            f"launches={len(launches)} mismatched={bad} max_abs_err={err:.3g}")
    if bad:
        print(line)
        raise SystemExit(f"phase 13a failed: the BVH walk kernel differs from its plain "
                         f"version ({label}, bounce {b})")
    if not timed:
        print(line)
        return dict(max_abs_err=err)
    stats = torch.zeros(4, dtype=torch.int64, device=rows.device)
    traverse_kernel.bvh_walk(scene, o, d, t0, i0, stats=stats)
    pops, slabs, mts, max_pops = (int(x) for x in stats)
    ms = {name: _cuda_ms(lambda: traverse_kernel.bvh_walk(scene, o, d, t0, i0, lanes=k))
          for name, k in launches.items()}
    plain_ms = None
    if plain_timed:
        plain_ms = _plain_ms(lambda: traverse.plain_bvh_closest_hit(scene, o, d, t0, i0),
                             runs=1)
    nodes, tris = scene.bvh_min.shape[0], scene.tri_p1.shape[0]
    # The least the function needs, whatever the kernel's layout: each ray's
    # origin and direction, hit in and hit out; the node boxes and children
    # and the triangles once.
    nbytes = n * (24 + 8 + 8) + nodes * (24 + 8) + tris * 36
    ops_ms = (live * 3 + slabs * BVH_SLAB_OPS + mts * BVH_MT_OPS) / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    per = max(live, 1)
    print(f"{line} ms={ms['default']:.4f} "
          + (f"plain_ms={plain_ms:.1f} " if plain_ms is not None else "")
          + f"pops_per_live_ray={pops / per:.2f} max_pops={max_pops} "
          f"slab_tests_per_live_ray={slabs / per:.2f} mt_tests_per_live_ray={mts / per:.2f} "
          f"ops_bound_ms={ops_ms:.4f} bytes_bound_ms={bytes_ms:.4f} "
          f"bound_share={bound_ms / ms['default']:.3f} lanes_ms="
          + json.dumps({k: round(v, 4) for k, v in ms.items() if k != "default"}))
    return dict(ms=ms["default"], plain_ms=plain_ms, bound_ms=bound_ms, max_abs_err=err,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                pops=pops, slabs=slabs, mts=mts, max_pops=max_pops, live=live, rays=n,
                lanes_ms={k: v for k, v in ms.items() if k != "default"})


def _walk_vs_packet(scene, packet_scene, rows, b: int) -> None:
    """13b: the walk against the packet engine (``packet_scene``: cull +
    fused on the card at packet backend "auto") on the same rays, at JAX's
    BVH-against-scan standard: t within rtol / atol 1e-5, under 1 % of live
    rays on another triangle. A
    mismatch is a tie when the two triangles' Möller–Trumbore distances
    for the ray agree within 1e-5 relative."""
    import torch
    from cuda_raytracer_tpu_torch.ops import intersect
    from cuda_raytracer_tpu_torch.render import wavefront

    o, d, _, _, alive = _walk_inputs(scene, rows)
    t_bvh, i_bvh, _ = wavefront.closest_hit(scene, o, d, alive)
    t_pk, i_pk, suspect = wavefront.closest_hit(packet_scene, o, d, alive)
    close = torch.isclose(t_bvh, t_pk, rtol=1e-5, atol=1e-5)
    differ = i_bvh != i_pk
    live = int(alive.sum())
    ties = 0
    if bool(differ.any()):
        rays_ = differ.nonzero()[:, 0]
        t_of = []
        for idx in (i_bvh[rays_], i_pk[rays_]):
            tri = torch.clamp(idx - scene.sphere_count, min=0).long()
            t_of.append(intersect.moller_trumbore(o[rays_], d[rays_], scene.tri_p1[tri],
                                                  scene.tri_e1[tri], scene.tri_e2[tri]))
        both_tri = (i_bvh[rays_] >= scene.sphere_count) & (i_pk[rays_] >= scene.sphere_count)
        ties = int((both_tri & ((t_of[0] - t_of[1]).abs() <= 1e-5 * t_of[0].abs())).sum())
    bad_t, mism = int((~close).sum()), int(differ.sum())
    print(f"phase 13b walk vs packet: torus centre block bounce={b} rays={rows.shape[0]} "
          f"live={live} t_outside_rtol_1e-5={bad_t} index_mismatches={mism} "
          f"mismatch_share_of_live={mism / max(live, 1):.2e} ties_among_mismatches={ties} "
          f"packet_suspect={int(suspect)}")
    if bad_t or mism >= 0.01 * live or int(suspect):
        raise SystemExit(f"phase 13b failed: the BVH walk and the packet engine disagree "
                         f"(bounce {b})")


def _image_gap(a, b) -> str:
    """Mean |Δ| of two uint8 images' display values, and the share of bytes
    within ±1."""
    import numpy as np

    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return f"mean_abs_display_diff={diff.mean():.4f} share_within_1={(diff <= 1).mean():.6f}"


def phase_bvh_render(full) -> int:
    """13c: the torus at 1000×1000 × 10 bounces through ``intersector="bvh"``
    and through the packet intersector (``full``'s), in turns (bvh, packet,
    packet, bvh), at 100 and 8 spp; then the centre block's profile through
    the BVH → the walk's launches in the first 100-spp BVH render."""
    from cuda_raytracer_tpu_torch.render import pipeline

    bvh = full.with_config(intersector="bvh")
    pipeline.render_framebuffer(_resized(bvh, 128, 128).with_config(rays_per_pixel=20))
    packet = PACKET_LAUNCH_NAMES
    must_not = {"bvh": packet + FORWARD_NOT, "packet": ("bvh_walk",) + FORWARD_NOT}
    launches = None
    for spp in (MESH_FULL_SPP, MESH_FEW_SPP):
        scenes = {"bvh": bvh.with_config(rays_per_pixel=spp),
                  "packet": full.with_config(rays_per_pixel=spp)}
        must = {"bvh": ("bvh_walk",) + FORWARD_KERNELS,
                "packet": _auto_kernels(scenes["packet"]) + FORWARD_KERNELS}
        out = _turns([(label, scenes[label]) for label in ("bvh", "packet", "packet", "bvh")],
                     must, must_not, "13c", "bvh render")
        seconds = _seconds_by_label(out)
        print(f"phase 13c bvh render: spp={spp} seconds {json.dumps(seconds)} "
              f"bvh vs packet images: {_image_gap(out[0][2], out[1][2])}")
        if spp == MESH_FULL_SPP:
            launches = out[0][4]["bvh_walk"]
    _profile_block(bvh.with_config(rays_per_pixel=20), "bvh", ("bvh_walk_kernel",), "13c")
    return launches


def phase_bvh_train(full) -> None:
    """13d: the train step (256×256 × 2 spp × 10 bounces, checkpointed, phase
    10c's shape) through ``intersector="bvh"`` and through the packet
    intersector (``full``'s: cull + fused), in turns (bvh, packet, packet, bvh): 5 timed steps each after 2 warm-ups; the loss
    must fall, every gradient be finite, and the walk's launches per step
    equal the forward pass's (the backward pass walks no BVH)."""
    import torch
    from cuda_raytracer_tpu_torch.render import diff

    base = _resized(full, TRAIN["width"], TRAIN["height"]).with_config(**TRAIN)
    rpp, bounces = TRAIN["rays_per_pixel"], TRAIN["bounces"]
    true_params, _ = diff.split_params(base)
    with torch.no_grad():
        target = diff.render_radiance(true_params, base, TRAIN_SEED, rpp, bounces)
    start = diff.params_to_numpy(true_params)
    start["materials.diffuse_albedo"][:] = 0.5
    scenes = {"bvh": base.with_config(intersector="bvh"), "packet": base}
    walk = {"bvh": ("bvh_walk",), "packet": ("cull_tiles", "fused_closest_hit")}
    medians = {}
    for turn, label in enumerate(("bvh", "packet", "packet", "bvh")):
        scene = scenes[label]
        schedule = diff.calibrate_live_schedule(scene, seeds=(TRAIN_SEED, TRAIN_SEED + 1))
        params = diff.params_from_numpy(start, base.device, requires_grad=True)
        optimizer = torch.optim.Adam(diff.param_leaves(params), lr=TRAIN_LR)
        step = diff.make_train_step(scene, optimizer, rpp, bounces, live_schedule=schedule,
                                    checkpoint_bounces=True)
        with torch.no_grad():
            _zero_launch_counts()
            diff.render_radiance(params, step.scene, TRAIN_SEED, rpp, bounces)
            forward = _launch_counts()
        for _ in range(TRAIN_WARMUP):
            step(params, target, TRAIN_SEED)
        torch.cuda.synchronize()
        seconds, losses = [], []
        _zero_launch_counts()
        for _ in range(TRAIN_STEPS):
            start_t = time.perf_counter()
            loss = step(params, target, TRAIN_SEED)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start_t)
            losses.append(float(loss))
        counts = _launch_counts()
        finite = all(bool(torch.isfinite(p).all()) and bool(torch.isfinite(p.grad).all())
                     for p in diff.param_leaves(params))
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
        ok_launches = all(per_step[k] == forward[k] > 0 for k in walk[label]) and all(
            counts[k] == 0 for k in walk["packet" if label == "bvh" else "bvh"])
        falling = losses[-1] < losses[0] and all(x == x for x in losses)
        median = statistics.median(seconds)
        medians.setdefault(label, []).append(round(median, 4))
        print(f"phase 13d train step: torus intersector={label} turn={turn} "
              f"checkpoint_bounces=True seconds_per_step={median:.4f} "
              f"steps={[round(x, 4) for x in seconds]} "
              f"paths_per_s={base.num_pixels * rpp / median:.6g} "
              f"losses={[f'{x:.6g}' for x in losses]} "
              f"launches_per_step={json.dumps(per_step)} "
              f"forward_launches={json.dumps(forward)} finite={finite} "
              f"loss_falling={falling} walk_launches_equal_forward={ok_launches}")
        if not (finite and falling and ok_launches):
            raise SystemExit(f"phase 13d failed: the {label} train step, turn {turn}")
    print(f"phase 13d train step: median seconds per step {json.dumps(medians)}")


def _cullhit_rows(base, last: int):
    """The centre 20-spp block of ``base`` traced as a render with
    ``sort_key="cullhit"`` traces it → yields (scene, block_lo, bounce,
    rows) for bounces 0..``last``; the caller must not change the rows."""
    import torch

    scene = base.with_config(rays_per_pixel=KEY_RPP, sort_key="cullhit")
    block_lo, block = _centre_block(scene, KEY_RPP)
    ids = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    for b, rows in _traced_rows(scene, ids, KEY_RPP, KEY_SEED):
        if b > last:
            return
        yield scene, block_lo, b, rows


def _key_check(scene, rows, label: str) -> float:
    """13e: the cullhit key kernel against its plain version on ``rows``,
    keys and live count in both count modes: 0 mismatched bits, else exit
    → the largest |Δ| (0)."""
    from cuda_raytracer_tpu_torch.ops.kernels import rays

    n, K, S = rows.shape[0], scene.num_clusters, scene.config.cull_split
    boxes = (scene.cluster_min, scene.cluster_max, K, S)
    bad, err = 0, 0.0
    for count in (False, True):
        got = rays.cullhit_keys(rows, *boxes, count, n)
        want = rays.plain_cullhit_keys(rows, *boxes, count, n)
        m, e = _bit_mismatch(got, want)
        bad, err = bad + m, max(err, e)
    print(f"phase 13e cullhit keys vs plain: {label} rays={n} clusters={K} "
          f"live={int(rays.rows_alive(rows).sum())} mismatched={bad}")
    if bad:
        raise SystemExit(f"phase 13e failed: the cullhit key kernel differs from its plain "
                         f"version ({label})")
    return err


def _key_times(scene, rows) -> dict:
    """13e: the cullhit key kernel's ms on ``rows`` and ray_keys' on copies
    of them out of L2 (as 6c times it)."""
    from cuda_raytracer_tpu_torch.ops.kernels import rays

    n = rows.shape[0]
    boxes = (scene.cluster_min, scene.cluster_max, scene.num_clusters, scene.config.cull_split)
    cold = _cold_copies(rows)
    return dict(ms=_cuda_ms(lambda: rays.cullhit_keys(rows, *boxes, False, n)),
                ray_keys_ms=_cuda_ms(lambda: rays.ray_keys(cold(), scene.min_coord,
                                                           scene.inv_extent, False, n)))


def _key_timing(scene, rows, label: str) -> dict:
    """13e: ``_key_times`` on ``rows``, the plain version's ms, the gates
    and boxes the kernel's rays tested beside the box tests a flat
    ascending scan needs, and the bound: bytes, or 17 operations a test
    the kernel made (``flat_bound_ms`` counts the flat scan's tests)."""
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import rays

    n, K, S = rows.shape[0], scene.num_clusters, scene.config.cull_split
    boxes = (scene.cluster_min, scene.cluster_max, K, S)
    r = _key_times(scene, rows)
    tests = torch.zeros(1, dtype=torch.int64, device=rows.device)
    rays.cullhit_keys(rows, *boxes, False, n, tests=tests)
    gated, flat = int(tests), rays.flat_box_tests(rows, *boxes)
    live = int(rays.rows_alive(rows).sum())
    plain_ms = _plain_ms(lambda: rays.plain_cullhit_keys(rows, *boxes, False, n))
    bytes_ms = (n * ROW_STATE_BYTES + n * 8 + 4 + K * S * 24) / PEAK_BYTES * 1e3
    ops_ms = gated * CULLHIT_BOX_OPS / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    flat_bound_ms = max(flat * CULLHIT_BOX_OPS / PEAK_FP32_FLOPS * 1e3, bytes_ms)
    print(f"phase 13e cullhit key timing: {label} ms={r['ms']:.4f} "
          f"ray_keys_ms={r['ray_keys_ms']:.4f} plain_ms={plain_ms:.2f} "
          f"gated_tests_per_live_ray={gated / max(live, 1):.2f} "
          f"flat_tests_per_live_ray={flat / max(live, 1):.2f} boxes={K * S} "
          f"ops_bound_ms={ops_ms:.4f} bytes_bound_ms={bytes_ms:.4f} "
          f"bound_share={bound_ms / r['ms']:.3f} flat_bound_ms={flat_bound_ms:.4f}")
    return dict(r, plain_ms=plain_ms, bound_ms=bound_ms, flat_bound_ms=flat_bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                gated_tests=gated, flat_tests=flat, live=live)


def phase_cullhit(full, lamp) -> tuple:
    """13e: the cullhit key on the centre block's bounces 0-3 and the
    lamp-scale torus's bounces 0-1 (``lamp``, 3,486 clusters: squeezed ids,
    a table staged above 48 KB), each traced as a cullhit render traces it,
    bounce 1 of each timed; then the torus at 1000×1000 × 8 spp with
    ``sort_key="cullhit"`` and with the Morton key, in turns (morton,
    cullhit, cullhit, morton): every framebuffer bit-identical → (the key
    kernel's result at the torus's bounce 1 with the lamp-scale's beside
    it, its launches in the first cullhit render)."""
    import torch

    result, worst = {}, 0.0
    for name, base, last in (("torus", full, 3), ("lamp-scale torus", lamp, 1)):
        for scene, block_lo, b, rows in _cullhit_rows(base, last):
            label = f"{name} centre block lo={block_lo} bounce={b}"
            worst = max(worst, _key_check(scene, rows, label))
            if b != 1:
                continue
            r = _key_timing(scene, rows, label)
            if name == "torus":
                result.update(r)
            else:
                result["lamp_scale"] = dict(
                    bounce=1, clusters=scene.num_clusters,
                    **{k: r[k] for k in ("ms", "bound_ms", "flat_bound_ms", "flat_tests",
                                         "gated_tests", "live")})
    result["max_abs_err"] = worst

    scenes = {"morton": full.with_config(rays_per_pixel=MESH_FEW_SPP),
              "cullhit": full.with_config(rays_per_pixel=MESH_FEW_SPP, sort_key="cullhit")}
    must = {"morton": AUTO_KERNELS + FORWARD_KERNELS,
            "cullhit": AUTO_KERNELS + ("cullhit_keys", "camera_rows", "rays_setup",
                                       "shade_rows")}
    must_not = {"morton": ("cullhit_keys", "bvh_walk") + FORWARD_NOT,
                "cullhit": ("ray_keys", "bvh_walk") + FORWARD_NOT}
    out = _turns([(label, scenes[label]) for label in ("morton", "cullhit", "cullhit",
                                                       "morton")],
                 must, must_not, "13e", "cullhit render")
    same = all(torch.equal(fb, out[0][1]) for _, fb, _, _, _ in out)
    seconds = _seconds_by_label(out)
    print(f"phase 13e cullhit render: spp={MESH_FEW_SPP} seconds {json.dumps(seconds)} "
          f"framebuffers_bit_identical={same}")
    if not same:
        raise SystemExit("phase 13e failed: the cullhit render differs from the Morton render")
    return result, out[1][4]["cullhit_keys"]


def phase_lamp_walk(device, lanes=WALK_LANES) -> dict:
    """13a at the lamp's scale: the torus at LAMP_SIZE (619,500 triangles,
    about the lamp's 619,350; its walk tables no longer sit easily in the
    50 MB L2), set up and timed; the walk bit-equal to its plain version on
    its centre block's bounces 0, 1 and 3, bounces 1 and 3 timed (also at
    ``lanes`` rays a warp) → bounce 1's check, with the scene as it was
    set up (``scene``)."""
    import torch
    from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
    from cuda_raytracer_tpu_torch.ops.kernels import traverse as traverse_kernel

    rpp, seed = 20, 80
    start = time.perf_counter()
    scene = scene_dsl.assemble_scene(builtin_scenes.parse_mesh_scene("torus", LAMP_SIZE),
                                     config_overrides=dict(intersector="packet"),
                                     device=device)
    setup = time.perf_counter() - start
    start = time.perf_counter()
    tb = traverse_kernel.walk_tables(scene)
    tables = time.perf_counter() - start
    mb = [x.numel() * x.element_size() / 1e6 for x in (tb.records, tb.triangles)]
    print(f"phase 13a lamp-scale torus: size={LAMP_SIZE} triangles={scene.triangle_count} "
          f"bvh_nodes={scene.bvh_node_count} setup_seconds={setup:.1f} "
          f"walk_tables_seconds={tables:.2f} records_MB={mb[0]:.2f} triangles_MB={mb[1]:.2f}")
    base, scene = scene, scene.with_config(rays_per_pixel=rpp, intersector="bvh")
    block_lo, block = _centre_block(scene, rpp)
    ids = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    result, worst = {}, 0.0
    for b, rows in _traced_rows(scene, ids, rpp, seed):
        if b > 3:
            break
        if b in (0, 1, 3):
            r = _walk_check(scene, rows, f"lamp-scale torus centre block lo={block_lo}", b,
                            timed=b > 0, lanes=lanes if b > 0 else ())
            worst = max(worst, r["max_abs_err"])
            result = r if b == 1 else result
    return dict(result, max_abs_err=worst, setup_seconds=setup, scene=base)


def phase_bvh(scenes) -> dict:
    """Phase 13: the BVH intersector and the cullhit sort key."""
    import torch

    rpp, seed = 20, 80
    full = scenes["torus"]
    # 13a-b: the torus's centre block at every bounce 0-9 (against the
    # packet engine at 0, 1 and 3), the glass torus's at bounces 0-3, each
    # timed at the kernel's pick of rays a warp and at WALK_LANES.
    checked = {"torus": range(10), "glass_torus": (0, 1, 2, 3)}
    result, worst, tail = {}, 0.0, []
    for name, bounces in checked.items():
        scene = scenes[name].with_config(rays_per_pixel=rpp, intersector="bvh")
        block_lo, block = _centre_block(scene, rpp)
        ids = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
        for b, rows in _traced_rows(scene, ids, rpp, seed):
            if b > max(bounces):
                break
            torus = name == "torus"
            r = _walk_check(scene, rows, f"{name} centre block lo={block_lo}", b, True,
                            plain_timed=torus and b == 1, lanes=WALK_LANES)
            worst = max(worst, r["max_abs_err"])
            if torus:
                tail.append(dict(bounce=b, rays=r["rays"], live=r["live"], ms=r["ms"],
                                 bound_ms=r["bound_ms"], max_pops=r["max_pops"],
                                 pops_per_live_ray=r["pops"] / max(r["live"], 1),
                                 lanes_ms=r["lanes_ms"]))
            if torus and b in (0, 1, 3):
                _walk_vs_packet(scene, scene.with_config(intersector="packet"), rows, b)
            if torus and b == 1:  # the kernel table: the sorted bounced block
                result = r
    print("phase 13a walk: torus centre block ms per bounce "
          + " ".join(f"{r['ms']:.4f}" for r in tail)
          + f" sum_ms={sum(r['ms'] for r in tail):.4f}")
    lamp = phase_lamp_walk(full.device)
    result = dict(result, max_abs_err=max(worst, lamp["max_abs_err"]), tail=tail,
                  lamp_scale=dict(bounce=1, ms=lamp["ms"], bound_ms=lamp["bound_ms"],
                                  max_pops=lamp["max_pops"],
                                  setup_seconds=lamp["setup_seconds"]))
    result["launches"] = phase_bvh_render(full)
    phase_bvh_train(full)
    key, key_launches = phase_cullhit(full, lamp["scene"])
    return {"bvh_walk": result, "cullhit_keys": dict(key, launches=key_launches)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    from cuda_raytracer_tpu_torch.ops.kernels import (
        bounce, build, cull, fused, fused1, rays, shade, sweep, traverse)

    device = torch.device("cuda")
    smi = _smi()
    print(smi)
    print(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    start = time.perf_counter()
    built = build.load_all(KERNEL_SOURCES)
    for module in (shade, cull, fused, fused1, sweep, bounce, rays, traverse):
        module.library()  # bind the argument types
    for name, b in built.items():
        regs = [ln.strip() for ln in b.log.splitlines() if "registers" in ln]
        print(f"phase 2 build: {name}.cu nvcc_seconds={b.seconds:.2f} {' | '.join(regs)}")
    print(f"phase 2 build: all seconds={time.perf_counter() - start:.2f}")
    from cuda_raytracer_tpu_torch.native import bvh_native

    start = time.perf_counter()
    bvh_native.library()
    print(f"phase 2 build: native BVH builder (g++) seconds={time.perf_counter() - start:.2f}")

    phase_kernel_vs_plain(device)
    main_path = phase_main_path(device)
    timing = phase_timing(device)
    scenes = {name: _mesh_scene(name, device) for name in ("torus", "glass_torus")}
    worst = phase_packet_vs_plain(scenes)
    bounce_check = phase_bounce_vs_plain(scenes, device)
    row_kernels = phase_row_kernels(scenes["torus"])
    mesh_launches, framebuffer_100 = phase_mesh_main_path(scenes["torus"])
    mesh_timing = phase_packet_timing(scenes["torus"])
    phase_mesh_profile(scenes["torus"])
    gated = phase_cli(scenes["torus"])
    diff_result = phase_diff(scenes["torus"], device)
    yard = [dict(r, fused1_ms=f["ms_chosen"]) for r, f in zip(
        mesh_timing["fused_closest_hit"]["tail"], mesh_timing["fused1_closest_hit"]["tail"])]
    packed, pack_result = phase_pack(scenes["torus"], device, yard)
    pack_launches = phase_pack_main_path(packed, scenes["torus"], framebuffer_100)
    del packed, framebuffer_100
    phase_sharding(scenes["torus"], gated["plain_cli"])
    bvh = phase_bvh(scenes)

    kernels = [{
        "name": "shade_trace",
        "route": "cuda",
        "source": "cuda_raytracer_tpu_torch/csrc/shade.cu",
        "replaces": "cuda_raytracer_tpu/ops/pallas/shade.py:94",
        "launches": main_path["launches"],
        "max_abs_err": timing["max_abs_err"],
        "agreement": timing["agreement"],
        "tolerance": f"max |d| < {AGREE_TOL} on >= {AGREE_MIN} of rays",
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        # The persistent grid, and the same pass at one block per SM.
        "grid": timing["grid"],
    }]
    for name, source, replaces in PACKET_KERNELS:
        t = mesh_timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": mesh_launches[name],
            "max_abs_err": max(worst[name], t["max_abs_err"]),
            "tolerance": "bit-equal",
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            # fused1: the centre block's bounces 0-9 at S = 1 and at the split;
            # fused (and the cull): its bounces 0-9, and the train step's pass.
            **({"tail": t["tail"]} if "tail" in t else {}),
            **({"train_tail": diff_result["train_tail"]}
               if name == "fused_closest_hit" else {}),
            **({"tail": [dict(bounce=r["bounce"], ms=r["cull_ms"], bound_ms=r["cull_bound_ms"])
                         for r in mesh_timing["fused_closest_hit"]["tail"]],
                "train_tail": [dict(bounce=r["bounce"], ms=r["cull_ms"],
                                    bound_ms=r["cull_bound_ms"])
                               for r in diff_result["train_tail"]]}
               if name == "cull_tiles" else {}),
        })
    b = mesh_timing["shade_rows"]
    kernels.append({
        "name": "shade_rows",
        "route": "cuda",
        "source": "cuda_raytracer_tpu_torch/csrc/bounce.cu",
        # No TPU kernel: the JAX package's process_rays, fused by XLA.
        "replaces": "cuda_raytracer_tpu/render/wavefront.py:275",
        # The 100-spp torus render of phase 7 through "auto".
        "launches": mesh_launches["shade_rows"],
        "max_abs_err": max(bounce_check["max_abs_err"], b["max_abs_err"],
                           row_kernels["bounce_max_abs_err"]),
        "agreement": b["agreement"],
        "tolerance": f"max |d| < {AGREE_TOL} on >= {AGREE_MIN} of rays",
        "ms": b["ms"],
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
    })
    for name, replaces, launches in (
            # JAX closest_hit (its sphere part and the packet path's ray tiles),
            # morton.ray_sort_keys, rng.uniforms: not TPU kernels, XLA ops.
            ("rays_setup", "cuda_raytracer_tpu/render/wavefront.py:75",
             mesh_launches["rays_setup"]),
            ("ray_keys", "cuda_raytracer_tpu/ops/morton.py:51", mesh_launches["ray_keys"]),
            # JAX generate_rays + make_initial_state (the port's pack_rows):
            # a block's starting rows; the 100-spp render's blocks.
            ("camera_rows", "cuda_raytracer_tpu/ops/camera.py:33",
             mesh_launches["camera_rows"]),
            # JAX reorder_rays' gather of the packed state (packed[order]);
            # the 100-spp "auto" render's sorted bounces (none: the walk on
            # the card is not reordered).
            ("reorder_rows", "cuda_raytracer_tpu/render/wavefront.py:754",
             mesh_launches["reorder_rows"]),
            # The torch shading's five draws a bounce and a graph-building
            # trace's camera: the 5 timed "auto" train steps (checkpointed);
            # no forward render launches it.
            ("pcg_draws", "cuda_raytracer_tpu/ops/rng.py:121",
             diff_result["train_launches"]["pcg_draws"])):
        r = row_kernels[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "cuda_raytracer_tpu_torch/csrc/rays.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": r["max_abs_err"],
            "tolerance": "bit-equal",
            "ms": r["ms"],
            # camera_rows: the sequence it replaced (the PCG draw kernel and
            # torch), on the card.
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # rays_setup: torch.stack of its ray tiles' rows; camera_rows:
            # torch.cat of its rows' columns; the packing only. reorder_rows:
            # torch.index_select of the rows.
            "library_ms": r["library_ms"],
            **({"render_launches": mesh_launches["pcg_draws"]} if name == "pcg_draws" else {}),
            **({k: r[k] for k in ("plain_torch_pcg_ms", "old_device_ops",
                                  "old_device_busy_ms", "old_host_enqueue_ms",
                                  "host_enqueue_ms")} if name == "camera_rows" else {}),
            **({k: r[k] for k in ("warm_ms", "int32_ms", "library_warm_ms", "launch_shapes")}
               if name == "reorder_rows" else {}),
        })
    kernels.append({
        "name": "cull_gated",
        "route": "cuda",
        "source": "cuda_raytracer_tpu_torch/csrc/cull.cu",
        "replaces": "cuda_raytracer_tpu/ops/pallas/cull.py:104",
        "launches": gated["launches"],
        "max_abs_err": gated["max_abs_err"],
        "tolerance": "bit-equal",
        # The hierarchical cull as the path runs it: one launch, the super
        # boxes tested in the kernel; beside it the two-step form (the
        # super-box pre-pass's ops, then the kernel reading gate words) and
        # the flat cull on the same rays.
        "ms": gated["ms"],
        "two_step_ms": gated["kernel_ms"] + gated["prepass_ms"],
        "gate_words_kernel_ms": gated["kernel_ms"],
        "prepass_ms": gated["prepass_ms"],
        "flat_cull_ms": gated["flat_ms"],
        "plain_ms": gated["plain_ms"],
        "bound_ms": gated["bound_ms"],
        "bound_by": gated["bound_by"],
        "library_ms": None,
    })
    kernels.append({
        "name": "sweep_pairs",
        "route": "cuda",
        "source": "cuda_raytracer_tpu_torch/csrc/sweep.cu",
        "replaces": "cuda_raytracer_tpu/ops/pallas/sweep.py:149",
        # The sweeps of the 5 timed "pallas" train steps (checkpointed).
        "launches": diff_result["launches"],
        "max_abs_err": diff_result["max_abs_err"],
        "tolerance": "bit-equal",
        "ms": diff_result["ms"],
        "fused_same_rays_ms": diff_result["fused_ms"],
        "plain_ms": diff_result["plain_ms"],
        "bound_ms": diff_result["bound_ms"],
        "bound_by": diff_result["bound_by"],
        "library_ms": None,
    })
    kernels.append({
        "name": "fused1_closest_hit_pack2",
        "route": "cuda",
        "source": "cuda_raytracer_tpu_torch/csrc/fused1.cu",
        "replaces": "cuda_raytracer_tpu/ops/pallas/fused1.py:148",
        # The packed torus render of phase 11c (1000×1000, 100 spp).
        "launches": pack_launches,
        "max_abs_err": pack_result["max_abs_err"],
        "tolerance": "bit-equal",
        "ms": pack_result["ms"],
        "tail": pack_result["tail"],
        "pack1_same_rays_ms": pack_result["pack1_ms"],
        "plain_ms": pack_result["plain_ms"],
        "bound_ms": pack_result["bound_ms"],
        "bound_by": pack_result["bound_by"],
        "library_ms": None,
    })
    for name, source, replaces, note in (
            # JAX's lockstep while_loop walk, not a TPU kernel; launches: the
            # 100-spp torus render through intersector="auto", the main path
            # (phase 7; phase 13c's explicit "bvh" render is bvh_render_launches).
            ("bvh_walk", "cuda_raytracer_tpu_torch/csrc/traverse.cu",
             "cuda_raytracer_tpu/ops/traverse.py:52", "bounce 1 of the centre block"),
            # JAX first2_cluster_keys, plain XLA; launches: the 8-spp torus
            # render with sort_key="cullhit" (phase 13e).
            ("cullhit_keys", "cuda_raytracer_tpu_torch/csrc/rays.cu",
             "cuda_raytracer_tpu/ops/morton.py:79", "bounce 1 of the centre block")):
        r = bvh[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": mesh_launches[name] if name == "bvh_walk" else r["launches"],
            "max_abs_err": r["max_abs_err"],
            "tolerance": "bit-equal",
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "timed_on": note,
            # The cullhit key: its bound counts the gates and boxes its rays
            # tested; flat_bound_ms the box tests of a flat ascending scan.
            **({"ray_keys_same_rows_ms": r["ray_keys_ms"], "gated_tests": r["gated_tests"],
                "flat_tests": r["flat_tests"], "flat_bound_ms": r["flat_bound_ms"],
                "lamp_scale": r["lamp_scale"]}
               if name == "cullhit_keys" else {}),
            # The walk: every bounce of the centre block (also at
            # WALK_LANES), and bounce 1 of the lamp-scale torus.
            **({"tail": r["tail"], "lamp_scale": r["lamp_scale"],
                "bvh_render_launches": r["launches"]} if name == "bvh_walk" else {}),
        })
    # Each kernel's launches on its path beside its time and bound, ranked by
    # the device time a path loses to it: launches x (ms - bound_ms).
    for row in sorted(kernels, key=lambda r: -r["launches"] * (r["ms"] - r["bound_ms"])):
        print(f"kernel rank: {row['name']} launches={row['launches']} ms={row['ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} lost_ms="
              f"{row['launches'] * (row['ms'] - row['bound_ms']):.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
