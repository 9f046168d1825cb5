#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. build every CUDA kernel of ``multimotionfusion_tpu_torch/csrc`` (nvcc, in
   parallel) and print the build seconds and each kernel's registers, shared
   memory, stack frame and spills (ptxas -v); require K5's step kernels and
   K3's one-launch SO(3) iteration (``REGISTER_ONLY``) to have no stack
   frame and no spills, and K4's passes, K8's and K14's association kernels
   and K21's three kernels (``NO_SPILLS``) no spills;
2. run ``MultiMotionFusionTorch`` on the card with the static 640x480
   configuration (``odom_init=""``, single model, 2^20 surfel capacity) over
   the synthetic scene (1 init frame + 45 frames), print the median and p75
   ms/frame (CUDA events, after 5 warm-up frames), the surfel count, the camera ATE
   against ground truth and each kernel's launch count; require the ATE and
   rotation bounds of tests/test_ate_gate.py and every kernel launched;
3. go on with the same engine: 10 frames timed per stage of the frame step
   (host clock and CUDA events around each named stage), then 10 frames under
   torch.profiler; print wall ms/frame, each stage's host and stream ms/frame,
   device kernel ms/frame by kernel, launches per frame and the device's busy
   share;
4. sync check: 10 more frames (one of them a compaction frame) with
   ``torch.cuda.set_sync_debug_mode`` on around ``engine._frame_core``; print
   the number of synchronising calls, which must be 0;
4b. the keypoint-seeded path: a second engine with the default
   ``odom_init="kp"`` (patch detector, 512 keypoints, 4096 tracks, 200
   RANSAC candidates) over the same 1 + 45 frames, launch counts reset before
   it: ATE and rotation bounds, every kernel of the path launched (the
   keypoint kernels K19-K21 and seed_select included), no ``*_plain`` call,
   the frames whose keypoint seed passed its gate (read once at the end),
   median ms/frame; then its stage breakdown (a ``sparse`` stage) and a sync
   check over 10 kp frames;
5. replay the inputs each kernel saw at one steady-state frame of phase 2
   (the compaction frame's clean and the first frame's compaction from
   frames of their own) through the kernel and through its plain PyTorch
   version on the card, check them within the tolerances of
   ``multimotionfusion_tpu_torch.kernels.checks``, and time kernel, plain
   version and, where one exists, a single PyTorch library call computing the
   same function (CUDA events over back-to-back calls, so host launch overhead
   counts where the host is slower), plus the kernel's device time alone
   (``_device_profile``: torch.profiler, every device event of 20 calls
   after 10 warm-up calls; by kernel for K4, K5's steps, K8, K11 and K14;
   for K1's filter, K2's two sides (each side every level in one launch),
   K13 and K19's patch_score also cold, ``device_ms_cold``: a 64 MB fill before every call flushes
   the L2 cache, its kernel left out by name;
   K4's sums also bit-equal to the block-order float32 sum of the call's
   partials; the one-launch SO(3) iteration also bit-equal to its two
   halves' standalone kernels, ``so3_reduce`` and ``so3_step``, whose lines
   replay the iteration's inputs and count no launch on the path); run the
   whole odometry loop on the card and, from the
   same inputs, the plain loop on the CPU; the same for the keypoint
   kernels on the inputs of one steady-state kp frame (``nms_topk`` also on
   a random-weight SuperPoint heat map and on a plateau), the seeded
   odometry loop, and the sparse block (detect -> track table -> RANSAC on
   the card against the plain chain on the CPU, same uniforms);
5b. the multi-model path (``enable_multi_model=True``, external masks:
   ``segmentation.mode="precomputed"``, 5 object slots of 2^16 surfels,
   2^19 global surfels, spawn cool-down 4, ``odom_init="kp"``): the
   reference package's bench.py::bench_multi_model scene (five textured
   spheres orbiting in front of a static camera) at 640x480, the masks
   computed here by a ray-sphere test (id k + 1 where sphere k is the
   front-most surface), 1 init frame + 40 frames with launch counts reset
   before: frames 11-20 under the sync check (a spawn and a compaction
   frame among them: 0 synchronising calls), frames 21-40 timed; print the
   per-frame active model count, the spawn ticks, median and p75 ms/frame,
   each kernel's launches and each object's error at its sphere's centre
   (``sphere_errors``); require 5 active models at the end, camera drift < 0.08 m
   (tests/test_five_movers.py's bound), each sphere within 2 cm of its
   centre on every frame, every kernel of the path launched
   and no ``*_plain`` call; then its stage breakdown; then each new kernel
   (K11 per level and its owner prep, every level in one launch, K5's
   M-wide steps, K12, K14 fuse and clean, K10 composite) against its plain
   version on the inputs of the last frame, and the composite odometry loop
   on the card against the plain loop on the CPU;
5c. the flow-CRF path (multi_flow_crf): the same scene and configuration
   with the default ``segmentation.mode="flow_crf"`` and no masks, 1 + 40
   frames with launch counts reset before: frames 11-20 under the sync check
   (a spawn frame among them), frames 21-40 timed; per frame the active
   models, the camera drift, the segment areas and ms; the spawn ticks; each
   slot associated with the sphere whose ray-sphere mask overlaps the slot's
   mask most on its spawn frame, and that sphere's centre error (printed,
   not bounded); require at least one spawn (one of them in the sync
   window), every kernel of the path launched (K13, K15-K18 with the multi
   step's) and no ``*_plain`` call; then its stage breakdown (the
   segmentation's spans: render_depths, flow, unaries, crf, components);
   the same journey again with the engine seeds FLOW_SEEDS (other RANSAC
   draws): the largest camera drift per seed must not be worse than the
   reference package's own over seeds (``journey_tests``: one-sided tests
   at JOURNEY_ALPHA of the share below 0.08 m and of the drifts); then
   K13, K15 (the whole flow, one cluster launch, bit-equal), K16 (one
   iteration and all ten), K17 (also on a 240x160 stack) and K18's three
   stages against their plain versions on the inputs of the last frame, and
   K21's two batches of that frame (the 6 per-model seeds over shared
   points, the 8 back-dating fits over per-fit points) and the back-dating
   batch with every active track selected: each row bit-equal to a one-fit
   launch, the batch within the one-fit line's tolerances of the plain
   version; phase ``draws``: the engine's per-fit draws (``draw_uniforms``)
   on a CUDA generator equal to sequential ``torch.rand`` calls;
5c'. the legacy CoFusion CRF path (multi_legacy_crf): the flow-CRF phase's
   scene and configuration with ``segmentation.mode="crf"`` (the per-slot
   step; the odometry's error images on), 1 + 40 frames with launch counts
   reset before, frames 11-20 under the sync check, frames 21-40 timed;
   per frame the active models, the camera drift, the segment areas and ms;
   the spawn frames, the launches a frame and each spawned object's error at
   its sphere's centre; require every kernel of the path launched (K24a-c,
   K4's error images, K17 at 640x480), no ``*_plain`` call, and the active
   count per frame and the spawn frames equal to the reference package's
   (REF_LEGACY_*); then its stage breakdown; then K4's error-image mode,
   K24a (centres and assignment, every pass from the plain chain), K24b,
   K24c (plan; one and ten mean-field steps in one launch, each step's Q
   also bit-equal to the one-step kernel's chain) and K17 at 640x480 with 7
   labels against their plain versions on the inputs
   of the last frame; the same kernels' lines also give each library
   yardstick's device time (``library_device_ms``);
5c''. SLIC on hand-made label images (``checks.slic_label_cases``, 487x651:
   the regular grid, whose last row and column of cells own the pixels
   beyond 480 and 640; a superpixel of > 20,000 pixels that spans many of
   the kernels' list chunks, empty superpixels, labels five cells from their
   pixel's cell, speckle on the edge cells): the boxes, centres and
   assignment of K24a and the means of K24b for N = 1, 13 and 40 images
   against the plain versions on the CPU, boxes and labels exact, sums
   bit-equal;
5c'''. K17 on hand-made [6, H, W] mask stacks (phase ``components_cases``,
   ``checks.component_cases`` at 480x640, 120x160 and 487x651: a spiral
   longer than the 64 sweeps across tile edges and corners, two equal
   squares in different tiles, an all-True and an empty label, a one-cell
   component in the last row and column, blobs) against the plain version
   on the CPU, kept cells and sizes exact;
5c''''. K5's solve on hand-made systems (phase ``solve_cases``,
   ``checks.solve_cases``: well-conditioned, diagonals six decades apart, the
   sphere-spin near-degeneracy either side of the 1e-4 cut, rank-deficient,
   all zero, inf, NaN, repeated eigenvalues and exact ties; N = 6 and 3)
   through the test entry ``mmf_solve_cases``, x and the eigenvalues
   bit-equal to the float32 emulation ``checks.solve_preconditioned_emulated``;
5c'''''. the work of K5's solves on the systems recorded for the ``gn_step``
   and ``gn_step_multi`` lines (phase ``solve_work``): sweeps and rotations
   counted on the CPU by the emulation (``checks.jacobi_work``), not
   measured on the card;
5c. the append scan of K8's and K14's association kernels on
   hand-made flags and owners (phase ``scan_cases``, ``checks.scan_cases``:
   no new flag, all new, one model, M = 8, pixels with no owner, appends
   clipped by, at, one below and far below each segment's room, n not a
   multiple of the 256-pixel tile) through their test entries
   (``mmf_fuse_scan_cases``, ``mmf_fuse_flat_scan_cases``): prefix and
   counts exact against torch.cumsum; K15 on hand-made image pairs (phase
   ``flow_cases``: 640x480 at 1/4, 487x651 whose 121 CRF rows do not divide
   by the cluster, 640x480 at 1/2 whose bands do not fit a block's shared
   memory), K20's update on hand-made tables (phase
   ``track_cases``) and its match on hand-made descriptors (phase
   ``match_cases``), each bit-equal to the plain version on the CPU; K18's
   finish on hand-made segment inputs (phase ``finish_cases``: no new
   label, a new label hugging each border and one inside, objects at and
   one cell under the minimum-cells gate, a segment without depth, M = 16,
   487x651) and K19's top-K on hand-made heat maps (phase ``topk_cases``:
   fewer peaks than K, a negative conf_thresh, a plateau with more peaks
   than K, 487x651, K the pixel count, a 1080x1920 plateau), masks, counts and the top-K exact
   against the plain versions on the CPU, the finish's mean and std
   bit-equal to ``checks.seg_stats_emulated``; K10 on hand-made index maps
   (phase ``splat_cases``, ``checks.SPLAT_CASES``: sizes off the 32 x 8
   tile, windows 1, 2, 3, 5 and 7, static, slot-pointer and composite modes,
   model boundaries inside every tile, exact and near depth ties, a tile
   without a surfel, fill-in with and without its gate, passthrough) and
   K14's clean on hand-made flat stores (phase ``clean_flat_cases``,
   ``checks.CLEAN_FLAT_CASES``: stale ALIVE past the counts, +0 and -0
   ALIVE, penalties of exactly 1, redundancy and z culls, windows 4 and 5),
   every output bit-equal to the plain version on the card; K11's owner
   prep on hand-made owners (phase ``owner_cases``, ``checks.OWNER_CASES``:
   487x651 and other sizes off the 32 x 8 tile, 1, 2 and 3 levels, owners
   hugging every border of the mask and the prediction, no-owner ids, one
   model) exact against the plain version on the card; K18's unaries on
   hand-made inputs (phase ``unaries_cases``, ``checks.UNARY_CASES``: no
   track, no new label, a grid of 121 x 163 cells, every track in one
   cell, 31 models, 9,000 tracks, inf and NaN velocities, inactive models)
   within ``check_seg_unaries``' tolerance of the plain version on the card;
   K13 on hand-made stores (phase ``depth_cases``, ``checks.DEPTH_CASES``:
   every count 0, full buckets, one model, 31 slots, strides of 1 and 2
   (an odd object bucket), every surfel in one cell, z at the max depth,
   behind the camera and on the projection's rounding edge, time - last_t
   at the window, a confidence gate some surfels miss, a 122 x 163 grid),
   coverage exact and depth within one log-depth bin of the plain version
   on the card, the keys' scratch all KEY_INVALID after every call; K19's
   patch_score on hand-made images (phase ``score_cases``,
   ``checks.SCORE_CASES``: 487x651, 9x11, 16x16 (all border), a constant
   image, step edges whose Sobel truncation flips sign, sizes one off the
   32 x 20 tile each way) bit-equal to the plain version on the card; K7/K9
   on hand-made maps (phase ``clean_cases``, ``checks.CLEAN_CASES``,
   ``COMPACT_CASES`` and ``SEGMENT_CASES``: 487x651, slots not a multiple of
   the 256-slot tile, windows 4 and 5, a scalar gate and a slot's gate by
   pointer, the skip flag set and unset, stale ALIVE past the count, +0 and
   -0 ALIVE, penalties of exactly 1, every slot kept, none kept, a count of
   0, kept columns reaching the capacity, the capacity above the columns,
   the multi-model repack with an empty and a full segment and without
   slots): the flag frame into a map and in place, the compaction frame,
   ``compact`` and the repack, the map, the count and the packed map
   bit-equal to the plain versions on the card, the verdicts' scratch back
   to its fill after every launch, and each compaction launch after a call
   the wrapper refuses over as many tiles left the scan words as they
   were; K24c on hand-made superpixels (phase ``lcrf_cases``,
   ``checks.LCRF_CASES``: one superpixel, whose row sum hits the 1e-12
   clamp, 1,203 (rows not a multiple of a block's 8), 2 and 16 labels, the
   new-model class off, an inactive model, NaN and +-inf ICP errors, equal
   features whose argmax ties, 3,600 and 8,040 superpixels (1280x720 and
   1920x1080 at 16 px: the mean field's variants with the kernel rows, and
   then Q too, read from L2)) within ``check_lcrf_plan``'s and
   ``check_lcrf_iterate``'s tolerances;
5d. five_movers: tests/test_five_movers.py's configuration and 17-frame
   journey at 160x120 (the scene from the port's own io/synthetic.py) on
   the card with the engine seeds FIVE_SEEDS: on every seed five spawns at
   least two frames apart and opposing x motions; the camera drift and the
   share of seeds holding all of that test's assertions (also five active
   over the last three frames, more than 120 pixels per label, camera
   within 0.08 m) not worse than the reference package's on the same seeds
   (``journey_tests``);
5e. relocalisation (``reloc_mode``), launch counts reset before each run:
   tests/test_reloc.py's journey at 640x480 (the default FernConfig: 500
   ferns at ÷8): 4 healthy frames, 13 blackout frames, one frame near pose
   1; lost must be set by the blackout, the map's count must not move while
   lost, lost must clear on the reappearance and the pose land within
   RELOC_BOUND_M of the truth; then the bench scene with reloc_mode on: 20
   frames timed, its stage breakdown and a sync check (0 synchronising calls,
   lost never set);
5f. loop closure (``close_loops``): tests/test_loop_closure.py's journey at
   640x480 with 2^20 surfels and 256 deformation nodes: six frames, a 3 cm
   self-consistent drift injected, a revisit of frame 0; a match accepted,
   the pose error after below 0.4 x before, the pose moved > 0.01; every
   frame under the sync check with exactly one host read (the match flag);
   the matching frame's device time split into find_frame, optimise and
   apply_to_map;
5g. the multi-model path with external masks and both flags on (phase 5b's
   scene and frames): lost never set, a keyframe inserted after the first,
   5 active models, camera drift < 0.08 m, no loop closure accepted with a
   mean constraint error >= 0.02; then K22 (the ÷f frame, encode + block_hd
   + argmax + fetch, insert, the photometric check; on the reloc journey's
   inputs) and K23 (the constraint points, the map; on the loop-closure
   journey's matching frame) against their plain versions;
6. phase ``device_counts``: K15's device launches a flow-CRF frame (at most
   2), a tracker update's device operations (at most 3, no memset), the
   device launches of one K18 finish and one K19 top-K (at most 2 each), of
   one K1 filter (1) and of each K2 side (at most 2; both sides at most 4 a
   static frame), of one K10 resolve (1, static and composite), of one
   K14 clean (at most 3), of one K11 owner prep (1, every level), of one
   K18 unaries call (1), of one K13 render (at most 2, no ``fill_int``
   among its kernels), of one K19 patch_score (1), of one K7/K9 clean (a
   flag frame at most 2, a compaction frame at most 3), of one ``compact``
   (1) and one multi-model repack (1), and K24c's launches a legacy frame
   (plan and mean field, at most 3), from the kernel lines' profiles;
7. print ``{"kernels": [...]}``, the card's name and power limit, and as the
   last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from collections import defaultdict

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
N_FRAMES = 45
WARMUP = 5
STAGE_FRAMES = 10
SYNC_FRAMES = 10
# frame whose kernel inputs are replayed: the last one, where the most surfels
# have reached the confidence gate (the prediction grows from empty at frame
# ~25 to ~10% of the pixels at frame 45); frame i runs at tick i + 1, so the
# compaction frame (tick % compact_every == 0) replayed is frame 39
CAPTURE_AT = N_FRAMES
CAPTURE_COMPACT_AT = 39
DEVICE = "cuda"
LEVELS = (0, 1, 2)
# every wrapper launch key of the frame step (init included)
MAIN_PATH = (
    ("frame_maps.filter", "frame_maps.surfels", "odo_init", "so3_iteration", "gn_step",
     "zbuffer", "fuse", "clean", "clean.compact", "compact", "splat_resolve")
    + ("pyramid.frame", "pyramid.pred")
    + tuple(f"gn_reduce.L{lvl}" for lvl in LEVELS)
)
KP_PATH = MAIN_PATH + ("patch_score", "nms_topk", "patch_desc", "mutual_match", "track_update",
                       "ransac_fit", "seed_select")
MULTI_FRAMES = 40
MULTI_SYNC = (11, 21)  # frames 11..20 = ticks 12..21: spawns at 14 and 18, compaction at 16
MULTI_TIMED_FROM = 21
MULTI_PATH = (
    ("frame_maps.filter", "frame_maps.surfels", "so3_iteration", "compact", "compact.segments",
     "zbuffer.flat",
     "fuse_flat", "clean_flat", "splat_resolve.composite", "patch_score", "nms_topk",
     "patch_desc", "mutual_match", "track_update", "ransac_fit", "multi_init", "multi_seed",
     "multi_arbitrate", "gn_step_multi", "pyramid.frame", "pyramid.pred")
    + ("owner_prep",)
    + tuple(f"gn_multi.L{lvl}" for lvl in LEVELS)
)
# The flow-CRF journeys depend on the engine's seed (its RANSAC uniforms), in
# the reference package as in the port, so the card is held to the
# reference's own distribution over seeds (PERF.md section 6): each
# reading below on the CPU, by
#   python -m tests.torch_five_movers --seeds 0-47 --packages reference
#   python tests/torch_multi_spheres.py --div 1 --flow-crf --chip-capacities \
#       --seeds N --packages reference   (N = 0, 2, 4, 6)
# The card runs the same seeds (FIVE_SEEDS; seed 0 and FLOW_SEEDS) and fails
# where a one-sided test at JOURNEY_ALPHA finds its journeys worse: fewer
# seeds below 0.08 m (tests/test_five_movers.py's bound) or passing all of
# that test's assertions (Fisher's exact test), or larger drifts (the
# Mann-Whitney U test).
REF_FIVE_CAMERA_M = (0.06927470862865448, 0.0643434226512909, 0.07273944467306137,
    0.07370460778474808, 0.0692746490240097, 0.06075234338641167, 0.08768142014741898,
    0.07008031755685806, 0.08948014676570892, 0.07585757225751877, 0.06927470862865448,
    0.06177077442407608, 0.0724828764796257, 0.06927470862865448, 0.06927470862865448,
    0.06117508187890053, 0.07364250719547272, 0.046321846544742584, 0.06661112606525421,
    0.08232472091913223, 0.06661113351583481, 0.07694651931524277, 0.04385105147957802,
    0.07008031755685806, 0.053002797067165375, 0.06927470862865448, 0.06905288994312286,
    0.06927511096000671, 0.0765383318066597, 0.07220902293920517, 0.06927470862865448,
    0.06342706829309464, 0.0682300329208374, 0.06104300543665886, 0.07274022698402405,
    0.0692746639251709, 0.08141686767339706, 0.06779580563306808, 0.08141608536243439,
    0.048052020370960236, 0.06324230134487152, 0.06927477568387985, 0.06927470862865448,
    0.07366485893726349, 0.07370460778474808, 0.05341135337948799, 0.07162389904260635,
    0.0727400928735733)
REF_FIVE_PASSING = (0, 4, 10, 13, 14, 15, 17, 24, 25, 27, 30, 35, 41, 42)
REF_FLOW_DRIFT_M = (0.04343545064330101, 0.05793355405330658, 0.05688067153096199,
                    0.033097345381975174)
JOURNEY_ALPHA = 0.01
DRIFT_BOUND = 0.08
FLOW_SEEDS = tuple(range(1, 12))
FIVE_SEEDS = tuple(range(48))
# the flow-CRF segmentation's kernels on top of the multi step's
FLOW_PATH = MULTI_PATH + (
    "zbuffer.depths", "flow", "crf.plan", "crf.iter",
    "components", "segment.unaries", "segment.fuse", "segment.finish")


# the legacy CoFusion CRF's per-slot step (segmentation.mode="crf"): the
# static step's kernels for every model (the odometry with K4's error-image
# mode), the keypoints, SLIC and the superpixel CRF (K24a-c) and K17
LEGACY_PATH = (
    ("frame_maps.filter", "frame_maps.surfels", "so3_iteration", "gn_step", "seed_select",
     "gn_reduce.error_images", "zbuffer", "fuse", "clean", "clean.compact", "compact",
     "splat_resolve", "patch_score", "nms_topk", "patch_desc", "mutual_match",
     "track_update", "ransac_fit", "slic.centres", "slic.assign", "sp.downsample", "sp.upsample",
     "legacy_crf.plan", "legacy_crf.mean_field", "components", "pyramid.frame", "pyramid.pred")
    + tuple(f"gn_reduce.L{lvl}" for lvl in LEVELS)
)
# The legacy CRF journey's lifecycle as the reference package runs it on the
# CPU, on the same frames at the same size (640x480, chip_smoke's
# capacities):
#   python tests/torch_legacy_spheres.py --div 1 --chip-capacities --packages reference
# the active model count per frame (frame 0 the init frame) and the frames
# with a spawn. On these orbits (0.12 m, ~1.5 cm a frame) no superpixel's
# ICP error reaches the new-model class, so the reference spawns nothing.
REF_LEGACY_ACTIVE = (0,) * (1 + MULTI_FRAMES)
REF_LEGACY_SPAWN_FRAMES = ()
# device ms and device launches a frame of every path before K18's
# one-launch finish and K19's two-launch top-K (PERF.md section 5: the first
# run of that tree), printed beside this run's stage phases
EARLIER_DEVICE = {"stages": (0.899, 180.2), "kp_stages": (1.084, 246.2),
                  "multi_stages": (3.427, 603.5), "flow_crf_stages": (3.038, 609.5),
                  "legacy_crf_stages": (4.376, 1275.0)}
# the odometry's step and reduction kernels and the fusion's, shown apart in
# the stage phases
GN_KERNELS = ("gn_step", "so3_step", "so3_iteration", "so3_pass", "pass1", "pass2", "finalize",
              "Memset")
# K21's kernels, shown apart in the stage phases
RANSAC_KERNELS = ("valid_positions", "candidates", "choose")
FUSE_KERNELS = ("assoc", "scan_new", "scan_models", "arbitrate", "apply", "fill_int")
# kernels of gn_step.cu that must keep their solve in registers (ptxas -v):
# K5's steps and K3's one-launch SO(3) iteration, whose last block steps
REGISTER_ONLY = ("so3_step", "gn_step", "gn_step_multi", "so3_iteration")
# kernels that must not spill (ptxas -v): K4's passes, K8's and K14's
# association with the append scan, K21's three kernels
NO_SPILLS = {"gn_reduce": ("pass1", "pass2"), "fuse": ("assoc",), "fuse_flat": ("assoc",),
             "ransac": ("valid_positions", "candidates", "choose")}


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_GAP_S = 0.05


def _device_profile(fn, reps: int = 20, warm: int = 10, tries: int = 3, before=None,
                    skip: tuple = ()):
    """Device work one call of ``fn`` enqueues, every event counted: ``warm``
    calls first inside the profile (its first device events go unrecorded),
    then ``reps`` calls in a marked range, and only the device events that
    start in it. The device idles ``PROFILE_GAP_S`` between the two, and the
    range is widened by half that gap: the profiler maps the
    device's clock onto the host's, and a skew of that map must move no warm
    call's event into the range (a warm call's three launches once made a
    tracker update count 3.15) and no timed event out of it. Returns (ms,
    device launches, {kernel name: ms}), all per call. A profile that
    recorded no device event is taken again; (None, None, {}) (not
    measured) after ``tries`` such. ``before`` runs ahead of every call, and
    device events whose name holds one of ``skip`` are left out."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(warm):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_GAP_S)
            with torch.profiler.record_function("mmf_timed_calls"):
                for _ in range(reps):
                    if before is not None:
                        before()
                    fn()
                torch.cuda.synchronize()
        marks = [e for e in prof.events() if e.name == "mmf_timed_calls"]
        if not marks:
            continue
        half = PROFILE_GAP_S * 1e6 / 2  # us
        t0, t1 = marks[0].time_range.start - half, marks[0].time_range.end + half
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and t0 <= e.time_range.start <= t1 and e.name != "mmf_timed_calls"
                  and not any(k in e.name for k in skip)]
        if not events:
            continue
        by_name = defaultdict(float)
        for e in events:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / reps
        total = sum(e.time_range.elapsed_us() for e in events)
        return total / 1e3 / reps, len(events) / reps, dict(by_name)
    return None, None, {}


def _kernel_name(event: str) -> str:
    """A device event's short name: a kernel's unqualified name
    (``(anonymous namespace)::assoc(...)`` -> ``assoc``), else the event's."""
    if event.startswith("Mem"):  # Memcpy / Memset
        return event[:60]
    name = event.replace("(anonymous namespace)::", "").removeprefix("void ")
    name = name.split("(", 1)[0].split("<", 1)[0]
    return name.rsplit("::", 1)[-1][:60]


def _device(fn, by_kernel: bool = False) -> dict:
    """``device_ms`` and ``device_launches_per_call`` of one call of ``fn``
    (``_device_profile``); with ``by_kernel``, also each kernel's ms a call
    (``device_ms_by_kernel``) by its short name."""
    ms, n, by_name = _device_profile(fn)
    out = dict(device_ms=ms, device_launches_per_call=n)
    if by_kernel:
        merged = defaultdict(float)
        for name, v in by_name.items():
            merged[_kernel_name(name)] += v
        out["device_ms_by_kernel"] = dict(merged)
    return out


# the cold readings: a fill of FLUSH_BYTES (more than the H100's 50 MB L2)
# before every call evicts its inputs; the fill's kernel is left out by name
FLUSH_BYTES = 64 << 20
FLUSH_KERNEL = "FillFunctor"
_flush = []


def _cold(fn) -> dict:
    """``device_ms_cold``: ``_device_profile``'s reading with the L2 cache
    flushed before every call (inputs read from device memory)."""
    if not _flush:
        _flush.append(torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=DEVICE))
    ms, _, _ = _device_profile(fn, before=lambda: _flush[0].fill_(1.0), skip=(FLUSH_KERNEL,))
    return dict(device_ms_cold=ms)


def _bound(bytes_moved: float, flops: float):
    tb, tf = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def static_frames(n_frames: int, odom_init: str = ""):
    """(config, frames, ground-truth poses) of the static 640x480 step: the
    reference package's bench.py::bench_static (same scene, camera motion and
    2^20 surfel capacity), 1 init frame + ``n_frames`` frames; ``odom_init``
    "kp" keeps the default KeypointConfig and RansacConfig."""
    from multimotionfusion_tpu_torch.config import CameraModel, EngineConfig, SurfelConfig
    from multimotionfusion_tpu_torch.io.readers import SyntheticLogReader

    cam = CameraModel()
    cfg = EngineConfig(camera=cam, enable_multi_model=False, odom_init=odom_init,
                       surfels=SurfelConfig(max_surfels=1 << 20))
    reader = SyntheticLogReader(cam, num_frames=1 + n_frames, cam_step=(0.004, 0.0, 0.0),
                                cam_rot_step=(0.0, 0.002, 0.0))
    frames = list(reader)
    return cfg, frames, reader.gt_poses


PORT_MODULES = (
    "multimotionfusion_tpu_torch.ops.frame_maps", "multimotionfusion_tpu_torch.ops.image",
    "multimotionfusion_tpu_torch.ops.rasterize", "multimotionfusion_tpu_torch.odometry.levels",
    "multimotionfusion_tpu_torch.odometry.rgbd", "multimotionfusion_tpu_torch.model.fusion",
    "multimotionfusion_tpu_torch.model.fillin", "multimotionfusion_tpu_torch.model.surfel_map",
    "multimotionfusion_tpu_torch.tracking.superpoint", "multimotionfusion_tpu_torch.tracking.tracker",
    "multimotionfusion_tpu_torch.ops.ransac", "multimotionfusion_tpu_torch.odometry.multi",
    "multimotionfusion_tpu_torch.segmentation.flow", "multimotionfusion_tpu_torch.segmentation.crf",
    "multimotionfusion_tpu_torch.segmentation.components",
    "multimotionfusion_tpu_torch.segmentation.flow_crf", "multimotionfusion_tpu_torch.model.ferns",
    "multimotionfusion_tpu_torch.model.deformation", "multimotionfusion_tpu_torch.segmentation.slic",
    "multimotionfusion_tpu_torch.segmentation.legacy_crf",
)


@contextlib.contextmanager
def count_plain_calls(calls):
    """Count calls of every ``*_plain`` function of the port while inside."""
    import importlib

    saved = []
    for name in PORT_MODULES:
        mod = importlib.import_module(name)
        for attr in [a for a in vars(mod) if a.endswith("_plain") and callable(getattr(mod, a))]:
            fn = getattr(mod, attr)

            def counted(*args, _fn=fn, _key=f"{name}.{attr}", **kwargs):
                calls[_key] = calls.get(_key, 0) + 1
                return _fn(*args, **kwargs)

            saved.append((mod, attr, fn))
            setattr(mod, attr, counted)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def run_engine(K, cfg, frames, gt_poses, path=MAIN_PATH, tag="engine"):
    """Phase 2 (and 4b): a main path, frames 0..N_FRAMES, with every launch
    counted and every call of a plain version counted (there must be none)."""
    plain_calls = {}
    with count_plain_calls(plain_calls):
        out = _run_engine(K, cfg, frames, gt_poses, path, tag)
    print(json.dumps({"phase": f"plain_calls_on_{tag}_path", "calls": plain_calls}))
    if plain_calls:
        raise SystemExit(f"plain versions ran on the {tag} path: {plain_calls}")
    return out


def _run_engine(K, cfg, frames, gt_poses, path, tag):
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
    from multimotionfusion_tpu_torch.odometry import rgbd

    K.reset_launches()
    engine = MultiMotionFusionTorch(cfg, device=DEVICE)
    K.start_capture()
    engine.process_frame(frames[0])
    captured = {"compact": K.stop_capture()["compact"]}
    ms = []
    for i in range(1, N_FRAMES + 1):
        if i in (CAPTURE_AT, CAPTURE_COMPACT_AT):
            K.start_capture()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        engine.process_frame(frames[i])
        end.record()
        end.synchronize()
        if i == CAPTURE_AT:
            captured.update(K.stop_capture())
        elif i == CAPTURE_COMPACT_AT:
            captured["clean.compact"] = K.stop_capture()["clean.compact"]
        if i > WARMUP:
            ms.append(start.elapsed_time(end))
    stats = engine.finish()
    launches = dict(K.LAUNCHES)

    est = np.stack([p for _, p in engine.pose_log])
    gt = np.stack(gt_poses[: len(est)])
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    ate = float(np.sqrt(np.mean(err**2)))
    path_m = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    # the angle from the Frobenius distance of the rotations in float64
    # (|R1 - R2|_F = 2 sqrt(2) sin(a / 2)), exact for tiny angles where the
    # arccos of a float32 trace rounds to 0
    dR = est[:, :3, :3].astype(np.float64) - gt[:, :3, :3].astype(np.float64)
    rot = float(np.degrees(np.max(2.0 * np.arcsin(np.minimum(
        np.linalg.norm(dR, axis=(1, 2)) / (2.0 * np.sqrt(2.0)), 1.0)))))
    summary = {
        "phase": tag, "odom_init": cfg.odom_init, "frames": len(est), "timed_frames": len(ms),
        "ms_per_frame_median": statistics.median(ms),
        # the highest quartile with at least ten timed frames beyond it
        "ms_per_frame_p75": statistics.quantiles(ms, n=4)[2],
        "ms_per_frame_min": min(ms), "surfels": stats["surfels"], "hwm": stats["hwm"],
        "ate_m": ate, "path_m": path_m, "ate_pct_path": 100.0 * ate / path_m,
        "max_rot_err_deg": rot, "launches": launches,
        "odometry_iterations_last_frame": rgbd.loop_iterations(engine._last_stats.odo),
        "gpu": _gpu_line(),
    }
    if cfg.odom_init == "kp":  # read once, after the run
        summary["seed_gate_accepted_frames"] = int(engine.seed_accepted)
        summary["seed_gate_frames"] = N_FRAMES
    print(json.dumps(summary))
    if not (ate < 0.05 * path_m and rot < 1.5):
        raise SystemExit(f"camera tracking out of bounds: ATE {ate} m over {path_m} m, rot {rot} deg")
    for k in path:
        if launches.get(k, 0) <= 0:
            raise SystemExit(f"kernel {k} was not launched on the {tag} path")
    return engine, launches, captured


class StageTimer:
    """Stand-in for engine._span: host time and a CUDA event pair per stage."""

    def __init__(self):
        self.host = defaultdict(float)
        self.pairs = []

    @contextlib.contextmanager
    def __call__(self, name):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        yield
        end.record()
        self.host[name] += (time.perf_counter() - t0) * 1e3
        self.pairs.append((name, start, end))

    def device(self):
        out = defaultdict(float)
        for name, start, end in self.pairs:
            out[name] += start.elapsed_time(end)
        return out


def run_stages(K, engine, frames, tag="stages") -> None:
    """Phase 3: where the frame's time goes, per stage and per device kernel."""
    from multimotionfusion_tpu_torch import engine as E
    from multimotionfusion_tpu_torch import engine_multi as EM

    n = STAGE_FRAMES
    before = dict(K.LAUNCHES)
    timer = StageTimer()
    span, E._span, EM._span = E._span, timer, timer
    try:
        t0 = time.perf_counter()
        for f in frames[:n]:
            engine.process_frame(f)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    finally:
        E._span = EM._span = span
    stage_dev = timer.device()
    wrappers = {k: (v - before.get(k, 0)) / n for k, v in K.LAUNCHES.items()}
    stages = {k: {"host_ms": timer.host[k] / n, "stream_ms": stage_dev[k] / n} for k in timer.host}

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for f in frames[n:2 * n]:
            engine.process_frame(f)
        torch.cuda.synchronize()
    kernels = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        # the stage spans also appear on the device timeline; they are not kernels
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.name not in timer.host:
            k = kernels[evt.name[:90]]
            k[0] += evt.time_range.elapsed_us() / 1e3 / n
            k[1] += 1
    busy = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    gn = {name: {"ms": v[0], "launches_per_frame": v[1] / n} for name, v in kernels.items()
          if any(k in name for k in GN_KERNELS)}
    fuse = {name: {"ms": v[0], "launches_per_frame": v[1] / n} for name, v in kernels.items()
            if any(f"::{k}(" in name for k in FUSE_KERNELS)}
    rs = {name: {"ms": v[0], "launches_per_frame": v[1] / n} for name, v in kernels.items()
          if any(f"::{k}(" in name for k in RANSAC_KERNELS)}
    print(json.dumps({
        "phase": tag, "frames": n, "wall_ms_per_frame": wall, "stages_per_frame": stages,
        "device_kernel_ms_per_frame": busy, "device_busy_share": busy / wall,
        "device_kernel_launches_per_frame": sum(v[1] for v in kernels.values()) / n,
        "wrapper_launches_per_frame": wrappers,
        "top_kernels_ms_per_frame": [
            {"name": name, "ms": v[0], "launches_per_frame": v[1] / n} for name, v in top],
        "odometry_kernels_ms_per_frame": gn, "fusion_kernels_ms_per_frame": fuse,
        "ransac_kernels_ms_per_frame": rs,
        **({"earlier_device_ms_and_launches_per_frame": EARLIER_DEVICE[tag]}
           if tag in EARLIER_DEVICE else {}),
        "gpu": _gpu_line(),
    }))


# calls of a kernel a measurement makes at most: _time_ms's 1 + 20 and
# _device_profile's 10 + 20 in each of its 3 tries
MEASURE_CALLS = 1 + 20 + 3 * 30


def _states(state, n=MEASURE_CALLS):
    """Fresh copies of a loop state (a step updates its state in place)."""
    copies = iter([state.clone() for _ in range(n)])
    return lambda: next(copies)


def measure_zbuffer(a):
    from multimotionfusion_tpu_torch.ops import rasterize as R

    cam = a[3]
    npix = cam.height * cam.width
    # library yardstick: one scatter-min of this frame's packed keys
    pix, key, _ = R.packed_keys(*a)
    buf = torch.full((npix + 1,), 2**31 - 1, dtype=torch.int32, device=DEVICE)
    n = a[0].shape[1]
    bound, by = _bound(2 * 64 * n + 4 * npix, 40 * n)
    return dict(
        ms=_time_ms(lambda: R.zbuffer_cuda(*a)), **_device(lambda: R.zbuffer_cuda(*a)),
        plain_ms=_time_ms(lambda: R.zbuffer_plain(*a)),
        **_library(lambda: buf.scatter_reduce_(0, pix, key, reduce="amin")),
        bound_ms=bound, bound_by=by,
    )


def measure_splat(a):
    from multimotionfusion_tpu_torch.model import fillin
    from multimotionfusion_tpu_torch.ops import rasterize as R

    index = a[0]
    npix = index.numel()
    n_win = int(torch.unique(index[index >= 0]).numel())
    # index map, winners' 13 channels, 49 output bytes; fill-in reads colour,
    # filtered depth and the frame's normal and radius (23 bytes) where it fills
    n_fill = int((index < 0).sum())
    bound, by = _bound(4 * npix + 13 * 4 * n_win + 49 * npix + 23 * n_fill, 25 * 40 * npix)
    data_local, ids = a[1], index.clamp(min=0).long()
    return dict(
        ms=_time_ms(lambda: R.splat_resolve_cuda(*a)),
        **_device(lambda: R.splat_resolve_cuda(*a)), **_cold(lambda: R.splat_resolve_cuda(*a)),
        plain_ms=_time_ms(lambda: fillin.splat_fill_plain(*a), reps=5),
        **_library(lambda: data_local[:, ids]),
        library_note="data_local[:, index.clamp(min=0)]: the winners' [16, H, W] gather "
                     "(gather_attr_images), part of the function",
        bound_ms=bound, bound_by=by,
    )


def measure_fuse(a):
    from multimotionfusion_tpu_torch.model import fusion as FU

    cam = a[9]
    n, npix = a[0].shape[1], cam.height * cam.width
    n_cb = npix // 4
    bound, by = _bound(2 * 64 * n + 64 * n_cb + 4 * npix + 28 * n_cb + 64 * n_cb, 16 * 60 * n_cb)
    new = (FU.fuse_cuda(*a)[2] == -1).to(torch.int32)  # the association's new flags
    return dict(
        ms=_time_ms(lambda: FU.fuse_cuda(*a, want_assoc=False)),
        **_device(lambda: FU.fuse_cuda(*a, want_assoc=False), by_kernel=True),
        plain_ms=_time_ms(lambda: FU.fuse_plain(*a), reps=5),
        **_library(lambda: torch.cumsum(new, 0)), bound_ms=bound, bound_by=by,
        library_note="torch.cumsum of the checkerboard's new flags: the append scan alone",
        new_flags=int(new.sum()),
    )


def measure_gn(a, level):
    from multimotionfusion_tpu_torch.odometry import rgbd

    icp_rows, rgb_rows, _ = rgbd.gn_rows(*a[:5])
    lv = a[0]
    h, w = lv.img.shape
    s = lv.stride
    P = ((h + s - 1) // s) * ((w + s - 1) // s)
    tap_bytes = 16 if lv.compact else 32
    bound, by = _bound(P * 37 + min(4 * P, h * w) * tap_bytes + 59 * 4, P * 300)
    return dict(
        ms=_time_ms(lambda: rgbd.gn_reduce_cuda(*a, level=level)),
        **_device(lambda: rgbd.gn_reduce_cuda(*a, level=level), by_kernel=True),
        plain_ms=_time_ms(lambda: rgbd.gn_reduce_plain(*a)),
        **_library(lambda: (icp_rows.T @ icp_rows, rgb_rows.T @ rgb_rows)),
        bound_ms=bound, bound_by=by,
    )


def measure_frame_depth(a):
    from multimotionfusion_tpu_torch.ops import frame_maps as FM

    npix = a[0].numel()
    # raw depth in (2 bytes), metric + filtered depth out; 169 taps of ~12
    # operations (expf counted as one) per pixel
    bound, by = _bound(a[0].element_size() * npix + 8 * npix, 169 * 12 * npix)
    return dict(
        ms=_time_ms(lambda: FM.frame_depth_cuda(*a)),
        **_device(lambda: FM.frame_depth_cuda(*a)), **_cold(lambda: FM.frame_depth_cuda(*a)),
        plain_ms=_time_ms(lambda: FM.frame_depth_plain(*a), reps=3),
        **_library(None), bound_ms=bound, bound_by=by,
    )


def measure_frame_surfels(a):
    from multimotionfusion_tpu_torch.ops import frame_maps as FM
    from multimotionfusion_tpu_torch.ops import maps as mapops

    npix = a[1].numel()
    # two depths and the colour in, 16 channels and the valid byte out
    bound, by = _bound((4 + 4 + 3 + 64 + 1) * npix, 80 * npix)
    # yardstick: the normals' cross products of the filtered vertex map
    v = mapops.create_vmap(a[2], a[3], a[5])
    right = (v[:-1, 1:] - v[:-1, :-1]).contiguous()
    down = (v[1:, :-1] - v[:-1, :-1]).contiguous()
    return dict(
        ms=_time_ms(lambda: FM.frame_surfels_cuda(*a)),
        **_device(lambda: FM.frame_surfels_cuda(*a)),
        plain_ms=_time_ms(lambda: FM.frame_surfels_plain(*a), reps=5),
        **_library(lambda: torch.linalg.cross(right, down, dim=-1)),
        library_note="torch.linalg.cross of the filtered vertex map's differences (the "
                     "normals' cross products, part of the function)",
        bound_ms=bound, bound_by=by,
    )


def _conv_yardstick(channels: int, h: int, w: int, down: bool):
    """One F.conv2d call (TF32 off): 5x5 stride 2 over ``channels`` input
    planes of the finer level (num and den of each), or the two 3x3 Sobel
    filters of one plane."""
    import torch.nn.functional as F

    if down:
        x = torch.rand((1, 2 * channels, h, w), device=DEVICE)
        k = torch.rand((2 * channels, 1, 5, 5), device=DEVICE)
        return lambda: F.conv2d(x, k, stride=2, padding=2, groups=2 * channels)
    x = torch.rand((1, 1, h, w), device=DEVICE)
    k = torch.rand((2, 1, 3, 3), device=DEVICE)
    return lambda: F.conv2d(x, k, padding=1)


def measure_pyr_frame(a):
    """The frame side, every level in one launch; the yardstick is the sum of
    each level's convolutions (level 0's Sobel; a coarser level's 5x5 stride-2
    num and den of the finer depth and intensity, then its Sobel)."""
    from multimotionfusion_tpu_torch.odometry import levels as LV

    cam, cfg = a[3], a[4]
    sizes = LV.level_sizes(cam.height, cam.width, cfg.num_pyr)
    run = lambda: LV.frame_levels_cuda(*a)  # noqa: E731
    # in: the filtered depth and the colour (7 B a level-0 pixel) and, where a
    # mask test is on, the model ids (4 B); out at each level: intensity,
    # Sobel x2, vertices, normals, validity (37 B), depth at coarse levels
    bytes_in = (7 + (4 if cfg.mask_icp or cfg.mask_rgb else 0)) * sizes[0][0] * sizes[0][1]
    bytes_out = sum((37 + 4 * (lvl > 0)) * h * w for lvl, (h, w) in enumerate(sizes))
    flops = sum((50 * (lvl > 0) + 60) * h * w for lvl, (h, w) in enumerate(sizes))
    conv = [_conv_yardstick(1, *sizes[0], False)]
    for lvl in range(1, len(sizes)):
        conv += [_conv_yardstick(2, *sizes[lvl - 1], True), _conv_yardstick(1, *sizes[lvl], False)]
    bound, by = _bound(bytes_in + bytes_out, flops)
    return dict(
        ms=_time_ms(run), **_device(run), **_cold(run),
        plain_ms=_time_ms(lambda: LV.frame_levels_plain(*a), reps=5),
        **_library(lambda: [c() for c in conv]), bound_ms=bound, bound_by=by,
        library_note="the levels' F.conv2d calls summed: 5x5 stride-2 num and den, Sobel",
    )


def measure_pyr_pred(a):
    """The prediction side, every level's map in one launch; the yardstick is
    the sum of the coarse levels' 5x5 stride-2 convolutions (num and den of
    the depth, RGB depth and intensity)."""
    from multimotionfusion_tpu_torch.odometry import levels as LV

    cam, cfg = a[3], a[4]
    sizes = LV.level_sizes(cam.height, cam.width, cfg.num_pyr)
    compact, _ = LV._use_terms(cfg)
    run = lambda: LV.pred_levels_cuda(*a)  # noqa: E731
    n0 = sizes[0][0] * sizes[0][1]
    # in: the vertex (its depth alone where level 0's map is bf16), normal
    # and colour; out: level 0's map (16 B bf16 or 32 B f32), 32 B a
    # coarse pixel
    bytes_moved = n0 * ((4 if compact else 12) + 12 + 12 + (16 if compact else 32))
    bytes_moved += sum(32 * h * w for h, w in sizes[1:])
    conv = [_conv_yardstick(3, *sizes[lvl - 1], True) for lvl in range(1, len(sizes))]
    bound, by = _bound(bytes_moved, sum(200 * h * w for h, w in sizes))
    return dict(
        ms=_time_ms(run), **_device(run), **_cold(run),
        plain_ms=_time_ms(lambda: LV.pred_levels_plain(*a), reps=5),
        **_library(lambda: [c() for c in conv]), bound_ms=bound, bound_by=by,
        library_note="the coarse levels' F.conv2d calls summed: 5x5 stride-2 num and den",
    )


def measure_odo_init(a):
    from multimotionfusion_tpu_torch.odometry import rgbd

    bound, by = _bound(4 * rgbd.S_SIZE, rgbd.S_SIZE)
    return dict(
        ms=_time_ms(lambda: rgbd.odo_init_cuda(*a)),
        **_device(lambda: rgbd.odo_init_cuda(*a)),
        plain_ms=_time_ms(lambda: rgbd.odo_init_plain(*a)),
        **_library(None), bound_ms=bound, bound_by=by,
    )


def measure_so3_reduce(a):
    from multimotionfusion_tpu_torch.odometry import rgbd

    rows, found = rgbd.so3_rows(*rgbd.so3_inputs(*a))
    npix = a[1].numel()
    # two images in; per found pixel ~150 operations (warp, 4 taps x 3
    # channels, gradients, Jacobian, 10 products)
    bound, by = _bound(8 * npix + 4 * rgbd.N_SO3_SUMS, 150 * int(found.sum()))
    return dict(
        ms=_time_ms(lambda: rgbd.so3_reduce_cuda(*a)),
        **_device(lambda: rgbd.so3_reduce_cuda(*a)),
        plain_ms=_time_ms(lambda: rgbd.so3_reduce_plain(*a)),
        **_library(lambda: rows.T @ rows), bound_ms=bound, bound_by=by,
    )


def measure_step(a, kind):
    from multimotionfusion_tpu_torch.odometry import rgbd

    state, rest = a[0], a[1:]
    cuda = rgbd.so3_step_cuda if kind == "so3" else rgbd.gn_step_cuda
    plain = rgbd.so3_step_plain if kind == "so3" else rgbd.gn_step_plain
    n = 3 if kind == "so3" else 6
    A = torch.eye(n, device=DEVICE) + 0.1 * torch.ones((n, n), device=DEVICE)
    fresh = _states(state)
    # the state and the sums in and out; a Jacobi eigensolve of n x n
    # (~8 sweeps of n(n-1)/2 rotations of 12 n operations) and the update
    bound, by = _bound(2 * 4 * rgbd.S_SIZE + 4 * 64, 8 * n * (n - 1) // 2 * 12 * n + 500)
    return dict(
        ms=_time_ms(lambda: cuda(fresh(), *rest)),
        **_device(lambda: cuda(fresh(), *rest), by_kernel=True),
        plain_ms=_time_ms(lambda: plain(state.clone(), *rest), reps=5),
        **_library(lambda: torch.linalg.eigh(A)), bound_ms=bound, bound_by=by,
        timing_note="each call on a fresh copy of the recorded state, the copies made before "
                    "the timing",
    )


def measure_so3_iteration(a):
    from multimotionfusion_tpu_torch.odometry import rgbd

    last, nxt, cam_l, state, verbatim = a
    rows, found = rgbd.so3_rows(*rgbd.so3_inputs(last, nxt, cam_l, state))
    npix = nxt.numel()
    fresh = _states(state)
    # so3_reduce's bytes and operations, the state in and out, and a 3x3
    # Jacobi eigensolve (~8 sweeps of 3 rotations of 36 operations) and the
    # update
    bound, by = _bound(8 * npix + 4 * rgbd.N_SO3_SUMS + 2 * 4 * rgbd.S_SIZE,
                       150 * int(found.sum()) + 8 * 3 * 36 + 500)
    run = lambda: rgbd.so3_iteration_cuda(last, nxt, cam_l, fresh(), verbatim)  # noqa: E731
    return dict(
        ms=_time_ms(run), **_device(run, by_kernel=True),
        plain_ms=_time_ms(lambda: rgbd.so3_iteration_plain(last, nxt, cam_l, state.clone(),
                                                           verbatim), reps=5),
        **_library(lambda: rows.T @ rows), bound_ms=bound, bound_by=by,
        timing_note="each call on a fresh copy of the recorded state, the copies made before "
                    "the timing; the yardstick is the 4x4 system's product alone",
    )


def measure_clean(a, in_place=False):
    """A clean's line: into the map's bucket (a copy, the static and global
    maps' call) or, ``in_place``, consuming a fresh copy of the recorded map
    each call (a legacy slot's call; the copies made before the timing)."""
    from multimotionfusion_tpu_torch.model import fusion as FU
    from multimotionfusion_tpu_torch.model import surfel_map as sm
    from multimotionfusion_tpu_torch.ops import rasterize as R

    (data, count, index, data_local, depth, mask, mask_id, cam, time_, time_delta, conf, cfg,
     compact) = a
    smap, im = sm.SurfelMap(data, count), R.IndexMap(index, data_local)
    args = (smap, im, depth, mask, mask_id, cam, time_, time_delta, conf, cfg, compact)
    rest = args[1:]
    out = torch.empty_like(data)
    B, npix = data.shape[1], index.numel()
    n_win = int(torch.unique(index[index >= 0]).numel())
    keep, pen = FU.clean_verdicts(*args[:10])
    n_keep = int(keep.sum())
    changed = int((pen != 1.0).sum()) + int(((data[sm.ALIVE] != 0) & ~keep).sum())
    # pixel pass: index map, each winner's 8 channels once, depth and mask;
    # surfel pass: ALIVE, LAST_T and CONF of every slot, and the map written
    # (a copy: every channel read and written; in place: the values that
    # change); compaction: three channels of every slot, the kept columns
    # read and the packed map written
    pixels = 12 * npix + 8 * 4 * n_win
    if compact:
        moved = pixels + 12 * B + 64 * n_keep + 64 * B
    elif in_place:
        moved = pixels + 12 * B + 4 * changed
    else:
        moved = pixels + 2 * 64 * B
    bound, by = _bound(moved, 16 * 30 * npix + 20 * B)
    if compact:
        library = lambda: data[:, keep]  # noqa: E731
    else:
        flat = index.clamp(min=0).reshape(-1).long()
        library = lambda: data_local.index_select(1, flat)  # noqa: E731
    if in_place:
        fresh = _states(data)  # MEASURE_CALLS: the timing's and the profile's calls

        def run():
            d = fresh()
            return FU.clean_cuda(sm.SurfelMap(d, count), *rest, out=d)
        timed = dict(ms=_time_ms(run), **_device(run),
                     timing_note="each call cleans a fresh copy of the recorded map in place, "
                                 "the copies made before the timing")
    else:
        timed = dict(ms=_time_ms(lambda: FU.clean_cuda(*args, out=out)),
                     **_device(lambda: FU.clean_cuda(*args, out=out), by_kernel=True))
    return dict(
        **timed, plain_ms=_time_ms(lambda: FU.clean_plain(*args), reps=5),
        **_library(library), bound_ms=bound, bound_by=by, kept=n_keep,
        values_changed=changed,
    )


def measure_compact(a):
    from multimotionfusion_tpu_torch.model import surfel_map as sm

    data, keep, capacity = a
    n = data.shape[1]
    bound, by = _bound(64 * int(keep.sum()) + n + 64 * capacity, 4 * n)
    return dict(
        ms=_time_ms(lambda: sm.compact_cuda(*a)), **_device(lambda: sm.compact_cuda(*a)),
        plain_ms=_time_ms(lambda: sm.compact_plain(*a), reps=5),
        **_library(lambda: data[:, keep]), bound_ms=bound, bound_by=by,
    )


def measure_compact_segments(a):
    """The multi-model repack into copies of the recorded destinations (it
    writes every column of them whatever they held); the yardstick:
    ``data[:, keep]`` of every segment, summed (the parent design's
    per-segment glue excluded)."""
    from multimotionfusion_tpu_torch.model import surfel_map as sm

    gsrc, osrc, counts, gdst, odst = a
    segs = [gsrc] + [osrc[:, k] for k in range(osrc.shape[1])]
    keeps = [(torch.arange(x.shape[1], device=x.device) < counts[m]) & (x[sm.ALIVE] > 0)
             for m, x in enumerate(segs)]
    kept = sum(int(k.sum()) for k in keeps)
    cols = sum(x.shape[1] for x in segs)
    # ALIVE is read only below each segment's count (the keep's first test
    # decides the rest); every slot of every destination is written
    below = sum(min(max(int(c), 0), x.shape[1]) for c, x in zip(counts.tolist(), segs))
    gk, ok_ = gdst.clone(), odst.clone()
    run = lambda: sm.compact_segments_cuda(gsrc, osrc, counts, gk, ok_)  # noqa: E731
    lib = [_library(lambda x=x, k=k: x[:, k]) for x, k in zip(segs, keeps)]
    return dict(
        ms=_time_ms(run), **_device(run),
        plain_ms=_time_ms(lambda: sm.compact_segments_plain(gsrc, osrc, counts, gdst.clone(),
                                                            odst.clone()), reps=5),
        library_ms=sum(x["library_ms"] for x in lib),
        library_device_ms=None if any(x["library_device_ms"] is None for x in lib)
        else sum(x["library_device_ms"] for x in lib),
        library_call="data[:, keep] of each segment, summed", kept=kept, segments=len(segs),
        slots_below_counts=below,
        **dict(zip(("bound_ms", "bound_by"), _bound(4 * below + 64 * kept + 64 * cols, 4 * cols))))


def measure_patch_score(a):
    from multimotionfusion_tpu_torch.tracking import superpoint as SP

    npix = a[0].numel()
    # intensity in, score and blurred intensity out; per pixel the Sobel
    # (12), three products, four 5-tap passes each way (80) and the
    # eigenvalue (10)
    bound, by = _bound(12 * npix, 105 * npix)
    sobel = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=DEVICE)
    weights = torch.stack([sobel, sobel.t()])[:, None]  # [2, 1, 3, 3]
    img = a[0][None, None]
    run = lambda: SP.patch_score_cuda(*a)  # noqa: E731
    return dict(
        ms=_time_ms(run), **_device(run), **_cold(run),
        plain_ms=_time_ms(lambda: SP.patch_score_plain(*a), reps=5),
        **_library(lambda: torch.nn.functional.conv2d(img, weights, padding=1)),
        library_note="one two-filter F.conv2d (the Sobel gradients, part of the function; "
                     "TF32 off)",
        bound_ms=bound, bound_by=by,
    )


def measure_nms(a):
    import torch.nn.functional as F

    from multimotionfusion_tpu_torch.tracking import superpoint as SP

    heat, k, thr, r = a
    npix = heat.numel()
    # the heat map in, K slots of xy, score and valid out; the (2r+1)^2 max
    # window as row maxima, then column maxima (2r+1 comparisons each), and
    # two comparisons a pixel
    bound, by = _bound(4 * npix + 13 * k, (2 * (2 * r + 1) + 2) * npix)

    def library():  # max-pool NMS, then one top-k
        local = F.max_pool2d(heat[None, None], 2 * r + 1, 1, r)[0, 0]
        peaks = torch.where((heat == local) & (heat > thr), heat, torch.zeros_like(heat))
        return torch.topk(peaks.reshape(-1), k)

    return dict(
        ms=_time_ms(lambda: SP.nms_topk_cuda(*a)),
        **_device(lambda: SP.nms_topk_cuda(*a), by_kernel=True),
        plain_ms=_time_ms(lambda: SP.nms_topk_plain(*a), reps=5),
        **_library(library), bound_ms=bound, bound_by=by,
    )


def measure_patch_desc(a):
    from multimotionfusion_tpu_torch.tracking import superpoint as SP

    k = a[1].shape[0]
    # 64 samples and 64 outputs a keypoint, ~6 operations each
    bound, by = _bound(k * (8 + 64 * 4 + 64 * 4), 6 * 64 * k)
    blurred = a[0]
    yi, xi = SP._patch_coords(a[1], *blurred.shape)
    return dict(
        ms=_time_ms(lambda: SP.patch_desc_cuda(*a)), **_device(lambda: SP.patch_desc_cuda(*a)),
        plain_ms=_time_ms(lambda: SP.patch_desc_plain(*a), reps=5),
        **_library(lambda: blurred[yi, xi]),
        library_note="blurred[yi, xi]: the [K, 64] patch samples' gather, part of the function",
        bound_ms=bound, bound_by=by,
    )


def _match_ops(k, n, d):
    """The dot products and norms of K queries against N tracks, and the
    distances' comparisons."""
    return 2 * k * n * d + 2 * (k + n) * d + 4 * k * n


def _match_bound(q, t):
    """Both descriptor sets and flags in, the matches out; ``_match_ops``.
    With -fmad=false a multiply and an add are two instructions at half the
    67 TFLOP/s peak's rate, so the kernel can reach only twice this bound
    (``bound_fmad_false_ms``)."""
    (k, d), n = q.shape, t.shape[0]
    return _bound((k + n) * (4 * d + 1) + 4 * k + n, _match_ops(k, n, d))


def measure_mutual_match(a):
    from multimotionfusion_tpu_torch.tracking import tracker as TR

    q, t = a[0], a[1]
    bound, by = _match_bound(q, t)

    def library():  # one distance matrix, both argmins
        dist = torch.cdist(q, t)
        return dist.argmin(1), dist.argmin(0)

    return dict(
        ms=_time_ms(lambda: TR.mutual_match_cuda(*a)),
        **_device(lambda: TR.mutual_match_cuda(*a), by_kernel=True),
        plain_ms=_time_ms(lambda: TR.mutual_match_plain(*a), reps=3),
        **_library(library), bound_ms=bound, bound_by=by, bound_fmad_false_ms=2 * bound,
    )


def _update_work(a):
    """(bytes, operations) of add_keypoints + prune + last_pair given the
    matches, the matches not counted: K keypoints in (xy, descriptor, flag,
    depth) and K rows out; per track the flags, the cleared slot, two ring
    slots' points and the pair."""
    table, kps = a[0], a[1]
    cap, d = table.capacity, table.desc.shape[1]
    k = kps.xy.shape[0]
    return (k * (8 + 4 * d + 1 + 4) + k * (4 * d + 8 + 12 + 2 + 9)
            + cap * (9 + 2 + 24 + 2 + 25), 30 * cap + 20 * k)


def _update_bound(a):
    """The update given the matches: ``_update_work`` and the match per
    keypoint in."""
    b, ops = _update_work(a)
    return _bound(b + 4 * a[1].xy.shape[0], ops)


def measure_track_update(a):
    from multimotionfusion_tpu_torch.tracking import tracker as TR

    table, kps, depth, time_, cam, cfg, pair = a
    match_idx, tcol, _ = TR._match_cuda(kps.desc, table.desc, kps.valid, None,
                                        cfg.match_dist_gate, table, time_, want_matched=False)
    tk = TR.TrackTable(*(x.clone() for x in table))
    run = lambda: TR.track_update_cuda(tk, kps, match_idx, tcol, depth, time_, cam, cfg,  # noqa: E731
                                       pair)
    bound, by = _update_bound(a)
    return dict(
        ms=_time_ms(run), **_device(run),
        plain_ms=_time_ms(lambda: TR.update_plain(TR.TrackTable(*(x.clone() for x in a[0])),
                                                  *a[1:]), reps=3),
        **_library(None), bound_ms=bound, bound_by=by,
        timing_note="the update launch alone, given the matches; repeated on one copy of the "
                    "recorded table",
    )


def measure_tracker_update(a):
    """The whole tracker update as the engine runs it: the match (two
    launches, the tracks' in_history in the first) and the update."""
    from multimotionfusion_tpu_torch.tracking import tracker as TR

    table, rest = a[0], a[1:]
    tk = TR.TrackTable(*(x.clone() for x in table))
    run = lambda: TR.update_cuda(tk, *rest)  # noqa: E731
    # the whole update's inputs and outputs: ``_update_work`` and the tracks'
    # descriptors the match reads (the matches are its own intermediates)
    (k, d), n = rest[0].desc.shape, table.capacity
    b, ops = _update_work(a)
    bound, by = _bound(b + 4 * n * d, ops + _match_ops(k, n, d))
    return dict(
        ms=_time_ms(run), **_device(run, by_kernel=True),
        plain_ms=_time_ms(lambda: TR.update_plain(TR.TrackTable(*(x.clone() for x in table)),
                                                  *rest), reps=3),
        **_library(None), bound_ms=bound, bound_by=by,
        timing_note="match + update, repeated on one copy of the recorded table",
    )


def measure_ransac(a):
    from multimotionfusion_tpu_torch.ops import ransac as RS

    u, p0, p1, valid, cfg = a
    n, c = p0.shape[0], u.shape[0]
    # the points in once; per candidate and point three passes (distance and
    # flag, refit sums, refit distance) of ~25 operations, two 4x4 power
    # iterations per candidate
    bound, by = _bound(n * 25 + c * 12 + 64 + n, c * n * 75 + c * 2 * 40 * 40)
    return dict(
        ms=_time_ms(lambda: RS.ransac_fit_cuda(*a)), **_device(lambda: RS.ransac_fit_cuda(*a)),
        plain_ms=_time_ms(lambda: RS.ransac_fit_plain(*a), reps=3),
        **_library(None), bound_ms=bound, bound_by=by,
    )


def measure_ransac_batch(a):
    from multimotionfusion_tpu_torch.ops import ransac as RS

    u, p0, p1, valid, cfg = a
    b, c, n = u.shape[0], u.shape[1], valid.shape[1]
    live = ~RS.hopeless(valid, cfg)
    # the fallback fit (two passes over the valid points) runs where no
    # candidate passed and at least 3 points are valid
    fallback = ~RS.ransac_fit_batch_cuda(*a).ok & (valid.sum(1) >= 3)
    reads = int((live | fallback).sum())  # fits that read their points
    n_live, n_fallback = int(live.sum()), int(fallback.sum())
    # in: each fit's flags and uniforms, the points of the fits that read
    # them (shared points once); out: T, inliers, error, count, ok and the
    # minimal sets. Operations: per candidate of a live fit three passes of
    # ~25 a point and two 4x4 power iterations, ~20 a candidate of a
    # hopeless fit (its minimal set), ~40 a point of a fallback fit
    points = 24 * n * (min(reads, 1) if p0.dim() == 2 else reads)
    bound, by = _bound(points + b * (n + 12 * c) + b * (64 + n + 9 + 12 * c),
                       n_live * (c * n * 75 + c * 2 * 40 * 40) + (b - n_live) * c * 20
                       + n_fallback * n * 40)
    return dict(
        ms=_time_ms(lambda: RS.ransac_fit_batch_cuda(*a)),
        **_device(lambda: RS.ransac_fit_batch_cuda(*a), by_kernel=True),
        plain_ms=_time_ms(lambda: RS.ransac_fit_batch_plain(*a), reps=1),
        **_library(None), bound_ms=bound, bound_by=by, live_fits=n_live,
        fallback_fits=n_fallback,
    )


def measure_seed_select(a):
    from multimotionfusion_tpu_torch.odometry import rgbd

    state, rest = a[0], a[1:]
    fresh = _states(state)
    bound, by = _bound(2 * 4 * rgbd.S_SIZE + 64 + 1 + 2 * 4 * rgbd.N_SUMS, 100)
    return dict(
        ms=_time_ms(lambda: rgbd.seed_select_cuda(fresh(), *rest)),
        **_device(lambda: rgbd.seed_select_cuda(fresh(), *rest)),
        plain_ms=_time_ms(lambda: rgbd.seed_select_plain(state.clone(), *rest), reps=5),
        **_library(None), bound_ms=bound, bound_by=by,
        timing_note="each call on a fresh copy of the recorded state (one 512-byte copy included)",
    )


def _library(fn) -> dict:
    """The yardstick's time as ``ms`` takes the kernel's (CUDA events over
    back-to-back calls) and its device time as ``device_ms`` (``_device_profile``);
    None where no single PyTorch call computes the same function."""
    if fn is None:
        return dict(library_ms=None, library_device_ms=None)
    return dict(library_ms=_time_ms(fn), library_device_ms=_device_profile(fn)[0])


def _measure(cuda, plain, bytes_moved, flops, library=None, plain_reps=3, by_kernel=False,
             **extra):
    bound, by = _bound(bytes_moved, flops)
    return dict(ms=_time_ms(cuda), **_device(cuda, by_kernel),
                plain_ms=_time_ms(plain, reps=plain_reps),
                **_library(library),
                bound_ms=bound, bound_by=by, **extra)


def measure_owner_prep(a):
    from multimotionfusion_tpu_torch.odometry import levels as LV
    from multimotionfusion_tpu_torch.odometry import multi as MO

    prev_mask, pred_own, frame, _, cfg, M = a
    args = (prev_mask, pred_own, frame, M, [LV._min_scale(cfg, l) for l in range(len(frame))])
    npix = sum(fl.img.numel() for fl in frame)
    # in: the mask and the prediction's owners once, each level's image,
    # gradients and depth; out: each level's eroded owner and validity, and
    # the owners of levels >= 1 (level 0's are the mask); 13 + 16 owner taps
    # a level pixel
    n0 = frame[0].img.numel()
    own_f = pred_own.to(torch.float32)[None, None]
    pool = torch.nn.functional.max_pool2d
    run = lambda: MO.owner_levels_cuda(*args)  # noqa: E731
    return _measure(run, lambda: MO.owner_levels_plain(*args),
                    8 * prev_mask.numel() + 16 * npix + 5 * npix + 4 * (npix - n0), 60 * npix,
                    library=lambda: [pool(own_f, 3, 1 << l, 1) for l in range(len(frame))],
                    **_cold(run),
                    library_note="F.max_pool2d 3x3 of the float owner image at each level's "
                                 "stride, one call a level, summed (the erosion's window, part "
                                 "of the function)")


def measure_gn_multi(a, level):
    from multimotionfusion_tpu_torch.odometry import multi as MO

    ml, Tinv, cam_l, scale2, p, M, _ = a
    icp_rows, rgb_rows, own, _ = MO.multi_rows(ml, Tinv, cam_l, scale2, p, M)
    onehot = torch.nn.functional.one_hot(torch.clamp(own, 0, M).long(), M + 1)[:, :M].float()
    lv = ml.gl
    h, w = lv.img.shape
    s = lv.stride
    P = ((h + s - 1) // s) * ((w + s - 1) // s)
    tap_bytes = 16 if lv.compact else 32
    full = lambda: MO.gn_multi_cuda(*a, level=level)  # noqa: E731
    return _measure(full, lambda: MO.gn_multi_plain(*a),
                    P * (37 + 8) + min(4 * P, h * w) * (tap_bytes + 4) + 64 * 4 * M, P * 300,
                    library=lambda: (torch.einsum("pm,pi,pj->mij", onehot, icp_rows, icp_rows),
                                     torch.einsum("pm,pi,pj->mij", onehot, rgb_rows, rgb_rows)),
                    library_note="owner-weighted rows.T @ rows (einsum over the one-hot owner)",
                    by_kernel=True)


def measure_multi_step(a, kind):
    from multimotionfusion_tpu_torch.odometry import multi as MO
    from multimotionfusion_tpu_torch.odometry import rgbd

    if kind == "init":
        M = a[0]
        return _measure(lambda: MO.multi_init_cuda(*a), lambda: MO.multi_init_plain(*a),
                        4 * (M + 1) * rgbd.S_SIZE, (M + 1) * rgbd.S_SIZE)
    state, rest = a[0], a[1:]
    cuda = {"seed": MO.multi_seed_cuda, "arbitrate": MO.multi_arbitrate_cuda,
            "step": MO.gn_step_multi_cuda}[kind]
    plain = {"seed": MO.multi_seed_plain, "arbitrate": MO.multi_arbitrate_plain,
             "step": MO.gn_step_multi_plain}[kind]
    M = state.numel() // rgbd.S_SIZE - 1
    fresh = _states(state)
    flops = M * (8 * 15 * 12 * 6 + 500) if kind == "step" else 100 * M
    extra, library = {}, None
    if kind == "step":
        sums, sp = rest[0], rest[2]
        w2 = torch.tensor(sp.icp_weight, dtype=torch.float32) ** 2
        systems = []
        for m in range(M):
            S_icp, _, S_rgb, _, _ = rgbd.systems_from_sums(sums[m], sp.scale2)
            systems.append(S_rgb[:6, :6] + w2 * S_icp[:6, :6] if sp.use_rgb else S_icp[:6, :6])
        A = torch.stack(systems).to(DEVICE)
        library = lambda: torch.linalg.eigh(A)  # noqa: E731
        extra = dict(by_kernel=True,
                     library_note="batched torch.linalg.eigh of the M 6x6 systems (the "
                                  "eigensolve alone, part of the step)")
    return _measure(lambda: cuda(fresh(), *rest), lambda: plain(state.clone(), *rest),
                    2 * 4 * state.numel() + 4 * 64 * M, flops, library=library,
                    timing_note="each call on a fresh copy of the recorded state, the copies "
                                "made before the timing", **extra)


def measure_zbuffer_flat(a):
    from multimotionfusion_tpu_torch.ops import rasterize as R

    data, counts, layout, T_inv, maxd, cam, time_, td = a
    npix = cam.height * cam.width
    pix, key, _ = R.flat_keys(*a)
    buf = torch.full((npix + 1,), 2**31 - 1, dtype=torch.int32, device=DEVICE)
    n = layout.total
    return _measure(lambda: R.zbuffer_flat_cuda(*a), lambda: R.zbuffer_flat_plain(*a),
                    2 * 64 * n + 8 * npix, 45 * n,
                    library=lambda: buf.scatter_reduce_(0, pix, key, reduce="amin"))


def measure_fuse_flat(a):
    from multimotionfusion_tpu_torch.model import fusion as FU

    cam, layout = a[12], a[2]
    n, npix = layout.total, cam.height * cam.width
    n_cb = npix // 4
    M = layout.n_models
    _, _, flags, own = FU.fuse_flat_cuda(*a, with_flags=True)
    new = ((flags >> 1) & 1) > 0
    hot = ((own[None] == torch.arange(M, device=DEVICE)[:, None]) & new[None]).to(torch.int32)
    return _measure(lambda: FU.fuse_flat_cuda(*a), lambda: FU.fuse_flat_plain(*a),
                    2 * 64 * n + 64 * n_cb + 12 * npix + 32 * n_cb + 64 * n_cb, 16 * 60 * n_cb,
                    library=lambda: torch.cumsum(hot, 1), by_kernel=True,
                    library_note="torch.cumsum along the [M, n] one-hot of new flags by owner: "
                                 "the append scan alone",
                    new_flags_per_model=hot.sum(1).tolist())


def measure_clean_flat(a):
    from multimotionfusion_tpu_torch.model import fusion as FU
    from multimotionfusion_tpu_torch.model import surfel_map as sm

    data, index, cam = a[0], a[3], a[8]
    n, npix = a[2].total, cam.height * cam.width
    n_win = int(torch.unique(index[index >= 0]).numel())
    out = FU.clean_flat_plain(*a)
    changed = [int((out[ch].view(torch.int32) != data[ch].view(torch.int32)).sum())
               for ch in (sm.CONF, sm.ALIVE)]
    # in place: the index map, winner-model image and depth; each winner's
    # 8 channels; ALIVE, LAST_T and CONF of every row; the CONF and ALIVE
    # values that change (this frame's data). The copy's bound, every channel
    # of every row read and written, is the parent design's
    in_place = 12 * npix + 8 * 4 * n_win + 12 * n + 4 * sum(changed)
    whole = _bound(16 * npix + 7 * 4 * n_win + 2 * 64 * n, 0)[0]
    fresh, fresh_cold = _states(data), _states(data)
    ids = torch.where(index >= 0, index, torch.full_like(index, n)).reshape(-1).long()
    verdict = torch.ones((npix,), dtype=torch.float32, device=DEVICE)
    per_surfel = torch.ones((n + 1,), dtype=torch.float32, device=DEVICE)
    return _measure(lambda: FU.clean_flat_cuda(fresh(), *a[1:]), lambda: FU.clean_flat_plain(*a),
                    in_place, 16 * 30 * npix + 20 * n,
                    library=lambda: per_surfel.scatter_reduce_(0, ids, verdict, reduce="amin",
                                                               include_self=True),
                    library_note="the plain version's scatter_reduce_(amin) of the pixel "
                                 "verdicts into the rows (part of the function)",
                    bound_whole_store_ms=whole, changed_conf_alive=changed,
                    **_cold(lambda: FU.clean_flat_cuda(fresh_cold(), *a[1:])),
                    timing_note="each kernel call cleans a fresh copy of the recorded store in "
                                "place, the copies made before the timing")


def measure_splat_composite(a):
    r = measure_splat(a)
    # the winner-model image read on top of the static resolve's bytes
    npix = a[0].numel()
    r["bound_ms"] += 4 * npix / HBM_BYTES_PER_S * 1e3
    return r


CSRC = "multimotionfusion_tpu_torch/csrc/"
JAX = "multimotionfusion_tpu/"


def plan():
    """(name, capture key, launch key, check, measure, source, replaced TPU function)."""
    from multimotionfusion_tpu_torch.kernels import checks as C

    p = [
        ("frame_maps[filter]", "frame_maps.filter", "frame_maps.filter", C.check_frame_depth,
         measure_frame_depth, "frame_maps.cu", "ops/image.py:158"),
        ("frame_maps[surfels]", "frame_maps.surfels", "frame_maps.surfels",
         C.check_frame_surfels, measure_frame_surfels, "frame_maps.cu",
         "model/surfel_map.py:123"),
    ]
    p += [
        ("pyramid.frame[L0-L2]", "pyramid.frame", "pyramid.frame", C.check_pyramid_frame_side,
         measure_pyr_frame, "pyramid.cu", "odometry/levels.py:41"),
        ("pyramid.pred[L0-L2]", "pyramid.pred", "pyramid.pred", C.check_pyramid_pred_side,
         measure_pyr_pred, "pyramid.cu", "odometry/levels.py:59"),
        ("odo_init", "odo_init", "odo_init", C.check_odo_init, measure_odo_init, "gn_step.cu",
         "odometry/rgbd.py:776"),
        ("so3_reduce", "so3_reduce", "so3_reduce", C.check_so3_reduce, measure_so3_reduce,
         "gn_step.cu", "odometry/rgbd.py:583"),
        ("so3_step", "so3_step", "so3_step", C.check_so3_step,
         lambda a: measure_step(a, "so3"), "gn_step.cu", "odometry/rgbd.py:94"),
        ("so3_iteration", "so3_iteration", "so3_iteration", C.check_so3_iteration,
         measure_so3_iteration, "gn_step.cu", "odometry/rgbd.py:583"),
    ]
    for lvl in LEVELS:
        p.append((f"gn_reduce[L{lvl}]", f"gn_reduce.L{lvl}", f"gn_reduce.L{lvl}",
                  lambda a, lvl=lvl: C.check_gn(a, lvl), lambda a, lvl=lvl: measure_gn(a, lvl),
                  "gn_reduce.cu", "odometry/rgbd.py:809"))
    p += [
        ("gn_step", "gn_step", "gn_step", C.check_gn_step, lambda a: measure_step(a, "gn"),
         "gn_step.cu", "odometry/rgbd.py:94"),
        ("zbuffer", "zbuffer", "zbuffer", C.check_zbuffer, measure_zbuffer, "zbuffer.cu",
         "ops/rasterize.py:142"),
        ("fuse", "fuse", "fuse", C.check_fuse, measure_fuse, "fuse.cu", "model/fusion.py:54"),
        ("clean[flag frame]", "clean", "clean", C.check_clean, measure_clean, "clean.cu",
         "model/fusion.py:239"),
        ("clean[flag frame, in place]", "clean", "clean",
         lambda a: C.check_clean(a, in_place=True),
         lambda a: measure_clean(a, in_place=True), "clean.cu", "model/fusion.py:239"),
        ("clean[compaction frame]", "clean.compact", "clean.compact", C.check_clean,
         measure_clean, "clean.cu", "model/surfel_map.py:178"),
        ("compact[first frame]", "compact", "compact", C.check_compact, measure_compact,
         "clean.cu", "model/surfel_map.py:178"),
        ("splat_resolve+fill_in", "splat_resolve", "splat_resolve", C.check_splat,
         measure_splat, "splat_resolve.cu", "ops/rasterize.py:366"),
    ]
    return p


def plan_kp():
    """The keypoint path's kernels, as ``plan``; a capture key None marks a
    synthetic input (``checks.nms_inputs``)."""
    from multimotionfusion_tpu_torch.kernels import checks as C

    return [
        ("patch_score", "patch_score", "patch_score", C.check_patch_score, measure_patch_score,
         "keypoints.cu", "tracking/superpoint.py:190"),
        ("nms_topk", "nms_topk", "nms_topk", C.check_nms_topk, measure_nms, "keypoints.cu",
         "tracking/superpoint.py:143"),
        ("nms_topk[superpoint heat]", "superpoint", "nms_topk", C.check_nms_topk, measure_nms,
         "keypoints.cu", "tracking/superpoint.py:143"),
        ("nms_topk[plateau]", "plateau", "nms_topk", C.check_nms_topk, measure_nms,
         "keypoints.cu", "tracking/superpoint.py:143"),
        ("patch_desc", "patch_desc", "patch_desc", C.check_patch_desc, measure_patch_desc,
         "keypoints.cu", "tracking/superpoint.py:190"),
        ("mutual_match", "mutual_match", "mutual_match", C.check_mutual_match,
         measure_mutual_match, "tracks.cu", "tracking/tracker.py:83"),
        ("add_keypoints+prune+last_pair", "track_update", "track_update", C.check_track_update,
         measure_track_update, "tracks.cu", "tracking/tracker.py:116"),
        ("tracker.update[match + update]", "track_update", "track_update",
         C.check_track_update, measure_tracker_update, "tracks.cu",
         "tracking/tracker.py:83,116,182,239"),
        ("ransac_fit", "ransac_fit", "ransac_fit", C.check_ransac, measure_ransac, "ransac.cu",
         "ops/ransac.py:165"),
        ("seed_select", "seed_select", "seed_select", C.check_seed_select, measure_seed_select,
         "gn_step.cu", "odometry/rgbd.py:962"),
    ]


def plan_multi():
    """The multi-model path's new kernels, as ``plan``."""
    from multimotionfusion_tpu_torch.kernels import checks as C

    p = [("owner_prep[L0-L2]", "owner_prep", "owner_prep", C.check_owner_prep,
          measure_owner_prep, "gn_multi.cu", "odometry/multi.py:188")]
    for lvl in LEVELS:
        p.append((f"gn_multi[L{lvl}]", f"gn_multi.L{lvl}", f"gn_multi.L{lvl}",
                  lambda a, lvl=lvl: C.check_gn_multi(a, lvl),
                  lambda a, lvl=lvl: measure_gn_multi(a, lvl), "gn_multi.cu",
                  "odometry/multi.py:157"))
    p += [
        ("multi_init", "multi_init", "multi_init", C.check_multi_init,
         lambda a: measure_multi_step(a, "init"), "gn_step.cu", "odometry/multi.py:530"),
        ("multi_seed", "multi_seed", "multi_seed", C.check_multi_seed,
         lambda a: measure_multi_step(a, "seed"), "gn_step.cu", "odometry/multi.py:279"),
        ("multi_arbitrate", "multi_arbitrate", "multi_arbitrate", C.check_multi_arbitrate,
         lambda a: measure_multi_step(a, "arbitrate"), "gn_step.cu", "odometry/multi.py:461"),
        ("gn_step_multi", "gn_step_multi", "gn_step_multi", C.check_gn_step_multi,
         lambda a: measure_multi_step(a, "step"), "gn_step.cu", "odometry/multi.py:480"),
        ("so3_step[multi, verbatim]", "so3_step", "so3_step", C.check_so3_step,
         lambda a: measure_step(a, "so3"), "gn_step.cu", "odometry/multi.py:245"),
        ("so3_iteration[multi, verbatim]", "so3_iteration", "so3_iteration",
         C.check_so3_iteration, measure_so3_iteration, "gn_step.cu", "odometry/multi.py:245"),
        ("zbuffer_flat", "zbuffer.flat", "zbuffer.flat", C.check_zbuffer_flat,
         measure_zbuffer_flat, "zbuffer.cu", "ops/rasterize.py:181"),
        ("fuse_flat", "fuse_flat", "fuse_flat", C.check_fuse_flat, measure_fuse_flat,
         "fuse_flat.cu", "model/fusion.py:414"),
        ("clean_flat", "clean_flat", "clean_flat", C.check_clean_flat, measure_clean_flat,
         "fuse_flat.cu", "model/fusion.py:615"),
        ("splat_resolve[composite]+fill_in[gated]", "splat_resolve.composite",
         "splat_resolve.composite", C.check_splat, measure_splat_composite, "splat_resolve.cu",
         "ops/rasterize.py:366"),
    ]
    return p


SYNTHETIC = ("superpoint", "plateau", "components_240x160")


def check_kernels(lines, captured, launches, n_frames):
    """Phase 5: each kernel against its plain version on the recorded inputs."""
    from multimotionfusion_tpu_torch.kernels import checks

    kernels = []
    for name, key, launch_key, check, measure, src, rep in lines:
        if key == "components_240x160":  # a synthetic stack between the path's two sizes
            a = checks.components_inputs(160, 240, DEVICE)
        elif key in SYNTHETIC:
            a = checks.nms_inputs(key, 480, 640, DEVICE)
        else:
            a = checks.args(key, captured[key])
        r = check(a)
        torch.cuda.synchronize()
        line = {"name": name, "route": "cuda", "source": CSRC + src, "replaces": JAX + rep,
                "launches": launches.get(launch_key, 0),
                "launches_per_frame": launches.get(launch_key, 0) / n_frames}
        line.update(r)
        line.update(measure(a))
        print(json.dumps({"phase": "kernel", **line}))
        kernels.append(line)
    return kernels


def check_loop(captured, tag="odometry_loop") -> dict:
    """The whole odometry loop: kernels on the card against the plain loop on
    the CPU, from the recorded inputs of one frame."""
    from multimotionfusion_tpu_torch.kernels import checks

    r = checks.check_track(checks.args("track", captured["track"]))
    print(json.dumps({"phase": tag, **r}))
    return r


def check_multi_loop(captured) -> dict:
    """The composite odometry loop: kernels on the card against the plain loop
    on the CPU, from the recorded inputs of one multi-model frame."""
    from multimotionfusion_tpu_torch.kernels import checks

    r = checks.check_multi_track(checks.args("multi_track", captured["multi_track"]))
    print(json.dumps({"phase": "multi_odometry_loop", **r}))
    return r


def check_sparse(captured) -> dict:
    """The sparse block of one kp frame: the kernels on the card against the
    plain chain on the CPU, from the same inputs and uniforms."""
    from multimotionfusion_tpu_torch.kernels import checks

    r = checks.check_sparse(checks.args("sparse", captured["sparse"]))
    print(json.dumps({"phase": "sparse_block", **r}))
    return r


@contextlib.contextmanager
def sync_watch(module, attr: str):
    """Sync debug mode "warn" around every call of ``module.attr`` (the frame
    step) while inside; yields the list of caught warnings."""
    core = getattr(module, attr)

    def checked(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return core(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    setattr(module, attr, checked)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        setattr(module, attr, core)


def _syncs(caught):
    return [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
            if "called a synchronizing" in str(w.message)]


def run_sync_check(engine, frames, tag="sync_check") -> int:
    """Phase 4: steady-state frames with the sync debug mode on around the
    frame step; returns the number of synchronising calls."""
    from multimotionfusion_tpu_torch import engine as E

    first = engine.tick
    with sync_watch(E, "_frame_core") as caught:
        for f in frames:
            engine.process_frame(f)
        torch.cuda.synchronize()
    syncs = _syncs(caught)
    ticks = list(range(first, engine.tick))
    compaction = [t for t in ticks if engine.cfg.surfels.compact_every > 0
                  and t % engine.cfg.surfels.compact_every == 0]
    print(json.dumps({"phase": tag, "frames": len(ticks), "ticks": ticks,
                      "compaction_ticks": compaction, "synchronizing_calls": len(syncs),
                      "where": sorted(set(syncs))[:10]}))
    if not compaction:
        raise SystemExit("sync check ran no compaction frame")
    return len(syncs)


# ---------------------------------------------------------------- multi-model

SPHERE_CENTRES = np.array([[-0.62, -0.18, 1.65], [0.62, -0.18, 1.65], [-0.4, 0.4, 1.6],
                           [0.4, 0.4, 1.6], [0.0, -0.45, 1.7]])
SPHERE_RADIUS, ORBIT_R, OMEGA = 0.26, 0.12, 0.12


def sphere_centres(i: int) -> np.ndarray:
    """[5, 3] sphere centres at frame i (bench.py::bench_multi_model's orbits)."""
    th = OMEGA * i + 1.3 * np.arange(5)
    return SPHERE_CENTRES + ORBIT_R * np.stack([np.cos(th), np.sin(th), np.zeros(5)], -1)


def sphere_mask(cam, centres) -> np.ndarray:
    """[H, W] uint8: k + 1 where sphere k is the front-most surface along the
    pixel's ray (static camera at the origin), else 0. The ray-sphere and
    ray-plane tests of the renderer (wall z = 2.5, floor y = 0.8)."""
    xs, ys = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                         np.arange(cam.height, dtype=np.float64))
    d = np.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy, np.ones_like(xs)], -1)
    nrm2 = np.einsum("hwi,hwi->hw", d, d)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_planes = np.minimum(np.where(d[..., 2] > 1e-9, 2.5 / d[..., 2], np.inf),
                              np.where(d[..., 1] > 1e-9, 0.8 / d[..., 1], np.inf))
    ts = []
    for c in centres:
        b = -(d @ c)
        cc = c @ c - SPHERE_RADIUS**2
        disc = b * b - nrm2 * cc
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / nrm2
        ts.append(np.where((disc > 0) & (t > 0.05), t, np.inf))
    ts = np.stack(ts)
    k = np.argmin(ts, axis=0)
    front = np.min(ts, axis=0)
    return np.where(np.isfinite(front) & (front <= t_planes), k + 1, 0).astype(np.uint8)


def sphere_errors(poses, active, ext) -> dict:
    """Each tracked sphere's error at its centre, per slot: a slot's model
    frame is the camera's at its spawn frame s0 (pose = I there), so
    inv(pose_j) carries the spawn-frame centre c_s0 onto the centre c_j of
    frame j; the error is |inv(pose_j) c_s0 - c_j|. ``poses`` [F, S, 4, 4],
    ``active`` [F, S] per frame (frame 0 = the init frame), ``ext`` [S] the
    slots' mask ids (sphere k has id k + 1)."""
    errs = {}
    for slot in range(len(ext)):
        frames_on = np.nonzero(active[:, slot])[0]
        if not len(frames_on) or ext[slot] <= 0:
            continue
        k, s0 = int(ext[slot]) - 1, int(frames_on[0])
        c0 = np.append(sphere_centres(s0)[k], 1.0)
        e = [float(np.linalg.norm((np.linalg.inv(poses[j, slot].astype(np.float64)) @ c0)[:3]
                                  - sphere_centres(j)[k])) for j in frames_on]
        errs[f"slot{slot}"] = {"sphere": k, "spawn_frame": s0, "frames": len(e),
                               "max_centre_err_m": max(e), "final_centre_err_m": e[-1],
                               "final_path_m": float(np.linalg.norm(
                                   sphere_centres(int(frames_on[-1]))[k] - sphere_centres(s0)[k]))}
    return errs


def multi_frames(n_frames: int, cam=None, object_capacity: int = 1 << 16,
                 max_surfels: int = 1 << 19, masks: bool = True):
    """(config, frames) of the multi-model step: by default
    bench.py::bench_multi_model's configuration and scene at 640x480, with
    external masks (``segmentation.mode="precomputed"``); with ``masks``
    False the default flow-CRF segmentation and frames without masks."""
    from multimotionfusion_tpu_torch.config import (CameraModel, EngineConfig,
                                                    SegmentationConfig, SurfelConfig)
    from multimotionfusion_tpu_torch.io import synthetic
    from multimotionfusion_tpu_torch.io.frame import FrameData

    cam = cam or CameraModel()
    cfg = EngineConfig(camera=cam, enable_multi_model=True, object_slots=5,
                       object_capacity=object_capacity,
                       surfels=SurfelConfig(max_surfels=max_surfels),
                       segmentation=SegmentationConfig(mode="precomputed" if masks else "flow_crf"),
                       model_spawn_offset=4, upload_yuv420=False, upload_depth_mm=False)
    frames = []
    for i in range(n_frames):
        centres = sphere_centres(i)
        depth, rgb = synthetic.render(np.eye(4, dtype=np.float32), cam,
                                      spheres=[(tuple(c), SPHERE_RADIUS) for c in centres])
        frames.append(FrameData(rgb=rgb.astype(np.uint8), depth=depth,
                                timestamp=int(i / 30 * 1e9),
                                mask=sphere_mask(cam, centres) if masks else None))
    return cfg, frames


def run_multi(K, cfg, frames):
    """Phase 5b: the multi-model path, 1 + MULTI_FRAMES frames."""
    from multimotionfusion_tpu_torch import engine_multi as EM
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
    from multimotionfusion_tpu_torch.odometry import multi as MO

    plain_calls = {}
    K.reset_launches()
    with count_plain_calls(plain_calls):
        engine = MultiMotionFusionTorch(cfg, device=DEVICE)
        engine.process_frame(frames[0])
        ms, syncs, sync_ticks = [], [], []
        for i in range(1, MULTI_FRAMES + 1):
            if i == MULTI_FRAMES:
                K.start_capture()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if MULTI_SYNC[0] <= i < MULTI_SYNC[1]:
                sync_ticks.append(engine.tick)
                with sync_watch(EM, "multi_frame_step") as caught:
                    engine.process_frame(frames[i])
                    torch.cuda.synchronize()
                syncs += _syncs(caught)
                continue
            start.record()
            engine.process_frame(frames[i])
            end.record()
            end.synchronize()
            if i == MULTI_FRAMES:
                captured = K.stop_capture()
            if i >= MULTI_TIMED_FROM:
                ms.append(start.elapsed_time(end))
        stats = engine.finish()
    launches = dict(K.LAUNCHES)
    print(json.dumps({"phase": "plain_calls_on_multi_path", "calls": plain_calls}))

    obj_log, spawn_log = engine._lifecycle_logs()
    active_per_frame = [int(a.sum()) for _, _, a in obj_log]
    spawn_ticks = [j + 1 for j, (_, sp, _, _) in enumerate(spawn_log) if sp is not None and bool(sp)]
    ext = engine.state.objects.ext_id.cpu().numpy()
    errs = sphere_errors(np.stack([p for _, p, _ in obj_log]), np.stack([a for _, _, a in obj_log]),
                         ext)
    cam_drift = float(np.linalg.norm(engine.state.pose.cpu().numpy()[:3, 3]))
    compaction = [t for t in sync_ticks if t % cfg.surfels.compact_every == 0]
    sync_spawns = [t for t in spawn_ticks if t in sync_ticks]
    print(json.dumps({
        "phase": "multi_engine", "frames": len(obj_log), "timed_frames": len(ms),
        "active_models_per_frame": active_per_frame, "spawn_ticks": spawn_ticks,
        "ext_id_per_slot": ext.tolist(), "ms_per_frame_median": statistics.median(ms),
        "ms_per_frame_p75": statistics.quantiles(ms, n=4)[2], "ms_per_frame_min": min(ms),
        "surfels": stats["surfels"], "hwm": stats["hwm"], "segment_px": stats["segment_px"],
        "camera_drift_m": cam_drift, "objects": errs, "launches": launches,
        "odometry_iterations_last_frame": MO.loop_iterations(engine._last_stats.odo),
        "sync_check": {"ticks": sync_ticks, "spawn_ticks": sync_spawns,
                       "compaction_ticks": compaction, "synchronizing_calls": len(syncs),
                       "where": sorted(set(syncs))[:10]},
        "gpu": _gpu_line(),
    }))
    if plain_calls:
        raise SystemExit(f"plain versions ran on the multi path: {plain_calls}")
    if active_per_frame[-1] != 5:
        raise SystemExit(f"{active_per_frame[-1]} active models at the end, not 5")
    if not cam_drift < 0.08:
        raise SystemExit(f"camera drift {cam_drift} m out of bounds")
    far = {k: o["max_centre_err_m"] for k, o in errs.items() if not o["max_centre_err_m"] < 0.02}
    if far or len(errs) != 5:
        raise SystemExit(f"spheres tracked: {sorted(errs)}; beyond 2 cm of the centre: {far}")
    if not (compaction and sync_spawns):
        raise SystemExit("the multi sync check ran no spawn or no compaction frame")
    for k in MULTI_PATH:
        if launches.get(k, 0) <= 0:
            raise SystemExit(f"kernel {k} was not launched on the multi path")
    return engine, launches, captured, len(syncs)

# ---------------------------------------------------------------- flow-CRF

def associate_slots(masks, active, cam) -> np.ndarray:
    """[S] sphere id + 1 of each slot (0: none): the sphere whose ray-sphere
    mask overlaps the slot's mask most on the slot's spawn frame. ``masks``
    [F, H, W] the engine's final masks per frame, ``active`` [F, S]."""
    ext = np.zeros(active.shape[1], np.int32)
    for slot in range(active.shape[1]):
        on = np.nonzero(active[:, slot])[0]
        if not len(on):
            continue
        j = int(on[0])
        own = masks[j] == slot + 1
        truth = sphere_mask(cam, sphere_centres(j))
        overlap = [int((own & (truth == k + 1)).sum()) for k in range(len(SPHERE_CENTRES))]
        if max(overlap) > 0:
            ext[slot] = int(np.argmax(overlap)) + 1
    return ext


def run_multi_flow(K, cfg, frames):
    """Phase 5c: the flow-CRF path, 1 + MULTI_FRAMES frames."""
    from multimotionfusion_tpu_torch import engine_multi as EM
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

    plain_calls = {}
    K.reset_launches()
    with count_plain_calls(plain_calls):
        engine = MultiMotionFusionTorch(cfg, device=DEVICE)
        engine.process_frame(frames[0])
        masks = [torch.zeros((cfg.camera.height, cfg.camera.width), dtype=torch.int32,
                             device=DEVICE)]
        ms, syncs, sync_ticks, frame_ms, seg_px = [], [], [], {}, []
        for i in range(1, MULTI_FRAMES + 1):
            if i == MULTI_FRAMES - 1:  # tick 40 repacks the stores: its inputs alone
                K.start_capture(["compact.segments"])
            elif i == MULTI_FRAMES:
                K.start_capture()
            if MULTI_SYNC[0] <= i < MULTI_SYNC[1]:
                sync_ticks.append(engine.tick)
                with sync_watch(EM, "multi_frame_step") as caught:
                    engine.process_frame(frames[i])
                    torch.cuda.synchronize()
                syncs += _syncs(caught)
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                engine.process_frame(frames[i])
                end.record()
                end.synchronize()
                frame_ms[i] = start.elapsed_time(end)
                if i >= MULTI_TIMED_FROM:
                    ms.append(frame_ms[i])
            masks.append(engine.last_mask.clone())
            seg_px.append(engine._last_stats.multi[9:])
            if i == MULTI_FRAMES - 1:
                repack = K.stop_capture().get("compact.segments")
            elif i == MULTI_FRAMES:
                captured = K.stop_capture()
                if repack is not None:
                    captured["compact.segments"] = repack
        stats = engine.finish()
    launches = dict(K.LAUNCHES)
    print(json.dumps({"phase": "plain_calls_on_flow_crf_path", "calls": plain_calls}))

    obj_log, spawn_log = engine._lifecycle_logs()
    active = np.stack([a for _, _, a in obj_log])
    spawn_ticks = [j + 1 for j, (_, sp, _, _) in enumerate(spawn_log) if sp is not None and bool(sp)]
    ext = associate_slots(torch.stack(masks).cpu().numpy(), active, cfg.camera)
    errs = sphere_errors(np.stack([p for _, p, _ in obj_log]), active, ext)
    drift = [float(np.linalg.norm(p[:3, 3])) for _, p in engine.pose_log]
    seg_px = [None] + torch.stack(seg_px).cpu().to(torch.int64).tolist()
    sync_spawns = [t for t in spawn_ticks if t in sync_ticks]
    print(json.dumps({
        "phase": "multi_flow_crf", "frames": len(obj_log), "timed_frames": len(ms),
        "per_frame": [{"frame": j, "active_models": int(active[j].sum()),
                       "camera_drift_m": drift[j], "ms": frame_ms.get(j),
                       "segment_px": seg_px[j]}
                      for j in range(len(obj_log))],
        "spawn_ticks": spawn_ticks, "sphere_id_per_slot": ext.tolist(),
        "ms_per_frame_median": statistics.median(ms),
        "ms_per_frame_p75": statistics.quantiles(ms, n=4)[2], "ms_per_frame_min": min(ms),
        "surfels": stats["surfels"], "hwm": stats["hwm"], "segment_px": stats["segment_px"],
        "camera_drift_m": drift[-1], "max_camera_drift_m": max(drift), "sphere_errors": errs,
        "launches": launches,
        "sync_check": {"ticks": sync_ticks, "spawn_ticks": sync_spawns,
                       "synchronizing_calls": len(syncs), "where": sorted(set(syncs))[:10]},
        "gpu": _gpu_line(),
    }))
    # failures are reported at the end of the script, after the kernel lines
    failed = [f"plain versions ran on the flow-CRF path: {plain_calls}"] if plain_calls else []
    failed += [] if spawn_ticks else ["the flow-CRF spawned no model"]
    failed += [] if sync_spawns else ["the flow-CRF sync check ran no spawn frame"]
    failed += [f"kernel {k} was not launched on the flow-CRF path" for k in FLOW_PATH
               if launches.get(k, 0) <= 0]
    return engine, launches, captured, len(syncs), failed, max(drift)


FIVE_CENTRES = [np.array([-0.55, -0.15, 1.55]), np.array([0.55, -0.15, 1.55]),
                np.array([-0.35, 0.35, 1.5]), np.array([0.35, 0.35, 1.5]),
                np.array([0.0, -0.4, 1.6])]
FIVE_VEL = [np.array([0.02, 0.0, 0.0]), np.array([-0.02, 0.0, 0.0]),
            np.array([0.015, 0.0, 0.0]), np.array([-0.015, 0.0, 0.0]),
            np.array([0.0, -0.015, 0.0])]


def five_movers():
    """(config, frames) of tests/test_five_movers.py: 160x120, five spheres
    of 0.21 m that approach for 4 frames, then move apart for 12."""
    from multimotionfusion_tpu_torch.config import (CameraModel, EngineConfig, KeypointConfig,
                                                    SegmentationConfig, SurfelConfig)
    from multimotionfusion_tpu_torch.io import synthetic
    from multimotionfusion_tpu_torch.io.frame import FrameData

    cam = CameraModel(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
    cfg = EngineConfig(
        camera=cam, enable_multi_model=True, odom_init="kp", object_slots=5,
        object_capacity=1 << 13, model_spawn_offset=2,
        surfels=SurfelConfig(max_surfels=65536, depth_cutoff=5.0),
        keypoints=KeypointConfig(max_keypoints=256, max_tracks=1024, track_history=8,
                                 detector="patch", match_dist_gate=1.0),
        segmentation=SegmentationConfig(new_label_min_frac=0.01))
    cs = [c.copy() for c in FIVE_CENTRES]
    frames = []
    for i in range(17):
        depth, rgb = synthetic.render(np.eye(4, dtype=np.float32), cam,
                                      spheres=[(tuple(c), 0.21) for c in cs])
        frames.append(FrameData(rgb=rgb.astype(np.uint8), depth=depth,
                                timestamp=int(i / 30 * 1e9)))
        cs = [c + (np.array([0.0, 0.0, -0.04]) if i < 4 else v) for c, v in zip(cs, FIVE_VEL)]
    return cfg, frames


def run_five_movers(seed: int = 0) -> dict:
    """Phase 5d: tests/test_five_movers.py's journey on the card with the
    engine's random seed ``seed`` (the RANSAC uniforms), checked against that
    test's assertions."""
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

    cfg, frames = five_movers()
    cfg = dataclasses.replace(cfg, seed=seed)
    plain_calls = {}
    with count_plain_calls(plain_calls):
        engine = MultiMotionFusionTorch(cfg, device=DEVICE)
        for f in frames:
            engine.process_frame(f)
        engine.finish()
    obj_log, _ = engine._lifecycle_logs()
    active = np.stack([a for _, _, a in obj_log])
    spawn = {k: int(np.argmax(active[:, k])) for k in range(5) if active[:, k].any()}
    ticks = sorted(spawn.values())
    mask = engine.state.prev_mask.cpu().numpy()
    px = [int((mask == mid).sum()) for mid in range(1, 6)]
    totals = []
    for k in range(5):
        on = [np.linalg.inv(p[k])[:3, 3] for _, p, a in obj_log if a[k]]
        totals.append((on[-1] - on[0]) if on else np.zeros(3))
    totals = np.stack(totals)
    cam = float(np.linalg.norm(engine.state.pose.cpu().numpy()[:3, 3]))
    r = {"phase": "five_movers", "seed": seed, "spawn_frames": spawn,
         "active_per_frame": active.sum(1).tolist(), "pixels_per_label": px,
         "totals_m": totals.tolist(), "camera_m": cam, "plain_calls": plain_calls,
         "gpu": _gpu_line()}
    checks = {
        "five spawns two apart": len(spawn) == 5 and all(b - a >= 2 for a, b in
                                                          zip(ticks, ticks[1:])),
        "five active in the last three frames": all(a == 5 for a in r["active_per_frame"][-3:]),
        "more than 120 pixels per label": all(n > 120 for n in px),
        "opposing x motions": bool((totals[:, 0] > 0.03).sum() >= 1
                                   and (totals[:, 0] < -0.03).sum() >= 1
                                   and np.abs(totals).max() < 0.45),
        "camera within 0.08 m": cam < 0.08,
        "no plain version ran": not plain_calls,
    }
    r["checks"] = checks
    r["ok"] = all(checks.values())
    print(json.dumps(r))
    return r


def journey_tests(name: str, card, ref, card_ok=None, ref_ok=None) -> dict:
    """One-sided tests of the card's journeys against the reference's: the
    share below DRIFT_BOUND and (with ``*_ok``) the share passing all
    assertions, Fisher's exact test; the readings, Mann-Whitney U."""
    from scipy import stats

    def fisher(a, b):
        table = [[sum(a), len(a) - sum(a)], [sum(b), len(b) - sum(b)]]
        return float(stats.fisher_exact(table, alternative="less").pvalue)

    p = {"below_bound": fisher([v < DRIFT_BOUND for v in card], [v < DRIFT_BOUND for v in ref]),
         "readings": float(stats.mannwhitneyu(card, ref, alternative="greater").pvalue)}
    if card_ok is not None:
        p["all_assertions"] = fisher(card_ok, ref_ok)
    out = {"phase": "journeys_vs_reference", "journey": name, "card_m": card,
           "reference_m": list(ref), "card_below_bound": sum(v < DRIFT_BOUND for v in card),
           "reference_below_bound": sum(v < DRIFT_BOUND for v in ref),
           "card_median_m": float(np.median(card)), "reference_median_m": float(np.median(ref)),
           "p_values": p, "alpha": JOURNEY_ALPHA,
           "ok": all(v >= JOURNEY_ALPHA for v in p.values())}
    if card_ok is not None:
        out.update(card_passing=sum(card_ok), reference_passing=sum(ref_ok))
    print(json.dumps(out))
    return out


def five_movers_seeds() -> dict:
    """Phase 5d over FIVE_SEEDS: every seed must spawn the five models two
    frames apart with opposing x motions and run no plain version (the
    reference does on every seed); the camera and the share of seeds holding
    all of tests/test_five_movers.py's assertions against the reference's
    (``journey_tests``)."""
    runs = [run_five_movers(seed) for seed in FIVE_SEEDS]
    robust = ("five spawns two apart", "opposing x motions", "no plain version ran")
    every = all(r["checks"][k] for r in runs for k in robust)
    t = journey_tests("five_movers", [r["camera_m"] for r in runs], REF_FIVE_CAMERA_M,
                      [r["ok"] for r in runs], [s in REF_FIVE_PASSING for s in FIVE_SEEDS])
    out = {"phase": "five_movers_seeds", "seeds": list(FIVE_SEEDS),
           "passing_seeds": [r["seed"] for r in runs if r["ok"]],
           "robust_checks_on_every_seed": every, "seed_0": runs[0]["checks"],
           "ok": every and t["ok"], "gpu": _gpu_line()}
    print(json.dumps(out))
    return out


def flow_drift_seeds(cfg, frames) -> dict:
    """The flow-CRF journey of phase 5c again with the engine's seeds
    FLOW_SEEDS (its largest camera drift and spawn ticks per seed)."""
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

    out = {}
    for seed in FLOW_SEEDS:
        engine = MultiMotionFusionTorch(dataclasses.replace(cfg, seed=seed), device=DEVICE)
        for f in frames:
            engine.process_frame(f)
        engine.finish()
        _, spawn_log = engine._lifecycle_logs()
        drift = [float(np.linalg.norm(p[:3, 3])) for _, p in engine.pose_log]
        out[seed] = {"max_camera_drift_m": max(drift), "final_camera_drift_m": drift[-1],
                     "spawn_ticks": [j + 1 for j, (_, sp, _, _) in enumerate(spawn_log)
                                     if sp is not None and bool(sp)]}
    print(json.dumps({"phase": "flow_crf_seeds", "seeds": out, "gpu": _gpu_line()}))
    return out


def measure_render_depths(a):
    from multimotionfusion_tpu_torch.ops import rasterize as R

    st, cam_c = a[0], a[4]
    M = 1 + st.odata.shape[0]
    npix = cam_c.height * cam_c.width
    counts = st.counts.cpu().tolist()
    # this run's live surfels of the strided store: 6 channels read each,
    # the [M, Hc, Wc] depth written once; ~45 operations a surfel
    n = (min(counts[0], st.bg) + st.gs - 1) // st.gs + sum(
        (min(c, st.bo) + st.os - 1) // st.os for c in counts[1:])
    pix, key = R.depth_keys(*a)
    buf = torch.full((M * npix + 1,), 2**31 - 1, dtype=torch.int32, device=DEVICE)
    run = lambda: R.render_depths_cuda(*a)  # noqa: E731
    return _measure(run, lambda: R.render_depths_plain(*a), 24 * n + 4 * M * npix, 45 * n,
                    library=lambda: buf.scatter_reduce_(0, pix, key, reduce="amin"),
                    by_kernel=True, **_cold(run),
                    library_note="one scatter_reduce_ (amin) of the plain version's keys")


def flow_ops(hc: int, wc: int, iters: int) -> int:
    """The operations K15 needs for a [hc, wc] grid: per CRF pixel and image
    the two-tap resize (6) and the 7-tap blurs (2 x 14), per coarser pixel and
    image the 25-tap downsample (~5 a tap); per level pixel the gradients (4),
    the structure tensor as column sums of 3 products (3 x 9 x 2) then row
    sums (3 x 9) and its gate (~15), and per iteration the warp (~25), the
    column sums of 2 products (2 x 9 x 2), their row sums (2 x 9) and the
    solve (~20)."""
    sizes = [(hc, wc)]
    for _ in range(2):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    n = [h * w for h, w in sizes]
    prep = 2 * (34 * n[0] + 125 * (n[1] + n[2]))
    return prep + sum(x * (4 + 54 + 27 + 15 + iters * (25 + 36 + 18 + 20)) for x in n)


def measure_flow(a):
    from multimotionfusion_tpu_torch.segmentation import flow as FL

    prev, _, hc, wc = a
    n = hc * wc
    # two full-resolution images in, the flow [hc, wc, 2] out
    return _measure(lambda: FL.dense_flow(*a), lambda: FL.dense_flow_plain(*a),
                    2 * 4 * prev.numel() + 8 * n, flow_ops(hc, wc, FL.ITERS), cluster=FL.CLUSTER)


def _crf_ops(unary, p):
    from multimotionfusion_tpu_torch.segmentation import crf as CRF

    L, h, w = unary.shape
    n = h * w
    ds = CRF.pool_of(h, w)
    cells = (h // ds) * (w // ds)
    rg, rb = CRF.box_radius(p.gauss_sigma), CRF.box_radius(p.sigma_xy / ds)
    gauss = 2 * 3 * (2 * rg + 1) * L * n
    grid = 2 * 3 * (2 * rb + 1) * cells * CRF.GRID_BINS ** 2 * L
    return gauss + L * n + grid + n * L * (25 * 2 + 12)


def measure_crf_iteration(a):
    import torch.nn.functional as F

    from multimotionfusion_tpu_torch.segmentation import crf as CRF

    unary, flow, p, _ = a
    L, h, w = unary.shape
    q0, plan_p = CRF.crf_plan_plain(unary, flow, p)
    _, plan_k = CRF.crf_plan_cuda(unary, flow, p)
    # the library yardstick of the Gaussian message: one conv2d with the
    # three-box kernel (the 2-D outer product of three box passes)
    r = CRF.box_radius(p.gauss_sigma)
    box = torch.ones(2 * r + 1, device=DEVICE) / (2 * r + 1)
    k1 = F.conv1d(F.conv1d(box[None, None], box.flip(0)[None, None], padding=2 * r),
                  box.flip(0)[None, None], padding=2 * r)[0, 0]
    k2 = (k1[:, None] * k1[None, :])[None, None]
    pad = k1.numel() // 2
    return _measure(lambda: CRF.crf_iteration_cuda(q0, unary, plan_k, p),
                    lambda: CRF.crf_iteration_plain(q0, unary, plan_p, p),
                    3 * 4 * L * h * w + 5 * h * w, _crf_ops(unary, p),
                    library=lambda: F.conv2d(q0[:, None], k2, padding=pad),
                    library_note="the Gaussian message alone: one conv2d with the 19x19 "
                                 "three-box kernel (other border truncation)")


def measure_crf(a):
    from multimotionfusion_tpu_torch.segmentation import crf as CRF

    unary, flow, p, iters = a
    L, h, w = unary.shape
    return _measure(lambda: CRF.mean_field(unary, flow, p, iters),
                    lambda: CRF.mean_field_plain(unary, flow, p, iters),
                    2 * 4 * L * h * w + 8 * h * w, iters * _crf_ops(unary, p) + 40 * h * w,
                    plain_reps=2)


def measure_components(a):
    from multimotionfusion_tpu_torch.segmentation import components as CC

    masks, iters = a
    n = masks.numel()
    # masks in, kept cells out; every sweep runs (5 loads and 4 mins a cell)
    return _measure(lambda: CC.keep_largest_components_cuda(*a),
                    lambda: CC.keep_largest_components_plain(*a), 2 * n + 4 * masks.shape[0],
                    iters * 9 * n + 4 * n)


def measure_seg_unaries(a):
    from multimotionfusion_tpu_torch.segmentation import flow_crf as FC

    pred = a[1]
    M, hc, wc = pred.shape
    n, t = hc * wc, a[4].shape[1]
    errors = FC.unaries_plain(*a).unary
    run = lambda: FC.unaries_cuda(*a)  # noqa: E731
    return _measure(run, lambda: FC.unaries_plain(*a),
                    4 * n + 4 * M * n + t * (8 + 4 * M + 1) + (4 * 2 * (M + 1) + M + 4) * n,
                    20 * M * n + 12 * (M + 1) * n + 8 * M * t,
                    library=lambda: torch.log_softmax(errors, 0), **_cold(run),
                    library_note="torch.log_softmax over the [L, hc, wc] unary (its softmax, "
                                 "part of the function)")


def measure_seg_fuse(a):
    from multimotionfusion_tpu_torch.segmentation import flow_crf as FC

    q = a[0]
    L, hc, wc = q.shape
    n = hc * wc
    return _measure(lambda: FC.fuse_labels_cuda(*a), lambda: FC.fuse_labels_plain(*a),
                    (8 * L + 8 + (L - 1) + 4 + (L - 1)) * n, 14 * L * n,
                    library=lambda: torch.argmax(q, 0),
                    library_note="torch.argmax over the [L, hc, wc] marginals (the labels, part "
                                 "of the function)")


def measure_seg_finish(a):
    from multimotionfusion_tpu_torch.segmentation import flow_crf as FC

    lbl, largest, _, _, h, w = a[:6]
    M = largest.shape[0]
    n = lbl.numel()
    return _measure(lambda: FC.finish_cuda(*a), lambda: FC.finish_plain(*a),
                    (4 + M + 4) * n + 5 * h * w + 12 * (M + 1), 2 * (M + 1) * 8 * n + 4 * h * w,
                    by_kernel=True)


def plan_flow():
    """The flow-CRF segmentation's kernels, as ``plan``."""
    from multimotionfusion_tpu_torch.kernels import checks as C

    p = [("compact.segments[compaction frame]", "compact.segments", "compact.segments",
          C.check_compact_segments, measure_compact_segments, "clean.cu",
          "model/surfel_map.py:178"),
         ("render_depths", "zbuffer.depths", "zbuffer.depths", C.check_render_depths,
          measure_render_depths, "zbuffer.cu", "ops/rasterize.py:255"),
         ("flow[prep + 3 levels]", "flow", "flow", C.check_flow, measure_flow, "flow.cu",
          "segmentation/flow.py:100,18")]
    p += [("crf[1 iteration]", "crf", "crf.iter", C.check_crf_iteration, measure_crf_iteration,
           "crf.cu", "segmentation/crf.py:246"),
          ("crf[plan + 10 iterations]", "crf", "crf.plan", C.check_crf, measure_crf, "crf.cu",
           "segmentation/crf.py:246"),
          ("components", "components", "components", C.check_components, measure_components,
           "components.cu", "segmentation/components.py:61"),
          ("components[240x160]", "components_240x160", "components",
           C.check_components, measure_components, "components.cu",
           "segmentation/components.py:61"),
          ("segment.unaries", "segment.unaries", "segment.unaries", C.check_seg_unaries,
           measure_seg_unaries, "segment.cu", "segmentation/flow_crf.py:51"),
          ("segment.fuse", "segment.fuse", "segment.fuse", C.check_seg_fuse, measure_seg_fuse,
           "segment.cu", "segmentation/flow_crf.py:231"),
          ("segment.finish", "segment.finish", "segment.finish", C.check_seg_finish,
           measure_seg_finish, "segment.cu", "segmentation/flow_crf.py:278"),
          # K21's batches of a multi-model frame: the per-model seeds (shared
          # points) and the back-dating fits (per-fit points), as the path ran
          # them, and the back-dating batch with every active track selected
          ("ransac_fit[batch, seeds]", "ransac_fit.shared", "ransac_fit", C.check_ransac_batch,
           measure_ransac_batch, "ransac.cu", "engine_multi.py:293"),
          ("ransac_fit[batch, back-dating]", "ransac_fit.per_fit", "ransac_fit",
           C.check_ransac_batch, measure_ransac_batch, "ransac.cu", "tracking/tracker.py:210"),
          ("ransac_fit[batch, back-dating, every track]", "ransac_fit.every_track", "ransac_fit",
           C.check_ransac_batch, measure_ransac_batch, "ransac.cu", "tracking/tracker.py:210")]
    return p


# ---------------------------------------------------------------- legacy CRF

def run_multi_legacy(K, cfg, frames):
    """Phase 5c': the legacy CoFusion CRF path (multi_legacy_crf), 1 +
    MULTI_FRAMES frames of the flow-CRF phase's scene."""
    from multimotionfusion_tpu_torch import engine_multi as EM
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

    plain_calls = {}
    K.reset_launches()
    with count_plain_calls(plain_calls):
        engine = MultiMotionFusionTorch(cfg, device=DEVICE)
        engine.process_frame(frames[0])
        masks = [torch.zeros((cfg.camera.height, cfg.camera.width), dtype=torch.int32,
                             device=DEVICE)]
        ms, syncs, sync_ticks, frame_ms, seg_px, spawned = [], [], [], {}, [], [False]
        for i in range(1, MULTI_FRAMES + 1):
            if i == MULTI_FRAMES:
                K.start_capture()
            if MULTI_SYNC[0] <= i < MULTI_SYNC[1]:
                sync_ticks.append(engine.tick)
                with sync_watch(EM, "multi_frame_step") as caught:
                    engine.process_frame(frames[i])
                    torch.cuda.synchronize()
                syncs += _syncs(caught)
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                engine.process_frame(frames[i])
                end.record()
                end.synchronize()
                frame_ms[i] = start.elapsed_time(end)
                if i >= MULTI_TIMED_FROM:
                    ms.append(frame_ms[i])
            masks.append(engine.last_mask.clone())
            seg_px.append(engine._last_stats.multi[9:])
            spawned.append(engine._last_stats.multi[6])
            if i == MULTI_FRAMES:
                captured = K.stop_capture()
        stats = engine.finish()
    launches = dict(K.LAUNCHES)
    print(json.dumps({"phase": "plain_calls_on_legacy_crf_path", "calls": plain_calls}))

    obj_log, _ = engine._lifecycle_logs()
    active = np.stack([a for _, _, a in obj_log])
    active_per_frame = [int(a.sum()) for a in active]
    spawn_frames = [j for j, x in enumerate(spawned) if bool(x)]
    ext = associate_slots(torch.stack(masks).cpu().numpy(), active, cfg.camera)
    errs = sphere_errors(np.stack([p for _, p, _ in obj_log]), active, ext)
    drift = [float(np.linalg.norm(p[:3, 3])) for _, p in engine.pose_log]
    seg_px = [None] + torch.stack(seg_px).cpu().to(torch.int64).tolist()
    print(json.dumps({
        "phase": "multi_legacy_crf", "frames": len(obj_log), "timed_frames": len(ms),
        "per_frame": [{"frame": j, "active_models": active_per_frame[j],
                       "camera_drift_m": drift[j], "ms": frame_ms.get(j),
                       "segment_px": seg_px[j]} for j in range(len(obj_log))],
        "spawn_frames": spawn_frames, "sphere_id_per_slot": ext.tolist(),
        "ms_per_frame_median": statistics.median(ms),
        "ms_per_frame_p75": statistics.quantiles(ms, n=4)[2], "ms_per_frame_min": min(ms),
        "launches_per_frame": sum(launches.values()) / MULTI_FRAMES,
        "surfels": stats["surfels"], "segment_px": stats["segment_px"],
        "active_models": active_per_frame[-1], "camera_drift_m": drift[-1],
        "max_camera_drift_m": max(drift), "sphere_errors": errs, "launches": launches,
        "reference_lifecycle": {"active_per_frame": REF_LEGACY_ACTIVE,
                                "spawn_frames": REF_LEGACY_SPAWN_FRAMES,
                                "script": "tests/torch_legacy_spheres.py --div 1 "
                                          "--chip-capacities --packages reference"},
        "sync_check": {"ticks": sync_ticks, "synchronizing_calls": len(syncs),
                       "where": sorted(set(syncs))[:10]},
        "gpu": _gpu_line(),
    }))
    failed = [f"plain versions ran on the legacy CRF path: {plain_calls}"] if plain_calls else []
    failed += [f"kernel {k} was not launched on the legacy CRF path" for k in LEGACY_PATH
               if launches.get(k, 0) <= 0]
    if active_per_frame != list(REF_LEGACY_ACTIVE) or spawn_frames != list(REF_LEGACY_SPAWN_FRAMES):
        failed.append(f"lifecycle {active_per_frame} (spawns {spawn_frames}) differs from the "
                      f"reference's {REF_LEGACY_ACTIVE} (spawns {REF_LEGACY_SPAWN_FRAMES})")
    return engine, launches, captured, len(syncs), failed


def measure_error_images(a):
    from multimotionfusion_tpu_torch.odometry import rgbd as RG

    n = a[0].img.numel()
    # per pixel: the sampling map (16 B), vertices, normals, intensity,
    # gradients and the validity in; two images out; ~150 operations
    return _measure(lambda: RG.error_images_cuda(*a), lambda: RG.error_images_plain(*a),
                    n * (16 + 12 + 12 + 4 + 4 + 4 + 1 + 8), 150 * n)


def _slic_state(a):
    """(image, labels of the last assignment, their boxes, centres before it,
    grid) on the card."""
    from multimotionfusion_tpu_torch.segmentation import slic as SL

    image, sp_size, coh, iters = a
    h, w, _ = image.shape
    grid = SL.grid_shape(h, w, sp_size)
    labels, bounds, cen = None, None, None
    for _ in range(iters):
        cen = SL.slic_centres_cuda(image, labels, grid[0] * grid[1], grid, sp_size, bounds)
        labels, bounds = SL.slic_assign_cuda(image, labels, cen, grid, sp_size, coh)
    return image, labels, bounds, cen, grid


def measure_slic_centres(a):
    from multimotionfusion_tpu_torch.segmentation import slic as SL

    image, labels, bounds, _, grid = _slic_state(a)
    s, n = grid[0] * grid[1], labels.numel()
    ys, xs = torch.meshgrid(torch.arange(image.shape[0], device=DEVICE),
                            torch.arange(image.shape[1], device=DEVICE), indexing="ij")
    vals = torch.cat([image.reshape(-1, 3), xs.reshape(-1, 1).float(), ys.reshape(-1, 1).float(),
                      torch.ones((n, 1), device=DEVICE)], 1)
    flat = labels.reshape(-1).long()
    acc = torch.zeros((s, 6), device=DEVICE)
    # the last pass, with the assignment's boxes (as on the path): colour,
    # label and the boxes in, [S, 6] out; 6 adds a pixel
    return _measure(lambda: SL.slic_centres_cuda(image, labels, s, grid, a[1], bounds),
                    lambda: SL.slic_centres_plain(image, labels, s),
                    n * 16 + s * 16 + s * 24, 6 * n,
                    library=lambda: acc.zero_().index_add_(0, flat, vals),
                    library_call="index_add_ of the [H*W, 6] sums")


def measure_slic_assign(a):
    from multimotionfusion_tpu_torch.segmentation import slic as SL

    image, labels, _, cen, grid = _slic_state(a)
    n = labels.numel()
    # colour and label in, label out, the centres once, the boxes out; 9
    # candidates of ~22 operations
    return _measure(lambda: SL.slic_assign_cuda(image, labels, cen, grid, a[1], a[2]),
                    lambda: SL.slic_assign_plain(image, labels, cen, grid, a[1], a[2]),
                    n * 20 + cen.numel() * 4 + cen.shape[0] * 16, 9 * 22 * n)


def measure_sp_means(a):
    from multimotionfusion_tpu_torch.segmentation import slic as SL

    images, labels, count, grid, bounds = a
    k, s = images.shape[0], count.shape[0]
    n = labels.numel()
    flat = labels.reshape(-1).long()
    vals = images.reshape(k, -1).T.contiguous()
    acc = torch.zeros((s, k), device=DEVICE)
    # the images and the labels read once, the boxes in, [N, S] out
    return _measure(lambda: SL.superpixel_means_cuda(images, labels, grid, bounds),
                    lambda: SL.superpixel_means_plain(images, labels, count),
                    4 * k * n + 4 * n + 16 * s + 4 * k * s, k * n,
                    library=lambda: acc.zero_().index_add_(0, flat, vals),
                    library_call="index_add_ of the [H*W, N] sums")


def measure_sp_upsample(a):
    from multimotionfusion_tpu_torch.segmentation import slic as SL

    lbl_sp, labels, nl = a
    n = labels.numel()
    return _measure(lambda: SL.upsample_onehot_cuda(*a), lambda: SL.upsample_onehot_plain(*a),
                    4 * n + 4 * lbl_sp.numel() + nl * n, nl * n)


def measure_lcrf_plan(a):
    from multimotionfusion_tpu_torch.segmentation import legacy_crf as LC

    lows = a[0]
    s, m = lows.shape[1], a[3].shape[0]
    nl = m + 1
    # the means, colours and positions in; unaries, features, Q0 and both
    # [S, S] kernels out; ~40 operations and two exps an entry
    return _measure(lambda: LC.crf_plan_cuda(*a), lambda: LC.crf_plan_plain(*a),
                    4 * lows.numel() + 20 * s + 4 * s * (2 * nl + 6) + 8 * s * s, 42 * s * s)


def measure_lcrf_iterate(a, iters):
    """``iters`` mean-field steps: the one-launch kernel, the plain chain and
    two torch.matmul and a softmax a step; ``one_step_launches_*``: the same
    steps as one-step launches (the per-step entry the checks keep)."""
    from multimotionfusion_tpu_torch.segmentation import legacy_crf as LC

    plan = LC.crf_plan_cuda(*a)
    s, nl = plan.q0.shape

    def chain(step):
        q = plan.q0
        for it in range(iters):
            q = step(q, it == iters - 1)
        return q

    def library(q, last):  # two products and a softmax, TF32 off
        msg = 40.0 * torch.matmul(plan.k_smooth, q) + 40.0 * torch.matmul(plan.k_app, q)
        return torch.softmax(-plan.unary - (msg.sum(-1, keepdim=True) - msg), -1)

    steps = lambda: chain(lambda q, last: LC.crf_iterate_cuda(q, plan, last)[0])  # noqa: E731
    one_step = _device(steps)
    # per step both kernels and Q in, Q out; 2 x 2 S^2 L operations
    return _measure(lambda: LC.crf_mean_field_cuda(plan, iters),
                    lambda: chain(lambda q, last: LC.crf_iterate_plain(q, plan)),
                    iters * (8 * s * s + 12 * s * nl), iters * 4 * s * s * nl,
                    library=lambda: chain(library),
                    library_call="two torch.matmul and torch.softmax per step",
                    one_step_launches_device_ms=one_step["device_ms"],
                    one_step_launches_per_call=one_step["device_launches_per_call"])


def plan_legacy():
    """The legacy CRF path's new kernels (K4's error images, K24a-c) and K17 at
    640x480, as ``plan``."""
    from multimotionfusion_tpu_torch.kernels import checks as C

    return [
        ("gn_reduce[error images]", "gn_reduce.error_images", "gn_reduce.error_images",
         C.check_error_images, measure_error_images, "gn_reduce.cu", "odometry/rgbd.py:1062"),
        ("slic.centres", "slic", "slic.centres", C.check_slic_centres, measure_slic_centres,
         "slic.cu", "segmentation/slic.py:47"),
        ("slic.assign", "slic", "slic.assign", C.check_slic_assign, measure_slic_assign,
         "slic.cu", "segmentation/slic.py:61"),
        ("sp.downsample", "sp.downsample", "sp.downsample", C.check_sp_means, measure_sp_means,
         "slic.cu", "segmentation/slic.py:83"),
        ("sp.upsample", "sp.upsample", "sp.upsample", C.check_sp_upsample, measure_sp_upsample,
         "slic.cu", "segmentation/slic.py:95"),
        ("legacy_crf.plan", "legacy_crf.plan", "legacy_crf.plan", C.check_lcrf_plan,
         measure_lcrf_plan, "legacy_crf.cu", "segmentation/legacy_crf.py:104"),
        ("legacy_crf.mean_field[1]", "legacy_crf.plan", "legacy_crf.mean_field",
         lambda a: C.check_lcrf_iterate(a, 1), lambda a: measure_lcrf_iterate(a, 1),
         "legacy_crf.cu", "segmentation/legacy_crf.py:53"),
        ("legacy_crf.mean_field[10]", "legacy_crf.plan", "legacy_crf.mean_field",
         lambda a: C.check_lcrf_iterate(a, 10), lambda a: measure_lcrf_iterate(a, 10),
         "legacy_crf.cu", "segmentation/legacy_crf.py:53"),
        ("components[640x480, L=7]", "components", "components",
         C.check_components, measure_components, "components.cu",
         "segmentation/components.py:61"),
    ]


def run_slic_cases() -> list:
    """Phase 5c'': K24a and K24b on hand-made label images against the plain
    versions on the CPU (``checks.check_slic_cases``)."""
    from multimotionfusion_tpu_torch.kernels import checks as C

    r = C.check_slic_cases(DEVICE)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "slic_cases", **r}))
    return [] if r["ok"] else [f"SLIC on hand-made labels: {r['cases']}"]


def run_components_cases() -> list:
    """Phase 5c''': K17 on hand-made mask stacks against the plain version on
    the CPU (``checks.check_components_cases``)."""
    from multimotionfusion_tpu_torch.kernels import checks as C

    r = C.check_components_cases(DEVICE)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "components_cases", **r}))
    return [] if r["ok"] else [f"K17 on hand-made stacks: {r['cases']}"]


def run_solve_cases() -> list:
    """Phase 5c'''': K5's solve_preconditioned<6> and <3> on the card (test
    entry ``mmf_solve_cases``) on ``checks.solve_cases`` (well-conditioned,
    diagonals six decades apart, the sphere-spin near-degeneracy either side
    of the 1e-4 cut, rank-deficient, all zero, inf, NaN, repeated
    eigenvalues and exact ties) against the float32 emulation
    (``checks.solve_preconditioned_emulated``): x and w bit-equal."""
    from multimotionfusion_tpu_torch.kernels import checks as C

    r = C.check_solve_cases(DEVICE)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "solve_cases", **r}))
    return [] if r["ok"] else [f"K5's solve on hand-made systems: {r['cases']}"]


def run_scan_cases() -> list:
    """Phase 5c: the append scan of K8's and K14's association kernels on
    hand-made flags and owners (``checks.scan_cases``: no new flag, all new,
    one model, M = 8, pixels with no owner, appends clipped by, at, one below
    and far below each segment's room, n not a multiple of the tile) through
    their test entries: prefix and counts exact against torch.cumsum."""
    from multimotionfusion_tpu_torch.kernels import checks as C

    r = C.check_scan_cases(DEVICE)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "scan_cases", **r}))
    return [] if r["ok"] else [f"the fuse scan on hand-made flags: {r['cases']}"]


def run_hand_made_cases() -> list:
    """Phase 5c: K15 on hand-made image pairs (640x480 at 1/4 and 1/2, and
    487x651, whose 121 CRF rows do not divide by the cluster), K20's update
    on hand-made tables (a full table, more new keypoints than free
    slots, all matched, none valid, the ring's wrap either way, no depth, no
    pair) and its match on hand-made descriptors (duplicates, invalid rows
    and columns, K and T off the tile), each exact against the plain version
    on the CPU (``checks.check_flow_cases``, ``check_track_cases``,
    ``check_match_cases``); K18's finish on hand-made segment inputs
    (``finish_cases``: no new label, a new label hugging each border and one
    inside, objects at and one cell under the minimum-cells gate, a segment
    without depth, M = 16, 487x651) and K19's top-K on hand-made heat maps
    (``topk_cases``: fewer peaks than K, a negative conf_thresh, a plateau
    with more peaks than K, 487x651, K the pixel count, a 1080x1920
    plateau): masks, counts and
    the top-K exact against the plain versions on the CPU, the finish's mean
    and std bit-equal to ``checks.seg_stats_emulated``
    (``check_finish_cases``, ``check_topk_cases``); K1's filter on
    ``FILTER_CASES`` (487x651, 80x60, 17x23, 9x11, all-zero depth, depth at
    and beside min_d and max_d; millimetres and metres) and K2's two sides
    on ``PYRAMID_CASES`` (the same sizes; model ids with mask_icp and
    mask_rgb on and off, use_rgb off, bf16 and f32 level-0 maps) against the
    plain versions on the card, within ``check_frame_depth``'s,
    ``check_pyramid_frame``'s and ``check_pyramid_pred``'s tolerances
    (``check_filter_cases``, ``check_pyramid_cases``); K10 on
    ``SPLAT_CASES`` (487x651 and other sizes off the 32 x 8 tile, windows 1,
    2, 3, 5 and 7, static, slot-pointer and composite modes with model
    boundaries inside every tile, exact and near depth ties, a tile without a
    surfel, fill-in with and without its gate, passthrough) and K14's clean
    on ``CLEAN_FLAT_CASES`` (stale ALIVE past the counts, +0 and -0 ALIVE,
    penalties of exactly 1, redundancy and z culls, windows 4 and 5),
    bit-equal to the plain versions on the card (``check_splat_cases``,
    ``check_clean_flat_cases``); K11's owner prep on ``OWNER_CASES``
    (487x651 and other sizes off the tile, 1-3 levels, owners hugging every
    border, no-owner ids, one model) exact against the plain version on the
    card (``check_owner_cases``), and K18's unaries on ``UNARY_CASES`` (no
    track, no new label, a ragged grid, one cell, 31 models, 9,000 tracks)
    within ``check_seg_unaries``' tolerance (``check_unaries_cases``); K13
    on ``DEPTH_CASES`` (every count 0, full buckets, one model, 31 slots,
    strides 1 and 2, one cell, the gates' and the projection's edges, a
    missed confidence gate, 122 x 163 cells) within
    ``check_render_depths``' tolerance, its scratch clean after each call
    (``check_depth_cases``), and K19's patch_score on ``SCORE_CASES``
    (487x651, 9x11, all border, constant, sign-flipping steps, sizes one
    off the tile) bit-equal (``check_score_cases``); K7/K9 on
    ``CLEAN_CASES``, ``COMPACT_CASES`` and ``SEGMENT_CASES`` bit-equal to the
    plain versions on the card (``check_clean_cases``) and K24c on
    ``LCRF_CASES`` within ``check_lcrf_plan``'s and ``check_lcrf_iterate``'s
    tolerances (``check_lcrf_cases``)."""
    from multimotionfusion_tpu_torch.kernels import checks as C

    failed = []
    for name in ("flow_cases", "track_cases", "match_cases", "finish_cases", "topk_cases",
                 "filter_cases", "pyramid_cases", "splat_cases", "clean_flat_cases",
                 "owner_cases", "unaries_cases", "depth_cases", "score_cases", "clean_cases",
                 "lcrf_cases"):
        r = getattr(C, f"check_{name}")(DEVICE)
        torch.cuda.synchronize()
        print(json.dumps({"phase": name, **r}))
        if not r["ok"]:
            failed.append(f"{name}: {r['cases']}")
    return failed


def device_counts(kernels) -> dict:
    """Phase 6: K15's device launches a frame (its wrapper runs once a
    flow-CRF frame), the device operations of one tracker update, the device
    launches of one K18 finish and one K19 top-K, of one K1 filter, of each
    K2 side, of one K10 resolve (static and composite) and of one K14 clean,
    of one K11 owner prep (every level), of one K18 unaries call, of one K13
    render, of one K19 patch_score, of one K7/K9 clean (flag frame, in place,
    compaction frame), of one ``compact`` and one multi-model repack, and
    K2's launches a static frame and K24c's a legacy frame (the plan and the
    ten-step mean field), from the kernel lines' profiles."""
    by = {k["name"]: k for k in kernels}
    flow, tracker = by["flow[prep + 3 levels]"], by["tracker.update[match + update]"]
    out = dict(flow_launches_per_frame=flow["device_launches_per_call"]
               * flow["launches_per_frame"],
               tracker_update_device_ops=tracker["device_launches_per_call"],
               tracker_update_kernels=sorted(tracker.get("device_ms_by_kernel", {})))
    limits = {"segment_finish": 2, "nms_topk": 2, "nms_topk_plateau": 2, "filter": 1,
              "pyramid_frame": 2, "pyramid_pred": 2, "splat_resolve": 1,
              "splat_resolve_composite": 1, "clean_flat": 3, "owner_prep": 1,
              "segment_unaries": 1, "render_depths": 2, "patch_score": 1, "clean_flag": 2,
              "clean_flag_in_place": 2, "clean_compaction": 3, "compact": 1,
              "compact_segments": 1, "legacy_crf_plan": 2, "legacy_crf_mean_field": 1}
    for key, line in (("segment_finish", "segment.finish"), ("nms_topk", "nms_topk"),
                      ("nms_topk_plateau", "nms_topk[plateau]"), ("filter", "frame_maps[filter]"),
                      ("pyramid_frame", "pyramid.frame[L0-L2]"),
                      ("pyramid_pred", "pyramid.pred[L0-L2]"),
                      ("splat_resolve", "splat_resolve+fill_in"),
                      ("splat_resolve_composite", "splat_resolve[composite]+fill_in[gated]"),
                      ("clean_flat", "clean_flat"), ("owner_prep", "owner_prep[L0-L2]"),
                      ("segment_unaries", "segment.unaries"),
                      ("render_depths", "render_depths"), ("patch_score", "patch_score"),
                      ("clean_flag", "clean[flag frame]"),
                      ("clean_flag_in_place", "clean[flag frame, in place]"),
                      ("clean_compaction", "clean[compaction frame]"),
                      ("compact", "compact[first frame]"),
                      ("compact_segments", "compact.segments[compaction frame]"),
                      ("legacy_crf_plan", "legacy_crf.plan"),
                      ("legacy_crf_mean_field", "legacy_crf.mean_field[10]")):
        out[f"{key}_device_launches"] = by[line]["device_launches_per_call"]
    out["render_depths_kernels"] = sorted(by["render_depths"].get("device_ms_by_kernel", {}))
    crf = [out["legacy_crf_plan_device_launches"], out["legacy_crf_mean_field_device_launches"]]
    out["legacy_crf_launches_per_frame"] = None if None in crf else sum(crf)
    sides = [by[f"pyramid.{side}[L0-L2]"] for side in ("frame", "pred")]
    out["pyramid_launches_per_frame"] = (
        None if any(k["device_launches_per_call"] is None for k in sides)
        else sum(k["device_launches_per_call"] * k["launches_per_frame"] for k in sides))
    out["ok"] = (out["flow_launches_per_frame"] is not None
                 and out["flow_launches_per_frame"] <= 2
                 and out["tracker_update_device_ops"] is not None
                 and out["tracker_update_device_ops"] <= 3
                 and not any(n.startswith("Mem") for n in out["tracker_update_kernels"])
                 and "fill_int" not in out["render_depths_kernels"]
                 and all(out[f"{key}_device_launches"] is not None
                         and out[f"{key}_device_launches"] <= limit
                         for key, limit in limits.items())
                 and out["pyramid_launches_per_frame"] is not None
                 and out["pyramid_launches_per_frame"] <= 4 * (N_FRAMES + 1) / N_FRAMES
                 and out["legacy_crf_launches_per_frame"] is not None
                 and out["legacy_crf_launches_per_frame"] <= 3)
    print(json.dumps({"phase": "device_counts", **out}))
    return out


def run_solve_work(captured, m_captured) -> None:
    """Phase 5c''''': the work of K5's eigensolve on the systems recorded for
    the ``gn_step`` and ``gn_step_multi`` lines, counted on the CPU by the
    float32 emulation (``checks.jacobi_work``): (sweeps, rotations) of each
    solve the recorded step applies. A count, not a measurement on the card;
    the kernel is bit-equal to the emulation (phase ``solve_cases``), so it
    makes the same rotations."""
    from multimotionfusion_tpu_torch.kernels import checks as C
    from multimotionfusion_tpu_torch.odometry import multi as MO
    from multimotionfusion_tpu_torch.odometry import rgbd

    def system(sums, sp, use_icp):
        S_icp, _, S_rgb, _, _ = rgbd.systems_from_sums(sums.cpu(), sp.scale2)
        w2 = torch.tensor(sp.icp_weight, dtype=torch.float32) ** 2
        A = (S_rgb[:6, :6] + w2 * S_icp[:6, :6] if use_icp and sp.use_rgb
             else S_icp[:6, :6] if use_icp else S_rgb[:6, :6])
        return C.jacobi_work(A.numpy())

    state, sums, sp, _ = C.args("gn_step", captured["gn_step"])
    single = ([system(sums, sp, sp.use_icp)] if float(state[rgbd.S_GN_DONE]) == 0 else [])
    state, sums, M, sp, _ = C.args("gn_step_multi", m_captured["gn_step_multi"])
    rows = state.cpu().view(M + 1, rgbd.S_SIZE)
    multi = [system(sums[m], sp, True) for m in range(M)
             if rows[M, rgbd.S_GN_DONE] == 0 and rows[m, rgbd.S_GN_DONE] == 0
             and rows[m, MO.S_ACTIVE] != 0]
    print(json.dumps({"phase": "solve_work", "gn_step": single, "gn_step_multi": multi,
                      "what": "(sweeps, rotations) of each solve the recorded step applies, "
                              "counted by checks.jacobi_work (the float32 emulation, on the "
                              "CPU), not measured on the card"}))


# ---------------------------------------------------------------- relocalisation, loop closure

FERN_PATH = ("ferns.frame", "ferns.encode_hd", "ferns.insert", "ferns.photo")
DEFORM_PATH = ("deform.points", "deform.apply_map")
# the static step's kernels but the compaction frame's (the journeys are short)
STEP_PATH = tuple(k for k in MAIN_PATH if k != "clean.compact")
RELOC_PATH = MAIN_PATH + FERN_PATH
LOOP_PATH = STEP_PATH + FERN_PATH + DEFORM_PATH
RELOC_FRAMES = 20  # healthy frames with reloc_mode on (bench scene), timed from WARMUP
# tests/test_reloc.py's bound on the recovered pose; the reference package
# recovers to 0.0006 m on the same 640x480 frames, on the CPU
# (python tests/torch_global_journeys.py --div 1 --packages reference)
RELOC_BOUND_M = 0.06
RELOC_JOURNEY_FRAMES = 18


def reloc_config(**kw):
    """tests/test_reloc.py's configuration at 640x480 (2^20 surfels, the
    default FernConfig: 500 ferns at ÷8)."""
    from multimotionfusion_tpu_torch.config import CameraModel, EngineConfig, SurfelConfig

    return EngineConfig(camera=CameraModel(), enable_multi_model=False, odom_init="",
                        reloc_mode=True, surfels=SurfelConfig(max_surfels=1 << 20,
                                                              depth_cutoff=5.0), **kw)


def reloc_frames(cam):
    """tests/test_reloc.py's journey: 4 frames of healthy tracking, 13
    blackout frames (zero depth, black colour), one frame near pose 1;
    (frames, its true pose)."""
    from multimotionfusion_tpu_torch.io import synthetic
    from multimotionfusion_tpu_torch.io.frame import FrameData

    frames = []
    for i in range(4):
        d, rgb = synthetic.render(synthetic.pose((0, 0.04 * i, 0), (0.06 * i, 0, 0)), cam)
        frames.append(FrameData(rgb=rgb.astype(np.uint8), depth=d, timestamp=i))
    black = FrameData(rgb=np.zeros((cam.height, cam.width, 3), np.uint8),
                      depth=np.zeros((cam.height, cam.width), np.float32), timestamp=99)
    frames += [black] * 13
    T_true = synthetic.pose((0, 0.04 + 0.01, 0), (0.06 + 0.01, 0, 0))
    d, rgb = synthetic.render(T_true, cam)
    frames.append(FrameData(rgb=rgb.astype(np.uint8), depth=d, timestamp=100))
    return frames, T_true


def run_reloc(K):
    """The static relocalisation journey (launch counts reset before it):
    lost after the blackout, the map's count still while lost, lost cleared
    on the reappearance and the pose within RELOC_BOUND_M of the truth."""
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

    cfg = reloc_config()
    frames, T_true = reloc_frames(cfg.camera)
    last = len(frames) - 1
    plain_calls, captured, per_frame = {}, {}, []
    K.reset_launches()
    with count_plain_calls(plain_calls):
        engine = MultiMotionFusionTorch(cfg, device=DEVICE)
        for i, f in enumerate(frames):
            if i in (1, last):
                K.start_capture()
            engine.process_frame(f)
            st = engine.state
            per_frame.append(tuple(t.clone() for t in (st.smap.count, st.lost, st.bad_track_count,
                                                       st.ferns.count)))
            if i == 1:  # a frame that inserts a keyframe
                captured["ferns.insert"] = K.stop_capture()["ferns.insert"]
            elif i == last:  # the relocalising frame
                captured.update({k: v for k, v in K.stop_capture().items()
                                 if k.startswith("ferns.") and k != "ferns.insert"})
        engine.finish()
    launches = dict(K.LAUNCHES)
    rows = [[int(x) for x in r] for r in per_frame]
    count, lost = [r[0] for r in rows], [bool(r[1]) for r in rows]
    T_est = engine.state.pose.cpu().numpy()
    delta = np.linalg.inv(T_true) @ T_est
    err = float(np.linalg.norm(delta[:3, 3]))
    lost_frames = [i for i in range(4, last) if lost[i]]
    out = {"phase": "reloc_journey", "frames": len(frames), "surfels_per_frame": count,
           "lost_per_frame": lost, "bad_track_count_per_frame": [r[2] for r in rows],
           "keyframes_per_frame": [r[3] for r in rows], "pose_err_m": err,
           "bound_m": RELOC_BOUND_M, "launches": launches, "plain_calls": plain_calls,
           "gpu": _gpu_line()}
    print(json.dumps(out))
    failed = [f"plain versions ran on the reloc path: {plain_calls}"] if plain_calls else []
    failed += [] if lost[last - 1] and not lost[3] else ["lost not set by the blackout"]
    failed += [] if len({count[i] for i in lost_frames}) == 1 else [
        "the map's count moved while lost"]
    failed += [] if not lost[last] else ["lost not cleared on the reappearance"]
    failed += [] if err < RELOC_BOUND_M else [f"relocalised pose {err} m off the truth"]
    failed += [f"kernel {k} was not launched on the reloc path" for k in STEP_PATH + FERN_PATH
               if launches.get(k, 0) <= 0]
    return launches, captured, failed


def run_reloc_healthy(K, frames):
    """Healthy tracking with reloc_mode on (the bench scene, launch counts
    reset before): ms per frame from WARMUP, every kernel of the path
    launched, lost never set; then the stage breakdown and the sync check."""
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

    cfg = dataclasses.replace(static_frames(0)[0], reloc_mode=True)
    plain_calls, ms, lost = {}, [], []
    K.reset_launches()
    with count_plain_calls(plain_calls):
        engine = MultiMotionFusionTorch(cfg, device=DEVICE)
        engine.process_frame(frames[0])
        for i in range(1, RELOC_FRAMES + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            engine.process_frame(frames[i])
            end.record()
            end.synchronize()
            lost.append(engine.state.lost)
            if i > WARMUP:
                ms.append(start.elapsed_time(end))
        engine.finish()
    launches = dict(K.LAUNCHES)
    lost = [bool(x) for x in lost]
    print(json.dumps({"phase": "reloc_healthy", "frames": RELOC_FRAMES + 1, "timed_frames": len(ms),
                      "ms_per_frame_median": statistics.median(ms),
                      "ms_per_frame_p75": statistics.quantiles(ms, n=4)[2],
                      "keyframes": int(engine.state.ferns.count), "lost_any": any(lost),
                      "launches": launches, "plain_calls": plain_calls, "gpu": _gpu_line()}))
    rest = frames[RELOC_FRAMES + 1:]
    run_stages(K, engine, rest[:2 * STAGE_FRAMES], "reloc_stages")
    syncs = run_sync_check(engine, rest[2 * STAGE_FRAMES:], "reloc_sync_check")
    failed = [f"plain versions ran on the healthy reloc path: {plain_calls}"] if plain_calls else []
    failed += ["lost set on healthy frames"] if any(lost) else []
    failed += [f"kernel {k} was not launched on the healthy reloc path" for k in RELOC_PATH
               if launches.get(k, 0) <= 0]
    return syncs, failed


def loop_config():
    """tests/test_loop_closure.py's _cfg() at 640x480 with the bench
    capacities (2^20 surfels, 256 deformation nodes) and the default
    FernConfig (500 ferns at ÷8: 300 constraint points)."""
    from multimotionfusion_tpu_torch.config import (CameraModel, DeformationConfig, EngineConfig,
                                                    KeypointConfig, SurfelConfig)

    return EngineConfig(camera=CameraModel(), enable_multi_model=False, odom_init="",
                        close_loops=True,
                        surfels=SurfelConfig(max_surfels=1 << 20, depth_cutoff=5.0, time_delta=3),
                        keypoints=KeypointConfig(max_keypoints=64, max_tracks=256,
                                                 track_history=8),
                        deformation=DeformationConfig(max_nodes=256, iterations=3),
                        loop_accept_cons_err=0.02)


def drift_state(state, D):
    """A rigid drift D applied to the pose and, in place, to every live
    surfel (the self-consistent error dense tracking cannot observe)."""
    from multimotionfusion_tpu_torch.model import surfel_map as sm

    Dt = torch.as_tensor(D, device=state.pose.device)
    alive = state.smap.alive_mask()
    pos = state.smap.data[sm.PX:sm.PZ + 1]
    pos.copy_(torch.where(alive[None], Dt[:3, :3] @ pos + Dt[:3, 3:4], pos))
    return state._replace(pose=Dt @ state.pose, prev_pose=Dt @ state.prev_pose)


class SpanEvents:
    """CUDA events around calls of ``module.attr`` while inside (device ms)."""

    def __init__(self, module, attr):
        self.module, self.attr, self.pairs = module, attr, []

    def __enter__(self):
        self.fn = getattr(self.module, self.attr)

        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.fn(*args, **kwargs)
            end.record()
            self.pairs.append((start, end))
            return out

        setattr(self.module, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)

    def ms(self):
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def run_loop_closure(K):
    """The static loop-closure journey (tests/test_loop_closure.py's): six
    frames on a short path, a 3 cm self-consistent drift injected, a revisit
    of frame 0; every frame under the sync check (one host read a frame: the
    match flag); the matching frame's device time split into find_frame,
    optimise and apply_to_map."""
    from multimotionfusion_tpu_torch import engine as E
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
    from multimotionfusion_tpu_torch.io import synthetic
    from multimotionfusion_tpu_torch.io.frame import FrameData
    from multimotionfusion_tpu_torch.model import deformation as DG
    from multimotionfusion_tpu_torch.model import ferns as FN

    cfg = loop_config()
    cam = cfg.camera
    gt = [synthetic.pose((0.0, 0.0015 * i, 0.0), (0.002 * i, 0.0, 0.0)) for i in range(6)]

    def frame(T, i):
        depth, rgb = synthetic.render(T, cam)
        return FrameData(rgb=rgb.astype(np.uint8), depth=depth, timestamp=i)

    frames = [frame(T, i) for i, T in enumerate(gt)] + [frame(gt[0], 6)]
    D = np.eye(4, dtype=np.float32)
    D[:3, 3] = (0.03, -0.02, 0.01)
    plain_calls, syncs = {}, []
    K.reset_launches()
    with count_plain_calls(plain_calls):
        engine = MultiMotionFusionTorch(cfg, device=DEVICE)
        engine.process_frame(frames[0])
        for i in range(1, 7):
            if i == 6:
                engine.finish()
                engine.state = drift_state(engine.state, D)
                pose_drifted = engine.state.pose.cpu().numpy()
                K.start_capture()
            with contextlib.ExitStack() as spans:
                ev = {name: spans.enter_context(SpanEvents(mod, name)) for mod, name in
                      ((FN, "find_frame"), (DG, "optimise"), (DG, "apply_to_map"))}
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                with sync_watch(E, "_frame_core") as caught:
                    start.record()
                    engine.process_frame(frames[i])
                    end.record()
                    torch.cuda.synchronize()
                syncs.append(len(_syncs(caught)))
            if i == 6:
                captured = {k: v for k, v in K.stop_capture().items() if k.startswith("deform.")}
                split = {k: e.ms() for k, e in ev.items()}
                split["frame"] = start.elapsed_time(end)
        engine.finish()
    launches = dict(K.LAUNCHES)
    matches = engine.pose_matches()
    T_true = gt[0]
    pose = engine.state.pose.cpu().numpy()
    err_before = float(np.linalg.norm((D @ T_true)[:3, 3] - T_true[:3, 3]))
    err_after = float(np.linalg.norm(pose[:3, 3] - T_true[:3, 3]))
    moved = float(np.linalg.norm(pose - pose_drifted))
    print(json.dumps({
        "phase": "loop_closure_journey", "frames": 7,
        "matches": [{k: v for k, v in m.items() if not k.endswith("_pose")} for m in matches],
        "pose_err_before_m": err_before, "pose_err_after_m": err_after, "pose_moved": moved,
        "matching_frame_device_ms": split, "host_reads_per_frame": syncs,
        "keyframes": int(engine.state.ferns.count), "launches": launches,
        "plain_calls": plain_calls, "gpu": _gpu_line()}))
    failed = [f"plain versions ran on the loop-closure path: {plain_calls}"] if plain_calls else []
    failed += [] if matches and matches[-1]["accepted"] else ["no accepted PoseMatch"]
    failed += [] if err_after < 0.4 * err_before else [
        f"pose error {err_after} m not below 0.4 x {err_before} m"]
    failed += [] if moved > 0.01 else ["the pose did not move from the drifted estimate"]
    failed += [] if syncs == [1] * 6 else [f"host reads per frame {syncs}, not 1"]
    failed += [f"kernel {k} was not launched on the loop-closure path" for k in LOOP_PATH
               if launches.get(k, 0) <= 0]
    return launches, captured, failed


def run_multi_global(K, cfg, frames):
    """The multi-model step with external masks and both reloc_mode and
    close_loops on (the five spheres, 1 + MULTI_FRAMES frames, launch counts
    reset before): lost never set, a keyframe inserted after the first, 5
    active models, camera drift < 0.08 m, no PoseMatch accepted with a mean
    constraint error >= 0.02."""
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

    cfg = dataclasses.replace(cfg, reloc_mode=True, close_loops=True)
    plain_calls, lost, ms = {}, [], []
    K.reset_launches()
    with count_plain_calls(plain_calls):
        engine = MultiMotionFusionTorch(cfg, device=DEVICE)
        engine.process_frame(frames[0])
        for i in range(1, MULTI_FRAMES + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            engine.process_frame(frames[i])
            end.record()
            end.synchronize()
            lost.append(engine.state.lost)
            if i >= MULTI_TIMED_FROM:
                ms.append(start.elapsed_time(end))
        stats = engine.finish()
    launches = dict(K.LAUNCHES)
    lost = [bool(x) for x in lost]
    matches = engine.pose_matches()
    drift = float(np.linalg.norm(engine.state.pose.cpu().numpy()[:3, 3]))
    bad = [m for m in matches if m["accepted"] and not m["mean_cons_err"] < 0.02]
    keyframes = int(engine.state.ferns.count)
    print(json.dumps({
        "phase": "multi_reloc_loops", "frames": MULTI_FRAMES + 1,
        "active_objects": stats["active_objects"], "camera_drift_m": drift,
        "lost_any": any(lost), "keyframes": keyframes,
        "matches": [{k: v for k, v in m.items() if not k.endswith("_pose")} for m in matches],
        "ms_per_frame_median": statistics.median(ms), "launches": launches,
        "plain_calls": plain_calls, "gpu": _gpu_line()}))
    failed = [f"plain versions ran on the multi reloc path: {plain_calls}"] if plain_calls else []
    failed += ["lost set on the multi-model path"] if any(lost) else []
    failed += [] if keyframes >= 2 else ["no keyframe inserted after the first"]
    failed += [] if stats["active_objects"] == 5.0 else [
        f"{stats['active_objects']} active models at the end, not 5"]
    failed += [] if drift < 0.08 else [f"camera drift {drift} m out of bounds"]
    failed += [f"accepted loop closures with mean_cons_err >= 0.02: {bad}"] if bad else []
    failed += [f"kernel {k} was not launched on the multi reloc path" for k in MULTI_PATH + FERN_PATH
               if launches.get(k, 0) <= 0]
    return failed


def measure_fern_frame(a):
    from multimotionfusion_tpu_torch.model import ferns as FN

    cam, f = a[2], a[4]
    n = (cam.height // f) * (cam.width // f)
    # per fern pixel: 3 depths and 3 colour bytes read; colour, vertex,
    # normal and depth written; ~40 operations
    return _measure(lambda: FN.fern_frame_cuda(*a), lambda: FN.fern_frame_plain(*a),
                    n * (12 + 3 + 3 + 12 + 12 + 4), 40 * n)


def measure_fern_encode_hd(a):
    from multimotionfusion_tpu_torch.model import ferns as FN

    db, frame, _ = a
    K_, F_ = db.codes.shape
    hw = frame.depth.numel()
    stored = int(db.count)
    # the conservatory, the fern pixels and the stored keyframes' codes in,
    # the codes and similarities out, the best keyframe fetched (read, then
    # written as a 4-channel prediction); 3 operations per stored code
    return _measure(lambda: FN.encode_hd_cuda(db, frame, True),
                    lambda: FN.encode_hd_plain(db, frame, True),
                    F_ * (8 + 16 + 3 + 4) + stored * F_ + F_ + 4 * K_ + 8 + 36 * hw + 64
                    + 44 * hw + 64, 3 * stored * F_, plain_reps=5)


def measure_fern_insert(a):
    from multimotionfusion_tpu_torch.kernels import checks as C
    from multimotionfusion_tpu_torch.model import ferns as FN

    db, frame, hd, pose, time_, thr, skip = a
    hw = frame.depth.numel()
    F_ = db.codes.shape[1]
    probe = C._db_copy(db)
    inserted = bool(FN.insert_plain(probe, frame, hd, pose, time_, thr, skip))
    moved = (27 * hw + F_ + 64) + (36 * hw + F_ + 64 + 4) if inserted else 0
    copies = iter([C._db_copy(db) for _ in range(MEASURE_CALLS)])
    return _measure(lambda: FN.insert_cuda(next(copies), frame, hd, pose, time_, thr, skip),
                    lambda: FN.insert_plain(C._db_copy(db), frame, hd, pose, time_, thr, skip),
                    moved + 13, 10, inserted=inserted,
                    timing_note="each call on a fresh copy of the store")


def measure_fern_photo(a):
    from multimotionfusion_tpu_torch.model import ferns as FN

    hw = a[1].shape[0] * a[1].shape[1]
    # keyframe vertices and colour, the live colour in; ~60 operations a pixel
    return _measure(lambda: FN.photo_cuda(*a), lambda: FN.photo_plain(*a),
                    hw * (16 + 12 + 3) + 64 + 16 + 5, 60 * hw)


def measure_deform_points(a):
    from multimotionfusion_tpu_torch.model import deformation as DG

    points, _, graph, k, look_back = a
    P, N = points.shape[0], graph.num_nodes
    # the points and the graph in; positions, node ids and weights out; per
    # point look_back distances (~10 operations), the top-(k+1), k blends (~30)
    return _measure(lambda: DG.deform_points_cuda(*a), lambda: DG.deform_points_plain(*a),
                    P * 16 + N * 68 + P * (12 + 8 * k), P * (look_back * 10 + 30 * k))


def measure_deform_apply(a):
    from multimotionfusion_tpu_torch.model import deformation as DG
    from multimotionfusion_tpu_torch.model import surfel_map as sm

    data, count, graph, k, gate = a
    n = int(count)
    alive = int(sm.SurfelMap(data, count).alive_count())
    copies = iter([data.clone() for _ in range(MEASURE_CALLS)])
    # the alive flag of every slot below the count, position and time of the
    # live ones in, their positions out; the graph once
    return _measure(lambda: DG.apply_to_map_cuda(next(copies), count, graph, k, gate),
                    lambda: DG.apply_to_map_plain(data.clone(), count, graph, k, gate),
                    4 * n + 16 * alive + 12 * alive + 68 * graph.num_nodes,
                    alive * (20 * 10 + 30 * k), live_surfels=alive,
                    timing_note="each call on a fresh copy of the map")


def plan_global():
    """The relocalisation and loop-closure kernels (K22, K23), as ``plan``."""
    from multimotionfusion_tpu_torch.kernels import checks as C

    ferns_ = [("ferns.frame", "ferns.frame", "ferns.frame", C.check_fern_frame, measure_fern_frame,
               "ferns.cu", "model/ferns.py:107"),
              ("ferns.encode_hd", "ferns.encode_hd", "ferns.encode_hd", C.check_fern_encode_hd,
               measure_fern_encode_hd, "ferns.cu", "model/ferns.py:116"),
              ("ferns.insert", "ferns.insert", "ferns.insert", C.check_fern_insert,
               measure_fern_insert, "ferns.cu", "model/ferns.py:142"),
              ("ferns.photo", "ferns.photo", "ferns.photo", C.check_fern_photo, measure_fern_photo,
               "ferns.cu", "model/ferns.py:220")]
    deform = [("deform.points", "deform.points", "deform.points", C.check_deform_points,
               measure_deform_points, "deformation.cu", "model/deformation.py:123"),
              ("deform.apply_map", "deform.apply_map", "deform.apply_map", C.check_deform_apply,
               measure_deform_apply, "deformation.cu", "model/deformation.py:193")]
    return ferns_, deform


def _short_name(mangled: str) -> str:
    """A kernel's name from its mangled one: the last nested name before the
    arguments, with an integer template argument
    (`_ZN12_GLOBAL__N_111solve_casesILi3EEEv...` -> `solve_cases<3>`)."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else 0
    parts = []
    while 0 < i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        parts.append(mangled[j:j + n])
        i = j + n
    if not parts:
        return mangled
    t = re.match(r"ILi(\d+)E", mangled[i:])
    return f"{parts[-1]}<{t.group(1)}>" if t else parts[-1]


def ptxas_table(log: str) -> dict:
    """Per kernel of one ``nvcc -Xptxas -v`` log: registers, shared memory,
    stack frame and spill bytes."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", ln)
        if m:
            cur = out.setdefault(_short_name(m.group(1)), dict(
                registers=None, smem=0, stack_frame=0, spill_stores=0, spill_loads=0))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["stack_frame"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multimotionfusion_tpu_torch import kernels as K
    from multimotionfusion_tpu_torch.kernels import checks

    # the library yardsticks compare with full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # a fresh build, so that the compiler's report covers every kernel
    shutil.rmtree(K.BUILD_DIR, ignore_errors=True)
    t_build = K.build_all()
    ptxas = {k: ptxas_table(v) for k, v in K.BUILD_LOG.items()}
    in_registers = {k: ptxas["gn_step"].get(k) for k in REGISTER_ONLY}
    registers_only = all(v is not None and v["stack_frame"] == 0 and v["spill_stores"] == 0
                         and v["spill_loads"] == 0 for v in in_registers.values())
    no_spills = {f"{lib}.{k}": ptxas[lib].get(k) for lib, ks in NO_SPILLS.items() for k in ks}
    spill_free = all(v is not None and v["spill_stores"] == 0 and v["spill_loads"] == 0
                     for v in no_spills.values())
    print(json.dumps({"phase": "build", "seconds": t_build, "ptxas": ptxas,
                      "k5_steps_and_so3_iteration": in_registers,
                      "registers_only": registers_only, "no_spill_kernels": no_spills,
                      "no_spills": spill_free}))
    if not registers_only:
        raise SystemExit(f"K5's step kernels or the SO(3) iteration use local memory: "
                         f"{in_registers}")
    if not spill_free:
        raise SystemExit(f"K4's passes, the fuse association or K21 spill: {no_spills}")

    cfg, frames, gt_poses = static_frames(N_FRAMES + 2 * STAGE_FRAMES + SYNC_FRAMES)
    engine, launches, captured = run_engine(K, cfg, frames, gt_poses)
    checks.derive_so3(captured)
    rest = frames[N_FRAMES + 1:]
    run_stages(K, engine, rest[:2 * STAGE_FRAMES])
    syncs = run_sync_check(engine, rest[2 * STAGE_FRAMES:])
    del engine

    kp_cfg = dataclasses.replace(cfg, odom_init="kp")
    kp_engine, kp_launches, kp_captured = run_engine(K, kp_cfg, frames, gt_poses, KP_PATH,
                                                     "kp_engine")
    run_stages(K, kp_engine, rest[:2 * STAGE_FRAMES], "kp_stages")
    syncs += run_sync_check(kp_engine, rest[2 * STAGE_FRAMES:], "kp_sync_check")
    del kp_engine

    m_cfg, m_frames = multi_frames(1 + MULTI_FRAMES + 2 * STAGE_FRAMES)
    m_engine, m_launches, m_captured, m_syncs = run_multi(K, m_cfg, m_frames)
    checks.derive_so3(m_captured)
    syncs += m_syncs
    run_stages(K, m_engine, m_frames[MULTI_FRAMES + 1:], "multi_stages")
    del m_engine

    f_cfg, f_frames = multi_frames(1 + MULTI_FRAMES + 2 * STAGE_FRAMES, masks=False)
    f_engine, f_launches, f_captured, f_syncs, f_failed, f_drift = run_multi_flow(
        K, f_cfg, f_frames)
    checks.derive_backdating(f_captured)
    draws = checks.check_draws(DEVICE)
    print(json.dumps({"phase": "draws", **draws}))
    if not draws["ok"]:
        f_failed.append(f"the batched draws differ from sequential ones: {draws}")
    syncs += f_syncs
    run_stages(K, f_engine, f_frames[MULTI_FRAMES + 1:], "flow_crf_stages")
    del f_engine
    drifts = [f_drift] + [r["max_camera_drift_m"] for r in flow_drift_seeds(
        f_cfg, f_frames[:MULTI_FRAMES + 1]).values()]
    if not journey_tests("multi_flow_crf", drifts, REF_FLOW_DRIFT_M)["ok"]:
        f_failed.append(f"camera drifts worse than the reference's: {drifts}")
    g_cfg = dataclasses.replace(f_cfg, segmentation=dataclasses.replace(f_cfg.segmentation,
                                                                          mode="crf"))
    g_engine, g_launches, g_captured, g_syncs, g_failed = run_multi_legacy(K, g_cfg, f_frames)
    syncs += g_syncs
    run_stages(K, g_engine, f_frames[MULTI_FRAMES + 1:], "legacy_crf_stages")
    del g_engine
    f_failed += g_failed + run_slic_cases() + run_components_cases() + run_solve_cases()
    f_failed += run_scan_cases() + run_hand_made_cases()
    five = five_movers_seeds()

    r_launches, r_captured, global_failed = run_reloc(K)
    r_syncs, h_failed = run_reloc_healthy(K, frames)
    syncs += r_syncs
    l_launches, l_captured, l_failed = run_loop_closure(K)
    global_failed += h_failed + l_failed + run_multi_global(K, m_cfg, m_frames[:MULTI_FRAMES + 1])
    fern_plan, deform_plan = plan_global()

    missing = sorted(({key for _, key, *_ in plan()} - set(captured))
                     | ({key for _, key, *_ in plan_kp()} - set(kp_captured) - set(SYNTHETIC))
                     | ({key for _, key, *_ in plan_multi()} - set(m_captured))
                     | ({key for _, key, *_ in plan_flow()} - set(f_captured) - set(SYNTHETIC))
                     | ({"track", "sparse"} - set(kp_captured))
                     | ({"multi_track"} - set(m_captured))
                     | ({key for _, key, *_ in plan_legacy()} - set(g_captured))
                     | ({key for _, key, *_ in fern_plan} - set(r_captured))
                     | ({key for _, key, *_ in deform_plan} - set(l_captured)))
    if missing:
        raise SystemExit(f"no captured inputs for {missing}")
    kernels = check_kernels(plan(), captured, launches, N_FRAMES)
    kernels += check_kernels(plan_kp(), kp_captured, kp_launches, N_FRAMES)
    kernels += check_kernels(plan_multi(), m_captured, m_launches, MULTI_FRAMES)
    kernels += check_kernels(plan_flow(), f_captured, f_launches, MULTI_FRAMES)
    kernels += check_kernels(plan_legacy(), g_captured, g_launches, MULTI_FRAMES)
    kernels += check_kernels(fern_plan, r_captured, r_launches, RELOC_JOURNEY_FRAMES)
    kernels += check_kernels(deform_plan, l_captured, l_launches, 7)
    run_solve_work(captured, m_captured)
    counts = device_counts(kernels)
    if not counts["ok"]:
        f_failed.append(f"K15's launches, a tracker update's device operations or K18's, "
                        f"K19's, K1's filter's, K2's, K10's, K14's clean's, K11's owner "
                        f"prep's, K18's unaries', K13's (or a fill), K19's patch_score's, "
                        f"K7/K9's or K24c's launches: {counts}")
    loops = [check_loop(captured), check_loop(kp_captured, "odometry_loop[kp]"),
             check_sparse(kp_captured), check_multi_loop(m_captured)]
    print(json.dumps({"kernels": kernels}))
    bad = [k["name"] for k in kernels if not k["ok"]]
    loops_ok = all(r["ok"] for r in loops)
    print(_gpu_line())
    if bad or not loops_ok or syncs or not five["ok"] or f_failed or global_failed:
        print(f"chip_smoke: kernels outside tolerance: {bad}; odometry loops, sparse block and "
              f"multi loop ok: {[r['ok'] for r in loops]}; synchronising calls: {syncs}; "
              f"five movers: {five}; flow-CRF and legacy CRF paths: {f_failed}; "
              f"relocalisation and loop "
              f"closure: {global_failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
