#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. build every CUDA kernel of ``multimotionfusion_tpu_torch/csrc`` (nvcc, in
   parallel) and print the build seconds and each kernel's register use;
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
   (torch.profiler); run the whole odometry loop on the card and, from the
   same inputs, the plain loop on the CPU; the same for the keypoint
   kernels on the inputs of one steady-state kp frame (``nms_topk`` also on
   a random-weight SuperPoint heat map and on a plateau), the seeded
   odometry loop, and the sparse block (detect -> track table -> RANSAC on
   the card against the plain chain on the CPU, same uniforms);
6. print ``{"kernels": [...]}``, the card's name and power limit, and as the
   last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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
    ("frame_maps.filter", "frame_maps.surfels", "odo_init", "so3_reduce", "so3_step", "gn_step",
     "zbuffer", "fuse", "clean", "clean.compact", "compact", "splat_resolve")
    + tuple(f"pyramid.{side}.L{lvl}" for side in ("frame", "pred") for lvl in LEVELS)
    + tuple(f"gn_reduce.L{lvl}" for lvl in LEVELS)
)
KP_PATH = MAIN_PATH + ("patch_score", "nms_topk", "patch_desc", "mutual_match", "track_update",
                       "ransac_fit", "seed_select")


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


def _device_ms(fn, reps: int = 20) -> float:
    """Device time of the work one call of ``fn`` enqueues (kernels, memsets,
    copies; torch.profiler), without the host's launch overhead that ``_time_ms``
    sees when the host is the slower side."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


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
    "multimotionfusion_tpu_torch.ops.ransac",
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

    n = STAGE_FRAMES
    before = dict(K.LAUNCHES)
    timer = StageTimer()
    span, E._span = E._span, timer
    try:
        t0 = time.perf_counter()
        for f in frames[:n]:
            engine.process_frame(f)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    finally:
        E._span = span
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
    print(json.dumps({
        "phase": tag, "frames": n, "wall_ms_per_frame": wall, "stages_per_frame": stages,
        "device_kernel_ms_per_frame": busy, "device_busy_share": busy / wall,
        "device_kernel_launches_per_frame": sum(v[1] for v in kernels.values()) / n,
        "wrapper_launches_per_frame": wrappers,
        "top_kernels_ms_per_frame": [
            {"name": name, "ms": v[0], "launches_per_frame": v[1] / n} for name, v in top],
        "gpu": _gpu_line(),
    }))


def _states(state, n=48):
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
        ms=_time_ms(lambda: R.zbuffer_cuda(*a)), device_ms=_device_ms(lambda: R.zbuffer_cuda(*a)),
        plain_ms=_time_ms(lambda: R.zbuffer_plain(*a)),
        library_ms=_time_ms(lambda: buf.scatter_reduce_(0, pix, key, reduce="amin")),
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
    return dict(
        ms=_time_ms(lambda: R.splat_resolve_cuda(*a)),
        device_ms=_device_ms(lambda: R.splat_resolve_cuda(*a)),
        plain_ms=_time_ms(lambda: fillin.splat_fill_plain(*a), reps=5),
        library_ms=None, bound_ms=bound, bound_by=by,
    )


def measure_fuse(a):
    from multimotionfusion_tpu_torch.model import fusion as FU

    cam = a[9]
    n, npix = a[0].shape[1], cam.height * cam.width
    n_cb = npix // 4
    bound, by = _bound(2 * 64 * n + 64 * n_cb + 4 * npix + 28 * n_cb + 64 * n_cb, 16 * 60 * n_cb)
    return dict(
        ms=_time_ms(lambda: FU.fuse_cuda(*a, want_assoc=False)),
        device_ms=_device_ms(lambda: FU.fuse_cuda(*a, want_assoc=False)),
        plain_ms=_time_ms(lambda: FU.fuse_plain(*a), reps=5),
        library_ms=None, bound_ms=bound, bound_by=by,
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
        device_ms=_device_ms(lambda: rgbd.gn_reduce_cuda(*a, level=level)),
        plain_ms=_time_ms(lambda: rgbd.gn_reduce_plain(*a)),
        library_ms=_time_ms(lambda: (icp_rows.T @ icp_rows, rgb_rows.T @ rgb_rows)),
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
        device_ms=_device_ms(lambda: FM.frame_depth_cuda(*a)),
        plain_ms=_time_ms(lambda: FM.frame_depth_plain(*a), reps=3),
        library_ms=None, bound_ms=bound, bound_by=by,
    )


def measure_frame_surfels(a):
    from multimotionfusion_tpu_torch.ops import frame_maps as FM

    npix = a[1].numel()
    # two depths and the colour in, 16 channels and the valid byte out
    bound, by = _bound((4 + 4 + 3 + 64 + 1) * npix, 80 * npix)
    return dict(
        ms=_time_ms(lambda: FM.frame_surfels_cuda(*a)),
        device_ms=_device_ms(lambda: FM.frame_surfels_cuda(*a)),
        plain_ms=_time_ms(lambda: FM.frame_surfels_plain(*a), reps=5),
        library_ms=None, bound_ms=bound, bound_by=by,
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


def measure_pyr_frame(a, level):
    from multimotionfusion_tpu_torch.odometry import levels as LV

    cam, cfg = a[3], a[4]
    finer = LV.frame_levels(*a)
    cam_l = cam.level(level)
    h, w = cam_l.height, cam_l.width
    npix = h * w
    prev = None if level == 0 else finer[level - 1]
    run = lambda: LV.frame_level_cuda(level, prev, *a)  # noqa: E731
    # in: level 0 depth + colour + mask (11 B/px), else the finer depth and
    # intensity (8 B per finer pixel) + mask; out: intensity, Sobel x2,
    # vertices, normals, validity (+ depth at coarse levels)
    if level == 0:
        bytes_in = 11 * npix
        conv = [_conv_yardstick(1, h, w, False)]
    else:
        hp, wp = finer[level - 1].img.shape
        bytes_in = 8 * hp * wp + 4 * npix
        conv = [_conv_yardstick(2, hp, wp, True), _conv_yardstick(1, h, w, False)]
    bytes_out = (4 * 3 + 24 + 1 + (4 if level else 0)) * npix
    bound, by = _bound(bytes_in + bytes_out, (50 * (level > 0) + 60) * npix)
    return dict(
        ms=_time_ms(run), device_ms=_device_ms(run),
        plain_ms=_time_ms(lambda: LV.frame_levels_plain(*a), reps=5),
        library_ms=_time_ms(lambda: [c() for c in conv]), bound_ms=bound, bound_by=by,
    )


def measure_pyr_pred(a, level):
    from multimotionfusion_tpu_torch.odometry import levels as LV

    vertex_conf, normal_rad, color, cam, cfg = a
    # level 2 reads level 1's pyramids
    finer = None if level < 2 else LV.pred_level_cuda(1, None, *a)[1]
    run = lambda: LV.pred_level_cuda(level, finer, vertex_conf, normal_rad, color, cam, cfg)  # noqa: E731
    cam_l = cam.level(level)
    npix = cam_l.height * cam_l.width
    hp, wp = cam.level(max(level - 1, 0)).height, cam.level(max(level - 1, 0)).width
    if level == 0:  # depth, normal, colour in; the bf16 map out
        bytes_moved, conv = (4 + 12 + 12) * npix + 16 * npix, None
    elif level == 1:  # finer depth and colour; three pyramids and the f32 map
        bytes_moved, conv = 16 * hp * wp + (12 + 32) * npix, _conv_yardstick(3, hp, wp, True)
    else:
        bytes_moved, conv = 12 * hp * wp + (12 + 32) * npix, _conv_yardstick(3, hp, wp, True)
    bound, by = _bound(bytes_moved, 200 * npix)
    return dict(
        ms=_time_ms(run), device_ms=_device_ms(run),
        plain_ms=_time_ms(lambda: LV.pred_levels_plain(*a), reps=5),
        library_ms=_time_ms(conv) if conv else None, bound_ms=bound, bound_by=by,
    )


def measure_odo_init(a):
    from multimotionfusion_tpu_torch.odometry import rgbd

    bound, by = _bound(4 * rgbd.S_SIZE, rgbd.S_SIZE)
    return dict(
        ms=_time_ms(lambda: rgbd.odo_init_cuda(*a)),
        device_ms=_device_ms(lambda: rgbd.odo_init_cuda(*a)),
        plain_ms=_time_ms(lambda: rgbd.odo_init_plain(*a)),
        library_ms=None, bound_ms=bound, bound_by=by,
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
        device_ms=_device_ms(lambda: rgbd.so3_reduce_cuda(*a)),
        plain_ms=_time_ms(lambda: rgbd.so3_reduce_plain(*a)),
        library_ms=_time_ms(lambda: rows.T @ rows), bound_ms=bound, bound_by=by,
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
        device_ms=_device_ms(lambda: cuda(fresh(), *rest)),
        plain_ms=_time_ms(lambda: plain(state.clone(), *rest), reps=5),
        library_ms=_time_ms(lambda: torch.linalg.eigh(A)), bound_ms=bound, bound_by=by,
        timing_note="each call on a fresh copy of the recorded state (one 512-byte copy included)",
    )


def measure_clean(a):
    from multimotionfusion_tpu_torch.model import fusion as FU
    from multimotionfusion_tpu_torch.model import surfel_map as sm
    from multimotionfusion_tpu_torch.ops import rasterize as R

    (data, count, index, data_local, depth, mask, mask_id, cam, time_, time_delta, conf, cfg,
     compact) = a
    smap, im = sm.SurfelMap(data, count), R.IndexMap(index, data_local)
    args = (smap, im, depth, mask, mask_id, cam, time_, time_delta, conf, cfg, compact)
    out = torch.empty_like(data)
    B, npix = data.shape[1], index.numel()
    n_win = int(torch.unique(index[index >= 0]).numel())
    keep, _ = FU.clean_verdicts(*args[:10])
    n_keep = int(keep.sum())
    # pixel pass: index map, 4x4 window winners (7 channels each, once per
    # winner), depth and mask; surfel pass: the [16, B] map in, and out (flag
    # frame) or the kept columns plus the zeroed tail (compaction)
    moved = 12 * npix + 7 * 4 * n_win + 64 * B + (64 * B if not compact else 64 * B)
    bound, by = _bound(moved, 16 * 30 * npix + 20 * B)
    if compact:
        library = lambda: data[:, keep]  # noqa: E731
    else:
        flat = index.clamp(min=0).reshape(-1).long()
        library = lambda: data_local.index_select(1, flat)  # noqa: E731
    return dict(
        ms=_time_ms(lambda: FU.clean_cuda(*args, out=out)),
        device_ms=_device_ms(lambda: FU.clean_cuda(*args, out=out)),
        plain_ms=_time_ms(lambda: FU.clean_plain(*args), reps=5),
        library_ms=_time_ms(library), bound_ms=bound, bound_by=by, kept=n_keep,
    )


def measure_compact(a):
    from multimotionfusion_tpu_torch.model import surfel_map as sm

    data, keep, capacity = a
    n = data.shape[1]
    bound, by = _bound(64 * int(keep.sum()) + n + 64 * capacity, 4 * n)
    return dict(
        ms=_time_ms(lambda: sm.compact_cuda(*a)), device_ms=_device_ms(lambda: sm.compact_cuda(*a)),
        plain_ms=_time_ms(lambda: sm.compact_plain(*a), reps=5),
        library_ms=_time_ms(lambda: data[:, keep]), bound_ms=bound, bound_by=by,
    )


def measure_patch_score(a):
    from multimotionfusion_tpu_torch.tracking import superpoint as SP

    npix = a[0].numel()
    # intensity in, score and blurred intensity out; per pixel the Sobel
    # (12), three products, four 5-tap passes each way (80) and the
    # eigenvalue (10)
    bound, by = _bound(12 * npix, 105 * npix)
    return dict(
        ms=_time_ms(lambda: SP.patch_score_cuda(*a)),
        device_ms=_device_ms(lambda: SP.patch_score_cuda(*a)),
        plain_ms=_time_ms(lambda: SP.patch_score_plain(*a), reps=5),
        library_ms=None, bound_ms=bound, bound_by=by,
    )


def measure_nms(a):
    import torch.nn.functional as F

    from multimotionfusion_tpu_torch.tracking import superpoint as SP

    heat, k, thr, r = a
    npix = heat.numel()
    # the heat map in, K slots of xy, score and valid out; a (2r+1)^2 max window
    bound, by = _bound(4 * npix + 13 * k, ((2 * r + 1) ** 2 + 2) * npix)

    def library():  # max-pool NMS, then one top-k
        local = F.max_pool2d(heat[None, None], 2 * r + 1, 1, r)[0, 0]
        peaks = torch.where((heat == local) & (heat > thr), heat, torch.zeros_like(heat))
        return torch.topk(peaks.reshape(-1), k)

    return dict(
        ms=_time_ms(lambda: SP.nms_topk_cuda(*a)), device_ms=_device_ms(lambda: SP.nms_topk_cuda(*a)),
        plain_ms=_time_ms(lambda: SP.nms_topk_plain(*a), reps=5),
        library_ms=_time_ms(library), bound_ms=bound, bound_by=by,
    )


def measure_patch_desc(a):
    from multimotionfusion_tpu_torch.tracking import superpoint as SP

    k = a[1].shape[0]
    # 64 samples and 64 outputs a keypoint, ~6 operations each
    bound, by = _bound(k * (8 + 64 * 4 + 64 * 4), 6 * 64 * k)
    return dict(
        ms=_time_ms(lambda: SP.patch_desc_cuda(*a)), device_ms=_device_ms(lambda: SP.patch_desc_cuda(*a)),
        plain_ms=_time_ms(lambda: SP.patch_desc_plain(*a), reps=5),
        library_ms=None, bound_ms=bound, bound_by=by,
    )


def measure_mutual_match(a):
    from multimotionfusion_tpu_torch.tracking import tracker as TR

    q, t = a[0], a[1]
    (k, d), n = q.shape, t.shape[0]
    bound, by = _bound((k + n) * (4 * d + 1) + 4 * k + n, 2 * k * n * d + 2 * (k + n) * d + 4 * k * n)

    def library():  # one distance matrix, both argmins
        dist = torch.cdist(q, t)
        return dist.argmin(1), dist.argmin(0)

    return dict(
        ms=_time_ms(lambda: TR.mutual_match_cuda(*a)),
        device_ms=_device_ms(lambda: TR.mutual_match_cuda(*a)),
        plain_ms=_time_ms(lambda: TR.mutual_match_plain(*a), reps=3),
        library_ms=_time_ms(library), bound_ms=bound, bound_by=by,
    )


def measure_track_update(a):
    from multimotionfusion_tpu_torch.tracking import tracker as TR

    table, kps, depth, time_, cam, cfg, pair = a
    match_idx, _ = TR.mutual_match_cuda(kps.desc, table.desc, kps.valid,
                                        TR.in_history(table, time_), cfg.match_dist_gate)
    tk = TR.TrackTable(*(x.clone() for x in table))
    run = lambda: TR.track_update_cuda(tk, kps, match_idx, depth, time_, cam, cfg, pair)  # noqa: E731
    cap, d = table.capacity, table.desc.shape[1]
    k = kps.xy.shape[0]
    # K keypoints in (xy, descriptor, flags, match, depth) and K rows out; per
    # track the flags, the cleared slot, two ring slots' points and the pair
    bound, by = _bound(k * (8 + 4 * d + 1 + 4 + 4) + k * (4 * d + 8 + 12 + 2 + 9)
                       + cap * (9 + 2 + 24 + 2 + 25), 30 * cap + 20 * k)
    return dict(
        ms=_time_ms(run), device_ms=_device_ms(run),
        plain_ms=_time_ms(lambda: TR.update_plain(TR.TrackTable(*(x.clone() for x in table)),
                                                  *a[1:]), reps=3),
        library_ms=None, bound_ms=bound, bound_by=by,
        timing_note="the update kernels alone, given the matches; repeated on one copy of the "
                    "recorded table",
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
        ms=_time_ms(lambda: RS.ransac_fit_cuda(*a)), device_ms=_device_ms(lambda: RS.ransac_fit_cuda(*a)),
        plain_ms=_time_ms(lambda: RS.ransac_fit_plain(*a), reps=3),
        library_ms=None, bound_ms=bound, bound_by=by,
    )


def measure_seed_select(a):
    from multimotionfusion_tpu_torch.odometry import rgbd

    state, rest = a[0], a[1:]
    fresh = _states(state)
    bound, by = _bound(2 * 4 * rgbd.S_SIZE + 64 + 1 + 2 * 4 * rgbd.N_SUMS, 100)
    return dict(
        ms=_time_ms(lambda: rgbd.seed_select_cuda(fresh(), *rest)),
        device_ms=_device_ms(lambda: rgbd.seed_select_cuda(fresh(), *rest)),
        plain_ms=_time_ms(lambda: rgbd.seed_select_plain(state.clone(), *rest), reps=5),
        library_ms=None, bound_ms=bound, bound_by=by,
        timing_note="each call on a fresh copy of the recorded state (one 512-byte copy included)",
    )


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
    for lvl in LEVELS:
        p.append((f"pyramid.frame[L{lvl}]", "pyramid.frame", f"pyramid.frame.L{lvl}",
                  lambda a, lvl=lvl: C.check_pyramid_frame(a, lvl),
                  lambda a, lvl=lvl: measure_pyr_frame(a, lvl), "pyramid.cu",
                  "odometry/levels.py:41"))
    for lvl in LEVELS:
        p.append((f"pyramid.pred[L{lvl}]", "pyramid.pred", f"pyramid.pred.L{lvl}",
                  lambda a, lvl=lvl: C.check_pyramid_pred(a, lvl),
                  lambda a, lvl=lvl: measure_pyr_pred(a, lvl), "pyramid.cu",
                  "odometry/levels.py:59"))
    p += [
        ("odo_init", "odo_init", "odo_init", C.check_odo_init, measure_odo_init, "gn_step.cu",
         "odometry/rgbd.py:776"),
        ("so3_reduce", "so3_reduce", "so3_reduce", C.check_so3_reduce, measure_so3_reduce,
         "gn_step.cu", "odometry/rgbd.py:583"),
        ("so3_step", "so3_step", "so3_step", C.check_so3_step,
         lambda a: measure_step(a, "so3"), "gn_step.cu", "odometry/rgbd.py:94"),
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
        ("ransac_fit", "ransac_fit", "ransac_fit", C.check_ransac, measure_ransac, "ransac.cu",
         "ops/ransac.py:165"),
        ("seed_select", "seed_select", "seed_select", C.check_seed_select, measure_seed_select,
         "gn_step.cu", "odometry/rgbd.py:962"),
    ]


SYNTHETIC = ("superpoint", "plateau")


def check_kernels(lines, captured, launches, n_frames):
    """Phase 5: each kernel against its plain version on the recorded inputs."""
    from multimotionfusion_tpu_torch.kernels import checks

    kernels = []
    for name, key, launch_key, check, measure, src, rep in lines:
        if key in SYNTHETIC:
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


def check_sparse(captured) -> dict:
    """The sparse block of one kp frame: the kernels on the card against the
    plain chain on the CPU, from the same inputs and uniforms."""
    from multimotionfusion_tpu_torch.kernels import checks

    r = checks.check_sparse(checks.args("sparse", captured["sparse"]))
    print(json.dumps({"phase": "sparse_block", **r}))
    return r


def run_sync_check(engine, frames, tag="sync_check") -> int:
    """Phase 4: steady-state frames with the sync debug mode on around the
    frame step; returns the number of synchronising calls."""
    from multimotionfusion_tpu_torch import engine as E

    core = E._frame_core

    def checked(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return core(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    first = engine.tick
    E._frame_core = checked
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for f in frames:
                engine.process_frame(f)
            torch.cuda.synchronize()
    finally:
        E._frame_core = core
    syncs = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "called a synchronizing" in str(w.message)]
    ticks = list(range(first, engine.tick))
    compaction = [t for t in ticks if engine.cfg.surfels.compact_every > 0
                  and t % engine.cfg.surfels.compact_every == 0]
    print(json.dumps({"phase": tag, "frames": len(ticks), "ticks": ticks,
                      "compaction_ticks": compaction, "synchronizing_calls": len(syncs),
                      "where": sorted(set(syncs))[:10]}))
    if not compaction:
        raise SystemExit("sync check ran no compaction frame")
    return len(syncs)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multimotionfusion_tpu_torch import kernels as K

    # the library yardsticks compare with full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_build = K.build_all()
    regs = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln]
            for k, v in K.BUILD_LOG.items()}
    print(json.dumps({"phase": "build", "seconds": t_build, "ptxas": regs}))

    cfg, frames, gt_poses = static_frames(N_FRAMES + 2 * STAGE_FRAMES + SYNC_FRAMES)
    engine, launches, captured = run_engine(K, cfg, frames, gt_poses)
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

    missing = sorted(({key for _, key, *_ in plan()} - set(captured))
                     | ({key for _, key, *_ in plan_kp()} - set(kp_captured) - set(SYNTHETIC))
                     | ({"track", "sparse"} - set(kp_captured)))
    if missing:
        raise SystemExit(f"no captured inputs for {missing}")
    kernels = check_kernels(plan(), captured, launches, N_FRAMES)
    kernels += check_kernels(plan_kp(), kp_captured, kp_launches, N_FRAMES)
    loops = [check_loop(captured), check_loop(kp_captured, "odometry_loop[kp]"),
             check_sparse(kp_captured)]
    print(json.dumps({"kernels": kernels}))
    bad = [k["name"] for k in kernels if not k["ok"]]
    loops_ok = all(r["ok"] for r in loops)
    print(_gpu_line())
    if bad or not loops_ok or syncs:
        print(f"chip_smoke: kernels outside tolerance: {bad}; odometry loops and sparse block "
              f"ok: {[r['ok'] for r in loops]}; synchronising calls: {syncs}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
