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
5. replay the inputs each kernel saw at one steady-state frame of phase 2
   (the compaction frame's clean and the first frame's compaction from
   frames of their own) through the kernel and through its plain PyTorch
   version on the card, check them within the tolerances of
   ``multimotionfusion_tpu_torch.kernels.checks``, and time kernel, plain
   version and, where one exists, a single PyTorch library call computing the
   same function (CUDA events over back-to-back calls, so host launch overhead
   counts where the host is slower), plus the kernel's device time alone
   (torch.profiler); run the whole odometry loop on the card and, from the
   same inputs, the plain loop on the CPU;
6. print ``{"kernels": [...]}``, the card's name and power limit, and as the
   last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import contextlib
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


def static_frames(n_frames: int):
    """(config, frames, ground-truth poses) of the static 640x480 step: the
    reference package's bench.py::bench_static (same scene, camera motion and
    2^20 surfel capacity), 1 init frame + ``n_frames`` frames."""
    from multimotionfusion_tpu_torch.config import CameraModel, EngineConfig, SurfelConfig
    from multimotionfusion_tpu_torch.io.readers import SyntheticLogReader

    cam = CameraModel()
    cfg = EngineConfig(camera=cam, enable_multi_model=False, odom_init="",
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


def run_engine(K, cfg, frames, gt_poses):
    """Phase 2: the main path, frames 0..N_FRAMES, with every launch counted
    and every call of a plain version counted (there must be none)."""
    plain_calls = {}
    with count_plain_calls(plain_calls):
        out = _run_engine(K, cfg, frames, gt_poses)
    print(json.dumps({"phase": "plain_calls_on_main_path", "calls": plain_calls}))
    if plain_calls:
        raise SystemExit(f"plain versions ran on the main path: {plain_calls}")
    return out


def _run_engine(K, cfg, frames, gt_poses):
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
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    rot = max(
        float(np.degrees(np.arccos(np.clip((np.trace(est[i, :3, :3].T @ gt[i, :3, :3]) - 1) / 2,
                                           -1, 1))))
        for i in range(len(est))
    )
    summary = {
        "phase": "engine", "frames": len(est), "timed_frames": len(ms),
        "ms_per_frame_median": statistics.median(ms),
        # the highest quartile with at least ten timed frames beyond it
        "ms_per_frame_p75": statistics.quantiles(ms, n=4)[2],
        "ms_per_frame_min": min(ms), "surfels": stats["surfels"], "hwm": stats["hwm"],
        "ate_m": ate, "path_m": path, "ate_pct_path": 100.0 * ate / path,
        "max_rot_err_deg": rot, "launches": launches,
        "odometry_iterations_last_frame": rgbd.loop_iterations(engine._last_stats.odo),
        "gpu": _gpu_line(),
    }
    print(json.dumps(summary))
    if not (ate < 0.05 * path and rot < 1.5):
        raise SystemExit(f"camera tracking out of bounds: ATE {ate} m over {path} m, rot {rot} deg")
    for k in MAIN_PATH:
        if launches.get(k, 0) <= 0:
            raise SystemExit(f"kernel {k} was not launched on the main path")
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


def run_stages(K, engine, frames) -> None:
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
        "phase": "stages", "frames": n, "wall_ms_per_frame": wall, "stages_per_frame": stages,
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


def check_kernels(captured, launches, n_frames):
    """Phase 5: each kernel against its plain version on the recorded inputs."""
    from multimotionfusion_tpu_torch.kernels import checks

    kernels = []
    for name, key, launch_key, check, measure, src, rep in plan():
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


def check_loop(captured) -> dict:
    """The whole odometry loop: kernels on the card against the plain loop on
    the CPU, from the recorded inputs of one frame."""
    from multimotionfusion_tpu_torch.kernels import checks

    r = checks.check_track(checks.args("track", captured["track"]))
    print(json.dumps({"phase": "odometry_loop", **r}))
    return r


def run_sync_check(engine, frames) -> int:
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
    print(json.dumps({"phase": "sync_check", "frames": len(ticks), "ticks": ticks,
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

    missing = sorted({key for _, key, *_ in plan()} - set(captured))
    if missing:
        raise SystemExit(f"no captured inputs for {missing}")
    kernels = check_kernels(captured, launches, N_FRAMES)
    loop = check_loop(captured)
    print(json.dumps({"kernels": kernels}))
    bad = [k["name"] for k in kernels if not k["ok"]]
    print(_gpu_line())
    if bad or not loop["ok"] or syncs:
        print(f"chip_smoke: kernels outside tolerance: {bad}; odometry loop ok: {loop['ok']}; "
              f"synchronising calls: {syncs}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
