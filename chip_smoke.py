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
   device kernel ms/frame by kernel and the device's busy share;
4. replay the inputs each kernel saw at one steady-state frame of phase 2
   through the kernel and through its plain PyTorch version on the card, check
   them within the tolerances of ``multimotionfusion_tpu_torch.kernels.checks``,
   and time kernel, plain version and, where one exists, a single PyTorch
   library call computing the same function (CUDA events over back-to-back
   calls, so host launch overhead counts where the host is slower), plus the
   kernel's device time alone (torch.profiler);
5. print ``{"kernels": [...]}``, the card's name and power limit, and as the
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
from collections import defaultdict

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
N_FRAMES = 45
WARMUP = 5
STAGE_FRAMES = 10
# frame whose kernel inputs are replayed: the last one, where the most surfels
# have reached the confidence gate (the prediction grows from empty at frame
# ~25 to ~10% of the pixels at frame 45)
CAPTURE_AT = N_FRAMES
DEVICE = "cuda"
MAIN_PATH = ("zbuffer", "splat_resolve", "fuse", "gn_reduce.L0", "gn_reduce.L1", "gn_reduce.L2")


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


def run_engine(K, cfg, frames, gt_poses):
    """Phase 2: the main path, frames 0..N_FRAMES, with every launch counted."""
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

    K.reset_launches()
    engine = MultiMotionFusionTorch(cfg, device=DEVICE)
    engine.process_frame(frames[0])
    ms, captured = [], {}
    for i in range(1, N_FRAMES + 1):
        if i == CAPTURE_AT:
            K.start_capture()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        engine.process_frame(frames[i])
        end.record()
        end.synchronize()
        if i == CAPTURE_AT:
            captured = K.stop_capture()
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
        "max_rot_err_deg": rot, "launches": launches, "gpu": _gpu_line(),
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


def run_stages(engine, frames) -> None:
    """Phase 3: where the frame's time goes, per stage and per device kernel."""
    from multimotionfusion_tpu_torch import engine as E

    n = STAGE_FRAMES
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
        "top_kernels_ms_per_frame": [
            {"name": name, "ms": v[0], "launches_per_frame": v[1] / n} for name, v in top],
        "gpu": _gpu_line(),
    }))


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
    from multimotionfusion_tpu_torch.ops import rasterize as R

    index = a[0]
    npix = index.numel()
    n_win = int(torch.unique(index[index >= 0]).numel())
    bound, by = _bound(4 * npix + 13 * 4 * n_win + 49 * npix, 25 * 40 * npix)
    return dict(
        ms=_time_ms(lambda: R.splat_resolve_cuda(*a)),
        device_ms=_device_ms(lambda: R.splat_resolve_cuda(*a)),
        plain_ms=_time_ms(lambda: R.splat_resolve_plain(*a), reps=5),
        library_ms=None, bound_ms=bound, bound_by=by,
    )


def measure_fuse(a):
    from multimotionfusion_tpu_torch.model import fusion as FU

    cam = a[9]
    n, npix = a[0].shape[1], cam.height * cam.width
    n_cb = npix // 4
    bound, by = _bound(2 * 64 * n + 64 * n_cb + 4 * npix + 28 * n_cb + 64 * n_cb, 16 * 60 * n_cb)
    return dict(
        ms=_time_ms(lambda: FU.fuse_cuda(*a)), device_ms=_device_ms(lambda: FU.fuse_cuda(*a)),
        plain_ms=_time_ms(lambda: FU.fuse_plain(*a), reps=5),
        library_ms=None, bound_ms=bound, bound_by=by,
    )


def measure_gn(a, level):
    from multimotionfusion_tpu_torch.odometry import rgbd

    icp_rows, rgb_rows, _ = rgbd.gn_rows(*a)
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


SOURCES = {
    "zbuffer": ("multimotionfusion_tpu_torch/csrc/zbuffer.cu",
                "multimotionfusion_tpu/ops/rasterize.py:142"),
    "splat_resolve": ("multimotionfusion_tpu_torch/csrc/splat_resolve.cu",
                      "multimotionfusion_tpu/ops/rasterize.py:366"),
    "fuse": ("multimotionfusion_tpu_torch/csrc/fuse.cu", "multimotionfusion_tpu/model/fusion.py:54"),
    "gn_reduce": ("multimotionfusion_tpu_torch/csrc/gn_reduce.cu",
                  "multimotionfusion_tpu/odometry/rgbd.py:809"),
}


def check_kernels(captured, launches, n_frames):
    """Phase 4: each kernel against its plain version on the recorded inputs."""
    from multimotionfusion_tpu_torch.kernels import checks

    plan = [("zbuffer", "zbuffer", checks.check_zbuffer, measure_zbuffer),
            ("splat_resolve", "splat_resolve", checks.check_splat, measure_splat),
            ("fuse", "fuse", checks.check_fuse, measure_fuse)]
    for lvl in (0, 1, 2):
        plan.append((f"gn_reduce[L{lvl}]", f"gn_reduce.L{lvl}",
                     lambda a, lvl=lvl: checks.check_gn(a, lvl),
                     lambda a, lvl=lvl: measure_gn(a, lvl)))
    kernels = []
    for name, key, check, measure in plan:
        a = checks.args(key, captured[key])
        r = check(a)
        torch.cuda.synchronize()
        src, rep = SOURCES[key.split(".")[0]]
        line = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches.get(key, 0), "launches_per_frame": launches.get(key, 0) / n_frames}
        line.update(r)
        line.update(measure(a))
        print(json.dumps({"phase": "kernel", **line}))
        kernels.append(line)
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multimotionfusion_tpu_torch import kernels as K

    t_build = K.build_all()
    regs = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln]
            for k, v in K.BUILD_LOG.items()}
    print(json.dumps({"phase": "build", "seconds": t_build, "ptxas": regs}))

    cfg, frames, gt_poses = static_frames(N_FRAMES + 2 * STAGE_FRAMES)
    engine, launches, captured = run_engine(K, cfg, frames, gt_poses)
    run_stages(engine, frames[N_FRAMES + 1:])

    missing = [k for k in MAIN_PATH if k not in captured]
    if missing:
        raise SystemExit(f"no captured inputs for {missing}")
    kernels = check_kernels(captured, launches, N_FRAMES)
    print(json.dumps({"kernels": kernels}))
    bad = [k["name"] for k in kernels if not k["ok"]]
    print(_gpu_line())
    if bad:
        print(f"chip_smoke: kernels outside tolerance: {bad}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
