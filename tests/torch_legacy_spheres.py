"""The legacy CoFusion CRF multi-model path (``segmentation.mode="crf"``) on
chip_smoke.py's scene: bench.py::bench_multi_model's five textured spheres
on 0.12 m orbits in front of a static camera, no masks, the multi phase's
configuration (5 object slots, spawn cool-down 4, ``odom_init="kp"``) with
the legacy CRF, cut to 640/div x 480/div (the camera's intrinsics / div).

Prints each package's lifecycle as one JSON line per package: the active
model count on every frame, the frames on which a model was spawned (the
``spawned`` stat), the camera drift and the segment areas of the last
frame. chip_smoke.py's multi_legacy_crf phase holds the card's lifecycle
equal to the reference package's reading from this script (its constants
REF_LEGACY_*). Full size, the chip phase's own configuration, is for a large
machine (JAX on its CPU):

    python tests/torch_legacy_spheres.py --div 1 --chip-capacities --packages reference

and a quick look on a small machine:

    JAX_PLATFORMS=cpu python tests/torch_legacy_spheres.py --div 4 --frames 11
"""

import os
import sys

# run as a file (python tests/<script>.py), the repo root first on the path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import dataclasses
import json
import time

import numpy as np


def scene(div: int, n_frames: int, capacities):
    """(port config, reference config, frames) of the cut scene in "crf" mode."""
    import chip_smoke
    from multimotionfusion_tpu_torch.config import CameraModel, SegmentationConfig

    cam = CameraModel(width=640 // div, height=480 // div, fx=528.0 / div, fy=528.0 / div,
                      cx=320.0 / div, cy=240.0 / div)
    cfg, frames = chip_smoke.multi_frames(n_frames, cam=cam, object_capacity=capacities[0],
                                          max_surfels=capacities[1], masks=False)
    cfg = dataclasses.replace(cfg, segmentation=SegmentationConfig(mode="crf"))
    return cfg, frames


def _jcfg(cfg):
    from multimotionfusion_tpu import config as J

    return J.EngineConfig(
        camera=J.CameraModel(**dataclasses.asdict(cfg.camera)), enable_multi_model=True,
        object_slots=cfg.object_slots, object_capacity=cfg.object_capacity,
        surfels=J.SurfelConfig(max_surfels=cfg.surfels.max_surfels),
        segmentation=J.SegmentationConfig(mode="crf"),
        model_spawn_offset=cfg.model_spawn_offset, upload_yuv420=False, upload_depth_mm=False)


def run(package: str, cfg, frames) -> dict:
    """The lifecycle of one package's free run (``device`` "cpu" for the port)."""
    active, spawned, drift = [], [], []
    t0 = time.time()
    if package == "reference":
        from multimotionfusion_tpu.engine import MultiMotionFusionTPU
        from multimotionfusion_tpu.io.frame import FrameData

        eng = MultiMotionFusionTPU(_jcfg(cfg))
        for f in frames:
            eng.process_frame(FrameData(rgb=f.rgb, depth=f.depth, timestamp=f.timestamp))
            s = eng.finish()
            active.append(int(np.asarray(eng.mstate.objects.active).sum()))
            spawned.append(bool(s.get("spawned", 0.0)))
            drift.append(float(np.linalg.norm(np.asarray(eng.mstate.pose)[:3, 3])))
    else:
        from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

        eng = MultiMotionFusionTorch(cfg, device=package)
        for f in frames:
            eng.process_frame(f)
            s = eng.finish()
            active.append(int(eng.state.objects.active.sum()))
            spawned.append(bool(s.get("spawned", 0.0)))
            drift.append(float(np.linalg.norm(eng.state.pose.cpu().numpy()[:3, 3])))
    return dict(package=package, size=[cfg.camera.width, cfg.camera.height],
                frames=len(frames), active_per_frame=active,
                spawn_frames=[i for i, x in enumerate(spawned) if x], camera_drift_m=drift[-1],
                max_camera_drift_m=max(drift), segment_px=s.get("segment_px"),
                seconds=time.time() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--div", type=int, default=4, help="camera cut: 640/div x 480/div")
    ap.add_argument("--frames", type=int, default=41, help="frames, the first the init frame")
    ap.add_argument("--chip-capacities", action="store_true",
                    help="chip_smoke's capacities (2^16 surfels per object, 2^19 global)")
    ap.add_argument("--packages", default="reference,port",
                    help="reference, port (the port on the CPU) or cuda (the port on the card)")
    a = ap.parse_args()
    caps = (1 << 16, 1 << 19) if a.chip_capacities else (1 << 14, 1 << 16)
    cfg, frames = scene(a.div, a.frames, caps)
    out = []
    for pkg in a.packages.split(","):
        r = run("cpu" if pkg == "port" else pkg, cfg, frames)
        out.append(r)
        print(json.dumps(r), flush=True)
    if len(out) == 2:
        same = all(out[0][k] == out[1][k] for k in ("active_per_frame", "spawn_frames"))
        print(json.dumps({"lifecycle_equal": same}))
        return 0 if same else 1
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")  # the reference runs on the CPU
    sys.exit(main())
