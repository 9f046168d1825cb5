"""The multi-model path's tracking against the reference package on
chip_smoke.py's scene: bench.py::bench_multi_model's five textured spheres
on 0.12 m orbits in front of a static camera, external masks from a
ray-sphere test (id k + 1 where sphere k is in front), the multi phase's
configuration (5 object slots, spawn cool-down 4, ``odom_init="kp"``), cut
to 640/div x 480/div (the camera's intrinsics / div) and capacities of 2^14
surfels per object and 2^16 global. Both packages run the frames free on
the CPU; each tracked sphere's error is measured at its centre
(``chip_smoke.sphere_errors``: the spawn-frame centre carried by the
model's pose against the true one).

Prints both packages' readings as one JSON line, and checks that both spawn
the five models on the same frames with the same slot ids and keep them
active, and that each of the port's spheres stays within 2 cm of its centre
on every frame and within 1.5x the reference's largest error over all
spheres (the two runs part after a few frames, as in
tests/test_torch_multi_engine.py, so sphere by sphere they differ). Exits 1
when a check fails. It takes minutes (the plain RANSAC on the CPU), so it is
a script beside the tests, not one of them; chip_smoke.py bounds the same
error on the card at 640x480. The chip phase's 1 + 40 frames at 160x120:

    JAX_PLATFORMS=cpu python -m tests.torch_multi_spheres --div 4 --frames 41
"""

import argparse
import dataclasses
import json
import sys

import numpy as np

import chip_smoke
from multimotionfusion_tpu import config as J
from multimotionfusion_tpu.engine import MultiMotionFusionTPU
from multimotionfusion_tpu.io.frame import FrameData
from multimotionfusion_tpu_torch.config import CameraModel
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch


def scene(div: int, n_frames: int):
    """(port config, reference config, frames) of the cut scene."""
    cam = CameraModel(width=640 // div, height=480 // div, fx=528.0 / div, fy=528.0 / div,
                      cx=320.0 / div, cy=240.0 / div)
    cfg, frames = chip_smoke.multi_frames(n_frames, cam=cam, object_capacity=1 << 14,
                                          max_surfels=1 << 16)
    jcfg = J.EngineConfig(
        camera=J.CameraModel(**dataclasses.asdict(cam)), enable_multi_model=True,
        object_slots=cfg.object_slots, object_capacity=cfg.object_capacity,
        surfels=J.SurfelConfig(max_surfels=cfg.surfels.max_surfels),
        segmentation=J.SegmentationConfig(mode="precomputed"),
        model_spawn_offset=cfg.model_spawn_offset, upload_yuv420=False, upload_depth_mm=False)
    return cfg, jcfg, frames


def _reading(poses, active, ext, pose):
    return dict(active_per_frame=active.sum(1).tolist(), ext_id_per_slot=np.asarray(ext).tolist(),
                spawn_frames=[int(np.argmax(active[:, k])) for k in range(active.shape[1])
                              if active[:, k].any()],
                camera_drift_m=float(np.linalg.norm(np.asarray(pose)[:3, 3])),
                objects=chip_smoke.sphere_errors(poses, active, np.asarray(ext)))


def run_port(cfg, frames):
    eng = MultiMotionFusionTorch(cfg, device="cpu")
    for f in frames:
        eng.process_frame(f)
    eng.finish()
    obj_log, _ = eng._lifecycle_logs()
    return _reading(np.stack([p for _, p, _ in obj_log]), np.stack([a for _, _, a in obj_log]),
                    eng.state.objects.ext_id.numpy(), eng.state.pose.numpy())


def run_reference(jcfg, frames):
    eng = MultiMotionFusionTPU(jcfg)
    for f in frames:
        eng.process_frame(FrameData(rgb=f.rgb, depth=f.depth, timestamp=f.timestamp, mask=f.mask))
    eng.finish()
    # the reference logs object poses from the second frame on
    s = jcfg.object_slots
    poses = [np.broadcast_to(np.eye(4, dtype=np.float32), (s, 4, 4))]
    active = [np.zeros(s, bool)]
    for _, p, a in eng._obj_pose_dev:
        poses.append(np.asarray(p))
        active.append(np.asarray(a))
    return _reading(np.stack(poses), np.stack(active), eng.mstate.objects.ext_id,
                    eng.mstate.pose)


def failures(ref, port):
    """The checks above that fail, as messages."""
    out = []
    for key in ("active_per_frame", "spawn_frames", "ext_id_per_slot"):
        if port[key] != ref[key]:
            out.append(f"{key}: port {port[key]}, reference {ref[key]}")
    if port["active_per_frame"][-1] != 5 or len(port["objects"]) != 5:
        out.append(f"{port['active_per_frame'][-1]} active models at the end, not 5")
    worst_ref = max(o["max_centre_err_m"] for o in ref["objects"].values())
    for slot, o in port["objects"].items():
        if not (o["max_centre_err_m"] < 0.02 and o["max_centre_err_m"] < 1.5 * worst_ref):
            out.append(f"{slot}: centre error {o['max_centre_err_m']} m (reference's worst "
                       f"{worst_ref} m)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--div", type=int, default=4, help="camera cut: 640/div x 480/div")
    ap.add_argument("--frames", type=int, default=41, help="frames, the first the init frame")
    a = ap.parse_args()
    cfg, jcfg, frames = scene(a.div, a.frames)
    readings = dict(reference=run_reference(jcfg, frames), port=run_port(cfg, frames))
    print(json.dumps(readings))
    bad = failures(readings["reference"], readings["port"])
    for msg in bad:
        print(msg, file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
