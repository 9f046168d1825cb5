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

With ``--flow-crf`` the frames carry no masks and both packages run the
default flow-CRF segmentation (chip_smoke.py's multi_flow_crf phase): each
slot is associated with the sphere whose ray-sphere mask overlaps the slot's
mask most on its spawn frame (``chip_smoke.associate_slots``), and the
readings are printed with the same fields. The check is then that the port
spawns at least one model and keeps the camera within 0.08 m (the chip
phase's bounds); spawn frames and centre errors are read, not bounded.
``--div 1 --chip-capacities --seeds 0-3`` runs the chip phase's own
configuration (640x480, 2^16 surfels per object, 2^19 global) once per
engine seed (the RANSAC draws) and prints each package's camera drift per
seed (about 5 minutes a seed; full size, so on a large machine; with
``--packages reference`` only the reference, chip_smoke.py's
REF_FLOW_DRIFT_M). ``--one-step`` instead runs the reference
free and steps the port from the reference's state before each frame
(``odom_init=""``: no RANSAC draws), printing per frame the share of mask
pixels apart, the camera and the largest object pose gap.
"""

import os
import sys

# run as a file (python tests/<script>.py), the repo root first on the path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import dataclasses
import json

import numpy as np

import chip_smoke
from multimotionfusion_tpu import config as J
from multimotionfusion_tpu.engine import MultiMotionFusionTPU
from multimotionfusion_tpu.io.frame import FrameData
from multimotionfusion_tpu_torch.config import CameraModel
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch


def scene(div: int, n_frames: int, flow_crf: bool = False, capacities=(1 << 14, 1 << 16)):
    """(port config, reference config, frames) of the cut scene."""
    cam = CameraModel(width=640 // div, height=480 // div, fx=528.0 / div, fy=528.0 / div,
                      cx=320.0 / div, cy=240.0 / div)
    cfg, frames = chip_smoke.multi_frames(n_frames, cam=cam, object_capacity=capacities[0],
                                          max_surfels=capacities[1], masks=not flow_crf)
    jcfg = J.EngineConfig(
        camera=J.CameraModel(**dataclasses.asdict(cam)), enable_multi_model=True,
        object_slots=cfg.object_slots, object_capacity=cfg.object_capacity,
        surfels=J.SurfelConfig(max_surfels=cfg.surfels.max_surfels),
        segmentation=J.SegmentationConfig(mode=cfg.segmentation.mode),
        model_spawn_offset=cfg.model_spawn_offset, upload_yuv420=False, upload_depth_mm=False)
    return cfg, jcfg, frames


def _reading(poses, active, ext, pose, masks=None, cam=None, drift=None):
    """The readings; with ``masks`` [F, H, W] (flow-CRF) the slots' sphere ids
    come from the mask overlap on each slot's spawn frame."""
    if masks is not None:
        ext = chip_smoke.associate_slots(masks, active, cam)
    return dict(active_per_frame=active.sum(1).tolist(), ext_id_per_slot=np.asarray(ext).tolist(),
                max_camera_drift_m=max(drift) if drift else None,
                spawn_frames=[int(np.argmax(active[:, k])) for k in range(active.shape[1])
                              if active[:, k].any()],
                camera_drift_m=float(np.linalg.norm(np.asarray(pose)[:3, 3])),
                objects=chip_smoke.sphere_errors(poses, active, np.asarray(ext)))


def run_port(cfg, frames, flow_crf=False):
    eng = MultiMotionFusionTorch(cfg, device="cpu")
    masks, drift = [], []
    for f in frames:
        eng.process_frame(f)
        masks.append(np.zeros(cfg.camera.shape, np.int32) if eng.last_mask is None
                     else eng.last_mask.numpy().copy())
        drift.append(float(np.linalg.norm(eng.state.pose.numpy()[:3, 3])))
    eng.finish()
    obj_log, _ = eng._lifecycle_logs()
    return _reading(np.stack([p for _, p, _ in obj_log]), np.stack([a for _, _, a in obj_log]),
                    eng.state.objects.ext_id.numpy(), eng.state.pose.numpy(),
                    np.stack(masks) if flow_crf else None, cfg.camera, drift)


def run_reference(jcfg, frames, flow_crf=False):
    eng = MultiMotionFusionTPU(jcfg)
    masks, drift = [], []
    for f in frames:
        eng.process_frame(FrameData(rgb=f.rgb, depth=f.depth, timestamp=f.timestamp, mask=f.mask))
        masks.append(np.asarray(eng.mstate.prev_mask))
        drift.append(float(np.linalg.norm(np.asarray(eng.mstate.pose)[:3, 3])))
    eng.finish()
    # the reference logs object poses from the second frame on
    s = jcfg.object_slots
    poses = [np.broadcast_to(np.eye(4, dtype=np.float32), (s, 4, 4))]
    active = [np.zeros(s, bool)]
    for _, p, a in eng._obj_pose_dev:
        poses.append(np.asarray(p))
        active.append(np.asarray(a))
    return _reading(np.stack(poses), np.stack(active), eng.mstate.objects.ext_id,
                    eng.mstate.pose, np.stack(masks) if flow_crf else None, jcfg.camera, drift)


def one_step(cfg, jcfg, frames):
    """Per frame (share of mask pixels apart, camera gap, object gap) of the
    port stepped from the reference's state against the reference's frame."""
    from multimotionfusion_tpu_torch import interop
    from tests.test_torch_flow_crf_engine import gaps, jstate

    cfg, jcfg = dataclasses.replace(cfg, odom_init=""), dataclasses.replace(jcfg, odom_init="")
    eng = MultiMotionFusionTPU(jcfg)
    for i, f in enumerate(frames):
        before = (eng.mstate, eng.tick, (eng._bucket, eng._bucket_obj))
        eng.process_frame(FrameData(rgb=f.rgb, depth=f.depth, timestamp=f.timestamp, mask=f.mask))
        eng.finish()
        if i == 0:
            continue
        port = MultiMotionFusionTorch(cfg, device="cpu")
        port.set_state(interop.multi_state_from_numpy(jstate(before[0]), "cpu"), before[1],
                       *before[2])
        port.process_frame(f)
        port.finish()
        ref, st = eng.mstate, port.state
        g = gaps(dict(mask=np.asarray(ref.prev_mask), pose=np.asarray(ref.pose),
                      obj_pose=np.asarray(ref.objects.pose)),
                 dict(mask=st.prev_mask.numpy(), pose=st.pose.numpy(),
                      obj_pose=st.objects.pose.numpy()))
        print(json.dumps({"frame": i, "mask_share_apart": g[0], "camera_gap": g[1],
                          "object_gap": g[2],
                          "active": [int(np.asarray(ref.objects.active).sum()),
                                     int(st.objects.active.sum())]}), flush=True)


def failures(ref, port, flow_crf=False):
    """The checks above that fail, as messages."""
    out = []
    if flow_crf:
        if not port["spawn_frames"]:
            out.append("the port spawned no model")
        if not port["camera_drift_m"] < 0.08:
            out.append(f"camera drift {port['camera_drift_m']} m")
        return out
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
    ap.add_argument("--flow-crf", action="store_true",
                    help="no masks: the default flow-CRF segmentation spawns the models")
    ap.add_argument("--chip-capacities", action="store_true",
                    help="2^16 surfels per object and 2^19 global, as chip_smoke.py")
    ap.add_argument("--seeds", default="", help="engine seeds, e.g. 0-3: the camera drift per seed")
    ap.add_argument("--packages", default="reference,port",
                    help="with --seeds: the packages to run, e.g. reference")
    ap.add_argument("--one-step", action="store_true",
                    help="the port stepped from the reference's state before each frame")
    a = ap.parse_args()
    caps = (1 << 16, 1 << 19) if a.chip_capacities else (1 << 14, 1 << 16)
    cfg, jcfg, frames = scene(a.div, a.frames, a.flow_crf, caps)
    if a.one_step:
        one_step(cfg, jcfg, frames)
        return 0
    if a.seeds:
        lo, _, hi = a.seeds.partition("-")
        for seed in range(int(lo), int(hi or lo) + 1):
            run = dict(reference=lambda: run_reference(dataclasses.replace(jcfg, seed=seed),
                                                       frames, a.flow_crf),
                       port=lambda: run_port(dataclasses.replace(cfg, seed=seed), frames,
                                             a.flow_crf))
            r = {k: run[k]() for k in a.packages.split(",")}
            print(json.dumps({"seed": seed, **{k: {"max_camera_drift_m": v["max_camera_drift_m"],
                                                   "camera_drift_m": v["camera_drift_m"],
                                                   "spawn_frames": v["spawn_frames"]}
                                               for k, v in r.items()}}), flush=True)
        return 0
    readings = dict(reference=run_reference(jcfg, frames, a.flow_crf),
                    port=run_port(cfg, frames, a.flow_crf))
    print(json.dumps(readings))
    bad = failures(readings["reference"], readings["port"], a.flow_crf)
    for msg in bad:
        print(msg, file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
