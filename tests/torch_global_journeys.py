"""chip_smoke.py's relocalisation and loop-closure journeys through the
reference package and the port, on the CPU.

- ``reloc``: tests/test_reloc.py's journey (4 healthy frames, 13 blackout
  frames, a frame near pose 1) with ``reloc_mode``; prints per package the
  ``lost`` flag and ``bad_track_count`` of every frame and the recovered
  pose's distance from the truth (chip_smoke.py bounds the card's by
  RELOC_BOUND_M, tests/test_reloc.py's 0.06 m);
- ``loop``: tests/test_loop_closure.py's journey (six frames, a 3 cm
  self-consistent drift, a revisit of frame 0) with ``close_loops``; prints
  per package the PoseMatch records and the pose error before and after.

At ``--div 1`` both run chip_smoke.py's configurations (640x480, 2^20
surfels, the default FernConfig: 500 ferns at ÷8, 256 deformation nodes):
full size, so on a large machine (the GPU machine's CPU has JAX):

    python tests/torch_global_journeys.py --div 1 --packages reference

Other ``--div`` values cut the camera to 640/div x 480/div with the tests'
capacities (2^16 surfels, ferns at ÷4, 64 nodes); ``--div 4`` is
tests/test_reloc.py's own size. Exits 1 when a package misses the journeys'
gates (lost set and cleared, the pose within 0.06 m; a closure accepted,
the error after below 0.4 x before).
"""

import os
import sys

# run as a file (python tests/<script>.py), the repo root first on the path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse
import dataclasses
import json

import numpy as np

import chip_smoke
from multimotionfusion_tpu_torch.config import CameraModel


def _cam(div: int) -> CameraModel:
    return CameraModel(width=640 // div, height=480 // div, fx=528.0 / div, fy=528.0 / div,
                       cx=320.0 / div, cy=240.0 / div)


def _configs(C, div: int):
    """(reloc, loop) configurations of package ``C``'s config module."""
    cam = C.CameraModel(**dataclasses.asdict(_cam(div)))
    full = div == 1
    ferns = C.FernConfig() if full else C.FernConfig(num_ferns=300, factor=4, max_depth=5.0)
    cap = 1 << 20 if full else 1 << 16
    reloc = C.EngineConfig(camera=cam, enable_multi_model=False, odom_init="", reloc_mode=True,
                           surfels=C.SurfelConfig(max_surfels=cap, depth_cutoff=5.0), ferns=ferns)
    loop = C.EngineConfig(
        camera=cam, enable_multi_model=False, odom_init="", close_loops=True,
        surfels=C.SurfelConfig(max_surfels=cap, depth_cutoff=5.0, time_delta=3),
        keypoints=C.KeypointConfig(max_keypoints=64, max_tracks=256, track_history=8),
        ferns=ferns if full else C.FernConfig(num_ferns=200, factor=4),
        deformation=C.DeformationConfig(max_nodes=256 if full else 64, iterations=3),
        loop_accept_cons_err=0.02)
    return reloc, loop


def _engine(package: str, cfg):
    if package == "reference":
        from multimotionfusion_tpu.engine import MultiMotionFusionTPU

        return MultiMotionFusionTPU(cfg)
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

    return MultiMotionFusionTorch(cfg, device="cpu")


def _config_module(package: str):
    if package == "reference":
        from multimotionfusion_tpu import config
    else:
        from multimotionfusion_tpu_torch import config
    return config


def _np(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def reloc(package: str, div: int) -> dict:
    cfg = _configs(_config_module(package), div)[0]
    frames, T_true = chip_smoke.reloc_frames(_cam(div))
    eng = _engine(package, cfg)
    lost, bad = [], []
    for f in frames:
        eng.process_frame(f)
        eng.finish()
        lost.append(bool(_np(eng.state.lost)))
        bad.append(int(_np(eng.state.bad_track_count)))
    delta = np.linalg.inv(T_true) @ _np(eng.state.pose)
    err = float(np.linalg.norm(delta[:3, 3]))
    ok = lost[-2] and not lost[3] and not lost[-1] and err < 0.06
    return {"journey": "reloc", "package": package, "lost": lost, "bad_track_count": bad,
            "pose_err_m": err, "ok": ok}


def loop(package: str, div: int) -> dict:
    from multimotionfusion_tpu_torch.io import synthetic
    from multimotionfusion_tpu_torch.io.frame import FrameData

    cfg = _configs(_config_module(package), div)[1]
    cam = _cam(div)
    gt = [synthetic.pose((0.0, 0.0015 * i, 0.0), (0.002 * i, 0.0, 0.0)) for i in range(6)]
    eng = _engine(package, cfg)
    D = np.eye(4, dtype=np.float32)
    D[:3, 3] = (0.03, -0.02, 0.01)
    for i, T in enumerate(gt + [gt[0]]):
        if i == 6:
            eng.finish()
            eng.state = (chip_smoke.drift_state(eng.state, D) if package == "port"
                         else _drift_reference(eng.state, D))
            drifted = _np(eng.state.pose)
        depth, rgb = synthetic.render(T, cam)
        eng.process_frame(FrameData(rgb=rgb.astype(np.uint8), depth=depth, timestamp=i))
    eng.finish()
    pose = _np(eng.state.pose)
    before = float(np.linalg.norm((D @ gt[0])[:3, 3] - gt[0][:3, 3]))
    after = float(np.linalg.norm(pose[:3, 3] - gt[0][:3, 3]))
    matches = [{k: (float(v) if isinstance(v, (float, np.floating)) else v)
                for k, v in m.items() if not k.endswith("_pose")} for m in eng.pose_matches()]
    ok = bool(matches) and matches[-1]["accepted"] and after < 0.4 * before
    return {"journey": "loop", "package": package, "matches": matches, "pose_err_before_m": before,
            "pose_err_after_m": after, "pose_moved": float(np.linalg.norm(pose - drifted)),
            "ok": ok}


def _drift_reference(state, D):
    import jax.numpy as jnp

    from multimotionfusion_tpu.model import surfel_map as sm

    Dj = jnp.asarray(D)
    pos = state.smap.data[sm.POS]
    data = state.smap.data.at[sm.POS].set(
        jnp.where(state.smap.alive_mask()[None], Dj[:3, :3] @ pos + Dj[:3, 3:4], pos))
    return state._replace(pose=Dj @ state.pose, prev_pose=Dj @ state.prev_pose,
                          smap=sm.SurfelMap(data=data, count=state.smap.count))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--div", type=int, default=4, help="camera cut: 640/div x 480/div")
    ap.add_argument("--packages", default="reference,port")
    ap.add_argument("--journeys", default="reloc,loop")
    args = ap.parse_args()
    ok = True
    for journey in args.journeys.split(","):
        for package in args.packages.split(","):
            r = {"reloc": reloc, "loop": loop}[journey](package, args.div)
            r["div"] = args.div
            print(json.dumps(r), flush=True)
            ok = ok and r["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
