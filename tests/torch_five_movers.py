"""tests/test_five_movers.py's journey through both packages on the CPU.

Five spheres of 0.21 m in front of a static 160x120 camera approach it for
4 frames, then move apart in opposing directions for 12 (1 + 16 frames);
the multi-model engine with the default flow-CRF segmentation spawns a model
per sphere by itself. Prints, for the reference package (the scene of
tests/synthetic.py) and for the port (chip_smoke.five_movers, the scene of
the port's own io/synthetic.py), the frame each slot became active, the
active models per frame, the pixels per label of the final mask, each
slot's motion (inv(pose) translation, last minus first active frame) and
the camera's drift, as one JSON line; then applies test_five_movers's
assertions to the port (five spawns at least two frames apart, five active
over the last three frames, more than 120 pixels per label, a clearly +x and
a clearly -x motion and none beyond 0.45 m, camera within 0.08 m) and exits
1 when one fails. About a minute of CPU; chip_smoke.py holds the same
assertions on the card:

    JAX_PLATFORMS=cpu python -m tests.torch_five_movers

The assertions hold for some random streams and not for others, in both
packages (the engines' seeds drive their RANSAC draws). With ``--seeds 0-5``
both packages run the journey once per engine seed (``--packages reference``
only the reference: chip_smoke.py's REF_FIVE_* come from ``--seeds 0-47``);
the script prints which seeds pass the assertions in each package, and
exits 1 when the port runs and passes none (about a minute a seed and
package).
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
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch


def _reading(active, poses, mask, cam_pose):
    """active [F, 5], poses [F, 5, 4, 4] per frame, the final mask, the camera."""
    spawn = {int(k): int(np.argmax(active[:, k])) for k in range(5) if active[:, k].any()}
    totals = []
    for k in range(5):
        on = [np.linalg.inv(poses[j, k])[:3, 3] for j in range(len(active)) if active[j, k]]
        totals.append((on[-1] - on[0]) if on else np.zeros(3))
    return dict(spawn_frames=spawn, active_per_frame=active.sum(1).tolist(),
                pixels_per_label=[int((mask == mid).sum()) for mid in range(1, 6)],
                totals_m=np.stack(totals).round(4).tolist(),
                camera_m=float(np.linalg.norm(np.asarray(cam_pose)[:3, 3])))


def run_reference(seed=0):
    from multimotionfusion_tpu.engine import MultiMotionFusionTPU
    from tests import test_five_movers as ref_test

    eng = MultiMotionFusionTPU(dataclasses.replace(ref_test._cfg(), seed=seed))
    active, poses = [], []
    for f in ref_test._frames():
        eng.process_frame(f)
        active.append(np.asarray(eng.mstate.objects.active))
        poses.append(np.asarray(eng.mstate.objects.pose))
    eng.finish()
    return _reading(np.stack(active), np.stack(poses), np.asarray(eng.mstate.prev_mask),
                    eng.mstate.pose)


def run_port(seed=0, device="cpu"):
    cfg, frames = chip_smoke.five_movers()
    eng = MultiMotionFusionTorch(dataclasses.replace(cfg, seed=seed), device=device)
    for f in frames:
        eng.process_frame(f)
    eng.finish()
    obj_log, _ = eng._lifecycle_logs()
    r = _reading(np.stack([a for _, _, a in obj_log]), np.stack([p for _, p, _ in obj_log]),
                 eng.state.prev_mask.cpu().numpy(), eng.state.pose.cpu().numpy())
    r["camera_per_frame_m"] = [round(float(np.linalg.norm(p[:3, 3])), 5) for _, p in eng.pose_log]
    return r


def failures(r):
    """test_five_movers's assertions on one reading, as messages."""
    out = []
    ticks = sorted(r["spawn_frames"].values())
    if len(ticks) != 5 or any(b - a < 2 for a, b in zip(ticks, ticks[1:])):
        out.append(f"spawn frames {r['spawn_frames']}")
    if any(a != 5 for a in r["active_per_frame"][-3:]):
        out.append(f"active per frame {r['active_per_frame']}")
    if any(n <= 120 for n in r["pixels_per_label"]):
        out.append(f"pixels per label {r['pixels_per_label']}")
    t = np.asarray(r["totals_m"])
    if not ((t[:, 0] > 0.03).sum() >= 1 and (t[:, 0] < -0.03).sum() >= 1
            and np.abs(t).max() < 0.45):
        out.append(f"motions {r['totals_m']}")
    if not r["camera_m"] < 0.08:
        out.append(f"camera {r['camera_m']} m")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="", help="engine seeds, e.g. 0-5 (default: 0 only)")
    ap.add_argument("--packages", default="reference,port",
                    help="with --seeds: the packages to run, e.g. reference")
    a = ap.parse_args()
    if not a.seeds:
        readings = dict(reference=run_reference(), port=run_port())
        print(json.dumps(readings))
        bad = failures(readings["port"])
        for msg in bad:
            print("port:", msg, file=sys.stderr)
        return 1 if bad else 0
    lo, _, hi = a.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)
    packages = a.packages.split(",")
    passing = {name: [] for name in packages}
    for seed in seeds:
        run = dict(reference=run_reference, port=run_port)
        readings = {name: run[name](seed) for name in packages}
        for name, r in readings.items():
            bad = failures(r)
            if not bad:
                passing[name].append(seed)
            print(json.dumps({"seed": seed, "package": name, "failures": bad,
                              "camera_m": r["camera_m"], "pixels_per_label": r["pixels_per_label"]}))
    print(json.dumps({"seeds": list(seeds), "passing_seeds": passing}))
    return 0 if passing.get("port", [0]) else 1


if __name__ == "__main__":
    sys.exit(main())
