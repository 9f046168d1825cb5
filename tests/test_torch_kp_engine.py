"""The port's keypoint-seeded static engine against the reference package, on
the CPU.

(The seeded odometry itself, ``rgbd.track`` with ``T_init``, is held to the
reference in tests/test_torch_gn_loop.py, beside the unseeded loop, whose
eager reference replay it shares.)

- The journey of tests/test_tracking.py::test_engine_kp_init_end_to_end
  (160x120, ``odom_init="kp"``, 8 frames), one reference run for the module:
  the port's ATE < 0.01 m, and each frame's pose within 1 % of the path and
  0.3 deg of the reference's (the bounds of tests/test_torch_engine.py: the
  two runs draw different RANSAC sets and round apart).
- ``interop`` carries the reference's state after 5 frames, the track table
  included, into the port, which steps frame 6: pose within 1e-4 m of the
  reference's step, and the track table equal but for the descriptors and
  points of tracks whose keypoints differ (none on this scene).
- ``odom_init="tf"`` with ``icp_refine=False``: the ground-truth pose
  replaces the pose before each step and the odometry is skipped; poses and
  surfel count held to the reference engine over 5 frames at 80x60.
"""

import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel, EngineConfig, KeypointConfig, SurfelConfig
from multimotionfusion_tpu.engine import MultiMotionFusionTPU
from multimotionfusion_tpu.io.readers import SyntheticLogReader
from multimotionfusion_tpu_torch import interop
from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
from multimotionfusion_tpu_torch.config import EngineConfig as TEngineConfig
from multimotionfusion_tpu_torch.config import KeypointConfig as TKeypointConfig
from multimotionfusion_tpu_torch.config import SurfelConfig as TSurfelConfig
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
from multimotionfusion_tpu_torch.tracking import tracker as ttr
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMK = dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
KK = dict(max_keypoints=256, max_tracks=1024, track_history=8, detector="patch",
          match_dist_gate=1.0)
N = 8
SNAP = 5  # frames before the interop snapshot


def _t(a):
    return torch.from_numpy(np.array(a))


def _rot_deg(A, B):
    return float(np.degrees(np.arccos(np.clip((np.trace(A[:3, :3].T @ B[:3, :3]) - 1) / 2, -1, 1))))


# ---------------------------------------------------------------- journey

def _cfgs(**kw):
    cfg = EngineConfig(camera=CameraModel(**CAMK), odom_init="kp", enable_multi_model=False,
                       keypoints=KeypointConfig(**KK),
                       surfels=SurfelConfig(max_surfels=32768, depth_cutoff=5.0), **kw)
    tcfg = TEngineConfig(camera=TCameraModel(**CAMK), odom_init="kp", enable_multi_model=False,
                         keypoints=TKeypointConfig(**KK),
                         surfels=TSurfelConfig(max_surfels=32768, depth_cutoff=5.0), **kw)
    return cfg, tcfg


@pytest.fixture(scope="module")
def reference():
    cfg, _ = _cfgs()
    reader = SyntheticLogReader(cfg.camera, num_frames=N, cam_step=(0.004, 0, 0),
                                cam_rot_step=(0, 0.002, 0))
    frames = list(reader)
    eng = MultiMotionFusionTPU(cfg)
    snapshot = None
    for i, f in enumerate(frames):
        if i == SNAP:
            st = eng.state
            snapshot = {
                "smap.data": np.array(st.smap.data), "smap.count": np.array(st.smap.count),
                "pose": np.array(st.pose), "prev_pose": np.array(st.prev_pose),
                "filled.color": np.array(st.filled.color),
                "filled.vertex_conf": np.array(st.filled.vertex_conf),
                "filled.normal_rad": np.array(st.filled.normal_rad),
                "last_intensity_coarse": np.array(st.last_intensity_coarse),
            }
            snapshot.update({f"tracks.{k}": np.array(getattr(st.tracks, k)) for k in ttr.FIELDS})
            bucket = eng._bucket
        eng.process_frame(f)
        if i == SNAP:
            tracks_after = {k: np.array(getattr(eng.state.tracks, k)) for k in ttr.FIELDS}
    eng.finish()
    poses = np.stack([np.asarray(p) for _, p in eng._pose_dev])
    return dict(frames=frames, gt=np.stack(reader.gt_poses), poses=poses, snapshot=snapshot,
                bucket=bucket, tracks_after=tracks_after)


def test_kp_journey_matches_reference(reference):
    _, tcfg = _cfgs()
    eng = MultiMotionFusionTorch(tcfg, device="cpu")
    for f in reference["frames"]:
        eng.process_frame(f)
    eng.finish()
    est = np.stack([p for _, p in eng.pose_log])
    gt, ref = reference["gt"], reference["poses"]
    assert est.shape == ref.shape == (N, 4, 4)
    ate = np.sqrt(np.mean(np.sum((est[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=-1)))
    assert ate < 0.01, ate
    path = np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1))
    dt = np.linalg.norm(est[:, :3, 3] - ref[:, :3, 3], axis=-1)
    assert dt.max() < 0.01 * path, (dt.max(), path)
    assert max(_rot_deg(est[i], ref[i]) for i in range(N)) < 0.3
    assert int(eng.state.tracks.active.sum()) > 50


def test_state_with_tracks_steps_like_reference(reference):
    _, tcfg = _cfgs()
    snap = reference["snapshot"]
    state = interop.state_from_numpy(snap, device="cpu")
    back = interop.state_to_numpy(state)
    for k, v in snap.items():
        np.testing.assert_array_equal(back[k], v)
    eng = MultiMotionFusionTorch(tcfg, device="cpu")
    eng.set_state(state, tick=SNAP + 1, bucket=reference["bucket"])
    eng.process_frame(reference["frames"][SNAP])
    eng.finish()
    ref_pose = reference["poses"][SNAP]
    assert np.linalg.norm(eng.state.pose.numpy()[:3, 3] - ref_pose[:3, 3]) < 1e-4
    after = reference["tracks_after"]
    for k in ("seen", "has_depth", "last_seen", "nvalid", "active", "model_id"):
        np.testing.assert_array_equal(getattr(eng.state.tracks, k).numpy(), after[k], err_msg=k)
    for k in ("xy", "p3d", "desc"):
        np.testing.assert_allclose(getattr(eng.state.tracks, k).numpy(), after[k], rtol=0,
                                   atol=1e-5, err_msg=k)


def test_state_without_tracks_gets_an_empty_table(reference):
    snap = {k: v for k, v in reference["snapshot"].items() if not k.startswith("tracks.")}
    state = interop.state_from_numpy(snap, device="cpu")
    assert state.tracks is None and "tracks.xy" not in interop.state_to_numpy(state)
    _, tcfg = _cfgs()
    eng = MultiMotionFusionTorch(tcfg, device="cpu")
    eng.set_state(state, tick=SNAP + 1, bucket=reference["bucket"])
    assert eng.state.tracks.xy.shape == (KK["max_tracks"], KK["track_history"], 2)
    assert not eng.state.tracks.active.any()
    eng.process_frame(reference["frames"][SNAP])
    assert eng.state.tracks.active.any()


# ---------------------------------------------------------------- odom_init="tf"

def test_tf_init_matches_reference():
    icp_refine = False
    camk = dict(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
    sk = dict(max_surfels=16384, depth_cutoff=5.0)
    cfg = EngineConfig(camera=CameraModel(**camk), odom_init="tf", enable_multi_model=False,
                       icp_refine=icp_refine, surfels=SurfelConfig(**sk))
    tcfg = TEngineConfig(camera=TCameraModel(**camk), odom_init="tf", enable_multi_model=False,
                         icp_refine=icp_refine, surfels=TSurfelConfig(**sk))
    reader = SyntheticLogReader(cfg.camera, num_frames=5, cam_step=(0.004, 0, 0),
                                cam_rot_step=(0, 0.002, 0))
    frames, gt = list(reader), reader.gt_poses
    ej, et = MultiMotionFusionTPU(cfg), MultiMotionFusionTorch(tcfg, device="cpu")
    for f, g in zip(frames, gt):
        ej.process_frame(f, gt_pose=g)
        et.process_frame(f, gt_pose=g)
    sj, st = ej.finish(), et.finish()
    pj = np.stack([np.asarray(p) for _, p in ej._pose_dev])
    pt = np.stack([p for _, p in et.pose_log])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt, np.stack(gt), rtol=0, atol=1e-6)
    assert et._last_stats.odo is None
    assert abs(st["surfels"] - sj["surfels"]) <= 0.005 * sj["surfels"]
