"""The port's static engine against the reference engine, on the CPU.

One reference run (the 48-frame 80x60 journey of tests/test_ate_gate.py, one
init frame then batches of 10; the reference's last batch runs three frames
past the journey, whose poses are dropped, so its batched step compiles
once) is shared by the module:
- the port, driven the same way, passes the same camera ATE and rotation
  bounds, and each frame's pose is within 1% of the path length and 0.3 deg of
  the reference's (the two float32 pipelines round differently, and the
  differences feed back through the map, so frame poses agree to a fraction
  of the accuracy bounds, not bit for bit);
- ``interop.state_from_numpy`` carries the reference's state after the init
  frame and 10 tracked frames into the port, which then steps the next frame:
  pose within 1e-4 m and surfel counts within 0.5% of the reference's step.
"""

import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel, EngineConfig, SurfelConfig
from multimotionfusion_tpu.engine import STAT_HWM, STAT_SURFELS, MultiMotionFusionTPU
from multimotionfusion_tpu.io.readers import SyntheticLogReader
from multimotionfusion_tpu_torch import interop
from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
from multimotionfusion_tpu_torch.config import EngineConfig as TEngineConfig
from multimotionfusion_tpu_torch.config import SurfelConfig as TSurfelConfig
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMK = dict(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
N = 48
BATCHES = [(1, 11), (11, 21), (21, 31), (31, 41), (41, N)]  # as tests/test_ate_gate.py
# the reference's last batch runs on past the journey to the batches' common
# length, so its batched step compiles once (a batch of 7 is a second
# program); the poses of those extra frames are dropped
REF_BATCHES = BATCHES[:-1] + [(41, 51)]


def _cfgs():
    cfg = EngineConfig(camera=CameraModel(**CAMK), enable_multi_model=False, odom_init="",
                       surfels=SurfelConfig(max_surfels=65536, depth_cutoff=5.0))
    tcfg = TEngineConfig(camera=TCameraModel(**CAMK), enable_multi_model=False, odom_init="",
                         surfels=TSurfelConfig(max_surfels=65536, depth_cutoff=5.0))
    return cfg, tcfg


@pytest.fixture(scope="module")
def reference():
    cfg, _ = _cfgs()
    reader = SyntheticLogReader(cfg.camera, num_frames=REF_BATCHES[-1][1],
                                cam_step=(0.004, 0.0, 0.0), cam_rot_step=(0.0, 0.002, 0.0))
    frames = list(reader)
    eng = MultiMotionFusionTPU(cfg)
    eng.process_frame(frames[0])
    snapshot = bucket = None
    for lo, hi in REF_BATCHES:
        if lo == 11:
            st = eng.state
            snapshot = {
                "smap.data": np.array(st.smap.data), "smap.count": np.array(st.smap.count),
                "pose": np.array(st.pose), "prev_pose": np.array(st.prev_pose),
                "filled.color": np.array(st.filled.color),
                "filled.vertex_conf": np.array(st.filled.vertex_conf),
                "filled.normal_rad": np.array(st.filled.normal_rad),
                "last_intensity_coarse": np.array(st.last_intensity_coarse),
            }
        eng.process_frames(frames[lo:hi])
        if lo == 11:
            bucket = eng._bucket
            stats11 = np.array(eng._stats_dev[-1])[0]  # the batch's first frame
    eng.finish()
    poses = np.stack([p for _, p in eng.global_model.pose_log])[:N]
    return dict(frames=frames[:N], gt=np.stack(reader.gt_poses)[:N], poses=poses,
                snapshot=snapshot, bucket=bucket, stats11=stats11)


def _rot_deg(A, B):
    return float(np.degrees(np.arccos(np.clip((np.trace(A[:3, :3].T @ B[:3, :3]) - 1) / 2, -1, 1))))


def test_journey_matches_reference(reference):
    _, tcfg = _cfgs()
    frames = reference["frames"]
    eng = MultiMotionFusionTorch(tcfg, device="cpu")
    eng.process_frame(frames[0])
    for lo, hi in BATCHES:
        eng.process_frames(frames[lo:hi])
    eng.finish()
    est = np.stack([p for _, p in eng.global_model.pose_log])
    gt, ref = reference["gt"], reference["poses"]
    assert est.shape == ref.shape == (N, 4, 4)

    path = np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1))
    ate = np.sqrt(np.mean(np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1) ** 2))
    assert ate < 0.05 * path, (ate, path)
    assert max(_rot_deg(est[i], gt[i]) for i in range(N)) < 1.5

    dt = np.linalg.norm(est[:, :3, 3] - ref[:, :3, 3], axis=-1)
    assert dt.max() < 0.01 * path, dt.max()
    assert max(_rot_deg(est[i], ref[i]) for i in range(N)) < 0.3


def test_state_from_numpy_one_step(reference):
    _, tcfg = _cfgs()
    state = interop.state_from_numpy(reference["snapshot"], device="cpu")
    back = interop.state_to_numpy(state)
    for k, v in reference["snapshot"].items():
        np.testing.assert_array_equal(back[k], v)
    eng = MultiMotionFusionTorch(tcfg, device="cpu")
    eng.set_state(state, tick=12, bucket=reference["bucket"])
    eng.process_frames(reference["frames"][11:12])
    stats = eng.finish()
    ref_pose = reference["poses"][11]
    assert np.linalg.norm(eng.state.pose.numpy()[:3, 3] - ref_pose[:3, 3]) < 1e-4
    ref = reference["stats11"]
    assert abs(stats["hwm"] - ref[STAT_HWM]) <= 0.005 * ref[STAT_HWM]
    assert abs(stats["surfels"] - ref[STAT_SURFELS]) <= 0.005 * ref[STAT_SURFELS]
    assert isinstance(eng.state.smap.count, torch.Tensor)
