"""The port's legacy CoFusion CRF multi-model step (``segmentation.mode="crf"``,
the per-slot step ``engine_multi._multi_frame_step_legacy``) against the
reference package, on the CPU, at 160x120 with 2 object slots and the
configuration of tests/test_multi_model.py's legacy test but
``odom_init=""`` (one reference compile of the init step and of the legacy
step for the module).

- tests/test_multi_model.py:141's 4-frame scene (a sphere moving sideways
  before a static camera) through the port: ``odometry.error_images`` on,
  the mask a valid label image, and the same active count as the reference.
- A sphere that jumps 20 cm towards the camera, which the legacy CRF spawns
  as a model on frame 1, then moves 1 cm: each step of frames 1 (the spawn)
  and 2 (the object tracked in its slot) is held in both
  directions, the port stepped from the reference's state (moved through
  ``interop``) against the reference's frame, and the reference stepped from
  the port's state against the port's frame: the camera within 1e-4 m and
  0.01 deg, the lifecycle equal (the active slots, the spawn flag), the mask
  equal on >= 99 % of the pixels, the global surfel count within 0.2 %.
"""

import dataclasses

import numpy as np
import pytest

from multimotionfusion_tpu import config as J
from multimotionfusion_tpu.engine import MultiMotionFusionTPU
from multimotionfusion_tpu.io.frame import FrameData
from multimotionfusion_tpu_torch import config as T
from multimotionfusion_tpu_torch import interop
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
from tests import synthetic
from tests.test_torch_multi_engine import _jstate, _to_reference
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMK = dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
H, W = CAMK["height"], CAMK["width"]
STEPS = (1, 2)  # the frames held one step at a time (1: the spawn)


def _cfg(C):
    """tests/test_multi_model.py's configuration in the legacy CRF mode, with
    ``odom_init=""``: the two packages draw other RANSAC sets (ROADMAP.md
    queue 3 #6), so a step held to 1e-4 starts the odometry unseeded."""
    return C.EngineConfig(
        camera=C.CameraModel(**CAMK), enable_multi_model=True, odom_init="kp", object_slots=2,
        object_capacity=1 << 14, surfels=C.SurfelConfig(max_surfels=65536, depth_cutoff=5.0),
        keypoints=C.KeypointConfig(max_keypoints=256, max_tracks=1024, track_history=8,
                                   detector="patch", match_dist_gate=1.0),
        segmentation=C.SegmentationConfig(mode="crf", new_label_min_frac=0.02))


def _frames(centres, radius):
    cam = J.CameraModel(**CAMK)
    out = []
    for i, c in enumerate(centres):
        d, rgb = synthetic.render(np.eye(4, dtype=np.float32), cam, sphere_center=tuple(c),
                                  sphere_radius=radius)
        out.append(FrameData(rgb=rgb.astype(np.uint8), depth=d, timestamp=int(i / 30 * 1e9)))
    return out


# tests/test_multi_model.py:141: a sphere moving 2 cm a frame sideways
SIDEWAYS = ([(0.15 + 0.02 * i, 0.0, 1.3) for i in range(4)], 0.45)
# a sphere that jumps 20 cm towards the camera (the legacy CRF spawns it),
# then moves 1 cm
APPROACH = ([(0.15, 0.0, 1.3), (0.15, 0.0, 1.1), (0.15, 0.0, 1.09)], 0.25)


def _summary(stats, active, pose, count, mask):
    return dict(active=np.asarray(active).tolist(), spawned=stats.get("spawned"),
                pose=np.asarray(pose, np.float64), count=int(count), mask=np.asarray(mask).copy())


def _ref_summary(eng):
    s = eng.finish()
    ms = eng.mstate
    return _summary(s, ms.objects.active, ms.pose, ms.smap.count, ms.prev_mask)


def _port_summary(eng):
    s = eng.finish()
    st = eng.state
    return _summary(s, st.objects.active, st.pose, st.smap.count, st.prev_mask)


def _reference_step(ms, tick, buckets, frame):
    eng = MultiMotionFusionTPU(_cfg(J))
    eng.mstate, eng.tick = ms, tick
    eng._buckets = lambda k_ahead=1: (buckets[0], buckets[0])
    eng._bucket_objects = lambda k_ahead=1: buckets[1]
    eng._maybe_prewarm = lambda: None
    eng.process_frame(frame)
    return _ref_summary(eng)


def _port_step(d, tick, buckets, frame):
    eng = MultiMotionFusionTorch(_cfg(T), device="cpu")
    eng.set_state(interop.multi_state_from_numpy(d, "cpu"), tick, *buckets)
    eng.process_frame(frame)
    return _port_summary(eng)


@pytest.fixture(scope="module")
def runs():
    """Both packages' free runs of both scenes, and the steps of ``STEPS``
    (each package from the other's state before the frame)."""
    out = {}
    for name, scene in (("sideways", SIDEWAYS), ("approach", APPROACH)):
        frames = _frames(*scene)
        ej = MultiMotionFusionTPU(_cfg(J))
        et = MultiMotionFusionTorch(_cfg(T), device="cpu")
        assert et.cfg.odometry.error_images and ej.cfg.odometry.error_images
        ref, port, states = [], [], []
        for f in frames:
            before_ref = (ej.mstate, ej.tick)
            before_port = (None if et.state is None else interop.multi_state_to_numpy(et.state),
                           et.tick)
            ej.process_frame(f)
            et.process_frame(f)
            states.append((before_ref + ((ej._bucket, ej._bucket_obj),),
                           before_port + ((et._map_bucket.bucket, et._obj_bucket.bucket),)))
            ref.append(_ref_summary(ej))
            port.append(_port_summary(et))
        out[name] = dict(frames=frames, ref=ref, port=port, states=states, engine=et)
    app = out["approach"]
    app["step"], app["cross"] = {}, {}
    for i in STEPS:
        (ms, tick, buckets), (d, ptick, pbuckets) = app["states"][i]
        app["step"][i] = _port_step(_jstate(ms), tick, buckets, app["frames"][i])
        app["cross"][i] = _reference_step(_to_reference(ms, d), ptick, pbuckets, app["frames"][i])
    return out


def test_multi_model_scene_runs_with_error_images(runs):
    run = runs["sideways"]
    eng = run["engine"]
    assert eng.cfg.odometry.error_images
    odo = eng._last_stats.odo
    assert odo.icp_error_image.shape == (H, W) and (odo.icp_error_image > 0).any()
    mask = eng.state.prev_mask.numpy()
    assert mask.shape == (H, W) and mask.min() >= 0 and mask.max() <= eng.cfg.object_slots
    assert np.isfinite(eng.finish()["icp_error"])
    for r, p in zip(run["ref"], run["port"]):
        assert r["active"] == p["active"]
        assert (r["mask"] == p["mask"]).mean() >= 0.99


def _angle_deg(a, b):
    """The angle between two rotations, from |A^T B - I| (arccos of the trace
    cannot resolve 0.01 deg between float32 matrices)."""
    d = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64) - np.eye(3)
    return float(np.degrees(np.linalg.norm(d) / np.sqrt(2.0)))


def _check(target, got, i):
    dt = np.linalg.norm(target["pose"][:3, 3] - got["pose"][:3, 3])
    assert dt < 1e-4, (i, dt)
    assert _angle_deg(target["pose"], got["pose"]) < 0.01, i
    assert (target["active"], target["spawned"]) == (got["active"], got["spawned"]), i
    assert (target["mask"] == got["mask"]).mean() >= 0.99, i
    assert abs(target["count"] - got["count"]) <= 0.002 * target["count"], i


@pytest.mark.parametrize("direction", ["port_from_reference", "reference_from_port"])
def test_legacy_step_matches_reference(runs, direction):
    run = runs["approach"]
    assert run["ref"][1]["spawned"] == 1.0 and any(run["ref"][1]["active"])
    for i in STEPS:
        if direction == "port_from_reference":
            _check(run["ref"][i], run["step"][i], i)
        else:
            _check(run["port"][i], run["cross"][i], i)


def test_legacy_crf_is_the_configured_mode(runs):
    cfg = runs["sideways"]["engine"].cfg
    assert cfg.segmentation.mode == "crf"
    assert dataclasses.replace(_cfg(T), odometry=cfg.odometry) == cfg
