"""The PyTorch port stands alone, and its engine runs on the card by default.

- An AST scan of every file of ``multimotionfusion_tpu_torch/`` and of
  ``chip_smoke.py``: no import of ``jax`` or of the reference package
  ``multimotionfusion_tpu`` (the port's own ``multimotionfusion_tpu_torch``
  imports are fine). An AST scan, not ``sys.modules``: the test process may
  have imported jax already.
- Without CUDA the engine raises unless given ``device="cpu"``; configurations
  the port does not run yet raise NotImplementedError; the legacy CRF
  (``segmentation.mode="crf"``, static and precomputed-mask base
  configurations) turns the odometry's error images on and steps; the default
  ``odom_init="kp"`` constructs and steps on the CPU, and so does the
  multi-model engine with external masks (``segmentation.mode="precomputed"``)
  and with the flow-CRF segmentation (the default mode, "none" alike, also
  with a segm_lvl tracker of its own); ``reloc_mode`` and ``close_loops``
  step in both engines.
"""

import ast
from pathlib import Path

import pytest
import torch

import numpy as np

from multimotionfusion_tpu_torch.config import (CameraModel, EngineConfig, FernConfig,
                                                KeypointConfig, OdometryConfig, RansacConfig,
                                                SegmentationConfig, SurfelConfig)
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
from multimotionfusion_tpu_torch.io.readers import SyntheticLogReader

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "multimotionfusion_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
STATIC = dict(enable_multi_model=False, odom_init="")
PRECOMPUTED = dict(enable_multi_model=True, segmentation=SegmentationConfig(mode="precomputed"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "multimotionfusion_tpu")


def test_port_imports_no_jax_and_no_reference_package():
    assert len(FILES) > 10
    names = {p.name for p in FILES}
    assert {"flow.py", "crf.py", "components.py", "flow_crf.py", "ferns.py", "deformation.py",
            "loop_closure.py", "slic.py", "legacy_crf.py"} <= names
    bad = [(str(p.relative_to(ROOT)), m) for p in FILES for m in _imports(p) if _forbidden(m)]
    assert bad == []


def test_engine_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiMotionFusionTorch(EngineConfig(**STATIC))
    eng = MultiMotionFusionTorch(EngineConfig(**STATIC), device="cpu")
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("override", [
    dict(enable_multi_model=True, segmentation=SegmentationConfig(mode="crf")),
    dict(frame_to_frame_rgb=True), dict(upload_yuv420=True),
])
def test_unported_configurations_raise(override):
    if override.get("segmentation") is not None:  # the legacy CRF is ported: it steps
        _legacy_crf_steps({**STATIC, **override})
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MultiMotionFusionTorch(EngineConfig(**{**STATIC, **override}), device="cpu")


def _legacy_crf_steps(kw):
    """The legacy CRF multi-model engine (``segmentation.mode="crf"``) on a
    small camera: the odometry's error images turn on, three frames of the
    approaching spheres step on the CPU, the mask is a label image."""
    cam = CameraModel(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
    cfg = EngineConfig(**{**kw, "camera": cam, "object_slots": 2, "object_capacity": 2048,
                          "surfels": SurfelConfig(max_surfels=1 << 13, depth_cutoff=5.0),
                          "keypoints": KeypointConfig(max_keypoints=64, max_tracks=256,
                                                      track_history=8),
                          "ransac": RansacConfig(iterations=32)})
    assert cfg.enable_multi_model and cfg.segmentation.mode == "crf"
    assert not cfg.odometry.error_images
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = MultiMotionFusionTorch(cfg, device="cpu")
        assert eng.cfg.odometry.error_images
        for f in _spheres(cam, 3):
            eng.process_frame(f)
        stats = eng.finish()
    finally:
        torch.set_num_threads(n)
    assert stats["surfels"] > 0 and len(stats["segment_px"]) == 3
    mask = eng.last_mask
    assert mask.shape == (60, 80) and int(mask.min()) >= 0 and int(mask.max()) <= 2
    assert eng._last_stats.odo.icp_error_image.shape == (60, 80)
    assert len(eng.pose_log) == 3


def test_default_kp_engine_steps_on_cpu():
    """EngineConfig(enable_multi_model=False) keeps odom_init="kp" with the
    default keypoint and RANSAC settings; three frames on a small camera."""
    cam = CameraModel(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
    cfg = EngineConfig(camera=cam, enable_multi_model=False)
    assert cfg.odom_init == "kp" and cfg.keypoints.max_tracks == 4096
    eng = MultiMotionFusionTorch(cfg, device="cpu")
    for f in SyntheticLogReader(cam, num_frames=3):
        eng.process_frame(f)
    stats = eng.finish()
    assert stats["surfels"] > 0 and eng.state.tracks.active.any()
    assert len(eng.pose_log) == 3


def test_unknown_odom_init_is_refused():
    with pytest.raises(ValueError, match="odom_init"):
        MultiMotionFusionTorch(EngineConfig(**{**STATIC, "odom_init": "imu"}), device="cpu")


@pytest.mark.parametrize("override", [
    dict(frame_to_frame_rgb=True),
    dict(segmentation=SegmentationConfig(mode="crf")),
    dict(upload_yuv420=True),
    dict(odom_init="tf"),
])
def test_unported_multi_configurations_raise(override):
    if override.get("segmentation") is not None:  # the legacy CRF is ported: it steps
        _legacy_crf_steps({**PRECOMPUTED, **override})
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MultiMotionFusionTorch(EngineConfig(**{**PRECOMPUTED, **override}), device="cpu")


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("kind", ["static", "multi"])
@pytest.mark.parametrize("flag", ["reloc_mode", "close_loops"])
def test_reloc_and_loop_closure_step_on_cpu(kind, flag):
    """``reloc_mode`` and ``close_loops`` construct and step (three frames of
    a small camera; the multi-model engine with external masks) on the CPU:
    the fern store holds the first keyframe, nothing is lost, the match log
    reads back."""
    cam = CameraModel(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
    base = STATIC if kind == "static" else {
        **PRECOMPUTED, "object_slots": 2, "object_capacity": 2048, "odom_init": "",
        "segmentation": SegmentationConfig(mode="precomputed", min_mask_size_px=40)}
    cfg = EngineConfig(camera=cam, surfels=SurfelConfig(max_surfels=1 << 13, depth_cutoff=5.0),
                       ferns=FernConfig(num_ferns=200, factor=4), **{**base, flag: True})
    eng = MultiMotionFusionTorch(cfg, device="cpu")
    for f in SyntheticLogReader(cam, num_frames=3):
        if kind == "multi":
            f.mask = np.zeros((cam.height, cam.width), np.uint8)
            f.mask[10:25, 10:30] = 7
        eng.process_frame(f)
    stats = eng.finish()
    assert stats["lost"] == 0.0 and stats["surfels"] > 0
    assert eng.state.ferns.capacity == cfg.ferns.num_ferns and int(eng.state.ferns.count) >= 1
    assert isinstance(eng.pose_matches(), list) and len(eng.pose_log) == 3


def test_precomputed_multi_engine_steps_on_cpu(tmp_path):
    """The multi-model engine with external masks (default odom_init="kp"):
    two ids in the mask spawn two models over four frames of a small camera
    (the last three in one ``process_frames`` call); events and one
    trajectory file per model."""
    cam = CameraModel(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
    cfg = EngineConfig(camera=cam, object_slots=2, object_capacity=2048, model_spawn_offset=1,
                       surfels=SurfelConfig(max_surfels=1 << 13, depth_cutoff=5.0),
                       keypoints=KeypointConfig(max_keypoints=64, max_tracks=256,
                                                track_history=8),
                       ransac=RansacConfig(iterations=32),
                       **{**PRECOMPUTED, "segmentation": SegmentationConfig(
                           mode="precomputed", min_mask_size_px=40)})
    assert cfg.odom_init == "kp"
    eng = MultiMotionFusionTorch(cfg, device="cpu")
    frames = list(SyntheticLogReader(cam, num_frames=4))
    for f in frames:
        f.mask = np.zeros((cam.height, cam.width), np.uint8)
        f.mask[10:25, 10:30] = 7
        f.mask[35:50, 50:70] = 3
    eng.process_frame(frames[0])
    eng.process_frames(frames[1:])
    stats = eng.finish()
    assert stats["active_objects"] == 2.0 and stats["surfels"] > 0
    assert sorted(eng.state.objects.ext_id.tolist()) == [3, 7]
    assert [e["id"] for e in eng.drain_events()] == [1, 2]
    names = sorted(p.rsplit("/", 1)[-1] for p in eng.export_poses(str(tmp_path)))
    assert names == ["poses-0.txt", "poses-1.txt", "poses-2.txt"]
    assert len((tmp_path / "poses-0.txt").read_text().splitlines()) == 4


def _spheres(cam, n):
    """Frames of three spheres that approach the camera, then move apart."""
    from multimotionfusion_tpu_torch.io import synthetic
    from multimotionfusion_tpu_torch.io.frame import FrameData

    cs = [np.array([-0.45, -0.1, 1.4]), np.array([0.45, -0.1, 1.4]), np.array([0.0, 0.3, 1.5])]
    vel = [np.array([0.02, 0.0, 0.0]), np.array([-0.02, 0.0, 0.0]), np.array([0.0, -0.015, 0.0])]
    out = []
    for i in range(n):
        depth, rgb = synthetic.render(np.eye(4, dtype=np.float32), cam,
                                      spheres=[(tuple(c), 0.22) for c in cs])
        out.append(FrameData(rgb=rgb.astype(np.uint8), depth=depth, timestamp=i))
        cs = [c + (np.array([0.0, 0.0, -0.04]) if i < 3 else v) for c, v in zip(cs, vel)]
    return out


@pytest.fixture
def one_torch_thread():
    """One torch thread: six pytest workers share the CPU (see
    tests/test_torch_segmentation.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("override", [
    dict(),  # the default flow_crf mode
    dict(segmentation=SegmentationConfig(mode="none", new_label_min_frac=0.01)),
    dict(odometry=OdometryConfig(segm_lvl=1)),
])
def test_flow_crf_multi_engine_steps_on_cpu(override):
    """``EngineConfig(enable_multi_model=True)`` with the flow-CRF: the
    spheres spawn models by themselves (no masks); with segm_lvl != init_lvl
    the second track table fills at its own level."""
    cam = CameraModel(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
    cfg = EngineConfig(camera=cam, enable_multi_model=True, object_slots=3,
                       object_capacity=2048, model_spawn_offset=2,
                       surfels=SurfelConfig(max_surfels=1 << 13, depth_cutoff=5.0),
                       keypoints=KeypointConfig(max_keypoints=64, max_tracks=256,
                                                track_history=8, match_dist_gate=1.0),
                       ransac=RansacConfig(iterations=32),
                       **{"segmentation": SegmentationConfig(new_label_min_frac=0.01), **override})
    assert cfg.segmentation.mode in ("flow_crf", "none") and cfg.odom_init == "kp"
    eng = MultiMotionFusionTorch(cfg, device="cpu")
    for f in _spheres(cam, 3):
        eng.process_frame(f)
    stats = eng.finish()
    assert stats["active_objects"] >= 1.0 and len(stats["segment_px"]) == 4
    assert [e["event"] for e in eng.drain_events()][:1] == ["new_model"]
    tseg = eng.state.tracks_segm
    if cfg.odometry.segm_lvl != cfg.odometry.init_lvl:
        assert tseg.capacity == 256 and bool(tseg.active.any())
    else:
        assert tseg.capacity == 1
    assert eng.last_mask.shape == (60, 80) and int(eng.last_mask.max()) >= 1
