"""The PyTorch port stands alone, and its engine runs on the card by default.

- An AST scan of every file of ``multimotionfusion_tpu_torch/`` and of
  ``chip_smoke.py``: no import of ``jax`` or of the reference package
  ``multimotionfusion_tpu`` (the port's own ``multimotionfusion_tpu_torch``
  imports are fine). An AST scan, not ``sys.modules``: the test process may
  have imported jax already.
- Without CUDA the engine raises unless given ``device="cpu"``; configurations
  this slice does not port raise NotImplementedError; the default
  ``odom_init="kp"`` constructs and steps on the CPU, and so does the
  multi-model engine with external masks (``segmentation.mode="precomputed"``).
"""

import ast
from pathlib import Path

import pytest
import torch

import numpy as np

from multimotionfusion_tpu_torch.config import (CameraModel, EngineConfig, KeypointConfig,
                                                OdometryConfig, RansacConfig, SegmentationConfig,
                                                SurfelConfig)
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
    bad = [(str(p.relative_to(ROOT)), m) for p in FILES for m in _imports(p) if _forbidden(m)]
    assert bad == []


def test_engine_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiMotionFusionTorch(EngineConfig(**STATIC))
    eng = MultiMotionFusionTorch(EngineConfig(**STATIC), device="cpu")
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("override", [
    dict(enable_multi_model=True), dict(reloc_mode=True), dict(close_loops=True),
    dict(frame_to_frame_rgb=True), dict(upload_yuv420=True),
])
def test_unported_configurations_raise(override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MultiMotionFusionTorch(EngineConfig(**{**STATIC, **override}), device="cpu")


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
    dict(segmentation=SegmentationConfig()),  # flow_crf, the default
    dict(segmentation=SegmentationConfig(mode="crf")),
    dict(odometry=OdometryConfig(segm_lvl=1)),
    dict(reloc_mode=True), dict(close_loops=True), dict(odom_init="tf"),
])
def test_unported_multi_configurations_raise(override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MultiMotionFusionTorch(EngineConfig(**{**PRECOMPUTED, **override}), device="cpu")


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
