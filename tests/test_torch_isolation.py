"""The PyTorch port stands alone, and its engine runs on the card by default.

- An AST scan of every file of ``multimotionfusion_tpu_torch/`` and of
  ``chip_smoke.py``: no import of ``jax`` or of the reference package
  ``multimotionfusion_tpu`` (the port's own ``multimotionfusion_tpu_torch``
  imports are fine). An AST scan, not ``sys.modules``: the test process may
  have imported jax already.
- Without CUDA the engine raises unless given ``device="cpu"``; configurations
  this slice does not port raise NotImplementedError; the default
  ``odom_init="kp"`` constructs and steps on the CPU.
"""

import ast
from pathlib import Path

import pytest
import torch

from multimotionfusion_tpu_torch.config import CameraModel, EngineConfig
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
from multimotionfusion_tpu_torch.io.readers import SyntheticLogReader

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "multimotionfusion_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
STATIC = dict(enable_multi_model=False, odom_init="")


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
