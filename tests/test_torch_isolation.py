"""The PyTorch port stands alone, and its engine runs on the card by default.

- An AST scan of every file of ``multimotionfusion_tpu_torch/`` and of
  ``chip_smoke.py``: no import of ``jax`` or of the reference package
  ``multimotionfusion_tpu`` (the port's own ``multimotionfusion_tpu_torch``
  imports are fine). An AST scan, not ``sys.modules``: the test process may
  have imported jax already.
- Without CUDA the engine raises unless given ``device="cpu"``; configurations
  this slice does not port raise NotImplementedError.
"""

import ast
from pathlib import Path

import pytest
import torch

from multimotionfusion_tpu_torch.config import EngineConfig
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

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
    dict(enable_multi_model=True), dict(odom_init="kp"), dict(odom_init="tf"),
    dict(reloc_mode=True), dict(close_loops=True), dict(frame_to_frame_rgb=True),
    dict(upload_yuv420=True),
])
def test_unported_configurations_raise(override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MultiMotionFusionTorch(EngineConfig(**{**STATIC, **override}), device="cpu")
