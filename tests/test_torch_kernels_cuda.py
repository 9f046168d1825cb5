"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Skipped where PyTorch sees no GPU. Imports nothing of JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

A 30-frame 160x120 run of the port's engine on the card records the inputs
each kernel saw at its last frame; every test replays them through the kernel
and the plain version and holds them to the tolerances of
``multimotionfusion_tpu_torch.kernels.checks``, as chip_smoke.py does at
640x480 (the kernels build with -fmad=false, so where both evaluate the same
expression they round alike).
"""

import pytest
import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel, EngineConfig, SurfelConfig
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
from multimotionfusion_tpu_torch.io.readers import SyntheticLogReader
from multimotionfusion_tpu_torch.kernels import checks

pytestmark = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
CAM = CameraModel(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
FRAMES = 30


@pytest.fixture(scope="module")
def captured():
    cfg = EngineConfig(camera=CAM, enable_multi_model=False, odom_init="",
                       surfels=SurfelConfig(max_surfels=1 << 16))
    frames = list(SyntheticLogReader(CAM, num_frames=FRAMES + 1))
    K.reset_launches()
    eng = MultiMotionFusionTorch(cfg, device="cuda")
    for f in frames[:-1]:
        eng.process_frame(f)
    K.start_capture()
    eng.process_frame(frames[-1])
    out = K.stop_capture()
    torch.cuda.synchronize()
    for k in ("zbuffer", "fuse", "splat_resolve", "gn_reduce.L0", "gn_reduce.L1",
              "gn_reduce.L2"):
        assert K.LAUNCHES.get(k, 0) > 0, k
    return out


def test_zbuffer(captured):
    r = checks.check_zbuffer(checks.args("zbuffer", captured["zbuffer"]))
    assert r["ok"], r


def test_splat_resolve(captured):
    r = checks.check_splat(checks.args("splat_resolve", captured["splat_resolve"]))
    assert r["ok"], r


def test_fuse(captured):
    r = checks.check_fuse(checks.args("fuse", captured["fuse"]))
    assert r["ok"], r


@pytest.mark.parametrize("level", [0, 1, 2])
def test_gn_reduce(captured, level):
    key = f"gn_reduce.L{level}"
    r = checks.check_gn(checks.args(key, captured[key]), level)
    assert r["ok"], r
