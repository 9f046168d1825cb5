"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Skipped where PyTorch sees no GPU (decided in the fixture). Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

A 30-frame 160x120 run of the port's engine on the card records the inputs
each kernel saw at its last frame (the first frame's compaction and a
compaction frame's clean from frames of their own); every test replays them
through the kernel and the plain version and holds them to the tolerances
of ``multimotionfusion_tpu_torch.kernels.checks``, as chip_smoke.py does at
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

CAM = CameraModel(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
FRAMES = 30
COMPACT_FRAME = 23  # runs at tick 24, a compaction frame (compact_every = 8)
LEVELS = (0, 1, 2)

CASES = (
    [("frame_maps.filter", checks.check_frame_depth),
     ("frame_maps.surfels", checks.check_frame_surfels)]
    + [(f"pyramid.frame.L{lvl}", lambda a, lvl=lvl: checks.check_pyramid_frame(a, lvl))
       for lvl in LEVELS]
    + [(f"pyramid.pred.L{lvl}", lambda a, lvl=lvl: checks.check_pyramid_pred(a, lvl))
       for lvl in LEVELS]
    + [("odo_init", checks.check_odo_init), ("so3_reduce", checks.check_so3_reduce),
       ("so3_step", checks.check_so3_step), ("gn_step", checks.check_gn_step),
       ("track", checks.check_track), ("zbuffer", checks.check_zbuffer),
       ("fuse", checks.check_fuse), ("clean", checks.check_clean),
       ("clean.compact", checks.check_clean), ("compact", checks.check_compact),
       ("splat_resolve", checks.check_splat)]
    + [(f"gn_reduce.L{lvl}", lambda a, lvl=lvl: checks.check_gn(a, lvl)) for lvl in LEVELS]
)


def _capture_key(name: str) -> str:
    """Recorded inputs of a launch key (the pyramids record once per frame)."""
    return name.rsplit(".", 1)[0] if name.startswith("pyramid.") else name


@pytest.fixture(scope="module")
def captured():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the kernels have no CPU mode")
    cfg = EngineConfig(camera=CAM, enable_multi_model=False, odom_init="",
                       surfels=SurfelConfig(max_surfels=1 << 16))
    frames = list(SyntheticLogReader(CAM, num_frames=FRAMES + 1))
    K.reset_launches()
    eng = MultiMotionFusionTorch(cfg, device="cuda")
    K.start_capture()
    eng.process_frame(frames[0])
    out = {"compact": K.stop_capture()["compact"]}
    for i in range(1, FRAMES + 1):
        if i in (COMPACT_FRAME, FRAMES):
            K.start_capture()
        eng.process_frame(frames[i])
        if i == COMPACT_FRAME:
            out["clean.compact"] = K.stop_capture()["clean.compact"]
        elif i == FRAMES:
            out.update(K.stop_capture())
    torch.cuda.synchronize()
    for name, _ in CASES:
        if name != "track":
            assert K.LAUNCHES.get(name, 0) > 0, name
    return out


@pytest.mark.parametrize("name,check", CASES, ids=[n for n, _ in CASES])
def test_kernel_matches_plain(captured, name, check):
    key = _capture_key(name)
    r = check(checks.args(key, captured[key]))
    assert r["ok"], r
