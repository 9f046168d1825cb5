"""The odometry's error images (K4's error-image mode, plain version on the
CPU) against the reference package, at 80x60.

- Given the reference's levels and its final pose, the port's
  ``error_images`` equal the reference's ``icp_error_image`` and
  ``rgb_error_image`` (``get_incremental_transformation`` with
  ``error_images=True``) within 1e-5 absolute, with equal zero sets.
- Over the whole ``track`` call (the port's own loop, whose pose differs from
  the reference's by rounding): within 1e-3 where both images are non-zero,
  and zero sets differing on at most 0.5 % of the pixels.
- The static engine steps with ``error_images=True``, and its poses are those
  of the engine without them (the images are an output only).
- The composite multi-model engine steps with ``error_images=True`` and
  ignores the flag, as the reference's composite odometry does (it never
  reads it): its poses and masks equal those of a run without it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel, OdometryConfig
from multimotionfusion_tpu.io import synthetic
from multimotionfusion_tpu.odometry import levels as jlv
from multimotionfusion_tpu.odometry import rgbd as jrgbd
from multimotionfusion_tpu.ops import image as jimg
from multimotionfusion_tpu.ops import maps as jmaps
from multimotionfusion_tpu_torch import config as T
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
from multimotionfusion_tpu_torch.io.readers import SyntheticLogReader
from multimotionfusion_tpu_torch.odometry import rgbd as trgbd
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMK = dict(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
CAM, TCAM = CameraModel(**CAMK), T.CameraModel(**CAMK)
CFGK = dict(mask_icp=False, mask_rgb=False, error_images=True)
CFG, TCFG = OdometryConfig(**CFGK), T.OdometryConfig(**CFGK)
MOTIONS = [  # tests/test_odometry.py
    ((0.0, 0.0, 0.0), (0.01, 0.0, 0.0)),
    ((0.01, -0.015, 0.02), (0.008, -0.005, 0.012)),
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference(motion):
    """The reference's levels (frame at ``motion`` against the prediction at
    the identity), its odometry result with error images, and the port's levels."""
    depth_a, rgb_a = synthetic.render(np.eye(4, dtype=np.float32), CAM)
    depth_b, rgb_b = synthetic.render(synthetic.pose(*motion), CAM)
    mask = jnp.zeros((CAM.height, CAM.width), jnp.int32)
    frame = jlv.build_frame_pyramids(jnp.asarray(depth_b), jnp.asarray(rgb_b), mask, CFG)
    pv = jmaps.create_vmap(jnp.asarray(depth_a), CAM, 5.0)
    pint = jimg.rgb_to_intensity(jnp.asarray(rgb_a))
    levels = jlv.build_level_data(frame, pv, jmaps.create_nmap(pv), pint, CAM, CFG)
    last = jimg.build_pyramid(pint, CFG.num_pyr)[-1]
    res = jrgbd.get_incremental_transformation(jnp.eye(4), levels, last, CFG, CAM)
    levels_t = [trgbd.LevelData(*(_t(a) for a in lv)) for lv in levels]
    return res, levels_t, last


def _params():
    return trgbd.GNParams(True, True, False, TCFG.dist_thresh, TCFG.angle_thresh,
                          TCFG.max_depth_delta_rgb, TCFG.max_depth_rgb, TCFG.sobel_scale)


@pytest.mark.parametrize("motion", MOTIONS)
def test_error_images_at_the_reference_pose(motion):
    res, levels_t, _ = _reference(motion)
    gl0 = trgbd.gn_level(levels_t[0], 0, TCFG, TCAM)._replace(stride=1)
    # T_prev = I, so the final increment inv(result_Rt) is the pose itself
    Rt_inv = _t(np.asarray(res.pose, np.float32))
    icp_t, rgb_t = trgbd.error_images(gl0, Rt_inv, TCAM.level(0), _params())
    for got, want in ((icp_t.numpy(), np.asarray(res.icp_error_image)),
                      (rgb_t.numpy(), np.asarray(res.rgb_error_image))):
        assert got.shape == want.shape == (CAM.height, CAM.width)
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert (want != 0).sum() > 1000


@pytest.mark.parametrize("motion", MOTIONS)
def test_track_error_images_match_reference(motion):
    res, levels_t, last = _reference(motion)
    out = trgbd.get_incremental_transformation(torch.eye(4), levels_t, _t(last), TCFG, TCAM)
    for got, want in ((out.icp_error_image.numpy(), np.asarray(res.icp_error_image)),
                      (out.rgb_error_image.numpy(), np.asarray(res.rgb_error_image))):
        both = (got != 0) & (want != 0)
        assert both.sum() > 1000
        np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-3)
        assert ((got == 0) != (want == 0)).mean() <= 0.005


def _static_cfg(error_images):
    return T.EngineConfig(camera=TCAM, odom_init="", enable_multi_model=False,
                          odometry=T.OdometryConfig(error_images=error_images),
                          surfels=T.SurfelConfig(max_surfels=16384, depth_cutoff=5.0))


def test_static_engine_steps_with_error_images():
    frames = list(SyntheticLogReader(TCAM, num_frames=3, cam_step=(0.004, 0, 0),
                                     cam_rot_step=(0, 0.002, 0)))
    poses = {}
    for flag in (False, True):
        eng = MultiMotionFusionTorch(_static_cfg(flag), device="cpu")
        for f in frames:
            eng.process_frame(f)
        eng.finish()
        poses[flag] = np.stack([p for _, p in eng.pose_log])
        odo = eng._last_stats.odo
        if flag:
            assert odo.icp_error_image.shape == (CAM.height, CAM.width)
            assert (odo.icp_error_image > 0).sum() > 1000
            assert (odo.rgb_error_image > 0).sum() > 100
        else:
            assert odo.icp_error_image is None
    np.testing.assert_array_equal(poses[True], poses[False])


def _multi_cfg(error_images):
    return T.EngineConfig(
        camera=TCAM, enable_multi_model=True, object_slots=2, object_capacity=2048, odom_init="",
        odometry=T.OdometryConfig(error_images=error_images),
        surfels=T.SurfelConfig(max_surfels=1 << 13, depth_cutoff=5.0),
        segmentation=T.SegmentationConfig(mode="precomputed", min_mask_size_px=40),
        model_spawn_offset=1, upload_yuv420=False, upload_depth_mm=False)


def test_composite_multi_engine_ignores_error_images():
    frames = list(SyntheticLogReader(TCAM, num_frames=3, cam_step=(0.004, 0, 0),
                                     cam_rot_step=(0, 0.002, 0)))
    out = {}
    for flag in (False, True):
        eng = MultiMotionFusionTorch(_multi_cfg(flag), device="cpu")
        assert eng.cfg.odometry.error_images == flag
        masks = []
        for f in frames:
            m = np.zeros((CAM.height, CAM.width), np.uint8)
            m[10:25, 10:30] = 7
            eng.process_frame(dataclasses.replace(f, mask=m))
            if eng.last_mask is not None:
                masks.append(eng.last_mask.numpy().copy())
        eng.finish()
        out[flag] = (np.stack([p for _, p in eng.pose_log]), np.stack(masks),
                     eng.state.objects.active.numpy().copy())
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)
    assert out[True][2].any()
