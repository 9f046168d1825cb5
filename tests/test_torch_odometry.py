"""Parity of the port's odometry with the reference package, on the CPU.

- One evaluation of both 7x7 normal systems (the reference's ``eval_systems``
  body, composed here from its public pieces) against the port's K4 plain
  version on the same frozen LevelData, at every pyramid level: systems
  within 1e-4 relative (Frobenius; the row sums run in another order),
  counts within 0.01%.
- The whole ``get_incremental_transformation`` on the motions of
  tests/test_odometry.py, each side building its own level data from the same
  rendered frames: pose within 5e-4 m and 1e-3 rad of the reference's.
"""

import functools

import jax
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
from multimotionfusion_tpu.utils import se3 as jse3
from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
from multimotionfusion_tpu_torch.config import OdometryConfig as TOdometryConfig
from multimotionfusion_tpu_torch.odometry import levels as tlv
from multimotionfusion_tpu_torch.odometry import rgbd as trgbd
from multimotionfusion_tpu_torch.ops import image as timg
from multimotionfusion_tpu_torch.ops import maps as tmaps
from multimotionfusion_tpu_torch.utils import se3 as tse3
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMK = dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
CAM, TCAM = CameraModel(**CAMK), TCameraModel(**CAMK)
CFGK = dict(mask_icp=False, mask_rgb=False)
CFG, TCFG = OdometryConfig(**CFGK), TOdometryConfig(**CFGK)
MOTIONS = [
    ((0.0, 0.0, 0.0), (0.01, 0.0, 0.0)),
    ((0.0, 0.02, 0.0), (0.0, 0.0, 0.01)),
    ((0.01, -0.015, 0.02), (0.008, -0.005, 0.012)),
]


def _render(rotvec, trans):
    depth_a, rgb_a = synthetic.render(np.eye(4, dtype=np.float32), CAM)
    depth_b, rgb_b = synthetic.render(synthetic.pose(rotvec, trans), CAM)
    return depth_a, rgb_a, depth_b, rgb_b


def _jax_levels(depth_a, rgb_a, depth_b, rgb_b):
    mask = jnp.zeros((CAM.height, CAM.width), jnp.int32)
    frame = jlv.build_frame_pyramids(jnp.asarray(depth_b), jnp.asarray(rgb_b), mask, CFG)
    pv = jmaps.create_vmap(jnp.asarray(depth_a), CAM, 5.0)
    pint = jimg.rgb_to_intensity(jnp.asarray(rgb_a))
    levels = jlv.build_level_data(frame, pv, jmaps.create_nmap(pv), pint, CAM, CFG)
    return levels, jimg.build_pyramid(pint, CFG.num_pyr)[-1]


def _torch_levels(depth_a, rgb_a, depth_b, rgb_b):
    mask = torch.zeros((CAM.height, CAM.width), dtype=torch.int32)
    frame = tlv.build_frame_pyramids(torch.from_numpy(depth_b), torch.from_numpy(rgb_b), mask, TCFG)
    pv = tmaps.create_vmap(torch.from_numpy(depth_a), TCAM, 5.0)
    pint = timg.rgb_to_intensity(torch.from_numpy(rgb_a))
    levels = tlv.build_level_data(frame, pv, tmaps.create_nmap(pv), pint, TCAM, TCFG)
    return levels, timg.build_pyramid(pint, TCFG.num_pyr)[-1]


def _jax_systems(level, i, result_Rt):
    """The reference's eval_systems body (rgbd.py:817-867) at level i."""
    cam_l = CAM.level(i)
    min_scale = CFG.min_grad_magnitudes[i] ** 2 / CFG.sobel_scale**2
    if i == 0:
        bank = jrgbd.build_compact_bank(level.vmap_prev[..., 2], level.nmap_prev, level.img_last)
        sampler = functools.partial(jrgbd.sample_compact, bank, cam=cam_l, use_icp=True,
                                    use_rgb=True, max_depth_rgb=CFG.max_depth_rgb)
    else:
        bank = jrgbd.build_generic_bank(level.vmap_prev, level.nmap_prev, level.depth_last,
                                        level.img_last)
        sampler = functools.partial(jrgbd.sample_generic, bank, use_icp=True, use_rgb=True)
    sv = jrgbd.rgb_static_valid(level, min_scale, 0, CFG.mask_rgb)
    s = CFG.fine_subsample if i == 0 else 1
    vm, nm = level.vmap_curr[::s, ::s], level.nmap_curr[::s, ::s]
    img, dx, dy, svs = (a[::s, ::s] for a in (level.img_next, level.didx, level.didy, sv))
    scale2 = jnp.float32(s * s)
    Rt_inv = jse3.inverse_T(jnp.asarray(result_Rt))
    Ri, ti = Rt_inv[:3, :3], Rt_inv[:3, 3]
    vcp = jnp.einsum("ij,hwj->hwi", Ri, vm, precision=jax.lax.Precision.HIGHEST) + ti
    z = vcp[..., 2]
    safe_z = jnp.where(z != 0, z, 1.0)
    uf = vcp[..., 0] * cam_l.fx / safe_z + cam_l.cx
    vf = vcp[..., 1] * cam_l.fy / safe_z + cam_l.cy
    ps = sampler(uf, vf)
    valid, cp, diff, sigma, cnt, _ = jrgbd.rgb_correspondences(
        ps, uf, vf, z, img, svs, CFG.max_depth_delta_rgb, cam_l)
    rgb_size = cnt.astype(jnp.float32) * scale2
    tmp_err = jnp.sqrt(sigma * scale2) / jnp.maximum(rgb_size, 1.0)
    sigma_val = jnp.where(tmp_err == 0, 1.0, rgb_size)
    S_rgb = scale2 * jrgbd.rgb_system(valid, cp, diff, sigma_val, dx, dy, cam_l, CFG.sobel_scale)
    S_icp, icnt, _ = jrgbd.icp_system(ps, vcp, nm, Ri, vm[..., 2] > 0, CFG.dist_thresh,
                                      CFG.angle_thresh)
    return (np.asarray(scale2 * S_icp), float(icnt) * float(scale2), np.asarray(S_rgb),
            float(rgb_size))


def _torch_systems(level, i, result_Rt):
    cam_l = TCAM.level(i)
    min_scale = TCFG.min_grad_magnitudes[i] ** 2 / TCFG.sobel_scale**2
    s = TCFG.fine_subsample if i == 0 else 1
    lv = trgbd.GNLevel(
        pred=trgbd.build_pred_map(level, i == 0), compact=i == 0, vmap=level.vmap_curr,
        nmap=level.nmap_curr, img=level.img_next, didx=level.didx, didy=level.didy,
        static_valid=trgbd.rgb_static_valid(level, min_scale, 0, TCFG.mask_rgb), stride=s,
    )
    p = trgbd.GNParams(True, True, False, TCFG.dist_thresh, TCFG.angle_thresh,
                       TCFG.max_depth_delta_rgb, TCFG.max_depth_rgb, TCFG.sobel_scale)
    sums = trgbd.gn_reduce(lv, tse3.inverse_T(torch.from_numpy(result_Rt)), cam_l,
                           float(s * s), p, level=i)
    S_icp, icnt, S_rgb, rgb_size, _ = trgbd.systems_from_sums(sums, float(s * s))
    return S_icp.numpy(), float(icnt), S_rgb.numpy(), float(rgb_size)


def _to_torch(level):
    return trgbd.LevelData(*(torch.from_numpy(np.array(a)) for a in level))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_eval_systems_matches_reference(i):
    frames = _render(*MOTIONS[2])
    levels, _ = _jax_levels(*frames)
    result_Rt = synthetic.pose((0.004, -0.006, 0.008), (0.003, -0.002, 0.004))
    Sj_i, cj_i, Sj_r, cj_r = _jax_systems(levels[i], i, result_Rt)
    St_i, ct_i, St_r, ct_r = _torch_systems(_to_torch(levels[i]), i, result_Rt)
    assert cj_i > 500 and cj_r > 500
    for St, Sj in ((St_i, Sj_i), (St_r, Sj_r)):
        assert np.linalg.norm(St - Sj) <= 1e-4 * np.linalg.norm(Sj)
    for ct, cj in ((ct_i, cj_i), (ct_r, cj_r)):
        assert abs(ct - cj) <= 1e-4 * cj


@pytest.mark.parametrize("rotvec,trans", MOTIONS)
def test_incremental_transformation_matches_reference(rotvec, trans):
    frames = _render(rotvec, trans)
    levels_j, last_j = _jax_levels(*frames)
    res_j = jrgbd.get_incremental_transformation(jnp.eye(4), levels_j, last_j, CFG, CAM)
    levels_t, last_t = _torch_levels(*frames)
    res_t = trgbd.get_incremental_transformation(torch.eye(4), levels_t, last_t, TCFG, TCAM)
    Pj, Pt = np.asarray(res_j.pose, np.float64), res_t.pose.numpy().astype(np.float64)
    delta = np.linalg.inv(Pj) @ Pt
    rot = np.arccos(np.clip((np.trace(delta[:3, :3]) - 1) / 2, -1, 1))
    assert np.linalg.norm(delta[:3, 3]) < 5e-4
    assert rot < 1e-3
    assert abs(float(res_t.icp_count) - float(res_j.icp_count)) <= 0.01 * float(res_j.icp_count)
