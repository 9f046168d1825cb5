"""The port's odometry loops (K3 + K5 plain versions, on the CPU) against the
reference package.

- ``so3_system`` (the 4x4 rotation-only photometric system) through the
  port's ``so3_reduce``: within 1e-4 relative (Frobenius; the row sums run in
  another order), count exact;
- ``solve_preconditioned`` and ``clamp_step``: within 1e-5 (both are
  Jacobi-scaled eigen-truncated float32 solves; eigh differs between LAPACK
  builds at ~1e-7 relative);
- the device-style loop (``rgbd.track``: the fixed iteration budget enqueued,
  done flags in the loop state) against the reference's
  ``get_incremental_transformation`` on the motions of tests/test_odometry.py
  and on cases where each exit fires: pose within 1e-5 m and 1e-4 rad, and
  the iteration at which every loop exits equal. The reference runs its
  loops inside ``lax.while_loop`` and does not report where they stopped, so
  ``_reference_loop`` replays the same loop bodies eagerly from the package's
  own functions (its pose is held to the jitted function's within 1e-5) and
  counts the iterations;
- the seeded solve (a pose seed ``T_init`` with its validity, the keypoint
  initialisation) against ``get_incremental_transformation(seeded=True)``
  with the true pose as the seed, the seed 5 cm off (the seed arbitration
  must fall back to the SO(3) pose) and an invalid seed: the same bounds and
  exit iterations, and the start the arbitration kept.
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
from multimotionfusion_tpu_torch.odometry import rgbd as trgbd

CAMK = dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
CAM, TCAM = CameraModel(**CAMK), TCameraModel(**CAMK)
CFGK = dict(mask_icp=False, mask_rgb=False)
CFG, TCFG = OdometryConfig(**CFGK), TOdometryConfig(**CFGK)
MOTIONS = [  # tests/test_odometry.py
    ((0.0, 0.0, 0.0), (0.01, 0.0, 0.0)),
    ((0.0, 0.02, 0.0), (0.0, 0.0, 0.01)),
    ((0.01, -0.015, 0.02), (0.008, -0.005, 0.012)),
]


def _levels(T_b, T_a=None, empty_prediction=False):
    """Reference LevelData of frame B against the prediction rendered at A,
    and the prediction's coarsest intensity (the SO(3) "last" image)."""
    T_a = np.eye(4, dtype=np.float32) if T_a is None else T_a
    depth_a, rgb_a = synthetic.render(T_a, CAM)
    depth_b, rgb_b = synthetic.render(T_b, CAM)
    if empty_prediction:
        depth_a, rgb_a = np.zeros_like(depth_a), np.zeros_like(rgb_a)
    mask = jnp.zeros((CAM.height, CAM.width), jnp.int32)
    frame = jlv.build_frame_pyramids(jnp.asarray(depth_b), jnp.asarray(rgb_b), mask, CFG)
    pv = jmaps.create_vmap(jnp.asarray(depth_a), CAM, 5.0)
    pint = jimg.rgb_to_intensity(jnp.asarray(rgb_a))
    levels = jlv.build_level_data(frame, pv, jmaps.create_nmap(pv), pint, CAM, CFG)
    return levels, jimg.build_pyramid(pint, CFG.num_pyr)[-1]


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference_loop(levels, last_l2, T_init=None, seed_valid=True):
    """The reference's SO(3) and GN loop bodies (rgbd.py:735-774, :988-1051),
    run eagerly: (pose, {"so3": n, "L0": n, "L1": n, "L2": n}, {loop: exit}).
    With ``T_init`` (T_prev = I), the seeded solve: the GN loop starts from
    the seed where ``seed_valid`` and the SO(3) pose otherwise, and the seed
    arbitration (rgbd.py:962-983) keeps it only when its coarse error is no
    worse than the SO(3) pose's (``exits["seed"]`` says which one ran)."""
    f32 = jnp.float32
    lvl = CFG.num_pyr - 1
    cam_l = CAM.level(lvl)
    K, Kinv = jrgbd._K(cam_l), jrgbd._K_inv(cam_l)
    ngx, ngy = jrgbd.central_grads(levels[lvl].img_next)
    bank = jrgbd.pack_bilinear_bank([levels[lvl].img_next, ngx, ngy])
    grads = jrgbd.central_grads(last_l2)
    R, last_R = jnp.eye(3, dtype=f32), jnp.eye(3, dtype=f32)
    last_err = last_count = jnp.array(3.4e38 / 2, f32)
    iters, exits = {}, {"so3": "cap"}
    for j in range(CFG.so3_iterations):
        S, cnt = jrgbd.so3_system(last_l2, bank, grads, K @ R @ Kinv, Kinv, K @ R)
        cntf = cnt.astype(f32)
        err = jnp.sqrt(S[3, 3]) / jnp.maximum(cntf, 1.0)
        converged = bool((err < last_err) & (jnp.abs(last_count - cntf) < 0.5))
        diverging = bool(err > last_err + 0.001)
        delta = jrgbd.solve_preconditioned(S[:3, :3], S[:3, 3])
        delta = delta * jnp.minimum(1.0, 0.1 / jnp.maximum(jnp.linalg.norm(delta), 1e-12))
        delta = jnp.where(cnt >= 60, delta, jnp.zeros_like(delta))
        R_new = jse3.so3_exp(delta) @ R
        R_out = R if converged else (last_R if diverging else R_new)
        last_err, last_count, last_R, R = err, cntf, R, R_out
        iters["so3"] = j + 1
        if converged or diverging:
            exits["so3"] = "converged" if converged else "diverging"
            break
    so3_Rt = jnp.eye(4, dtype=f32).at[:3, :3].set(R)
    result_Rt = so3_Rt
    if T_init is not None:
        result_Rt = jse3.inverse_T(jnp.asarray(T_init, f32)) if seed_valid else so3_Rt
    for i in range(CFG.num_pyr - 1, -1, -1):
        level, cam_l = levels[i], CAM.level(i)
        if i == 0:
            bank = jrgbd.build_compact_bank(level.vmap_prev[..., 2], level.nmap_prev,
                                            level.img_last)
            sampler = functools.partial(jrgbd.sample_compact, bank, cam=cam_l, use_icp=True,
                                        use_rgb=True, max_depth_rgb=CFG.max_depth_rgb)
        else:
            bank = jrgbd.build_generic_bank(level.vmap_prev, level.nmap_prev, level.depth_last,
                                            level.img_last)
            sampler = functools.partial(jrgbd.sample_generic, bank, use_icp=True, use_rgb=True)
        min_scale = CFG.min_grad_magnitudes[i] ** 2 / CFG.sobel_scale**2
        sv = jrgbd.rgb_static_valid(level, min_scale, 0, CFG.mask_rgb)
        s = CFG.fine_subsample if i == 0 else 1
        vm, nm = level.vmap_curr[::s, ::s], level.nmap_curr[::s, ::s]
        img, dx, dy, svs = (a[::s, ::s] for a in (level.img_next, level.didx, level.didy, sv))
        scale2 = jnp.float32(s * s)

        def evaluate(Rt, cam_l=cam_l, sampler=sampler, vm=vm, nm=nm, img=img, dx=dx, dy=dy,
                     svs=svs, scale2=scale2):
            Rt_inv = jse3.inverse_T(Rt)
            Ri, ti = Rt_inv[:3, :3], Rt_inv[:3, 3]
            vcp = jnp.einsum("ij,hwj->hwi", Ri, vm, precision=jax.lax.Precision.HIGHEST) + ti
            z = vcp[..., 2]
            safe_z = jnp.where(z != 0, z, 1.0)
            uf = vcp[..., 0] * cam_l.fx / safe_z + cam_l.cx
            vf = vcp[..., 1] * cam_l.fy / safe_z + cam_l.cy
            ps = sampler(uf, vf)
            valid, cp, diff, sigma, cnt, _ = jrgbd.rgb_correspondences(
                ps, uf, vf, z, img, svs, CFG.max_depth_delta_rgb, cam_l)
            rgb_size = cnt.astype(f32) * scale2
            tmp_err = jnp.sqrt(sigma * scale2) / jnp.maximum(rgb_size, 1.0)
            sigma_val = jnp.where(tmp_err == 0, 1.0, rgb_size)
            S_rgb = scale2 * jrgbd.rgb_system(valid, cp, diff, sigma_val, dx, dy, cam_l,
                                              CFG.sobel_scale)
            S_icp, icnt, _ = jrgbd.icp_system(ps, vcp, nm, Ri, vm[..., 2] > 0, CFG.dist_thresh,
                                              CFG.angle_thresh)
            return scale2 * S_icp, icnt.astype(f32) * scale2, S_rgb, rgb_size

        if i == lvl and T_init is not None:
            def arb_err(Rt):
                S_i, cnt_i, _, _ = evaluate(Rt)
                e = jnp.sqrt(S_i[6, 6]) / jnp.maximum(cnt_i, 1.0)
                return float(jnp.where(cnt_i >= 60, e, jnp.inf))

            keep = arb_err(result_Rt) <= arb_err(so3_Rt)
            exits["seed"] = "seed" if keep and seed_valid else "so3"
            result_Rt = result_Rt if keep else so3_Rt
        for j in range(CFG.iterations[i]):
            S_icp, icp_cnt, S_rgb, rgb_size = evaluate(result_Rt)
            w = CFG.icp_weight
            A = S_rgb[:6, :6] + w * w * S_icp[:6, :6]
            b = S_rgb[:6, 6] + w * w * S_icp[:6, 6]
            x = jrgbd.clamp_step(jrgbd.solve_preconditioned(A, b))
            enough = bool(icp_cnt + rgb_size >= 60)
            if enough:
                result_Rt = jse3.gn_update_pose(result_Rt, x)
            eps = CFG.convergence_eps
            converged = enough and bool(jnp.linalg.norm(x[0:3]) < eps) and bool(
                jnp.linalg.norm(x[3:6]) < eps)
            iters[f"L{i}"] = j + 1
            exits[f"L{i}"] = "not enough" if not enough else "converged" if converged else "cap"
            if not enough or converged:
                break
    return np.asarray(jse3.inverse_T(result_Rt), np.float64), iters, exits


def _compare(T_b, T_a=None, empty_prediction=False, flip_last=False):
    levels, last = _levels(T_b, T_a, empty_prediction)
    if flip_last:  # a previous frame that does not match: upside down
        last = jnp.asarray(np.asarray(last)[::-1].copy())
    res_j = jrgbd.get_incremental_transformation(jnp.eye(4), levels, last, CFG, CAM)
    pose_j = np.asarray(res_j.pose, np.float64)
    pose_e, iters_e, exits = _reference_loop(levels, last)
    np.testing.assert_allclose(pose_e, pose_j, rtol=0, atol=1e-5)
    levels_t = [trgbd.LevelData(*(_t(a) for a in lv)) for lv in levels]
    res_t = trgbd.get_incremental_transformation(torch.eye(4), levels_t, _t(last), TCFG, TCAM)
    pose_t = res_t.pose.numpy().astype(np.float64)
    delta = np.linalg.inv(pose_j) @ pose_t
    rot = np.linalg.norm(delta[:3, :3] - np.eye(3)) / np.sqrt(2.0)  # = angle, small angles
    assert np.linalg.norm(delta[:3, 3]) <= 1e-5, (pose_t, pose_j)
    assert rot <= 1e-4
    iters_t = trgbd.loop_iterations(res_t)
    assert iters_t == {k: iters_e.get(k, 0) for k in iters_t}, (iters_t, iters_e)
    return iters_e, exits, res_j, res_t


@pytest.mark.parametrize("rotvec,trans", MOTIONS)
def test_loop_matches_reference_on_odometry_motions(rotvec, trans):
    iters, _, res_j, res_t = _compare(synthetic.pose(rotvec, trans))
    assert sum(iters[f"L{i}"] for i in range(3)) < sum(CFG.iterations)  # converged early
    assert abs(float(res_t.icp_count) - float(res_j.icp_count)) <= 1e-3 * float(res_j.icp_count)


@pytest.mark.parametrize("case", ["so3_converges", "so3_diverges", "gn_not_enough",
                                  "gn_converges"])
def test_loop_exits_match_reference(case):
    if case == "so3_diverges":
        # the previous frame's image upside down: the photometric error rises
        _, exits, _, _ = _compare(synthetic.pose((0.0, 0.02, 0.0), (0.01, 0.0, 0.0)),
                                  flip_last=True)
        assert exits["so3"] == "diverging", exits
    elif case == "gn_not_enough":  # an empty prediction: no correspondences
        iters, exits, _, _ = _compare(synthetic.pose((0.0, 0.0, 0.0), (0.01, 0.0, 0.0)),
                                      empty_prediction=True)
        assert iters["L2"] == iters["L1"] == iters["L0"] == 1
        assert all(exits[f"L{i}"] == "not enough" for i in range(3)), exits
    else:
        _, exits, _, _ = _compare(synthetic.pose(*MOTIONS[0]))
        if case == "so3_converges":
            assert exits["so3"] == "converged", exits
        else:
            assert "converged" in (exits["L0"], exits["L1"], exits["L2"]), exits


@pytest.mark.parametrize("rot", [(0.0, 0.0, 0.0), (0.01, -0.02, 0.015)])
def test_so3_system_matches_reference(rot):
    levels, last = _levels(synthetic.pose((0.0, 0.02, 0.0), (0.0, 0.0, 0.01)))
    cam_l = CAM.level(2)
    R = np.asarray(synthetic.pose(rot, (0.0, 0.0, 0.0)))[:3, :3].astype(np.float32)
    img = levels[2].img_next
    ngx, ngy = jrgbd.central_grads(img)
    bank = jrgbd.pack_bilinear_bank([img, ngx, ngy])
    K, Kinv = jrgbd._K(cam_l), jrgbd._K_inv(cam_l)
    Sj, cj = jrgbd.so3_system(last, bank, jrgbd.central_grads(last), K @ R @ Kinv, Kinv, K @ R)
    state = trgbd.odo_init("cpu")
    state[trgbd.S_R:trgbd.S_R + 9] = torch.from_numpy(R.reshape(-1))
    sums = trgbd.so3_reduce(_t(last), _t(img), TCAM.level(2), state)
    St = trgbd._sym(sums[:10], 4).numpy()
    Sj = np.asarray(Sj)
    assert int(cj) > 500 and float(sums[10]) == int(cj)
    assert np.linalg.norm(St - Sj) <= 1e-4 * np.linalg.norm(Sj)


@pytest.mark.parametrize("spectrum", [
    (1.0, 0.5, 0.2, 0.1, 0.05, 0.01),
    (1.0, 0.5, 0.3, 0.1, 1e-8, 1e-9),  # two near-null directions: truncated
    (1.0, 0.3, 0.1),
    (1.0, 0.3, 1e-9),
])
def test_solve_and_clamp_match_reference(spectrum):
    """Well-conditioned and near-degenerate systems (the truncation fires on
    the second of each size), scaled so the clamp fires on some steps."""
    n = len(spectrum)
    rng = np.random.default_rng(len(spectrum) + int(spectrum[-1] < 1e-6))
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    D = np.diag(rng.uniform(0.1, 100.0, n))
    A = (D @ Q @ np.diag(spectrum) @ Q.T @ D).astype(np.float32)
    A = (A + A.T) / 2
    for scale in (1e-3, 1.0):
        b = (scale * rng.normal(size=n)).astype(np.float32)
        xj = np.asarray(jrgbd.solve_preconditioned(jnp.asarray(A), jnp.asarray(b)))
        xt = trgbd.solve_preconditioned(_t(A), _t(b)).numpy()
        np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-5 * np.abs(xj).max())
        if n == 6:
            cj = np.asarray(jrgbd.clamp_step(jnp.asarray(xj)))
            ct = trgbd.clamp_step(_t(xj)).numpy()
            np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", ["true_pose", "off_5cm", "invalid"])
def test_seeded_track_matches_reference(seed):
    T_b = np.asarray(synthetic.pose((0.0, 0.02, 0.0), (0.01, 0.0, 0.0)), np.float32)
    T_init = T_b.copy()
    if seed == "off_5cm":
        T_init[0, 3] += 0.05
    valid = seed != "invalid"
    levels, last = _levels(T_b)
    res_j = jrgbd.get_incremental_transformation(
        jnp.eye(4), levels, last, CFG, CAM, 0, T_init=jnp.asarray(T_init), seeded=True,
        seed_valid=jnp.asarray(valid))
    pose_j = np.asarray(res_j.pose, np.float64)
    pose_e, iters_e, exits = _reference_loop(levels, last, T_init=T_init, seed_valid=valid)
    np.testing.assert_allclose(pose_e, pose_j, rtol=0, atol=1e-5)
    assert exits["seed"] == ("seed" if seed == "true_pose" else "so3"), exits
    levels_t = [trgbd.LevelData(*(_t(a) for a in lv)) for lv in levels]
    res_t = trgbd.get_incremental_transformation(torch.eye(4), levels_t, _t(last), TCFG, TCAM,
                                                 T_init=_t(T_init), seed_valid=torch.tensor(valid))
    pose_t = res_t.pose.numpy().astype(np.float64)
    delta = np.linalg.inv(pose_j) @ pose_t
    assert np.linalg.norm(delta[:3, 3]) <= 1e-5, (pose_t, pose_j)
    assert np.linalg.norm(delta[:3, :3] - np.eye(3)) / np.sqrt(2.0) <= 1e-4
    iters_t = trgbd.loop_iterations(res_t)
    assert iters_t == {k: iters_e.get(k, 0) for k in iters_t}, (iters_t, iters_e)
    assert np.linalg.norm(pose_t[:3, 3] - T_b[:3, 3]) < 2e-3
