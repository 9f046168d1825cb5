"""The port's composite multi-model odometry (K11 and K5's M-wide steps, plain
versions on the CPU) against the reference package's
``multi_incremental_transformation``, at 160x120.

Cases: the two-partition seed-free scenes of tests/test_multi_odometry.py,
and a four-owner scene where the prediction's owners differ from the frame
mask along a band at the top border (the erosion's wrap-around at work),
with per-model seeds of which one is invalid, and one inactive model.

- the owner pyramids and the owner-aware photometric validity are
  bit-equal: the eroded owner against the reference's erosion code
  (multi.py:212-223) applied here to the same image, the validity against
  ``rgb_static_valid_multi``;
- every model's final pose within 1e-5 m and 1e-4 rad of the reference's,
  ICP and RGB counts equal, and the iteration at which every loop exits
  equal. The reference runs its loops inside ``lax.while_loop`` and does not
  report where they stopped, so its function body runs unjitted here with a
  ``while_loop`` that counts its iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel, OdometryConfig
from multimotionfusion_tpu.io import synthetic
from multimotionfusion_tpu.odometry import multi as jmulti
from multimotionfusion_tpu.odometry.levels import build_frame_pyramids, build_level_data
from multimotionfusion_tpu.ops import image as jimg
from multimotionfusion_tpu.ops import maps as jmaps
from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
from multimotionfusion_tpu_torch.config import OdometryConfig as TOdometryConfig
from multimotionfusion_tpu_torch.odometry import multi as tmulti
from multimotionfusion_tpu_torch.odometry import rgbd as trgbd
from multimotionfusion_tpu_torch.odometry.levels import FrameLevel, _min_scale
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMK = dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
CAM, TCAM = CameraModel(**CAMK), TCameraModel(**CAMK)
CFG = dataclasses.replace(OdometryConfig(), mask_icp=False)
TCFG = dataclasses.replace(TOdometryConfig(), mask_icp=False)
H, W = CAM.height, CAM.width


def _halves():
    own = np.zeros((H, W), np.int32)
    own[:, W // 2:] = 1
    return own


def _four_owners():
    own = np.zeros((H, W), np.int32)
    own[:, 100:] = 1
    own[60:, :50] = 2
    own[0:20, 30:60] = 3
    pred = own.copy()
    pred[0:3, 100:] = 2  # a band along the top border: the erosion wraps to the bottom
    return own, pred


def _seeds():
    T = synthetic.pose((0.0, 0.004, 0.0), (0.006, 0.0, 0.0))
    eye = np.eye(4, dtype=np.float32)
    return np.stack([T, eye, T, eye]).astype(np.float32)


CASES = {
    "halves_a": dict(motion=((0.0, 0.004, 0.0), (0.006, 0.0, 0.0)), owners=_halves),
    "halves_b": dict(motion=((0.003, 0.0, 0.002), (0.0, -0.005, 0.002)), owners=_halves),
    "four_owners_seeded": dict(
        motion=((0.003, 0.0, 0.002), (0.0, -0.005, 0.002)), owners=_four_owners,
        T_init=_seeds(), seed_valid=np.array([True, False, True, True]),
        active=np.array([True, True, True, False])),
}


def _reference(levels, last, T_prev, M, pred_own, T_init=None, seed_valid=None, active=None):
    """The reference's function body, unjitted, with a counting while_loop:
    (result, [so3, L2, L1, L0] iterations)."""
    calls = []

    def counting(cond, body, carry):
        n = 0
        while bool(cond(carry)):
            carry = body(carry)
            n += 1
        calls.append(n)
        return carry

    orig = jax.lax.while_loop
    jax.lax.while_loop = counting
    try:
        res = jmulti.multi_incremental_transformation.__wrapped__(
            jnp.asarray(T_prev), levels, last, CFG, CAM, M,
            T_init=None if T_init is None else jnp.asarray(T_init),
            seed_valid=None if seed_valid is None else jnp.asarray(seed_valid),
            active=None if active is None else jnp.asarray(active),
            pred_own=jnp.asarray(pred_own))
    finally:
        jax.lax.while_loop = orig
    return res, calls


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    c = CASES[request.param]
    owners = c["owners"]()
    own, pred_own = owners if isinstance(owners, tuple) else (owners, owners)
    M = int(own.max()) + 1
    depth_a, rgb_a = synthetic.render(np.eye(4, dtype=np.float32), CAM)
    depth_b, rgb_b = synthetic.render(synthetic.pose(*c["motion"]), CAM)
    frame = build_frame_pyramids(jnp.asarray(depth_b), jnp.asarray(rgb_b), jnp.asarray(own), CFG)
    pv = jmaps.create_vmap(jnp.asarray(depth_a), CAM, 5.0)
    pint = jimg.rgb_to_intensity(jnp.asarray(rgb_a))
    levels = build_level_data(frame, pv, jmaps.create_nmap(pv), pint, CAM, CFG)
    last = jimg.build_pyramid(pint, CFG.num_pyr)[-1]
    T_prev = np.broadcast_to(np.eye(4, dtype=np.float32), (M, 4, 4)).copy()
    ref, calls = _reference(levels, last, T_prev, M, pred_own, c.get("T_init"),
                            c.get("seed_valid"), c.get("active"))

    mls = []
    for i, L in enumerate(levels):
        tl = trgbd.LevelData(*(torch.from_numpy(np.array(x)) for x in L))
        g = trgbd.gn_level(tl, i, TCFG, TCAM)
        fl = FrameLevel(tl.depth_next, tl.img_next, tl.didx, tl.didy, tl.vmap_curr, tl.nmap_curr,
                        g.static_valid)
        o, b, sv = tmulti.owner_level_plain(i, torch.from_numpy(own), torch.from_numpy(pred_own),
                                            fl, M, _min_scale(TCFG, i))
        mls.append(tmulti.MultiLevel(g._replace(static_valid=sv), o, b))
    opt = lambda k: None if c.get(k) is None else torch.from_numpy(c[k])  # noqa: E731
    port = tmulti.multi_track(torch.from_numpy(T_prev), mls, torch.from_numpy(np.array(last)),
                              TCFG, TCAM, M, opt("T_init"), opt("seed_valid"), opt("active"))
    return dict(levels=levels, own=own, pred_own=pred_own, M=M, ref=ref, calls=calls,
                port=port, mls=mls)


def test_owner_maps_bit_equal(case):
    M, levels, mls = case["M"], case["levels"], case["mls"]
    # the reference's erosion (odometry/multi.py:197-223) on the same image
    own0 = jnp.asarray(case["pred_own"])
    mx = mn = own0
    for _ in range(2):
        mx2, mn2 = mx, mn
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            mx2 = jnp.maximum(mx2, jnp.roll(mx, (dy, dx), axis=(0, 1)))
            mn2 = jnp.minimum(mn2, jnp.roll(mn, (dy, dx), axis=(0, 1)))
        mx, mn = mx2, mn2
    eroded = jnp.where((own0 == 0) & (mx != mn), jnp.int32(M), own0)
    ref_pyr = jimg.build_pyramid_nearest(eroded, CFG.num_pyr)
    for i, ml in enumerate(mls):
        np.testing.assert_array_equal(ml.bank_own.numpy(), np.asarray(ref_pyr[i]))
        np.testing.assert_array_equal(ml.own.numpy(), np.asarray(levels[i].mask_next))
        min_scale = (CFG.min_grad_magnitudes[i] ** 2) / (CFG.sobel_scale**2)
        sv = jmulti.rgb_static_valid_multi(levels[i], min_scale, M)
        np.testing.assert_array_equal(ml.gl.static_valid.numpy(), np.asarray(sv))
        assert int(sv.sum()) > 0
    if M > 2:  # the band at the top border wraps to the bottom rows
        assert (mls[0].bank_own.numpy()[-2:] == M).any()


def test_multi_track_matches_reference(case):
    ref, port, M = case["ref"], case["port"], case["M"]
    for m in range(M):
        Tr, Tp = np.asarray(ref.poses[m], np.float64), port.poses[m].numpy().astype(np.float64)
        assert np.linalg.norm(Tr[:3, 3] - Tp[:3, 3]) < 1e-5, (m, Tr, Tp)
        dR = np.linalg.norm(Tr[:3, :3] - Tp[:3, :3]) / (2.0 * np.sqrt(2.0))
        assert 2.0 * np.arcsin(min(dR, 1.0)) < 1e-4, m
    np.testing.assert_array_equal(port.icp_count.numpy(), np.asarray(ref.icp_count))
    np.testing.assert_array_equal(port.rgb_count.numpy(), np.asarray(ref.rgb_count))
    assert float(port.icp_count[0]) > 1000
    it = tmulti.loop_iterations(port)
    so3, l2, l1, l0 = case["calls"]
    assert (it["so3"], it["L2"], it["L1"], it["L0"]) == (so3, l2, l1, l0), (it, case["calls"])
