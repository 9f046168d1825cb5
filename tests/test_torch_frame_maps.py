"""The port's frame maps (K1), pyramids (K2), winner gather (K7), compaction
(K9) and fill-in (K10's epilogue), plain versions on the CPU, against the
reference package on the same numpy inputs.

Tolerances:
- ``compute_frame_surfels`` (fed the reference's filtered depth): valid mask
  exact, every channel within 1e-5 relative (|a - b| / max(|b|, 1));
- frame and prediction levels (``build_level_data``, ``rgb_static_valid``,
  the sampling maps): masks exact; the level-0 bf16 sampling map bit-equal to
  the reference's compact bank; f32 fields within 1e-5 relative: the
  Gaussian pyramid's sums may round one ulp apart between XLA:CPU and
  PyTorch;
- ``gather_attr_images`` and ``compact`` (order and count): exact, they only
  move values;
- ``fill_in``: within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel, OdometryConfig
from multimotionfusion_tpu.io import synthetic
from multimotionfusion_tpu.model import fillin as jfill
from multimotionfusion_tpu.model import surfel_map as jsm
from multimotionfusion_tpu.odometry import levels as jlv
from multimotionfusion_tpu.odometry import rgbd as jrgbd
from multimotionfusion_tpu.ops import image as jimg
from multimotionfusion_tpu.ops import maps as jmaps
from multimotionfusion_tpu.ops import rasterize as jr
from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
from multimotionfusion_tpu_torch.config import OdometryConfig as TOdometryConfig
from multimotionfusion_tpu_torch.model import fillin as tfill
from multimotionfusion_tpu_torch.model import surfel_map as tsm
from multimotionfusion_tpu_torch.odometry import levels as tlv
from multimotionfusion_tpu_torch.ops import frame_maps as tfm
from multimotionfusion_tpu_torch.ops import rasterize as tr
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMS = {
    "80x60": dict(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0),
    "160x120": dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0),
}
CUTOFF = 3.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_less(np.abs(a - b), rel * np.maximum(np.abs(b), 1.0) + 1e-30)


def _frame(name, seed=3, pose=((0.01, -0.02, 0.0), (0.02, 0.0, 0.01))):
    """A rendered frame with sensor noise and holes, as uint16 millimetres."""
    cam = CameraModel(**CAMS[name])
    rng = np.random.default_rng(seed)
    depth, rgb = synthetic.render(synthetic.pose(*pose), cam)
    depth = depth + rng.normal(0, 0.002, depth.shape).astype(np.float32) * (depth > 0)
    depth[rng.random(depth.shape) < 0.03] = 0.0
    mm = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
    return cam, TCameraModel(**CAMS[name]), mm, rgb.astype(np.uint8)


@pytest.mark.parametrize("name,weighting", [("80x60", 1.0), ("160x120", 0.7)])
def test_frame_surfels_match_reference(name, weighting):
    jcam, tcam, mm, rgb = _frame(name)
    depth = mm.astype(np.float32) * np.float32(0.001)
    depth_t, filt_t = tfm.frame_depth(_t(mm.view(np.int16)))
    np.testing.assert_array_equal(depth_t.numpy(), depth)  # the millimetre conversion
    filt = np.asarray(jimg.bilateral_depth_filter(jnp.asarray(depth)))
    _close(filt_t.numpy(), filt)
    vraw = jmaps.create_vmap(jnp.asarray(depth), jcam, CUTOFF)
    vf = jmaps.create_vmap(jnp.asarray(filt), jcam, CUTOFF)
    fj = jsm.compute_frame_surfels(jnp.asarray(rgb.astype(np.float32)), vraw, vf,
                                   jmaps.create_nmap(vf), jcam, 7, CUTOFF, weighting)
    ft = tfm.frame_surfels(_t(rgb), depth_t, _t(filt), tcam, 7, CUTOFF,
                           torch.tensor(weighting, dtype=torch.float32))
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    assert int(ft.valid.sum()) > 0.5 * ft.valid.numel()
    _close(ft.data.numpy(), np.asarray(fj.data))


def _prediction(jcam):
    """A prediction as the engine holds it: filled vertex+conf, normal+radius
    and colour maps rendered at another pose, with a hole."""
    depth, rgb = synthetic.render(synthetic.pose((0.0, 0.01, 0.0), (0.0, 0.01, 0.0)), jcam)
    depth[: jcam.height // 6] = 0.0
    v = np.asarray(jmaps.create_vmap(jnp.asarray(depth), jcam, 5.0))
    n = np.asarray(jmaps.create_nmap(jnp.asarray(v)))
    conf = np.full(depth.shape + (1,), 3.0, np.float32)
    return (np.concatenate([v, conf], -1), np.concatenate([n, 0.01 * conf], -1),
            rgb.astype(np.float32))


@pytest.mark.parametrize("name", sorted(CAMS))
def test_levels_static_valid_and_sampling_maps_match_reference(name):
    jcam, tcam, mm, rgb = _frame(name)
    cfg, tcfg = OdometryConfig(), TOdometryConfig()
    filt = np.asarray(jimg.bilateral_depth_filter(jnp.asarray(mm.astype(np.float32) * 0.001)))
    mask = (np.arange(mm.size).reshape(mm.shape) % 97 == 0).astype(np.int32)  # a few others
    vc, nr, color = _prediction(jcam)
    frame = jlv.build_frame_pyramids(jnp.asarray(filt), jnp.asarray(rgb.astype(np.float32)),
                                     jnp.asarray(mask), cfg)
    pint = jimg.rgb_to_intensity(jnp.asarray(color))
    levels = jlv.build_level_data(frame, jnp.asarray(vc[..., :3]), jnp.asarray(nr[..., :3]),
                                  pint, jcam, cfg)
    ft = tlv.frame_levels(_t(filt), _t(rgb), _t(mask), tcam, tcfg)
    pt = tlv.pred_levels(_t(vc), _t(nr), _t(color), tcam, tcfg)
    for i, (lvj, f, p) in enumerate(zip(levels, ft, pt)):
        min_scale = cfg.min_grad_magnitudes[i] ** 2 / cfg.sobel_scale**2
        sv = np.asarray(jrgbd.rgb_static_valid(lvj, min_scale, 0, cfg.mask_rgb))
        np.testing.assert_array_equal(f.static_valid.numpy(), sv)
        assert sv.sum() > 0
        np.testing.assert_array_equal(f.img.numpy(), np.asarray(lvj.img_next))
        np.testing.assert_array_equal(f.didx.numpy(), np.asarray(lvj.didx))
        np.testing.assert_array_equal(f.didy.numpy(), np.asarray(lvj.didy))
        np.testing.assert_array_equal(f.vmap.numpy()[..., 2] > 0, np.asarray(lvj.vmap_curr)[..., 2] > 0)
        for a, b in ((f.depth, lvj.depth_next), (f.vmap, lvj.vmap_curr), (f.nmap, lvj.nmap_curr)):
            _close(a.numpy(), b)
        if i == 0:  # bf16 [z_hi, z_lo, n, img] == the compact bank's first tap
            bank = jrgbd.build_compact_bank(lvj.vmap_prev[..., 2], lvj.nmap_prev, lvj.img_last)
            want = np.asarray(bank[..., :6]).view(np.int16)
            np.testing.assert_array_equal(p[..., :6].view(torch.int16).numpy(), want)
        else:  # f32 [v, n, depth_last, img] == the generic bank's first tap
            bank = np.asarray(jrgbd.build_generic_bank(lvj.vmap_prev, lvj.nmap_prev,
                                                       lvj.depth_last, lvj.img_last))
            np.testing.assert_array_equal(p.numpy()[..., 2] > 0, bank[..., 2] > 0)
            _close(p.numpy(), bank[..., :8])


def test_gather_attr_images_exact():
    rng = np.random.default_rng(5)
    data_local = rng.normal(size=(16, 500)).astype(np.float32)
    index = rng.integers(-1, 500, size=(30, 40)).astype(np.int32)
    want = np.asarray(jr.gather_attr_images(jnp.asarray(data_local), jnp.asarray(index)))
    got = tr.gather_attr_images(_t(data_local), _t(index)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("capacity", [700, 1500])
def test_compact_order_and_count_exact(capacity):
    rng = np.random.default_rng(capacity)
    data = rng.normal(size=(16, 1000)).astype(np.float32)
    keep = rng.random(1000) < 0.6
    dj, cj = jsm.compact(jnp.asarray(data), jnp.asarray(keep), capacity)
    dt, ct = tsm.compact(_t(data), _t(keep), capacity)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert int(ct) == int(cj) == int(keep.sum())


@pytest.mark.parametrize("passthrough", [False, True])
def test_fill_in_matches_reference(passthrough):
    jcam, tcam, mm, rgb = _frame("80x60")
    h, w = jcam.height, jcam.width
    rng = np.random.default_rng(11)
    vc, nr, color = _prediction(jcam)
    valid = rng.random((h, w)) < 0.5
    tmap = rng.integers(1, 9, (h, w)).astype(np.int32)
    pj = jr.PredictedMaps(jnp.asarray(color), jnp.asarray(vc), jnp.asarray(nr),
                          jnp.asarray(tmap), jnp.asarray(valid))
    pt = tr.PredictedMaps(_t(color), _t(vc), _t(nr), _t(tmap), _t(valid))
    depth = mm.astype(np.float32) * 0.001
    vf = jmaps.create_vmap(jnp.asarray(depth), jcam, CUTOFF)
    nf = jmaps.create_nmap(vf)
    conf = jsm.pixel_confidence(jcam, 1.0)
    rad = jsm.radius_from_depth(vf[..., 2], nf[..., 2], jcam)
    fj = jfill.fill_in(pj, jnp.asarray(rgb.astype(np.float32)), vf, nf, conf, rad, passthrough)
    # the port's epilogue takes the frame surfels' normals and radius
    fs = tfm.frame_surfels(_t(rgb), _t(depth), _t(depth), tcam, 1, CUTOFF,
                           torch.tensor(1.0))
    frame = tr.FillFrame(_t(rgb), _t(depth), fs.data, CUTOFF, passthrough)
    ft = tfill.fill_in(pt, *tfill.frame_fill_maps(frame, tcam), passthrough=passthrough)
    for a, b in zip(ft, fj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
