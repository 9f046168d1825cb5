"""The port's composite index map (K12) and composite splat resolve (K10 in
composite mode, with the gated fill-in) against the reference package, on
the CPU, on the multi-model scene of ``tests/torch_flat_scene.py`` (80x60,
four models: depth near-ties between objects and their stale copies in the
global map, a surfel beyond its model's max depth, stale surfels).

- ``zbuffer_flat``: the index map and the winner-model image bit-equal to
  ``predict_indices_flat`` + ``win_model_image`` (both sides given the same
  camera-frame surfels: the port's transform by the inverse poses); the
  camera-frame copy within 1e-6 of the reference's ``transform_surfels``;
- ``splat_fill`` in composite mode: valid maps equal, and at most 0.5 % of
  the pixels valid in both carry another surfel's attributes (ROADMAP queue
  3 #1: exact depth ties between coplanar surfels, which XLA:CPU and PyTorch
  round differently); elsewhere within 1e-5; the fill-in only at the global
  model's pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.model import fillin as jfill
from multimotionfusion_tpu.model import surfel_map as jsm
from multimotionfusion_tpu.ops import maps as jmaps
from multimotionfusion_tpu.ops import rasterize as jr
from multimotionfusion_tpu.utils import se3 as jse3
from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
from multimotionfusion_tpu_torch.model import fillin as tfill
from multimotionfusion_tpu_torch.ops import rasterize as tr
from multimotionfusion_tpu_torch.utils import se3 as tse3
from tests import torch_flat_scene as sc
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TCAM = TCameraModel(**sc.CAMK)
LAYOUT = tr.FlatLayout(sc.BG, sc.BO, sc.SLOTS)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module", params=[0, 1])
def composite(request):
    s = sc.build(request.param)
    T_inv = tse3.inverse_T(_t(s["poses"]))
    index, data_local, win = tr.zbuffer_flat_plain(
        _t(s["data"]), _t(s["counts"]), LAYOUT, T_inv, _t(s["maxd"]), TCAM, sc.TIME,
        sc.CFG.time_delta)
    alive = (sc.pos_in_seg() < s["counts"][sc.seg_model()]) & (s["data"][sc.ALIVE] > 0)
    im = jr.predict_indices_flat(jnp.asarray(data_local.numpy()), jnp.asarray(alive),
                                 jnp.asarray(sc.seg_model()), jnp.asarray(s["maxd"]), sc.M,
                                 sc.CAM, sc.TIME, sc.CFG.time_delta)
    jwin = jr.win_model_image(im.index, sc.bases(), sc.M)
    return dict(scene=s, index=index, data_local=data_local, win=win, jim=im, jwin=jwin)


def test_zbuffer_flat_matches_reference(composite):
    c, s = composite, composite["scene"]
    np.testing.assert_array_equal(c["index"].numpy(), np.asarray(c["jim"].index))
    np.testing.assert_array_equal(c["win"].numpy(), np.asarray(c["jwin"]))
    won = c["win"].numpy()
    # the scene exercises what the test names: objects win, and some pixels go
    # to objects over their equally deep stale global copies
    assert all((won == m).sum() > 20 for m in range(sc.M)), np.bincount(won.reshape(-1))
    # the per-model transform equals the reference's transform_surfels
    seg = sc.seg_model()
    for m in range(sc.M):
        cols = seg == m
        ref = jsm.transform_surfels(jnp.asarray(s["data"][:, cols]),
                                    jse3.inverse_T(jnp.asarray(s["poses"][m])))
        np.testing.assert_allclose(c["data_local"].numpy()[:, cols], np.asarray(ref), atol=1e-6)


def test_zbuffer_flat_gates(composite):
    """Over-max-depth and stale surfels never win; winners are alive."""
    c, s = composite, composite["scene"]
    idx = c["index"].numpy()
    ids = idx[idx >= 0]
    dl = c["data_local"].numpy()
    seg = sc.seg_model()
    assert np.all(dl[sc.PZ, ids] <= s["maxd"][seg[ids]])
    assert np.all(sc.TIME - dl[sc.LAST_T, ids] <= sc.CFG.time_delta)
    assert np.all(s["data"][sc.ALIVE, ids] > 0)
    # model 1's max depth cuts part of its surfels
    over = (seg == 1) & (dl[sc.PZ] > s["maxd"][1]) & (s["data"][sc.ALIVE] > 0)
    assert over.sum() > 10


def test_composite_splat_fill_matches_reference(composite):
    c, s = composite, composite["scene"]
    conf_all = s["conf_all"]
    frame = s["frame"]
    mask = s["mask"]
    jim = c["jim"]
    jattrs = jr.gather_attr_images(jim.data_local, jim.index)
    conf_px = jr.take_small(jnp.asarray(conf_all), c["jwin"], sc.M)
    pred = jr.splat_resolve(jim, sc.CAM, 0.0, sc.TIME, sc.TIME, sc.CFG.time_delta,
                            sc.CFG.splat_footprint, attrs=jattrs, conf_img=conf_px,
                            own_img=c["jwin"])
    h, w = sc.CAM.height, sc.CAM.width
    fd = np.array(frame.data).reshape(16, h, w)
    vmap_f = jmaps.create_vmap(jnp.asarray(s["depth"]), sc.CAM, sc.CFG.depth_cutoff)
    ref = jfill.fill_in(pred, jnp.asarray(s["rgb"]), vmap_f,
                        jnp.asarray(np.moveaxis(fd[[sc.NX, sc.NY, sc.NZ]], 0, -1)),
                        jsm.pixel_confidence(sc.CAM, 1.0), jnp.asarray(fd[sc.RADIUS]),
                        gate=jnp.asarray(mask == 0))
    rgb_u8 = _t(np.clip(s["rgb"], 0, 255).astype(np.uint8))
    fill = tr.FillFrame(rgb_u8, _t(s["depth"]), _t(frame.data), sc.CFG.depth_cutoff, False,
                        gate=_t(mask))
    pp, fp = tfill.splat_fill_plain(c["index"], c["data_local"], TCAM, 0.0, sc.TIME, sc.TIME,
                                    sc.CFG.time_delta, sc.CFG.splat_footprint, fill,
                                    tr.Composite(_t(conf_all), c["win"]))
    valid = np.asarray(pred.valid)
    np.testing.assert_array_equal(pp.valid.numpy(), valid)
    assert valid.sum() > 500
    both = valid
    va = np.concatenate([np.asarray(pred.color), np.asarray(pred.vertex_conf),
                         np.asarray(pred.normal_rad)], -1)[both]
    vb = torch.cat([pp.color, pp.vertex_conf, pp.normal_rad], -1).numpy()[both]
    differ = np.abs(va - vb).max(-1) > 1e-5
    assert differ.sum() <= 0.005 * both.sum(), (differ.sum(), both.sum())
    # the filled maps: the frame where the global model's pixels have no surfel
    # (the frame colour is the reference's float colour rounded to uint8)
    filled_ref = np.concatenate([np.asarray(ref.vertex_conf), np.asarray(ref.normal_rad)], -1)
    filled_port = torch.cat([fp.vertex_conf, fp.normal_rad], -1).numpy()
    took = ~valid & (mask == 0)
    assert took.sum() > 50 and (~valid & (mask != 0)).sum() > 0
    np.testing.assert_allclose(filled_port[took], filled_ref[took], atol=1e-5)
    np.testing.assert_array_equal(filled_port[~valid & (mask != 0)], 0.0)
