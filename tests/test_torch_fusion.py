"""Parity of the port's fuse (K8 plain version) and clean with the reference
package, on the CPU, on the scenes of tests/test_surfel_fusion.py.

Both sides get the same map and the same index map (the reference's), so the
comparison isolates fuse and clean. Tolerances: ``count`` equal (ids and
append slots follow the same order); surfel data within 1e-4 relative to
max(|value|, 1): merges are confidence-weighted averages whose float32
rounding may differ by a few ulps (FMA contraction in XLA:CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel, SurfelConfig
from multimotionfusion_tpu.io import synthetic
from multimotionfusion_tpu.model import fusion as jfu
from multimotionfusion_tpu.model import surfel_map as jsm
from multimotionfusion_tpu.ops import maps as jmaps
from multimotionfusion_tpu.ops import rasterize as jr
from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
from multimotionfusion_tpu_torch.config import SurfelConfig as TSurfelConfig
from multimotionfusion_tpu_torch.model import fusion as tfu
from multimotionfusion_tpu_torch.model import surfel_map as tsm
from multimotionfusion_tpu_torch.ops import rasterize as tr
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMK = dict(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
CAM, TCAM = CameraModel(**CAMK), TCameraModel(**CAMK)
CFG = SurfelConfig(max_surfels=8192, depth_cutoff=5.0)
TCFG = TSurfelConfig(max_surfels=8192, depth_cutoff=5.0)


def _frame(T_wc, time, weighting=1.0):
    depth, rgb = synthetic.render(T_wc, CAM)
    vmap = jmaps.create_vmap(jnp.asarray(depth), CAM, CFG.depth_cutoff)
    nmap = jmaps.create_nmap(vmap)
    fs = jsm.compute_frame_surfels(jnp.asarray(rgb), vmap, vmap, nmap, CAM, time,
                                   CFG.depth_cutoff, weighting)
    return fs, depth


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _tmap(smap):
    return tsm.SurfelMap(_t(smap.data), _t(smap.count, torch.int32).reshape(()))


def _timap(im):
    return tr.IndexMap(_t(im.index), _t(im.data_local))


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_less(np.abs(a - b), 1e-4 * np.maximum(np.abs(b), 1.0) + 1e-12)


def _scene(case):
    """(map, reference index map, frame, depth, pose, time) of one scene."""
    fs1, depth = _frame(np.eye(4, dtype=np.float32), time=1)
    smap = jsm.init_from_frame(fs1, CFG.max_surfels)
    pose = np.eye(4, dtype=np.float32)
    if case == "static":
        time = 2
    elif case in ("moved", "full"):  # odd parity, the camera moved 1 cm and turned,
        time = 3  # the map's left half culled (so the frame appends there); "full":
        pose = synthetic.pose((0.0, 0.01, 0.0), (0.01, 0.0, 0.0))  # room for FULL_ROOM more
        if case == "full":
            smap = jsm.init_from_frame(fs1, int(smap.count) + FULL_ROOM)
        alive = np.array(smap.data[jsm.ALIVE]) * (np.array(smap.data[jsm.PX]) > 0)
        smap = jsm.SurfelMap(smap.data.at[jsm.ALIVE].set(jnp.asarray(alive)), smap.count)
    else:  # "aged": half the map stable, the rest past the unstable grace period
        time = 25
        n = int(smap.count)
        conf = np.array(smap.data[jsm.CONF])
        conf[: n // 2] = 20.0
        smap = jsm.SurfelMap(smap.data.at[jsm.CONF].set(jnp.asarray(conf)), smap.count)
    fs, depth = _frame(pose, time=time, weighting=0.7)
    im = jr.predict_indices(smap, jnp.asarray(pose), CAM, time, 200, CFG.depth_cutoff)
    return smap, im, fs, depth, pose, time


FULL_ROOM = 40  # "full": the map's capacity a few dozen surfels above its count


@pytest.mark.parametrize("case", ["static", "moved", "aged", "full"])
def test_fuse_matches_reference(case):
    smap, im, fs, _, pose, time = _scene(case)
    mask = np.zeros((CAM.height, CAM.width), np.int32)
    fj = jfu.fuse(smap, fs, im, jnp.asarray(mask), 0, jnp.asarray(pose), CAM, time, CFG)
    ft = tfu.fuse(_tmap(smap), tsm.FrameSurfels(_t(fs.data), _t(fs.valid)), _timap(im),
                  _t(mask), 0, _t(pose), TCAM, time, TCFG)
    n = int(fj.count)
    assert int(ft.count) == n
    if case == "moved":
        assert n > int(smap.count) + 100  # appends
    if case == "full":  # the appends clipped to the capacity
        assert n == smap.capacity == int(smap.count) + FULL_ROOM
    assert float(jnp.max(fj.data[jsm.LAST_T])) == time  # merges
    _close(ft.data.numpy()[:, :n], np.asarray(fj.data)[:, :n])


@pytest.mark.parametrize("case,compact", [("static", False), ("moved", True),
                                          ("aged", False), ("aged", True)])
def test_fuse_then_clean_matches_reference(case, compact):
    smap, im, fs, depth, pose, time = _scene(case)
    mask = np.zeros((CAM.height, CAM.width), np.int32)
    fj = jfu.fuse(smap, fs, im, jnp.asarray(mask), 0, jnp.asarray(pose), CAM, time, CFG)
    cj = jfu.clean(fj, im, jnp.asarray(depth), jnp.asarray(mask), 0, jnp.asarray(pose), CAM,
                   time, 200, 10.0, CFG, compact=compact)
    ft = tsm.SurfelMap(_t(fj.data), _t(fj.count, torch.int32).reshape(()))
    ct = tfu.clean(ft, _timap(im), _t(depth), _t(mask), 0, TCAM, time, 200, 10.0, TCFG,
                   compact=compact)
    n = int(cj.count)
    assert int(ct.count) == n
    assert int(ct.alive_count()) == int(cj.alive_count())
    if case == "aged":  # the unstable-age cull fired
        assert int(cj.alive_count()) < int(fj.alive_count())
    _close(ct.data.numpy()[:, :n], np.asarray(cj.data)[:, :n])


def test_clean_penalises_phantom_like_reference():
    """A surfel planted 0.5 m in front of the wall takes the see-through
    penalty on both sides (the scene of test_surfel_fusion)."""
    fs1, depth = _frame(np.eye(4, dtype=np.float32), time=1)
    smap = jsm.init_from_frame(fs1, CFG.max_surfels)
    n0 = int(smap.count)
    phantom = np.zeros((jsm.CHANNELS,), np.float32)
    phantom[jsm.PZ] = float(depth[int(CAM.cy), int(CAM.cx)]) - 0.5
    phantom[[jsm.CONF, jsm.INIT_T, jsm.LAST_T, jsm.ALIVE]] = 1.0
    phantom[jsm.RADIUS] = 0.01
    phantom[jsm.NZ] = -1.0
    smap = jsm.SurfelMap(smap.data.at[:, n0].set(jnp.asarray(phantom)), jnp.int32(n0 + 1))
    im = jr.predict_indices(smap, jnp.eye(4), CAM, 2, 200, CFG.depth_cutoff)
    mask = np.zeros((CAM.height, CAM.width), np.int32)
    cj = jfu.clean(smap, im, jnp.asarray(depth), jnp.asarray(mask), 0, jnp.eye(4), CAM,
                   2, 200, 10.0, CFG)
    ct = tfu.clean(_tmap(smap), _timap(im), _t(depth), _t(mask), 0, TCAM, 2, 200, 10.0, TCFG)
    assert float(ct.data[jsm.CONF, n0]) < 1.0 / (1.0 + CFG.outlier_coeff * 0.4)
    _close(ct.data.numpy()[:, : n0 + 1], np.asarray(cj.data)[:, : n0 + 1])
