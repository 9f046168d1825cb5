"""Parity of the port's z-buffer (K6 plain version) and splat resolve (K10 plain
version) with the reference package, on the CPU.

Tolerances:
- ``predict_indices``: index maps equal on >= 99.9% of pixels. The packed key
  quantises log2(depth); XLA:CPU and PyTorch may round the transform or log2
  one ulp apart, which moves a key across a bin edge and flips a depth tie.
- ``splat_resolve`` (fed the same index map): valid maps equal and the
  resolved vertex within 1e-5 absolute wherever both are valid. Colour,
  confidence, normal and radius within 1e-5 on >= 99.5% of those pixels and
  the init time equal there: the rest are exact depth ties between coplanar
  surfels (a wall seen head-on), which the strict ``<`` hands to whichever
  candidate's ray-plane hit rounds one ulp nearer; XLA:CPU (FMA contraction)
  and PyTorch round that hit differently, so the winner, and with it its
  attributes, can differ while the depth agrees (ROADMAP.md, queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel
from multimotionfusion_tpu.io import synthetic
from multimotionfusion_tpu.model import surfel_map as jsm
from multimotionfusion_tpu.ops import maps as jmaps
from multimotionfusion_tpu.ops import rasterize as jr
from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
from multimotionfusion_tpu_torch.model import surfel_map as tsm
from multimotionfusion_tpu_torch.ops import rasterize as tr
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMK = dict(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
CAM, TCAM = CameraModel(**CAMK), TCameraModel(**CAMK)


def _map(seed, capacity=8192):
    """A map fused from a rendered frame, with seeded confidences/times."""
    depth, rgb = synthetic.render(np.eye(4, dtype=np.float32), CAM)
    vmap = jmaps.create_vmap(jnp.asarray(depth), CAM, 5.0)
    nmap = jmaps.create_nmap(vmap)
    fs = jsm.compute_frame_surfels(jnp.asarray(rgb), vmap, vmap, nmap, CAM, 1, 5.0, 1.0)
    smap = jsm.init_from_frame(fs, capacity)
    data = np.array(smap.data)
    n = int(smap.count)
    rng = np.random.default_rng(seed)
    data[jsm.CONF, :n] = rng.uniform(0.0, 20.0, n)
    data[jsm.LAST_T, :n] = rng.integers(1, 6, n)
    data[jsm.ALIVE, :n] *= rng.random(n) > 0.05
    return data, n


def _pose(seed):
    rng = np.random.default_rng(seed)
    return synthetic.pose(rng.normal(0, 0.01, 3), rng.normal(0, 0.01, 3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predict_indices_matches_reference(seed):
    data, n = _map(seed)
    pose = _pose(seed)
    im_j = jr.predict_indices(jsm.SurfelMap(jnp.asarray(data), jnp.int32(n)), jnp.asarray(pose),
                              CAM, 5, 200, 5.0)
    im_t = tr.predict_indices(
        tsm.SurfelMap(torch.from_numpy(data.copy()), torch.tensor(n, dtype=torch.int32)),
        torch.from_numpy(pose), TCAM, 5, 200, 5.0,
    )
    idx_j, idx_t = np.asarray(im_j.index), im_t.index.numpy()
    assert (idx_j >= 0).mean() > 0.5
    assert (idx_j == idx_t).mean() >= 0.999
    np.testing.assert_allclose(im_t.data_local.numpy(), np.asarray(im_j.data_local),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_splat_resolve_matches_reference(seed):
    data, n = _map(seed)
    pose = _pose(seed + 10)
    im = jr.predict_indices(jsm.SurfelMap(jnp.asarray(data), jnp.int32(n)), jnp.asarray(pose),
                            CAM, 5, 200, 5.0)
    pj = jr.splat_resolve(im, CAM, 10.0, 5, 5, 200)
    pt = tr.splat_resolve(
        tr.IndexMap(torch.from_numpy(np.array(im.index)), torch.from_numpy(np.array(im.data_local))),
        TCAM, 10.0, 5, 5, 200,
    )
    vj, vt = np.asarray(pj.valid), pt.valid.numpy()
    assert vj.mean() > 0.3
    np.testing.assert_array_equal(vt, vj)
    _check_resolved(pj, pt, vj)


def _check_resolved(pj, pt, both):
    np.testing.assert_allclose(pt.vertex_conf.numpy()[both][:, :3],
                               np.asarray(pj.vertex_conf)[both][:, :3], rtol=0, atol=1e-5)
    attrs_j = np.concatenate([np.asarray(pj.color), np.asarray(pj.vertex_conf)[..., 3:],
                              np.asarray(pj.normal_rad)], -1)[both]
    attrs_t = np.concatenate([pt.color.numpy(), pt.vertex_conf.numpy()[..., 3:],
                              pt.normal_rad.numpy()], -1)[both]
    same = np.all(np.abs(attrs_t - attrs_j) <= 1e-5, axis=-1)
    assert same.mean() >= 0.995, (int((~same).sum()), int(both.sum()))
    np.testing.assert_array_equal(pt.time.numpy()[both][same], np.asarray(pj.time)[both][same])


def test_splat_predict_first_frame():
    """The gated render of the first frame (z-buffer over the gated surfels)."""
    data, n = _map(5)
    smap_j = jsm.SurfelMap(jnp.asarray(data), jnp.int32(n))
    pj = jr.splat_predict(smap_j, jnp.eye(4), CAM, 5.0, 3, 3, 200, 5.0)
    pt = tr.splat_predict(
        tsm.SurfelMap(torch.from_numpy(data.copy()), torch.tensor(n, dtype=torch.int32)),
        torch.eye(4), TCAM, 5.0, 3, 3, 200, 5.0,
    )
    vj = np.asarray(pj.valid)
    assert vj.mean() > 0.3
    assert (pt.valid.numpy() == vj).mean() >= 0.999
    _check_resolved(pj, pt, vj & pt.valid.numpy())
