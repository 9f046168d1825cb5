"""The port's composite fusion and clean (K14) and the per-segment repack
against the reference package, on the CPU, on the multi-model scene of
``tests/torch_flat_scene.py`` (a segment at capacity, an inactive owner, the
sentinel id M in the mask).

Both sides get the same flat store, frame, index map and winner-model image
(the port's ``zbuffer_flat``, itself held bit-equal to the reference in
``test_torch_composite_maps.py``), so each comparison isolates one pass:
- ``fuse_flat``: per-model counts equal, the whole flat store within 1e-6
  (relative to max(|value|, 1)): merges are confidence-weighted averages in
  the owner's model frame and appends keep the reference's order;
- ``clean_flat`` on the fused store: ALIVE equal, CONF within 1e-6;
- the repack of each segment (``surfel_map.compact``): equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.model import fusion as jfu
from multimotionfusion_tpu.model import surfel_map as jsm
from multimotionfusion_tpu.ops import rasterize as jr
from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
from multimotionfusion_tpu_torch.config import SurfelConfig as TSurfelConfig
from multimotionfusion_tpu_torch.model import fusion as tfu
from multimotionfusion_tpu_torch.model import surfel_map as tsm
from multimotionfusion_tpu_torch.ops import rasterize as tr
from multimotionfusion_tpu_torch.utils import se3 as tse3
from tests import torch_flat_scene as sc
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TCAM = TCameraModel(**sc.CAMK)
TCFG = TSurfelConfig(max_surfels=8192, depth_cutoff=5.0)
LAYOUT = tr.FlatLayout(sc.BG, sc.BO, sc.SLOTS)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _close(a, b, tol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    err = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    assert err.max() <= tol, (err.max(), np.unravel_index(err.argmax(), err.shape))


@pytest.fixture(scope="module", params=[0, 1])
def fused(request):
    s = sc.build(request.param)
    index, data_local, win = tr.zbuffer_flat_plain(
        _t(s["data"]), _t(s["counts"]), LAYOUT, tse3.inverse_T(_t(s["poses"])), _t(s["maxd"]),
        TCAM, sc.TIME, sc.CFG.time_delta)
    fs = s["frame"]
    jim = jr.IndexMap(jnp.asarray(index.numpy()), jnp.asarray(data_local.numpy()))
    jattrs = jr.gather_attr_images(jim.data_local, jim.index)
    jwin = jnp.asarray(win.numpy())
    ref_data, ref_counts = jfu.fuse_flat(
        jnp.asarray(s["data"]), jnp.asarray(s["counts"]), sc.bases(), fs, jim,
        jnp.asarray(s["mask"]), jnp.asarray(s["poses"]), jnp.asarray(s["maxd"]),
        jnp.asarray(s["active"]), sc.CAM, sc.TIME, sc.CFG, jattrs, jwin)
    tfs = tsm.FrameSurfels(_t(fs.data), _t(fs.valid))
    out, counts = tfu.fuse_flat_plain(
        _t(s["data"]), _t(s["counts"]), LAYOUT, tfs.data, tfs.valid, index, data_local,
        _t(s["mask"]), win, _t(s["poses"]), _t(s["maxd"]), _t(s["active"]), TCAM, sc.TIME, TCFG)
    return dict(scene=s, index=index, data_local=data_local, win=win, jim=jim, jattrs=jattrs,
                jwin=jwin, ref=(np.asarray(ref_data), np.asarray(ref_counts)), port=(out, counts))


def test_fuse_flat_matches_reference(fused):
    s = fused["scene"]
    ref_data, ref_counts = fused["ref"]
    out, counts = fused["port"]
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    # the scene exercises appends into active models, none into the full
    # segment (2), the inactive model (3) or the sentinel's pixels
    grew = ref_counts - s["counts"]
    assert grew[0] > 0 and grew[1] > 0 and grew[2] == 0 and grew[3] == 0, grew
    written = (ref_data != s["data"]).any(0)
    seg = sc.seg_model()
    assert written[seg == 2].any() and not written[seg == 3].any()
    _close(out.numpy(), ref_data)


def test_clean_flat_matches_reference(fused):
    s = fused["scene"]
    ref_data, ref_counts = fused["ref"]
    seg = sc.seg_model()
    alive = (sc.pos_in_seg() < ref_counts[seg]) & (ref_data[sc.ALIVE] > 0)
    ref = np.asarray(jfu.clean_flat(
        jnp.asarray(ref_data), jnp.asarray(ref_counts), jnp.asarray(seg), jnp.asarray(alive),
        fused["jim"], jnp.asarray(s["depth"]), jnp.asarray(s["conf_all"]), sc.CAM, sc.TIME,
        sc.CFG.time_delta, sc.CFG, fused["jattrs"], fused["jwin"]))
    out = tfu.clean_flat_plain(_t(ref_data), _t(ref_counts), LAYOUT, fused["index"],
                               fused["data_local"], fused["win"], _t(s["depth"]),
                               _t(s["conf_all"]), TCAM, sc.TIME, sc.CFG.time_delta, TCFG).numpy()
    np.testing.assert_array_equal(out[sc.ALIVE], ref[sc.ALIVE])
    _close(out[sc.CONF], ref[sc.CONF])
    np.testing.assert_array_equal(np.delete(out, [sc.CONF, sc.ALIVE], 0),
                                  np.delete(ref, [sc.CONF, sc.ALIVE], 0))
    # culls and penalties both fired
    assert ((ref_data[sc.ALIVE] > 0) & (ref[sc.ALIVE] == 0)).sum() > 0
    assert (ref[sc.CONF] < ref_data[sc.CONF]).sum() > 0


def test_segment_repack_matches_reference(fused):
    ref_data, ref_counts = fused["ref"]
    segs = [(0, sc.BG)] + [(sc.BG + k * sc.BO, sc.BO) for k in range(sc.SLOTS)]
    for m, (base, size) in enumerate(segs):
        d = ref_data[:, base:base + size]
        keep = (np.arange(size) < ref_counts[m]) & (d[sc.ALIVE] > 0)
        jd, jc = jsm.compact(jnp.asarray(d), jnp.asarray(keep), size)
        td, tc = tsm.compact_plain(_t(d), _t(keep), size)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert int(tc) == int(jc)
