"""The port's flow-CRF kernels' plain versions against the reference package,
on the CPU, at small sizes, on seeded inputs.

- K13 ``rasterize.render_depths`` against ``render_model_depths`` fed as the
  reference's engine feeds it (``_stride_cols`` with strides 2 global / 1
  objects, slot ids from the original index): three models, a confidence
  gate that some surfels miss, stale and beyond-max-depth surfels. Coverage
  equal; depth equal, or one log-depth step (0.27 %) apart where the two
  packages' log2 round a bin edge differently;
- K15 ``flow.dense_flow_plain`` against ``dense_flow`` of the reference's
  resized intensities, on a textured shift and on two frames of the moving
  spheres: within 1e-3 px (the sums are the same taps in the same order; the
  reference's resize is a matmul) on all but 0.5 % of the cells, where the
  min-eigenvalue gate flips at its threshold;
- K16 ``crf.mean_field_plain`` against ``mean_field`` with both kernels, on
  a 40x32 grid (pooled 4x4, 8x10 cells) and a 24x16 grid (no pooling):
  within 2e-5 on 99.5 % of the entries and 1e-3 on all (cumulative sums and
  softmaxes of other libraries, amplified by ten iterations where two labels
  compete closely);
- K17 ``components.keep_largest_components_plain`` bit-equal to
  ``keep_largest_components_batched`` on random blobs, on a spiral whose
  in-component geodesic diameter exceeds the 64 sweeps (the truncation
  splits it), and on two equal-size components (the lower id wins); also
  ``connected_components`` and ``component_sizes_at_pixels``;
- K18 ``reprojection_probability`` within a few ulp (exp), ``sparse_unary``
  exact, and the whole ``flow_crf_segmentation`` on a rendered frame pair
  with model predictions: the masks at most 1 % of the pixels apart (label
  flips where two rows' posteriors nearly tie), ``has_new_label`` equal,
  pixel counts within 1 %, means within 1e-5 m and variances within 2e-5
  m^2 (the one-pass variance cancels); the same check on inputs captured
  from the reference engine in test_torch_flow_crf_engine.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu import config as J
from multimotionfusion_tpu import engine_multi as jem
from multimotionfusion_tpu.io import synthetic
from multimotionfusion_tpu.model import surfel_map as jsm
from multimotionfusion_tpu.ops import image as jimg
from multimotionfusion_tpu.ops import rasterize as jr
from multimotionfusion_tpu.segmentation import components as jcc
from multimotionfusion_tpu.segmentation import crf as jcrf
from multimotionfusion_tpu.segmentation import flow as jflow
from multimotionfusion_tpu.segmentation import flow_crf as jfc
from multimotionfusion_tpu.utils import se3 as jse3
from multimotionfusion_tpu_torch import config as T
from multimotionfusion_tpu_torch.ops import image as timg
from multimotionfusion_tpu_torch.ops import rasterize as tr
from multimotionfusion_tpu_torch.segmentation import components as tcc
from multimotionfusion_tpu_torch.segmentation import crf as tcrf
from multimotionfusion_tpu_torch.segmentation import flow as tflow
from multimotionfusion_tpu_torch.segmentation import flow_crf as tfc
from multimotionfusion_tpu_torch.utils import se3 as tse3
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMK = dict(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
H, W = CAMK["height"], CAMK["width"]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------- K13

def _surfels(rng, n, centre, conf_lo, conf_hi, time):
    d = np.zeros((16, n), np.float32)
    d[0:3] = rng.normal(size=(3, n)) * np.array([[0.4], [0.3], [0.2]]) + np.array(centre)[:, None]
    d[3] = rng.uniform(conf_lo, conf_hi, n)
    d[8] = time - rng.integers(0, 3, n)  # last seen; some beyond the time window
    nrm = rng.normal(size=(3, n))
    d[9:12] = nrm / np.linalg.norm(nrm, axis=0)
    d[12] = 0.01
    d[13] = (rng.random(n) < 0.95).astype(np.float32)
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_render_depths_matches_reference(seed):
    rng = np.random.default_rng(seed)
    time, td = 10, 1.0
    bg, bo, S = 1200, 400, 2
    gdata = _surfels(rng, bg, (0.0, 0.0, 2.0), 0.0, 5.0, time)
    odata = np.stack([_surfels(rng, bo, c, 0.0, 5.0, time)
                      for c in ((-0.3, 0.0, 1.2), (0.3, 0.1, 1.4))])
    counts = np.array([1100, 380, 250], np.int32)
    poses = np.stack([synthetic.pose((0.01, 0.02, 0.0), (0.02, -0.01, 0.0)),
                      synthetic.pose((0.0, 0.03, 0.01), (0.05, 0.0, 0.0)),
                      np.eye(4)]).astype(np.float32)
    maxd = np.array([5.0, 1.5, 1.45], np.float32)
    conf = np.array([1.0, 2.0, 0.5], np.float32)  # a gate some surfels miss
    cam = J.CameraModel(**CAMK)
    cam_c = jem._crf_camera(cam, 0.25)

    # the reference, fed as its engine feeds it (engine_multi.py:876-982)
    Tinv = jse3.inverse_T(jnp.asarray(poses))
    g_local = jsm.transform_surfels(jnp.asarray(gdata), Tinv[0])
    o_local = jnp.stack([jsm.transform_surfels(jnp.asarray(odata[k]), Tinv[k + 1])
                         for k in range(S)])
    galive = (np.arange(bg) < counts[0]) & (gdata[13] > 0)
    oalive = np.stack([(np.arange(bo) < counts[k + 1]) & (odata[k, 13] > 0) for k in range(S)])
    o_flat = jnp.moveaxis(o_local, 0, 1).reshape(16, -1)
    flat = jnp.concatenate([jem._stride_cols(g_local, 2), jem._stride_cols(o_flat, 1)], axis=1)
    alive = jnp.concatenate([jem._stride_cols(jnp.asarray(galive), 2),
                             jnp.asarray(oalive.reshape(-1))])
    seg_model = jnp.concatenate([jnp.zeros(((bg + 1) // 2,), jnp.int32),
                                 jnp.arange(S * bo, dtype=jnp.int32) // bo + 1])
    ref = np.asarray(jr.render_model_depths(flat, alive, seg_model, jnp.asarray(conf),
                                            jnp.asarray(maxd), 1 + S, cam_c, time, td))

    st = tr.DepthStores(_t(gdata), _t(odata), _t(counts), bg, bo, 2, 1)
    out = tr.render_depths_plain(st, tse3.inverse_T(_t(poses)), _t(maxd), _t(conf),
                                 T.CameraModel(**vars(cam_c)), time, td).numpy()
    np.testing.assert_array_equal(out > 0, ref > 0)
    assert (ref > 0).sum() > 100
    # one log-depth bin is 2^(8 / 2^20) - 1 = 5.3e-6 relative
    np.testing.assert_allclose(out, ref, rtol=6e-6, atol=0)


# ---------------------------------------------------------------- K15

def _textured(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h // 4 + 2, w // 4 + 2)).astype(np.float32)
    img = np.kron(img, np.ones((4, 4), np.float32))
    return np.asarray(jimg.gaussian_blur(jnp.asarray(img), 2.0, 4))


def _sphere_frames(i):
    cam = J.CameraModel(**CAMK)
    out = []
    for k in (i, i + 1):
        c1 = (-0.3 + 0.03 * k, 0.0, 1.4)
        c2 = (0.35, 0.1 - 0.02 * k, 1.6)
        depth, rgb = synthetic.render(np.eye(4, dtype=np.float32), cam,
                                      spheres=[(c1, 0.22), (c2, 0.2)])
        out.append((depth.astype(np.float32), np.floor(rgb @ np.array([0.114, 0.299, 0.587]))
                    .astype(np.float32)))
    return out


def _flow_pair(kind):
    if kind == "shift":
        big = _textured(2 * H + 16, 2 * W + 16, 0)
        return big[8:8 + 2 * H, 8:8 + 2 * W], big[5:5 + 2 * H, 10:10 + 2 * W], 2 * H, 2 * W
    (_, prev), (_, nxt) = _sphere_frames(0)
    return prev, nxt, H, W


@pytest.mark.parametrize("kind", ["shift", "spheres"])
def test_dense_flow_matches_reference(kind):
    prev, nxt, h, w = _flow_pair(kind)
    hc, wc = h // 4, w // 4
    ref = np.asarray(jflow.dense_flow(jimg.resize_bilinear(jnp.asarray(prev), (hc, wc)),
                                      jimg.resize_bilinear(jnp.asarray(nxt), (hc, wc))))
    out = tflow.dense_flow_plain(_t(prev), _t(nxt), hc, wc).numpy()
    assert out.shape == ref.shape == (hc, wc, 2)
    gap = np.abs(out - ref).max(axis=-1)
    assert np.mean(gap > 1e-3) <= 0.005, (np.mean(gap > 1e-3), gap.max())
    assert np.abs(ref).max() > 0.2  # the flow moved


def test_resize_matches_reference():
    img = _textured(H, W, 3)
    for shape in ((H // 4, W // 4), (2 * H, 2 * W), (15, 27)):
        ref = np.asarray(jimg.resize_bilinear(jnp.asarray(img), shape))
        out = timg.resize_bilinear(_t(img), shape).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)  # two taps, a few ulp


# ---------------------------------------------------------------- K16

@pytest.mark.parametrize("hw", [(32, 40), (16, 24)])
def test_mean_field_matches_reference(hw):
    h, w = hw
    rng = np.random.default_rng(5)
    L = 5
    unary = rng.uniform(0.0, 3.0, (L, h, w)).astype(np.float32)
    unary[:, : h // 2, : w // 2] *= 0.2
    flow = (rng.normal(size=(h, w, 2)) * 0.5).astype(np.float32)
    flow[h // 3: 2 * h // 3, w // 3:] += np.array([2.0, -1.0], np.float32)
    cfg = J.SegmentationConfig()
    ref = np.asarray(jcrf.mean_field(
        jnp.asarray(unary),
        kernels=[("gaussian", dict(sigma=cfg.pairwise_gaussian_sigma),
                  4.0 * cfg.pairwise_gaussian_weight),
                 ("bilateral", dict(features=jnp.asarray(flow) * 10.0,
                                    sigma_xy=cfg.pairwise_flow_sigma_xy,
                                    sigma_f=10.0 * cfg.pairwise_flow_sigma_v),
                  cfg.pairwise_flow_weight)],
        iterations=cfg.crf_iterations))
    p = tfc.crf_params(T.SegmentationConfig())
    assert tcrf.pool_of(h, w) == (4 if h == 32 else 1)
    out = tcrf.mean_field_plain(_t(unary), _t(flow), p, 10).numpy()
    gap = np.abs(out - ref)
    # ten iterations with pairwise weights of 160 and 40 amplify the cumsum
    # and softmax rounding where two labels compete closely
    assert np.mean(gap > 2e-5) <= 0.005 and gap.max() < 1e-3, (np.mean(gap > 2e-5), gap.max())
    assert np.abs(out - np.exp(-unary) / np.exp(-unary).sum(0)).max() > 0.05  # messages acted


# ---------------------------------------------------------------- K17

def _spiral(n):
    """An n x n square spiral of one-pixel corridors between one-pixel walls
    (path length ~n^2 / 2)."""
    m = np.zeros((n, n), bool)
    y = x = 0
    m[0, 0] = True
    legs = [n - 1, n - 1] + [k for k in range(n - 1, 0, -2) for _ in range(2)][1:]
    for i, length in enumerate(legs):
        dy, dx = ((0, 1), (1, 0), (0, -1), (-1, 0))[i % 4]
        for _ in range(length):
            y, x = y + dy, x + dx
            m[y, x] = True
    return m


def _stacks():
    rng = np.random.default_rng(7)
    blobs = rng.random((4, 30, 40)) < 0.45
    spiral = np.zeros((1, 30, 40), bool)
    spiral[0, :25, :25] = _spiral(25)
    ties = np.zeros((1, 30, 40), bool)
    ties[0, 2:8, 3:9] = True
    ties[0, 20:26, 30:36] = True  # equal sizes
    empty = np.zeros((1, 30, 40), bool)
    return np.concatenate([blobs, spiral, ties, empty])


def test_largest_components_bit_equal():
    masks = _stacks()
    ref = np.asarray(jcc.keep_largest_components_batched(jnp.asarray(masks)))
    keep, sizes = tcc.keep_largest_components_plain(_t(masks))
    np.testing.assert_array_equal(keep.numpy(), ref)
    np.testing.assert_array_equal(sizes.numpy(), ref.reshape(ref.shape[0], -1).sum(1))
    # the spiral is longer than 64 sweeps: truncation split it
    assert 0 < ref[4].sum() < masks[4].sum()
    # equal sizes: the lower id (the first component) wins
    assert ref[5, 2:8, 3:9].all() and not ref[5, 20:26, 30:36].any()
    assert not ref[6].any()
    for m in masks[[0, 4]]:
        np.testing.assert_array_equal(tcc.connected_components(_t(m)).numpy(),
                                      np.asarray(jcc.connected_components(jnp.asarray(m))))
        np.testing.assert_array_equal(tcc.component_sizes_at_pixels(_t(m)).numpy(),
                                      np.asarray(jcc.component_sizes_at_pixels(jnp.asarray(m))))
        np.testing.assert_array_equal(tcc.keep_largest_component(_t(m)).numpy(),
                                      np.asarray(jcc.keep_largest_component(jnp.asarray(m))))


# ---------------------------------------------------------------- K18

def seg_inputs(seed):
    """A frame pair of the moving spheres with per-model CRF-scale depth
    predictions (the background, one sphere where it was, one sphere not
    modelled), tracks with velocity errors, at 80x60 (CRF 20x15)."""
    rng = np.random.default_rng(seed)
    (_, prev), (depth, nxt) = _sphere_frames(seed)
    hc, wc = H // 4, W // 4
    M = 4
    cam = J.CameraModel(**CAMK)
    bg_depth, _ = synthetic.render(np.eye(4, dtype=np.float32), cam, spheres=[])
    s1, _ = synthetic.render(np.eye(4, dtype=np.float32), cam,
                             spheres=[((-0.3 + 0.03 * seed, 0.0, 1.4), 0.22)])
    pred = np.zeros((M, hc, wc), np.float32)
    pred[0] = bg_depth[2::4, 2::4] + rng.normal(size=(hc, wc)) * 0.005
    sph = s1[2::4, 2::4]
    pred[1] = np.where(sph < bg_depth[2::4, 2::4] - 0.05, sph, 0.0)
    pred[2] = np.where(rng.random((hc, wc)) < 0.1, 1.0, 0.0)  # a stray model
    active = np.array([True, True, True, False])
    T_ = 48
    txy = rng.uniform([0, 0], [W - 1, H - 1], (T_, 2)).astype(np.float32)
    vel = rng.uniform(0, 60, (M, T_)).astype(np.float32)
    vel[3, :5] = np.inf
    valid = rng.random(T_) < 0.8
    return dict(prev=prev, nxt=nxt, depth=depth.astype(np.float32), pred=pred, active=active,
                txy=txy, vel=vel, valid=valid)


def test_reprojection_and_sparse_unary_exact():
    s = seg_inputs(0)
    fd = s["depth"][2::4, 2::4]
    rp, ro, rb = jfc.reprojection_probability(jnp.asarray(fd), jnp.asarray(s["pred"]),
                                              jnp.asarray(s["active"]), 0.03)
    tp, to, tb = tfc.reprojection_probability(_t(fd), _t(s["pred"]), _t(s["active"]), 0.03)
    # exp of two libraries: a few ulp
    np.testing.assert_allclose(tp.numpy(), np.asarray(rp), rtol=2e-6, atol=0)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=0, atol=2e-7)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
    for allow_new in (True, False):
        ref = jfc.sparse_unary(jnp.asarray(s["txy"]), jnp.asarray(s["vel"]),
                               jnp.asarray(s["valid"]), jnp.asarray(s["active"]), H // 4, W // 4,
                               0.25, 20.0, allow_new)
        out = tfc.sparse_unary(_t(s["txy"]), _t(s["vel"]), _t(s["valid"]), _t(s["active"]),
                               H // 4, W // 4, 0.25, 20.0, allow_new)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


TIE_EPS = 1e-4
LABEL_SCORES = []  # what RecordingJnp records: one [L, Hc, Wc] array per call


class RecordingJnp:
    """``jax.numpy`` for the reference's flow_crf module whose label argmax
    over [L, Hc, Wc] also appends its scores (prob - bias) to LABEL_SCORES,
    through a debug callback, so that it records under jit too."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def argmax(x, axis=None, **kwargs):
        if axis == 0 and jnp.ndim(x) == 3:
            jax.debug.callback(lambda v: LABEL_SCORES.append(np.asarray(v)), x)
        return jnp.argmax(x, axis=axis, **kwargs)


def near_ties(scores, cfg, shape, eps=TIE_EPS):
    """[H, W] pixels of the CRF cells whose label is a near-tie: the label is
    the argmax of ``scores`` = prob - bias, then the min_claim_prob floor on
    max(prob); a near-tie where the two best scores lie within ``eps`` or
    max(prob) within ``eps`` of the floor. Cells map to pixels by the
    reference's nearest upsample."""
    m = scores.shape[0] - 1
    prob = scores + 0.02 * np.concatenate([np.arange(m), [0]]).astype(np.float32)[:, None, None]
    top = np.sort(scores, axis=0)
    tie = (top[-1] - top[-2] < eps) | (np.abs(prob.max(0) - cfg.min_claim_prob) < eps)
    h, w = shape
    ys = np.clip((np.arange(h) * cfg.scale).astype(np.int32), 0, tie.shape[0] - 1)
    xs = np.clip((np.arange(w) * cfg.scale).astype(np.int32), 0, tie.shape[1] - 1)
    return tie[ys[:, None], xs[None, :]]


def reference_with_ties(args, cam, cfg, allow_new=True, pred_at_crf_scale=True):
    """(the reference's flow_crf_segmentation, its near-tie pixels)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jfc, "jnp", RecordingJnp())
    del LABEL_SCORES[:]
    try:
        ref = jax.jit(jfc.flow_crf_segmentation, static_argnames=(
            "cam", "cfg", "allow_new", "pred_at_crf_scale"))(
            *map(jnp.asarray, args), cam=cam, cfg=cfg, allow_new=allow_new,
            pred_at_crf_scale=pred_at_crf_scale)
        jax.effects_barrier()
    finally:
        mp.undo()
    (scores,) = LABEL_SCORES
    return ref, near_ties(scores, cfg, ref.mask.shape)


def run_both(s, jcfg, tcfg, allow_new=True):
    """(reference result, its near-tie pixels, port result) of the whole
    segmentation."""
    cam = J.CameraModel(**CAMK)
    ref, ties = reference_with_ties([s[k] for k in ("prev", "nxt", "depth", "pred", "active",
                                                    "txy", "vel", "valid")], cam, jcfg, allow_new)
    out = tfc.flow_crf_segmentation(_t(s["prev"]), _t(s["nxt"]), _t(s["depth"]), _t(s["pred"]),
                                    _t(s["active"]), _t(s["txy"]), _t(s["vel"]), _t(s["valid"]),
                                    tcfg, allow_new)
    return ref, ties, out


def check_segmentation(ref, ties, out):
    """Masks equal at every pixel but the reference's near-ties
    (``reference_with_ties``, TIE_EPS), has_new_label equal, pixel counts
    within 1 %, depth statistics within 1e-5 m; returns the share of pixels
    apart."""
    apart = ((out.mask.numpy() != np.asarray(ref.mask))
             | (out.new_label_mask.numpy() != np.asarray(ref.new_label_mask)))
    assert not (apart & ~ties).any(), (int(apart.sum()), int((apart & ~ties).sum()))
    assert bool(out.has_new_label) == bool(ref.has_new_label)
    rc, oc = np.asarray(ref.pixel_counts), out.pixel_counts.numpy()
    assert np.all(np.abs(oc - rc) <= np.maximum(0.01 * rc, 16)), (oc, rc)
    np.testing.assert_allclose(out.depth_mean.numpy(), np.asarray(ref.depth_mean), atol=1e-5)
    # the one-pass variance E[d^2] - mu^2 cancels: ~8 ulp of E[d^2] (6 m^2 at
    # 2.5 m) when the two libraries sum in another order
    np.testing.assert_allclose(out.depth_std.numpy() ** 2, np.asarray(ref.depth_std) ** 2,
                               atol=2e-5)
    np.testing.assert_allclose(out.flow.numpy(), np.asarray(ref.flow), atol=2e-3)
    return float(apart.mean())


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_crf_segmentation_matches_reference(seed):
    s = seg_inputs(seed)
    jcfg = J.SegmentationConfig(new_label_min_frac=0.01, min_mask_size_px=40)
    tcfg = T.SegmentationConfig(new_label_min_frac=0.01, min_mask_size_px=40)
    ref, ties, out = run_both(s, jcfg, tcfg)
    gap = check_segmentation(ref, ties, out)
    print("mask cells apart", gap, "has_new", bool(ref.has_new_label),
          "counts", np.asarray(ref.pixel_counts).tolist())
    assert len(np.unique(np.asarray(ref.mask))) >= 2
