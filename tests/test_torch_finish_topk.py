"""The hand-made inputs of K18's finish and K19's top-K, on the CPU: the
plain versions against the reference package, and the summation order the
card holds K18's statistics to.

On the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``'s phases
``finish_cases`` and ``topk_cases``) each kernel is held exact to its plain
version on these cases, and K18's depth mean and std bit-equal to
``checks.seg_stats_emulated``. Here:

- ``flow_crf.finish_plain`` on every ``checks.finish_cases`` case against
  the reference's finish: ``flow_crf_segmentation`` computes it inline
  (``multimotionfusion_tpu/segmentation/flow_crf.py:278-406``), so
  ``reference_finish`` repeats those lines with ``jax.numpy``, eagerly, on
  the same labels, kept components and CRF-scale depth. Masks,
  has_new_label and pixel counts equal; means within 1e-5 m and variances
  within 2e-5 m^2 (the tolerances of ``checks.check_seg_finish``). Each
  case is also what its name says (``checks.finish_case_facts``);
- ``seg_stats_emulated`` within the same tolerances of the plain version's
  statistics on every case, and bit-equal to a per-cell numpy float32 loop
  of the contract order (1,024 strided partials, then the halving tree) on
  a small grid;
- ``superpoint.nms_topk_plain`` on every ``checks.TOPK_CASES`` case against
  the reference's ``_nms_topk``, whose ``approx_max_k`` is the exact top-k
  on the CPU at these sizes, except where K is the pixel count: there it
  orders the zero scores otherwise, and the case is held to a stable numpy
  argsort of the peak scores instead.

No reference step is compiled; the reference's operations run eagerly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.tracking import superpoint as jsp
from multimotionfusion_tpu_torch.config import SegmentationConfig
from multimotionfusion_tpu_torch.kernels import checks
from multimotionfusion_tpu_torch.segmentation import flow_crf as tfc
from multimotionfusion_tpu_torch.tracking import superpoint as tsp
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FINISH = dict(checks.finish_cases("cpu"))
# the cases at which the reference's approx_max_k is not the stable top-k
TOPK_NUMPY = ("all_pixels",)


def reference_finish(lbl, largest_obj, frame_depth_c, h, w, cfg, allow_new):
    """``flow_crf_segmentation``'s lines 287-406 (the minimum-cells gate, the
    border test, the nearest upsample and the sigma-clipped statistics) on
    numpy inputs, with the reference's jax.numpy operations: (mask,
    new_label_mask, has_new_label, pixel_counts, depth_mean, depth_std)."""
    lbl, largest_obj, frame_depth_c = map(jnp.asarray, (lbl, largest_obj, frame_depth_c))
    hc, wc = lbl.shape
    m = largest_obj.shape[0]
    n_labels = m + 1
    counts = jnp.concatenate([
        jnp.sum((lbl == 0).astype(jnp.int32))[None],
        jnp.sum(largest_obj.reshape(n_labels - 1, -1).astype(jnp.int32), axis=1)])
    min_cells = max(1, int(round(cfg.min_mask_size_px * cfg.scale * cfg.scale)))
    obj_ok = counts >= min_cells
    for l in range(1, m):
        largest_obj = largest_obj.at[l - 1].set(largest_obj[l - 1] & obj_ok[l])
    counts = counts * jnp.concatenate([jnp.ones((1,), jnp.int32), obj_ok[1:m].astype(jnp.int32),
                                       jnp.ones((1,), jnp.int32)])
    segm = jnp.where(lbl == 0, jnp.int32(0), jnp.int32(-1))
    for l in range(1, n_labels):
        segm = jnp.where(largest_obj[l - 1], l, segm)
    new_comp = largest_obj[m - 1]
    yy = jnp.arange(hc, dtype=jnp.int32)[:, None]
    xx = jnp.arange(wc, dtype=jnp.int32)[None, :]
    top = jnp.min(jnp.where(new_comp, yy, hc))
    bottom = jnp.max(jnp.where(new_comp, yy, -1))
    left = jnp.min(jnp.where(new_comp, xx, wc))
    right = jnp.max(jnp.where(new_comp, xx, -1))
    b = max(1, int(round(20 * cfg.scale)))
    at_border = (((top < b) & (bottom < b)) | ((left < b) & (right < b))
                 | ((top > hc - 1 - b) & (bottom > hc - 1 - b))
                 | ((left > wc - 1 - b) & (right > wc - 1 - b)))
    has_new = (jnp.asarray(allow_new)
               & ((counts[m].astype(jnp.float32) / (hc * wc)) > cfg.new_label_min_frac)
               & ~at_border)
    if h == hc * (h // hc) and w == wc * (w // wc) and h // hc == w // wc:
        k = h // hc
        full = jnp.broadcast_to(segm[:, None, :, None], (hc, k, wc, k)).reshape(h, w)
    else:
        ys = jnp.clip((jnp.arange(h) * cfg.scale).astype(jnp.int32), 0, hc - 1)
        xs = jnp.clip((jnp.arange(w) * cfg.scale).astype(jnp.int32), 0, wc - 1)
        full = segm[ys[:, None], xs[None, :]]
    new_mask = full == m
    mask = jnp.where((full < 0) | (full == m), 0, full)
    scale_w = 1.0 / (cfg.scale * cfg.scale)
    pix_counts = (counts[:m].astype(jnp.float32) * scale_w).astype(jnp.int32)
    depth_ok = frame_depth_c > 1e-6
    lbl_stack = jnp.stack([(segm == l) & depth_ok for l in range(m + 1)])

    def _stats(sel):
        cnt = jnp.sum(sel, axis=(1, 2))
        n = jnp.maximum(cnt, 1.0)
        mu = jnp.sum(jnp.where(sel, frame_depth_c[None], 0.0), axis=(1, 2)) / n
        var = jnp.sum(jnp.where(sel, frame_depth_c[None] ** 2, 0.0), axis=(1, 2)) / n - mu ** 2
        return mu, jnp.sqrt(jnp.maximum(var, 0.0))

    sel0 = lbl_stack.astype(jnp.float32)
    mu0, sd0 = _stats(sel0)
    band = jnp.maximum(1.2 * sd0, 0.05)
    lo, hi = (mu0 - band)[:, None, None], (mu0 + band)[:, None, None]
    sel1 = sel0 * ((frame_depth_c[None] >= lo) & (frame_depth_c[None] <= hi)).astype(jnp.float32)
    mean, std = _stats(sel1)
    return tuple(np.asarray(v) for v in (mask, new_mask, has_new, pix_counts, mean, std))


def _assert_stats_close(mean, std, ref_mean, ref_std):
    np.testing.assert_allclose(np.asarray(mean), np.asarray(ref_mean), rtol=0, atol=1e-5)
    # the one-pass variance E[d^2] - mu^2 cancels: ~8 ulp of E[d^2] (9 m^2 at
    # 3 m) when the two sum in another order
    np.testing.assert_allclose(np.asarray(std) ** 2, np.asarray(ref_std) ** 2, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", checks.FINISH_CASES)
def test_finish_plain_matches_reference(name):
    a = FINISH[name]
    lbl, largest, sizes, fd, h, w, cfg, allow_new = a
    out = tfc.finish_plain(*a)
    ref = reference_finish(lbl.numpy(), largest.numpy(), fd.numpy(), h, w, cfg, allow_new)
    for field, o, r in zip(("mask", "new_label_mask", "has_new_label", "pixel_counts"), out[:4],
                           ref[:4]):
        np.testing.assert_array_equal(o.numpy(), r, err_msg=field)
    _assert_stats_close(out[4], out[5], ref[4], ref[5])
    facts = checks.finish_case_facts(name, a, out)
    assert facts["ok"], facts


@pytest.mark.parametrize("name", checks.FINISH_CASES)
def test_stats_emulation_within_plain(name):
    a = FINISH[name]
    out = tfc.finish_plain(*a)
    mean, std = checks.seg_stats_emulated(*a[:4], a[6])
    _assert_stats_close(mean, std, out[4], out[5])


def _contract_loop(segm: np.ndarray, fd: np.ndarray, m: int):
    """The contract order cell by cell in numpy float32: partial t sums its
    cells t, t + 1024, ... of each segment, then the halving tree."""
    f = np.float32
    seg, d = segm.reshape(-1), fd.reshape(-1).astype(f)
    lo = hi = None
    for clip in (False, True):
        red = np.zeros((m + 1, 3, 1024), f)
        for t in range(1024):
            for c in range(t, seg.size, 1024):
                l = seg[c]
                if l < 0 or not d[c] > f(1e-6):
                    continue
                if clip and not (lo[l] <= d[c] <= hi[l]):
                    continue
                red[l, 0, t] = f(red[l, 0, t] + f(1.0))
                red[l, 1, t] = f(red[l, 1, t] + d[c])
                red[l, 2, t] = f(red[l, 2, t] + f(d[c] * d[c]))
        s = 512
        while s >= 1:
            red[:, :, :s] = red[:, :, :s] + red[:, :, s:2 * s]
            s //= 2
        n = np.maximum(red[:, 0, 0], f(1.0))
        mu = red[:, 1, 0] / n
        var = red[:, 2, 0] / n - mu * mu
        sd = np.sqrt(np.maximum(var, f(0.0)))
        band = np.maximum(f(1.2) * sd, f(0.05))
        lo, hi = mu - band, mu + band
    return mu, sd


def test_stats_emulation_is_the_contract_order():
    """On a 30x45 grid (1,350 cells: the partials below 326 sum two cells),
    three labels, a gated one and depth with holes and outliers."""
    rng = np.random.default_rng(3)
    hc, wc, m = 30, 45, 3
    cfg = SegmentationConfig(new_label_min_frac=0.01)
    lbl = rng.integers(0, m + 1, (hc, wc)).astype(np.int32)
    largest = np.stack([lbl == l for l in range(1, m + 1)])
    largest[0, :, :20] = False  # label 1's cells there outside its component
    sizes = largest.reshape(m, -1).sum(1).astype(np.int32)
    sizes[1] = 3  # label 2 under the minimum-cells gate
    fd = (rng.normal(2.0, 0.3, (hc, wc)) + 1.5 * (rng.random((hc, wc)) < 0.1)).astype(np.float32)
    fd[rng.random((hc, wc)) < 0.1] = 0.0
    t = torch.from_numpy
    mean, std = checks.seg_stats_emulated(t(lbl), t(largest), t(sizes), t(fd), cfg)
    segm = checks.segment_ids(t(lbl), t(largest), t(sizes), cfg).numpy()
    assert (segm == -1).any() and not (segm == 2).any()
    mu, sd = _contract_loop(segm, fd, m)
    assert mean.numpy().tobytes() == mu.tobytes()
    assert std.numpy().tobytes() == sd.tobytes()


def _numpy_topk(heat: np.ndarray, k: int, thr: float, r: int):
    """The exact top-k of the max-window peak scores: a stable descending
    argsort (ties to the lower flat index)."""
    h, w = heat.shape
    pad = np.pad(heat, r, constant_values=-np.inf)
    local = np.full_like(heat, -np.inf)
    for oy in range(2 * r + 1):
        for ox in range(2 * r + 1):
            local = np.maximum(local, pad[oy:oy + h, ox:ox + w])
    scores = np.where((heat == local) & (heat > np.float32(thr)), heat, np.float32(0)).reshape(-1)
    idx = np.argsort(-scores, kind="stable")[:k]
    top = scores[idx]
    return np.stack([idx % w, idx // w], -1).astype(np.float32), top, top > 0


@pytest.mark.parametrize("name,kind,h,w", checks.TOPK_CASES, ids=[c[0] for c in checks.TOPK_CASES])
def test_topk_plain_matches_reference(name, kind, h, w):
    a = checks.nms_inputs(kind, h, w, "cpu")
    heat, k, thr, r = a
    out = tsp.nms_topk_plain(*a)
    if name in TOPK_NUMPY:
        ref = _numpy_topk(heat.numpy(), k, thr, r)
    else:
        ref = tuple(np.asarray(v) for v in jsp._nms_topk(jnp.asarray(heat.numpy()), k, thr, r))
    for field, o, e in zip(("xy", "score", "valid"), out, ref):
        np.testing.assert_array_equal(o.numpy(), e, err_msg=field)
    facts = checks.topk_case_facts(name, a, out)
    assert facts["ok"], facts
