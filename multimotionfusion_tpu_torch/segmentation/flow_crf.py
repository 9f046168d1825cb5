"""Flow-CRF motion segmentation (the MultiMotionFusion contribution; K18
and the chain of K13, K15-K17 around it).

Port of the reference package's ``segmentation/flow_crf.py``. Per frame, at
the CRF scale (1/4):

1. dense flow prev -> next (K15, ``flow.py``);
2. ``unaries`` (K18, first stage): the frame depth sampled at each cell's
   centre; per model the raw reprojection fit exp(-|depth error| / 0.03)
   where the model's CRF-scale depth (K13) covers the cell, the outlier row
   1 - best fit where the observation lies in front of every covering model,
   the ``behind`` flags; the sparse track errors (0 match, 1 mismatch, +inf
   unknown) scattered to their cells by a min, softmax -> -log;
3. ``crf.mean_field`` (K16) with the Gaussian and the flow-bilateral kernel;
4. ``fuse_labels`` (K18, second stage): the CRF posterior times the flow
   ramp fused with the gated reprojection probability, object rows zeroed
   where the observation lies behind them, inactive labels out, the first
   argmax of prob - 0.02 * model id and the minimum-claim floor; the label
   stack of every non-global label;
5. ``components.keep_largest_components_batched`` (K17);
6. ``finish`` (K18, third stage): the minimum-cells gate, the border test of
   the new label's bounding box, ``has_new_label``, the nearest upsample to
   full resolution, pixel counts and the sigma-clipped depth statistics of
   every segment (two passes).

Each stage's wrapper launches ``csrc/segment.cu`` for CUDA tensors and takes
its plain PyTorch version (``*_plain``) only for CPU tensors. Every output
stays on the device: ``has_new_label`` and the counts feed the lifecycle's
``torch.where``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import SegmentationConfig
from multimotionfusion_tpu_torch.ops.image import div, resize_bilinear
from multimotionfusion_tpu_torch.segmentation import components, crf, flow as flow_mod

F32 = torch.float32
I32 = torch.int32
_INF = float("inf")


class SegmentationResult(NamedTuple):
    mask: torch.Tensor  # [H, W] int32 model-slot ids at full resolution
    new_label_mask: torch.Tensor  # [H, W] bool: pixels of the prospective new model
    has_new_label: torch.Tensor  # [] bool
    pixel_counts: torch.Tensor  # [M] int32 per model (largest component, full-res pixels)
    depth_mean: torch.Tensor  # [M + 1] mean frame depth per segment (index M = the new label)
    depth_std: torch.Tensor  # [M + 1]
    flow: Optional[torch.Tensor] = None  # [Hc, Wc, 2] the flow (None for external masks)


class Unaries(NamedTuple):
    frame_depth_c: torch.Tensor  # [Hc, Wc] frame depth at the cell centres
    p_proj: torch.Tensor  # [L, Hc, Wc] reprojection probability (row M: outlier)
    behind: torch.Tensor  # [M, Hc, Wc] bool: observed behind a covering model
    unary: torch.Tensor  # [L, Hc, Wc] -log of the sparse unary softmax


def crf_params(cfg: SegmentationConfig) -> crf.CrfParams:
    return crf.CrfParams(cfg.pairwise_gaussian_sigma, 4.0 * cfg.pairwise_gaussian_weight,
                         cfg.pairwise_flow_sigma_xy, 10.0 * cfg.pairwise_flow_sigma_v,
                         cfg.pairwise_flow_weight)


def _factors(h: int, w: int, hc: int, wc: int):
    """(ky, kx) when the CRF grid divides the image evenly, else None."""
    if h == hc * (h // hc) and w == wc * (w // wc):
        return h // hc, w // wc
    return None


# ---------------------------------------------------------------- plain twins

def cell_depth(frame_depth: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """Frame depth at CRF scale: each cell's centre sample (never an average
    across a depth edge), or a bilinear resize where the grid does not divide
    the image."""
    h, w = frame_depth.shape
    f = _factors(h, w, hc, wc)
    if f is None:
        return resize_bilinear(frame_depth, (hc, wc))
    ky, kx = f
    return frame_depth.reshape(hc, ky, wc, kx)[:, ky // 2, :, kx // 2]


def reprojection_probability(fd: torch.Tensor, pred: torch.Tensor, active: torch.Tensor,
                             max_err: float):
    """(per-model raw fit [M, Hc, Wc], outlier row [Hc, Wc], behind [M, Hc, Wc])."""
    dist = torch.abs(fd[None] - pred)
    invalid = torch.any((fd[None] < 1e-6) & (pred < 1e-6), dim=0)
    raw = torch.exp(div(-dist, max_err))
    zero = torch.zeros_like(raw)
    raw = torch.where(pred > 1e-6, raw, zero)
    prob = torch.where(invalid[None], zero, raw * active[:, None, None].to(F32))
    best_fit = torch.max(prob, dim=0).values
    covered = (pred > 1e-6) & active[:, None, None]
    behind = covered & (fd[None] > pred + max_err)
    in_front = ~torch.any(behind, dim=0)
    any_cover = torch.any(covered, dim=0)
    z = torch.zeros_like(fd)
    outlier = torch.where(invalid | ~in_front | ~any_cover, z, 1.0 - best_fit)
    outlier = torch.where(fd > 1e-6, outlier, z)
    return prob, outlier, behind


def sparse_unary(track_xy, track_vel, track_valid, active, hc: int, wc: int, scale: float,
                 threshold: float, allow_new: bool) -> torch.Tensor:
    """[L, Hc, Wc] unary errors: 0 match / 1 mismatch / +inf unknown (the
    outlier class last); several tracks in one cell take the minimum."""
    dev = track_vel.device
    m, t = track_vel.shape
    inf = torch.full((m, t), _INF, dtype=F32, device=dev)
    err_active = torch.where(track_valid[None] & active[:, None],
                             (track_vel > threshold).to(F32), inf)
    fits_any = torch.any((track_vel < threshold) & active[:, None], dim=0)
    known = torch.all(~active[:, None] | torch.isfinite(track_vel), dim=0)
    err_out = torch.where(track_valid & known, fits_any.to(F32), inf[0])
    if not allow_new:
        err_out = inf[0]
    err = torch.cat([err_active, err_out[None]], dim=0)
    xi = torch.clamp(torch.round(track_xy[:, 0] * scale).to(torch.int64), 0, wc - 1)
    yi = torch.clamp(torch.round(track_xy[:, 1] * scale).to(torch.int64), 0, hc - 1)
    pix = torch.where(track_valid, yi * wc + xi, torch.full_like(xi, hc * wc))
    unary = torch.full((m + 1, hc * wc + 1), _INF, dtype=F32, device=dev)
    unary.scatter_reduce_(1, pix[None].expand(m + 1, t), err, reduce="amin", include_self=True)
    return unary[:, : hc * wc].reshape(m + 1, hc, wc)


def neg_log_softmax_errors(err: torch.Tensor) -> torch.Tensor:
    """-log of the softmax over -errors; all-unknown cells are uniform."""
    n = err.shape[0]
    e = torch.exp(-err)
    esum = e[0]
    for i in range(1, n):
        esum = esum + e[i]
    probs = torch.where(esum[None] > 0, e / torch.clamp(esum[None], min=1e-12),
                        torch.full_like(e, 1.0 / n))
    return -torch.log(torch.clamp(probs, min=1e-12))


def unaries_plain(frame_depth, pred_c, active, track_xy, track_vel, track_valid,
                  cfg: SegmentationConfig, allow_new: bool) -> Unaries:
    """Plain PyTorch K18, first stage."""
    m, hc, wc = pred_c.shape
    fd = cell_depth(frame_depth, hc, wc)
    prob, outlier, behind = reprojection_probability(fd, pred_c, active, cfg.sigma_depth)
    err = sparse_unary(track_xy, track_vel, track_valid, active, hc, wc, cfg.scale,
                       cfg.velocity_threshold, allow_new)
    return Unaries(fd, torch.cat([prob, outlier[None]], dim=0), behind,
                   neg_log_softmax_errors(err))


def fuse_labels_plain(q, flow, p_proj, behind, active, cfg: SegmentationConfig, allow_new: bool):
    """Plain PyTorch K18, second stage: (labels [Hc, Wc] int32, the stack of
    labels 1..M [M, Hc, Wc] bool)."""
    n_labels, hc, wc = q.shape
    m = n_labels - 1
    dev = q.device
    magn = torch.sqrt(flow[..., 0] * flow[..., 0] + flow[..., 1] * flow[..., 1])
    ramp = torch.clamp(div(magn - cfg.flow_ramp_lo, cfg.flow_ramp_hi - cfg.flow_ramp_lo), 0.0, 1.0)
    p_flow = q * ramp[None]
    zero = torch.zeros_like(p_proj)
    p_proj_g = torch.where(p_proj < 0.3, zero, p_proj)
    prob = 1.0 - (1.0 - p_flow) * (1.0 - p_proj_g)
    rows = torch.zeros((1, hc, wc), dtype=torch.bool, device=dev)
    obj_behind = torch.cat([rows, behind[1:], rows], dim=0)
    prob = torch.where(obj_behind, zero, prob)
    label_ok = torch.cat([active, torch.tensor([allow_new], device=dev)])
    prob = torch.where(label_ok[:, None, None], prob, torch.full_like(prob, -1.0))
    bias = 0.02 * torch.cat([torch.arange(m, dtype=F32, device=dev),
                             torch.zeros((1,), dtype=F32, device=dev)])
    lbl = torch.argmax(prob - bias[:, None, None], dim=0).to(I32)
    best = torch.max(prob, dim=0).values
    lbl = torch.where((lbl > 0) & (best < cfg.min_claim_prob), torch.zeros_like(lbl), lbl)
    ids = torch.arange(1, n_labels, dtype=I32, device=dev)[:, None, None]
    return lbl, lbl[None] == ids


def _segm(lbl, largest):
    """[Hc, Wc] int32: 0 for global cells, l on label l's kept component, -1
    elsewhere."""
    segm = torch.where(lbl == 0, torch.zeros_like(lbl), torch.full_like(lbl, -1))
    for l in range(1, largest.shape[0] + 1):
        segm = torch.where(largest[l - 1], torch.full_like(segm, l), segm)
    return segm


def _upsample(segm: torch.Tensor, h: int, w: int, scale: float) -> torch.Tensor:
    hc, wc = segm.shape
    f = _factors(h, w, hc, wc)
    if f is not None and f[0] == f[1]:
        k = f[0]
        return segm[:, None, :, None].expand(hc, k, wc, k).reshape(h, w)
    dev = segm.device
    ys = torch.clamp((torch.arange(h, device=dev) * scale).to(torch.int64), 0, hc - 1)
    xs = torch.clamp((torch.arange(w, device=dev) * scale).to(torch.int64), 0, wc - 1)
    return segm[ys[:, None], xs[None, :]]


def _stats(sel: torch.Tensor, fd: torch.Tensor):
    cnt = torch.sum(sel, dim=(1, 2))
    n = torch.clamp(cnt, min=1.0)
    zero = torch.zeros_like(sel)
    mu = torch.sum(torch.where(sel != 0, fd[None].expand_as(sel), zero), dim=(1, 2)) / n
    var = torch.sum(torch.where(sel != 0, (fd * fd)[None].expand_as(sel), zero), dim=(1, 2)) / n \
        - mu * mu
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


def finish_plain(lbl, largest, sizes, fd, h: int, w: int, cfg: SegmentationConfig,
                 allow_new: bool):
    """Plain PyTorch K18, third stage: (mask, new_label_mask, has_new_label,
    pixel counts [M], depth mean [M + 1], depth std [M + 1])."""
    m = largest.shape[0]
    hc, wc = lbl.shape
    dev = lbl.device
    counts = torch.cat([torch.sum((lbl == 0).to(I32))[None], sizes.to(I32)])
    min_cells = max(1, int(round(cfg.min_mask_size_px * cfg.scale * cfg.scale)))
    obj_ok = counts >= min_cells
    gate = torch.cat([obj_ok[1:m], torch.ones((1,), dtype=torch.bool, device=dev)])
    largest = largest & gate[:, None, None]
    one = torch.ones((1,), dtype=I32, device=dev)
    counts = counts * torch.cat([one, obj_ok[1:m].to(I32), one])
    segm = _segm(lbl, largest)

    new_comp = largest[m - 1]
    yy = torch.arange(hc, dtype=I32, device=dev)[:, None].expand(hc, wc)
    xx = torch.arange(wc, dtype=I32, device=dev)[None, :].expand(hc, wc)
    top = torch.min(torch.where(new_comp, yy, torch.full_like(yy, hc)))
    bottom = torch.max(torch.where(new_comp, yy, torch.full_like(yy, -1)))
    left = torch.min(torch.where(new_comp, xx, torch.full_like(xx, wc)))
    right = torch.max(torch.where(new_comp, xx, torch.full_like(xx, -1)))
    b = max(1, int(round(20 * cfg.scale)))
    at_border = (((top < b) & (bottom < b)) | ((left < b) & (right < b))
                 | ((top > hc - 1 - b) & (bottom > hc - 1 - b))
                 | ((left > wc - 1 - b) & (right > wc - 1 - b)))
    frac = div(counts[m].to(F32), float(hc * wc))
    has_new = (frac > cfg.new_label_min_frac) & ~at_border
    if not allow_new:
        has_new = has_new & False

    full = _upsample(segm, h, w, cfg.scale)
    new_mask = full == m
    mask = torch.where((full < 0) | new_mask, torch.zeros_like(full), full)
    scale_w = 1.0 / (cfg.scale * cfg.scale)
    pix_counts = (counts[:m].to(F32) * scale_w).to(I32)

    ids = torch.arange(m + 1, dtype=I32, device=dev)[:, None, None]
    sel0 = ((segm[None] == ids) & (fd > 1e-6)[None]).to(F32)
    mu0, sd0 = _stats(sel0, fd)
    band = torch.clamp(1.2 * sd0, min=0.05)
    lo, hi = (mu0 - band)[:, None, None], (mu0 + band)[:, None, None]
    sel1 = sel0 * ((fd[None] >= lo) & (fd[None] <= hi)).to(F32)
    mean, std = _stats(sel1, fd)
    return mask, new_mask, has_new, pix_counts, mean, std


# ---------------------------------------------------------------- kernels

def _check_all(**tensors):
    for name, (t, dtype) in tensors.items():
        K.check(t, dtype, name)


def unaries_cuda(frame_depth, pred_c, active, track_xy, track_vel, track_valid,
                 cfg: SegmentationConfig, allow_new: bool) -> Unaries:
    """K18 first stage on the card: ``csrc/segment.cu`` ``mmf_seg_unaries``."""
    _check_all(frame_depth=(frame_depth, F32), pred_c=(pred_c, F32), active=(active, torch.bool),
               track_xy=(track_xy, F32), track_vel=(track_vel, F32),
               track_valid=(track_valid, torch.bool))
    m, hc, wc = pred_c.shape
    h, w = frame_depth.shape
    if _factors(h, w, hc, wc) is None:
        raise NotImplementedError("csrc/segment.cu samples cell centres: the CRF grid must "
                                  "divide the image")
    t = track_vel.shape[1]
    dev = pred_c.device
    fd = torch.empty((hc, wc), dtype=F32, device=dev)
    p_proj = torch.empty((m + 1, hc, wc), dtype=F32, device=dev)
    behind = torch.empty((m, hc, wc), dtype=torch.bool, device=dev)
    err = torch.empty((m + 1, hc, wc), dtype=F32, device=dev)
    unary = torch.empty((m + 1, hc, wc), dtype=F32, device=dev)
    f = K.fn("segment", "mmf_seg_unaries", [K.P, K.I, K.I, K.P, K.I, K.I, K.I, K.P, K.P, K.P,
                                            K.P, K.I, K.F, K.F, K.I, K.F] + [K.P] * 5)
    K.call("segment.unaries", f, K.ptr(frame_depth), h, w, K.ptr(pred_c), m, hc, wc,
           K.ptr(active), K.ptr(track_xy), K.ptr(track_vel), K.ptr(track_valid), t,
           float(cfg.scale), float(cfg.velocity_threshold), int(allow_new),
           float(cfg.sigma_depth), K.ptr(fd), K.ptr(p_proj), K.ptr(behind), K.ptr(err),
           K.ptr(unary))
    return Unaries(fd, p_proj, behind, unary)


def fuse_labels_cuda(q, flow, p_proj, behind, active, cfg: SegmentationConfig, allow_new: bool):
    """K18 second stage on the card: ``csrc/segment.cu`` ``mmf_seg_fuse``."""
    _check_all(q=(q, F32), flow=(flow, F32), p_proj=(p_proj, F32), behind=(behind, torch.bool),
               active=(active, torch.bool))
    n_labels, hc, wc = q.shape
    m = n_labels - 1
    dev = q.device
    lbl = torch.empty((hc, wc), dtype=I32, device=dev)
    stack = torch.empty((m, hc, wc), dtype=torch.bool, device=dev)
    f = K.fn("segment", "mmf_seg_fuse", [K.P] * 5 + [K.I] * 4 + [K.F] * 3 + [K.P] * 2)
    K.call("segment.fuse", f, K.ptr(q), K.ptr(flow), K.ptr(p_proj), K.ptr(behind), K.ptr(active),
           m, hc, wc, int(allow_new), float(cfg.flow_ramp_lo),
           float(cfg.flow_ramp_hi - cfg.flow_ramp_lo), float(cfg.min_claim_prob), K.ptr(lbl),
           K.ptr(stack))
    return lbl, stack


def finish_cuda(lbl, largest, sizes, fd, h: int, w: int, cfg: SegmentationConfig,
                allow_new: bool):
    """K18 third stage on the card: ``csrc/segment.cu`` ``mmf_seg_finish``."""
    _check_all(lbl=(lbl, I32), largest=(largest, torch.bool), sizes=(sizes, I32), fd=(fd, F32))
    m = largest.shape[0]
    hc, wc = lbl.shape
    dev = lbl.device
    mask = torch.empty((h, w), dtype=I32, device=dev)
    new_mask = torch.empty((h, w), dtype=torch.bool, device=dev)
    has_new = torch.empty((), dtype=torch.bool, device=dev)
    pix_counts = torch.empty((m,), dtype=I32, device=dev)
    mean = torch.empty((m + 1,), dtype=F32, device=dev)
    std = torch.empty((m + 1,), dtype=F32, device=dev)
    f = K.fn("segment", "mmf_seg_finish", [K.P] * 4 + [K.I] * 8 + [K.F] * 3 + [K.P] * 6)
    K.call("segment.finish", f, K.ptr(lbl), K.ptr(largest), K.ptr(sizes), K.ptr(fd), m, hc, wc,
           h, w, int(allow_new), max(1, int(round(cfg.min_mask_size_px * cfg.scale * cfg.scale))),
           max(1, int(round(20 * cfg.scale))), float(cfg.new_label_min_frac),
           1.0 / (cfg.scale * cfg.scale), float(cfg.scale), K.ptr(mask), K.ptr(new_mask),
           K.ptr(has_new), K.ptr(pix_counts), K.ptr(mean), K.ptr(std))
    return mask, new_mask, has_new, pix_counts, mean, std


def unaries(frame_depth, pred_c, active, track_xy, track_vel, track_valid,
            cfg: SegmentationConfig, allow_new: bool) -> Unaries:
    K.record("segment.unaries", frame_depth=frame_depth, pred_c=pred_c, active=active,
             track_xy=track_xy, track_vel=track_vel, track_valid=track_valid, cfg=cfg,
             allow_new=allow_new)
    impl = unaries_cuda if pred_c.is_cuda else unaries_plain
    return impl(frame_depth, pred_c, active, track_xy, track_vel, track_valid, cfg, allow_new)


def fuse_labels(q, flow, p_proj, behind, active, cfg: SegmentationConfig, allow_new: bool):
    K.record("segment.fuse", q=q, flow=flow, p_proj=p_proj, behind=behind, active=active,
             cfg=cfg, allow_new=allow_new)
    impl = fuse_labels_cuda if q.is_cuda else fuse_labels_plain
    return impl(q, flow, p_proj, behind, active, cfg, allow_new)


def finish(lbl, largest, sizes, fd, h: int, w: int, cfg: SegmentationConfig, allow_new: bool):
    K.record("segment.finish", lbl=lbl, largest=largest, sizes=sizes, fd=fd, h=h, w=w, cfg=cfg,
             allow_new=allow_new)
    impl = finish_cuda if lbl.is_cuda else finish_plain
    return impl(lbl, largest, sizes, fd, h, w, cfg, allow_new)


def flow_crf_segmentation(prev_intensity, next_intensity, frame_depth, pred_c, model_active,
                          track_xy, track_vel, track_valid, cfg: SegmentationConfig,
                          allow_new: bool = True, span=None) -> SegmentationResult:
    """The flow-CRF segmentation of one frame from the full-resolution
    intensities and filtered depth [H, W] and the per-model CRF-scale
    predicted depth ``pred_c`` [M, Hc, Wc] (K13). ``span(name)`` names the
    stages (flow, unaries, crf, components) for a profiler."""
    span = span or (lambda name: contextlib.nullcontext())
    h, w = frame_depth.shape
    hc, wc = pred_c.shape[1:]
    with span("flow"):  # K15
        flow = flow_mod.dense_flow(prev_intensity, next_intensity, hc, wc)
    with span("unaries"):  # K18
        un = unaries(frame_depth, pred_c, model_active, track_xy, track_vel, track_valid, cfg,
                     allow_new)
    with span("crf"):  # K16
        q = crf.mean_field(un.unary, flow, crf_params(cfg), cfg.crf_iterations)
    with span("components"):  # K18, K17, K18
        lbl, stack = fuse_labels(q, flow, un.p_proj, un.behind, model_active, cfg, allow_new)
        largest, sizes = components.keep_largest_components_batched(stack)
        mask, new_mask, has_new, pix, mean, std = finish(lbl, largest, sizes, un.frame_depth_c,
                                                          h, w, cfg, allow_new)
    return SegmentationResult(mask, new_mask, has_new, pix, mean, std, flow)
