"""Legacy CoFusion CRF segmentation, ICP-error driven (kernel K24c).

Port of the reference package's ``segmentation/legacy_crf.py``
(Segmentation::performSegmentationCRF, the pre-flow-CRF mode of
``segmentation.mode="crf"``): SLIC superpixels (K24a) -> the superpixel means
of the depth and of every model's ICP error and confidence images (K24b) ->
per-superpixel unaries from the confidence-gated ICP errors plus a new-model
class -> an exact dense CRF over the superpixels (a Gaussian smoothness
kernel over (x, y) and a 6-D (x, y, r, g, b, depth) appearance kernel, both
without self-messages and normalised symmetrically; Potts mean field) ->
first-index argmax -> the labels back on the pixels (K24b) -> the largest
component of each label at full resolution (K17) -> the new label's size
gates.

- ``crf_plan`` (K24c, ``csrc/legacy_crf.cu`` ``mmf_lcrf_plan``, two
  launches): the depth range (min / max, exact in any order), the gates, the
  unaries with their clamps, the features, both [S, S] kernel matrices with
  their row sums and symmetric normalisation, and Q0 = softmax(-unary);
- ``mean_field`` (K24c ``mmf_lcrf_mean_field``, through
  ``crf_mean_field_cuda``): every mean-field step in one cooperative
  launch, both [S, S] x [S, L] products in the kernel, Q after each step and
  the last step's first-index argmax;
- ``crf_iterate_cuda`` (K24c ``mmf_lcrf_iterate``): one step, for the checks.

Each wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version (``*_plain``, the reference's expressions in its order;
``torch.matmul`` for the products) only for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import SegmentationConfig
from multimotionfusion_tpu_torch.segmentation import components, slic as slic_mod

F32 = torch.float32
I32 = torch.int32
UNARY_THRESHOLD_NEW = 5.0
UNARY_K_ERROR = 0.01
UNARY_WEIGHT_ERROR = 40.0
SCALE_POS = 1.0 / 8.0
SCALE_RGB = 1.0 / 30.0
SCALE_DEPTH = 1.0 / 0.4
WEIGHT_SMOOTHNESS = 40.0
WEIGHT_APPEARANCE = 40.0
MAX_LABELS = 16  # the widest label axis csrc/legacy_crf.cu holds in registers


class LegacyCrfResult(NamedTuple):
    mask: torch.Tensor  # [H, W] int32 model indices (labels < M)
    new_label_mask: torch.Tensor  # [H, W] bool
    has_new_label: torch.Tensor  # [] bool
    pixel_counts: torch.Tensor  # [M] per model (largest component)
    slic_labels: torch.Tensor  # [H, W]


class CrfPlan(NamedTuple):
    unary: torch.Tensor  # [S, L]
    feat: torch.Tensor  # [S, 6]
    k_smooth: torch.Tensor  # [S, S] normalised, no self-messages
    k_app: torch.Tensor  # [S, S]
    q0: torch.Tensor  # [S, L] softmax(-unary)


# ---------------------------------------------------------------- plain twins

def crf_inputs_plain(lows: torch.Tensor, mean_color: torch.Tensor, mean_xy: torch.Tensor,
                     active: torch.Tensor, allow_new: bool):
    """(unary [S, L], features [S, 6]) from the superpixel means ``lows``
    ([1 + 2M, S]: depth, M ICP errors, M confidences; legacy_crf.py:104-139)."""
    m = active.shape[0]
    low_depth, low_icp, low_conf = lows[0], lows[1:1 + m], lows[1 + m:1 + 2 * m]
    depth_range = torch.clamp(torch.max(low_depth) - torch.min(low_depth), min=1e-3)
    gate_val = depth_range * UNARY_K_ERROR
    icp0 = torch.where(low_conf[0] < 0.3, gate_val, low_icp[0])
    rest = torch.where(low_conf[1:] <= 0.4, gate_val, low_icp[1:])
    low_icp = torch.cat([icp0[None], rest], dim=0)
    inf = torch.full_like(low_icp, float("inf"))
    err = torch.where(active[:, None], low_icp / depth_range, inf)
    unary_models = UNARY_WEIGHT_ERROR * err
    lowest = torch.min(torch.where(active[:, None], err, inf), dim=0).values
    unary_new = torch.clamp(UNARY_THRESHOLD_NEW - UNARY_WEIGHT_ERROR * lowest, min=0.01)
    if not allow_new:
        unary_new = torch.full_like(unary_new, float("inf"))
    unary = torch.cat([unary_models, unary_new[None]], dim=0).T
    unary = torch.clamp(torch.nan_to_num(unary, posinf=1e5), max=1e5)
    unary = torch.clamp(unary, min=1e-5).contiguous()
    feat = torch.cat([mean_xy * SCALE_POS, mean_color * SCALE_RGB,
                      torch.clamp(low_depth * SCALE_DEPTH, max=100.0)[:, None]], dim=-1)
    return unary, feat.contiguous()


def crf_kernels_plain(feat: torch.Tensor):
    """The two [S, S] kernels (legacy_crf.py:62-80)."""
    xy = feat[:, :2] * (SCALE_POS / (1.0 / 8.0)) / 2.0  # sigma 2 in superpixel units
    dxy = xy[:, None] - xy[None]
    k_smooth = torch.exp(-0.5 * (dxy[..., 0] * dxy[..., 0] + dxy[..., 1] * dxy[..., 1]))
    df = feat[:, None] - feat[None]
    sq = df * df
    d_f = sq[..., 0]
    for k in range(1, feat.shape[1]):
        d_f = d_f + sq[..., k]
    k_app = torch.exp(-0.5 * d_f)
    eye = torch.eye(feat.shape[0], dtype=F32, device=feat.device)
    out = []
    for k in (k_smooth - eye, k_app - eye):
        d = 1.0 / torch.sqrt(torch.clamp(torch.sum(k, dim=1), min=1e-12))
        out.append(k * d[:, None] * d[None, :])
    return out[0], out[1]


def crf_plan_plain(lows, mean_color, mean_xy, active, allow_new: bool) -> CrfPlan:
    unary, feat = crf_inputs_plain(lows, mean_color, mean_xy, active, allow_new)
    ks, ka = crf_kernels_plain(feat)
    return CrfPlan(unary, feat, ks, ka, torch.softmax(-unary, dim=-1))


def crf_iterate_plain(q: torch.Tensor, plan: CrfPlan) -> torch.Tensor:
    """One Potts mean-field step (legacy_crf.py:79-84)."""
    msg = WEIGHT_SMOOTHNESS * torch.matmul(plan.k_smooth, q) + WEIGHT_APPEARANCE * torch.matmul(
        plan.k_app, q)
    pairwise = torch.sum(msg, dim=-1, keepdim=True) - msg
    return torch.softmax(-plan.unary - pairwise, dim=-1)


def superpixel_crf_plain(unary: torch.Tensor, feat: torch.Tensor, iters: int) -> torch.Tensor:
    """The reference's ``_superpixel_crf``: Q [S, L] after ``iters`` steps."""
    ks, ka = crf_kernels_plain(feat)
    plan = CrfPlan(unary, feat, ks, ka, torch.softmax(-unary, dim=-1))
    q = plan.q0
    for _ in range(iters):
        q = crf_iterate_plain(q, plan)
    return q


# ---------------------------------------------------------------- kernels

def crf_plan_cuda(lows, mean_color, mean_xy, active, allow_new: bool) -> CrfPlan:
    """K24c plan on the card: ``csrc/legacy_crf.cu`` ``mmf_lcrf_plan``."""
    for t, name in ((lows, "lows"), (mean_color, "mean_color"), (mean_xy, "mean_xy")):
        K.check(t, F32, name)
    K.check(active, torch.bool, "active")
    m = active.shape[0]
    s = lows.shape[1]
    nl = m + 1
    if nl > MAX_LABELS or lows.shape[0] != 1 + 2 * m:
        raise ValueError(f"lows must be [1 + 2M, S] with M + 1 <= {MAX_LABELS}")
    dev = lows.device
    unary = torch.empty((s, nl), dtype=F32, device=dev)
    feat = torch.empty((s, 6), dtype=F32, device=dev)
    ks = torch.empty((s, s), dtype=F32, device=dev)
    ka = torch.empty((s, s), dtype=F32, device=dev)
    dinv = K.scratch("legacy_crf.dinv", 2 * s, F32, dev)  # the row factors, within a call
    q0 = torch.empty((s, nl), dtype=F32, device=dev)
    f = K.fn("legacy_crf", "mmf_lcrf_plan", [K.P, K.P, K.P, K.P, K.I, K.I, K.I] + [K.P] * 6)
    K.call("legacy_crf.plan", f, K.ptr(lows), K.ptr(mean_color), K.ptr(mean_xy), K.ptr(active),
           m, s, int(allow_new), K.ptr(unary), K.ptr(feat), K.ptr(ks), K.ptr(ka), K.ptr(dinv),
           K.ptr(q0))
    return CrfPlan(unary, feat, ks, ka, q0)


def crf_mean_field_cuda(plan: CrfPlan, iterations: int):
    """K24c's ``iterations`` >= 1 mean-field steps on the card in one launch
    (``mmf_lcrf_mean_field``): (Q after each step [iterations, S, L], the
    last step's first-index argmax [S] int32)."""
    s, nl = plan.q0.shape
    if iterations < 1 or nl > MAX_LABELS:
        raise ValueError(f"at least one step and at most {MAX_LABELS} labels")
    for t, name in ((plan.q0, "q0"), (plan.unary, "unary"), (plan.k_smooth, "k_smooth"),
                    (plan.k_app, "k_app")):
        K.check(t, F32, name)
    hist = torch.empty((iterations, s, nl), dtype=F32, device=plan.q0.device)
    lbl = torch.empty((s,), dtype=I32, device=plan.q0.device)
    f = K.fn("legacy_crf", "mmf_lcrf_mean_field",
             [K.P, K.P, K.P, K.P, K.I, K.I, K.F, K.F, K.I, K.P, K.P])
    K.call("legacy_crf.mean_field", f, K.ptr(plan.q0), K.ptr(plan.unary), K.ptr(plan.k_smooth),
           K.ptr(plan.k_app), s, nl, WEIGHT_SMOOTHNESS, WEIGHT_APPEARANCE, iterations,
           K.ptr(hist), K.ptr(lbl))
    return hist, lbl


def crf_iterate_cuda(q: torch.Tensor, plan: CrfPlan, want_labels: bool = False):
    """K24c mean-field step on the card: ``mmf_lcrf_iterate`` (one warp per
    superpixel row); with ``want_labels`` also the first-index argmax."""
    K.check(q, F32, "q")
    s, nl = q.shape
    out = torch.empty_like(q)
    lbl = torch.empty((s,), dtype=I32, device=q.device) if want_labels else None
    f = K.fn("legacy_crf", "mmf_lcrf_iterate", [K.P, K.P, K.P, K.P, K.I, K.I, K.F, K.F, K.P,
                                                K.P])
    K.call("legacy_crf.iterate", f, K.ptr(q), K.ptr(plan.unary), K.ptr(plan.k_smooth),
           K.ptr(plan.k_app), s, nl, WEIGHT_SMOOTHNESS, WEIGHT_APPEARANCE, K.ptr(out),
           None if lbl is None else K.ptr(lbl))
    return out, lbl


# ---------------------------------------------------------------- API

def crf_plan(lows, mean_color, mean_xy, active, allow_new: bool) -> CrfPlan:
    K.record("legacy_crf.plan", lows=lows, mean_color=mean_color, mean_xy=mean_xy,
             active=active, allow_new=allow_new)
    impl = crf_plan_cuda if lows.is_cuda else crf_plan_plain
    return impl(lows, mean_color, mean_xy, active, allow_new)


def mean_field(plan: CrfPlan, iterations: int) -> torch.Tensor:
    """[S] int32 first-index argmax of Q after ``iterations`` steps (on the
    card every step in one launch)."""
    if iterations < 1:  # no iteration: Q0's argmax
        return torch.argmax(plan.q0, dim=-1).to(I32)
    K.record("legacy_crf.mean_field", plan=plan, iterations=iterations)
    if plan.q0.is_cuda:
        return crf_mean_field_cuda(plan, iterations)[1]
    q = plan.q0
    for _ in range(iterations):
        q = crf_iterate_plain(q, plan)
    return torch.argmax(q, dim=-1).to(I32)


def legacy_crf_segmentation(
    rgb: torch.Tensor,  # [H, W, 3] float (0..255)
    depth: torch.Tensor,  # [H, W]
    icp_errors: torch.Tensor,  # [M, H, W] per-model ICP error images
    model_conf: torch.Tensor,  # [M, H, W] per-model prediction confidence
    model_active: torch.Tensor,  # [M] bool
    cfg: SegmentationConfig,
    allow_new: bool = True,
) -> LegacyCrfResult:
    m = icp_errors.shape[0]
    n_labels = m + 1
    h, w = depth.shape
    sp = slic_mod.slic(rgb.contiguous())
    lows = slic_mod.superpixel_means(
        torch.cat([depth[None], icp_errors, model_conf], dim=0).contiguous(), sp)
    plan = crf_plan(lows, sp.mean_color.contiguous(), sp.mean_xy.contiguous(),
                    model_active.contiguous(), allow_new)
    lbl_sp = mean_field(plan, cfg.crf_iterations)
    masks = slic_mod.upsample_onehot(lbl_sp, sp.labels, n_labels)
    largest, counts = components.keep_largest_components_batched(masks)

    # the labels are disjoint, so the label of a kept pixel is its only True row
    kept = largest.any(dim=0)
    segm = torch.where(kept, torch.argmax(largest.to(torch.uint8), dim=0).to(I32),
                       torch.full((h, w), -1, dtype=I32, device=depth.device))
    total = h * w
    new_px = counts[m]
    has_new = (new_px > cfg.min_rel_size_new * total) & (new_px < cfg.max_rel_size_new * total)
    if not allow_new:
        has_new = has_new & False
    new_mask = (segm == m) & has_new
    mask = torch.where((segm < 0) | (segm == m), torch.zeros_like(segm), segm)
    return LegacyCrfResult(mask, new_mask, has_new, counts[:m], sp.labels)
