"""Dense CRF mean-field inference on the CRF grid (kernel K16).

Port of the reference package's ``segmentation/crf.py``: Potts mean field
(DenseCRF::inference) with two message kernels,

- a Gaussian smoothness message: three box passes per axis (Wells'
  approximation; sigma 3 gives box radius 3), zero outside the image;
- a bilateral message in (x, y, flow) on a regular grid: every pixel splats
  its label distribution into one of 8 x 8 flow slabs (fmin/fmax binning of
  the features, ``rint``) of its 4x4-pooled cell (no pooling below 32 px or
  for sizes not divisible by 4), the grid is blurred spatially (three box
  passes per axis, radius from sigma_xy / pool) and across the slabs (a
  5-tap Gaussian per feature axis, wrapping around, built from the
  data-dependent bin scale), then each pixel reads its own slab back and
  divides by the equally blurred occupancy.

Each iteration subtracts the self-message, forms the Potts pairwise term
(the sum of the other labels' messages) and takes the softmax of
``-unary - pairwise``.

``crf_plan`` (the iteration-invariant part: binning, occupancy, the slab
kernel, the initial softmax) and ``crf_iteration`` launch ``csrc/crf.cu`` for
CUDA tensors and take their plain PyTorch versions (``*_plain``) only for CPU
tensors; ``mean_field`` chains them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from multimotionfusion_tpu_torch import kernels as K

F32 = torch.float32
I32 = torch.int32
GRID_BINS = 8
OFFS = (-2, -1, 0, 1, 2)  # the slab blur's taps
MAX_LINE = 192  # the longest line a box pass of csrc/crf.cu holds in shared memory


class CrfParams(NamedTuple):
    """The two message kernels of the flow-CRF (SegmentationConfig)."""

    gauss_sigma: float
    gauss_weight: float
    sigma_xy: float
    sigma_f: float
    bil_weight: float
    feature_scale: float = 10.0  # features = flow * feature_scale


def box_radius(sigma: float) -> int:
    """Radius of the three-box approximation of a Gaussian of ``sigma``."""
    return max(1, int(round((math.sqrt(4.0 * sigma * sigma + 1.0) - 1.0) / 2)))


def pool_of(h: int, w: int, pool: int = 4) -> int:
    return pool if (h % pool == 0 and w % pool == 0 and min(h, w) >= 32) else 1


# ---------------------------------------------------------------- plain twins

def _box_sum(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """Windowed sum over [i - r, i + r] along ``axis`` (zero outside), via cumsum."""
    n = x.shape[axis]
    zshape = list(x.shape)
    zshape[axis] = r
    z = torch.zeros(zshape, dtype=x.dtype, device=x.device)
    cs = torch.cumsum(torch.cat([z, x, z], dim=axis), dim=axis)
    hi = cs.narrow(axis, 2 * r, n)
    zshape[axis] = 1
    csp = torch.cat([torch.zeros(zshape, dtype=x.dtype, device=x.device), cs], dim=axis)
    return hi - csp.narrow(axis, 0, n)


def _three_box(x: torch.Tensor, sigma: float, axes) -> torch.Tensor:
    r = box_radius(sigma)
    inv = 1.0 / float(2 * r + 1)
    out = x
    for axis in axes:
        for _ in range(3):
            out = _box_sum(out, r, axis) * inv
    return out


def gaussian_message(q: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian-kernel message for all labels: [L, H, W] -> [L, H, W]."""
    radius = max(1, int(2.0 * sigma))
    if radius > 4:
        return _three_box(q, sigma, (1, 2))
    from multimotionfusion_tpu_torch.ops.image import _shift2d

    taps = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    taps = (taps / taps.sum()).astype(np.float32)
    out = torch.zeros_like(q)
    for i, t in enumerate(taps):
        out = out + float(t) * _shift2d(q, i - radius, 0)
    out2 = torch.zeros_like(q)
    for i, t in enumerate(taps):
        out2 = out2 + float(t) * _shift2d(out, 0, i - radius)
    return out2


def splat_plan(features: torch.Tensor, grid_bins: int = GRID_BINS):
    """(one-hot blocks [hp, wp, S, ds*ds], bin scale [F], ds) of the
    bilateral grid (the reference's bilateral_grid_splat_plan)."""
    h, w, f = features.shape
    flat = features.reshape(-1, f)
    fmin, fmax = flat.min(dim=0).values, flat.max(dim=0).values
    scale = torch.full_like(fmax, grid_bins - 1) / torch.clamp(fmax - fmin, min=1e-6)
    bins = torch.clamp(torch.round((features - fmin) * scale), 0, grid_bins - 1).to(I32)
    flat_bin = bins[..., 0]
    for i in range(1, f):
        flat_bin = flat_bin * grid_bins + bins[..., i]
    nslab = grid_bins ** f
    ds = pool_of(h, w)
    hp, wp = h // ds, w // ds
    fb = flat_bin.reshape(hp, ds, wp, ds).permute(0, 2, 1, 3).reshape(hp, wp, ds * ds)
    slabs = torch.arange(nslab, dtype=I32, device=features.device)
    oh = (fb[:, :, None, :] == slabs[None, None, :, None]).to(F32)
    return oh, scale, ds


def slab_kernel(scale: torch.Tensor, sigma_f: float, grid_bins: int = GRID_BINS) -> torch.Tensor:
    """[S, S] slab blur: per feature a wrapping 5-tap Gaussian of sigma
    ``sigma_f * scale`` bins, the Kronecker product over the features."""
    kern = None
    offs = torch.tensor(OFFS, dtype=F32, device=scale.device)
    eye = torch.eye(grid_bins, dtype=F32, device=scale.device)
    roll = torch.stack([eye[:, torch.roll(torch.arange(grid_bins), -o)] for o in OFFS])
    for i in range(scale.shape[0]):
        sb = torch.clamp(sigma_f * scale[i], min=1e-3)
        wts = torch.exp(-0.5 * (offs / sb) ** 2)
        wts = wts / torch.sum(wts)
        km = torch.einsum("k,kab->ab", wts, roll.to(scale.device))
        kern = km if kern is None else torch.einsum("ab,cd->acbd", kern, km).reshape(
            kern.shape[0] * grid_bins, kern.shape[0] * grid_bins)
    return kern


def bilateral_message(q: torch.Tensor, plan, sigma_xy: float, sigma_f: float) -> torch.Tensor:
    """Bilateral message [L, H, W]: splat, spatial and slab blur, slice, normalise."""
    nl, h, w = q.shape
    oh, scale, ds = plan
    hp, wp, nslab, npix = oh.shape
    qb = q.reshape(nl, hp, ds, wp, ds).permute(1, 3, 2, 4, 0).reshape(hp, wp, npix, nl)
    grid = torch.einsum("hwsp,hwpl->hwsl", oh, qb)
    occ = oh.sum(dim=-1)
    sig = sigma_xy / ds
    grid = _three_box(grid.reshape(hp, wp, nslab * nl), sig, (0, 1)).reshape(hp, wp, nslab, nl)
    occ = _three_box(occ, sig, (0, 1))
    kern = slab_kernel(scale, sigma_f)
    grid = torch.einsum("hwsl,st->hwtl", grid, kern)
    occ = torch.einsum("hws,st->hwt", occ, kern)
    msg = torch.einsum("hwsp,hwsl->hwpl", oh, grid)
    norm = torch.einsum("hwsp,hws->hwp", oh, occ)
    msg = msg.reshape(hp, wp, ds, ds, nl).permute(4, 0, 2, 1, 3).reshape(nl, h, w)
    norm = norm.reshape(hp, wp, ds, ds).permute(0, 2, 1, 3).reshape(h, w)
    return msg / torch.clamp(norm, min=1e-6)[None]


def crf_plan_plain(unary: torch.Tensor, flow: torch.Tensor, p: CrfParams):
    """Plain PyTorch K16 plan: (Q0 = softmax(-unary), the splat plan)."""
    return torch.softmax(-unary, dim=0), splat_plan(flow * p.feature_scale)


def crf_iteration_plain(q: torch.Tensor, unary: torch.Tensor, plan, p: CrfParams) -> torch.Tensor:
    """Plain PyTorch K16 iteration: Q -> softmax(-unary - Potts(messages))."""
    msg = torch.zeros_like(q)
    msg = msg + p.gauss_weight * (gaussian_message(q, p.gauss_sigma) - q)
    msg = msg + p.bil_weight * (bilateral_message(q, plan, p.sigma_xy, p.sigma_f) - q)
    pairwise = torch.sum(msg, dim=0, keepdim=True) - msg
    return torch.softmax(-unary - pairwise, dim=0)


def mean_field_plain(unary: torch.Tensor, flow: torch.Tensor, p: CrfParams,
                     iterations: int) -> torch.Tensor:
    q, plan = crf_plan_plain(unary, flow, p)
    for _ in range(iterations):
        q = crf_iteration_plain(q, unary, plan, p)
    return q


# ---------------------------------------------------------------- kernels

class CardPlan(NamedTuple):
    """The iteration-invariant state of ``csrc/crf.cu``."""

    params: torch.Tensor  # [16] f32: fmin, scale, the slab taps of each feature
    bins: torch.Tensor  # [H*W] int32 slab of each pixel
    norm: torch.Tensor  # [H*W] f32 blurred occupancy at each pixel's slab
    ds: int


def _check_lines(h: int, w: int, ds: int) -> None:
    if max(h, w, h // ds, w // ds) > MAX_LINE:
        raise ValueError(f"a CRF grid line longer than {MAX_LINE} does not fit csrc/crf.cu")


def crf_plan_cuda(unary: torch.Tensor, flow: torch.Tensor, p: CrfParams):
    """K16 plan on the card: ``csrc/crf.cu`` ``mmf_crf_plan``: (Q0, CardPlan)."""
    K.check(unary, F32, "unary")
    K.check(flow, F32, "flow")
    nl, h, w = unary.shape
    if tuple(flow.shape) != (h, w, 2):
        raise ValueError("flow must be [H, W, 2]")
    ds = pool_of(h, w)
    _check_lines(h, w, ds)
    dev = unary.device
    hp, wp = h // ds, w // ds
    q = torch.empty_like(unary)
    params = torch.empty((16,), dtype=F32, device=dev)
    bins = torch.empty((h * w,), dtype=I32, device=dev)
    norm = torch.empty((h * w,), dtype=F32, device=dev)
    occ = torch.empty((hp * wp * GRID_BINS ** 2,), dtype=F32, device=dev)
    f = K.fn("crf", "mmf_crf_plan", [K.P, K.P, K.I, K.I, K.I, K.I, K.F, K.F, K.I, K.F]
             + [K.P] * 5)
    K.call("crf.plan", f, K.ptr(unary), K.ptr(flow), nl, h, w, ds, float(p.feature_scale),
           float(p.sigma_f), box_radius(p.sigma_xy / ds), 1.0 / float(2 * box_radius(
               p.sigma_xy / ds) + 1), K.ptr(q), K.ptr(params), K.ptr(bins), K.ptr(norm), K.ptr(occ))
    return q, CardPlan(params, bins, norm, ds)


def crf_iteration_cuda(q: torch.Tensor, unary: torch.Tensor, plan: CardPlan,
                       p: CrfParams) -> torch.Tensor:
    """K16 iteration on the card: ``csrc/crf.cu`` ``mmf_crf_iteration``."""
    K.check(q, F32, "q")
    K.check(unary, F32, "unary")
    nl, h, w = q.shape
    if max(1, int(2.0 * p.gauss_sigma)) <= 4:
        raise ValueError("csrc/crf.cu implements the three-box Gaussian message (sigma >= 2.5)")
    ds = plan.ds
    hp, wp = h // ds, w // ds
    dev = q.device
    out = torch.empty_like(q)
    gauss = torch.empty((2, nl, h, w), dtype=F32, device=dev)
    grid = torch.empty((hp * wp * GRID_BINS ** 2 * nl,), dtype=F32, device=dev)
    rg = box_radius(p.gauss_sigma)
    rb = box_radius(p.sigma_xy / ds)
    f = K.fn("crf", "mmf_crf_iteration", [K.P, K.P, K.P, K.P, K.P, K.I, K.I, K.I, K.I, K.I, K.F,
                                          K.I, K.F, K.F, K.F, K.P, K.P, K.P])
    K.call("crf.iter", f, K.ptr(q), K.ptr(unary), K.ptr(plan.params), K.ptr(plan.bins),
           K.ptr(plan.norm), nl, h, w, ds, rg, 1.0 / float(2 * rg + 1), rb,
           1.0 / float(2 * rb + 1), float(p.gauss_weight), float(p.bil_weight), K.ptr(gauss),
           K.ptr(grid), K.ptr(out))
    return out


def crf_plan(unary, flow, p: CrfParams):
    impl = crf_plan_cuda if unary.is_cuda else crf_plan_plain
    return impl(unary, flow, p)


def crf_iteration(q, unary, plan, p: CrfParams):
    impl = crf_iteration_cuda if q.is_cuda else crf_iteration_plain
    return impl(q, unary, plan, p)


def mean_field(unary: torch.Tensor, flow: torch.Tensor, p: CrfParams,
               iterations: int) -> torch.Tensor:
    """Potts mean field with the Gaussian and the flow-bilateral message over
    ``iterations``: Q [L, H, W] from the unary [L, H, W] and the flow [H, W, 2]."""
    K.record("crf", unary=unary, flow=flow, p=p, iterations=iterations)
    q, plan = crf_plan(unary, flow, p)
    for _ in range(iterations):
        q = crf_iteration(q, unary, plan, p)
    return q
