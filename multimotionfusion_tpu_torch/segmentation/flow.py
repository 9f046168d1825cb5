"""Dense optical flow (prev -> next) at the CRF working scale (kernel K15).

Port of the reference package's ``segmentation/flow.py``: a pyramidal
iterative Lucas-Kanade flow. Both full-resolution intensities are resized to
the CRF scale (bilinear, ``ops/image.py::resize_bilinear``), blurred (sigma
1.25, radius 3) and reduced to a 3-level pyramid (validity-renormalised 5x5
Gaussian, gate 0); from the coarsest level down, the flow is upsampled x2
(bilinear, times 2) and refined by 4 Lucas-Kanade iterations:

- unit-gain central differences of ``prev`` (the reference's ``jnp.roll``
  form, border rows and columns zeroed);
- the structure tensor and right-hand sides summed over a zero-padded 9x9
  box (vertical sums first, then horizontal, each in tap order);
- the min-eigenvalue gate ``det > 1e-3 and min_eig > 0.5`` (no update
  elsewhere);
- a bilinear warp of ``next`` clamped to ``[0, w - 1.001]``, the temporal
  difference, the 2x2 solve and the +-2 px step clamp.

``flow_prep`` (resize, blur, pyramids) and ``lk_level`` (one level's
upsample and iterations) launch ``csrc/flow.cu`` for CUDA tensors and take
their plain PyTorch versions (``*_plain``) only for CPU tensors;
``dense_flow`` chains them.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.ops import image as imops

F32 = torch.float32
LEVELS = 3
ITERS = 4
RADIUS = 4  # the 9x9 Lucas-Kanade window
BLUR_SIGMA, BLUR_RADIUS = 1.25, 3


def _box(x: torch.Tensor, r: int = RADIUS) -> torch.Tensor:
    """Zero-padded (2r+1)^2 box sum: vertical sums, then horizontal, each
    accumulated in tap order from zero (the reference's order)."""
    h, w = x.shape
    k = 2 * r + 1
    xp = torch.nn.functional.pad(x, (0, 0, r, r))
    acc = torch.zeros_like(x)
    for d in range(k):
        acc = acc + xp[d:d + h, :]
    accp = torch.nn.functional.pad(acc, (r, r, 0, 0))
    out = torch.zeros_like(x)
    for d in range(k):
        out = out + accp[:, d:d + w]
    return out


def gradients(prev: torch.Tensor):
    """(gx, gy): unit-gain central differences with zeroed border columns
    (gx) and rows (gy)."""
    gx = 0.5 * (torch.roll(prev, -1, dims=1) - torch.roll(prev, 1, dims=1))
    gy = 0.5 * (torch.roll(prev, -1, dims=0) - torch.roll(prev, 1, dims=0))
    gx[:, 0] = 0.0
    gx[:, -1] = 0.0
    gy[0, :] = 0.0
    gy[-1, :] = 0.0
    return gx, gy


def _warp(nxt: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """next sampled bilinearly at (x + fx, y + fy), clamped a hair inside
    the last pixel (the reference's pre-shifted tap bank)."""
    h, w = nxt.shape
    dev = nxt.device
    ys = torch.arange(h, dtype=F32, device=dev)[:, None]
    xs = torch.arange(w, dtype=F32, device=dev)[None, :]
    wu = torch.clamp(xs + fx, 0.0, w - 1.001)
    wv = torch.clamp(ys + fy, 0.0, h - 1.001)
    u0, v0 = torch.floor(wu), torch.floor(wv)
    u0c = torch.clamp(u0.to(torch.int64), 0, w - 2)
    v0c = torch.clamp(v0.to(torch.int64), 0, h - 2)
    tu, tv = wu - u0, wv - v0
    t00, t01 = nxt[v0c, u0c], nxt[v0c, u0c + 1]
    t10, t11 = nxt[v0c + 1, u0c], nxt[v0c + 1, u0c + 1]
    return (t00 * (1 - tu) * (1 - tv) + t01 * tu * (1 - tv)
            + t10 * (1 - tu) * tv + t11 * tu * tv)


def lk_refine(prev: torch.Tensor, nxt: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
              iters: int = ITERS):
    """``iters`` Lucas-Kanade updates of (fx, fy) at one level."""
    gx, gy = gradients(prev)
    ixx, ixy, iyy = _box(gx * gx), _box(gx * gy), _box(gy * gy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    min_eig = tr / 2.0 - torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    ok = (det > 1e-3) & (min_eig > 0.5)
    zero = torch.zeros_like(det)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), zero)
    for _ in range(iters):
        it = _warp(nxt, fx, fy) - prev
        bx, by = _box(gx * it), _box(gy * it)
        dx = torch.clamp(-(iyy * bx - ixy * by) * inv_det, -2.0, 2.0)
        dy = torch.clamp(-(-ixy * bx + ixx * by) * inv_det, -2.0, 2.0)
        fx = fx + torch.where(ok, dx, zero)
        fy = fy + torch.where(ok, dy, zero)
    return fx, fy


# ---------------------------------------------------------------- plain twins

def flow_prep_plain(prev: torch.Tensor, nxt: torch.Tensor, hc: int, wc: int) -> List[torch.Tensor]:
    """Plain PyTorch K15 front end: [LEVELS] pyramids of the resized and
    blurred intensities, each level [2, h_l, w_l] (prev, next)."""
    ims = [imops.gaussian_blur(imops.resize_bilinear(x, (hc, wc)), BLUR_SIGMA, BLUR_RADIUS)
           for x in (prev, nxt)]
    pyr = [torch.stack(ims)]
    for _ in range(LEVELS - 1):
        pyr.append(torch.stack([imops.pyr_down_gauss(p) for p in pyr[-1]]))
    return pyr


def lk_level_plain(pair: torch.Tensor, coarse: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch K15 level: the coarser level's flow [2, h/2, w/2] (None
    at the coarsest) upsampled x2, refined on ``pair`` [2, h, w]; [2, h, w]."""
    h, w = pair.shape[1:]
    if coarse is None:
        fx = torch.zeros((h, w), dtype=F32, device=pair.device)
        fy = torch.zeros_like(fx)
    else:
        fx = imops.resize_bilinear(coarse[0], (h, w)) * 2.0
        fy = imops.resize_bilinear(coarse[1], (h, w)) * 2.0
    return torch.stack(lk_refine(pair[0], pair[1], fx, fy))


# ---------------------------------------------------------------- kernels

def flow_prep_cuda(prev: torch.Tensor, nxt: torch.Tensor, hc: int, wc: int) -> List[torch.Tensor]:
    """K15 front end on the card: ``csrc/flow.cu`` ``mmf_flow_prep``."""
    K.check(prev, F32, "prev")
    K.check(nxt, F32, "next")
    if prev.shape != nxt.shape or prev.dim() != 2:
        raise ValueError("prev and next must be [H, W] of one shape")
    h, w = prev.shape
    shapes = [(hc, wc)]
    for _ in range(LEVELS - 1):
        shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    pyr = [torch.empty((2, a, b), dtype=F32, device=prev.device) for a, b in shapes]
    tmp = torch.empty((2, hc, wc), dtype=F32, device=prev.device)
    f = K.fn("flow", "mmf_flow_prep", [K.P, K.P, K.I, K.I, K.I, K.I]
             + [K.F] * (2 * BLUR_RADIUS + 1) + [K.P] * 4)
    taps = [float(t) for t in imops.gaussian_weights(BLUR_SIGMA, BLUR_RADIUS)]
    K.call("flow.prep", f, K.ptr(prev), K.ptr(nxt), h, w, hc, wc, *taps, K.ptr(tmp),
           *(K.ptr(p) for p in pyr))
    return pyr


def lk_level_cuda(pair: torch.Tensor, coarse: Optional[torch.Tensor], level: int = 0,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K15 level on the card: ``csrc/flow.cu`` ``mmf_lk_level`` (launches
    counted as ``flow.L<level>``). With ``out`` ([h, w, 2]) the last
    iteration also writes the flow there, interleaved."""
    K.check(pair, F32, "pair")
    if coarse is not None:
        K.check(coarse, F32, "coarse")
    _, h, w = pair.shape
    hp, wp = (0, 0) if coarse is None else coarse.shape[1:]
    dev = pair.device
    # gx, gy, ixx, ixy, iyy, inv_det, ok, it, and two flow buffers of two planes
    scratch = torch.empty((12, h, w), dtype=F32, device=dev)
    if out is not None:
        K.check(out, F32, "out")
        if tuple(out.shape) != (h, w, 2):
            raise ValueError("out must be [h, w, 2]")
    f = K.fn("flow", "mmf_lk_level", [K.P, K.P, K.I, K.I, K.I, K.I, K.I, K.F, K.F, K.P, K.P])
    K.call(f"flow.L{level}", f, K.ptr(pair), None if coarse is None else K.ptr(coarse), h, w,
           hp, wp, ITERS, float(w - 1.001), float(h - 1.001), K.ptr(scratch),
           None if out is None else K.ptr(out))
    # the iterations alternate between the two flow buffers
    return scratch[8:10] if ITERS % 2 == 0 else scratch[10:12]


def flow_prep(prev, nxt, hc: int, wc: int) -> List[torch.Tensor]:
    impl = flow_prep_cuda if prev.is_cuda else flow_prep_plain
    return impl(prev, nxt, hc, wc)


def lk_level(pair, coarse, level: int, out=None) -> torch.Tensor:
    if pair.is_cuda:
        return lk_level_cuda(pair, coarse, level, out)
    flow = lk_level_plain(pair, coarse)
    if out is not None:
        out.copy_(flow.permute(1, 2, 0))
    return flow


def dense_flow(prev: torch.Tensor, nxt: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """[hc, wc, 2] flow in CRF-scale pixels such that next(x + flow) ~ prev(x),
    from the full-resolution intensities ``prev`` and ``nxt`` [H, W]."""
    K.record("flow", prev=prev, nxt=nxt, hc=hc, wc=wc)
    pyr = flow_prep(prev, nxt, hc, wc)
    out = torch.empty((hc, wc, 2), dtype=F32, device=prev.device)
    flow = None
    for lvl in range(LEVELS - 1, -1, -1):
        flow = lk_level(pyr[lvl], flow, lvl, out if lvl == 0 else None)
    return out


def dense_flow_plain(prev: torch.Tensor, nxt: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """Plain PyTorch K15 as a whole: [hc, wc, 2]."""
    pyr = flow_prep_plain(prev, nxt, hc, wc)
    flow = None
    for lvl in range(LEVELS - 1, -1, -1):
        flow = lk_level_plain(pyr[lvl], flow)
    return flow.permute(1, 2, 0).contiguous()
