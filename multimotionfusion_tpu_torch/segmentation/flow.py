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

``dense_flow`` launches ``csrc/flow.cu`` once for CUDA tensors (the whole
flow in one thread-block cluster) and takes the plain PyTorch version
(``dense_flow_plain``: ``flow_prep_plain``, then ``lk_level_plain`` per
level) only for CPU tensors.
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


# ---------------------------------------------------------------- kernel

CLUSTER = 16  # blocks of the one cluster, csrc/flow.cu's CLUSTER (the non-portable size)
SMEM_BYTES = 232_448  # a block's shared memory on an H100
NEAR = 8  # rows of next staged each side of a block's rows for the warp (csrc/flow.cu)


def _level_sizes(hc: int, wc: int):
    sizes = [(hc, wc)]
    for _ in range(LEVELS - 1):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    return sizes


def flow_scratch_floats(hc: int, wc: int) -> int:
    """Floats of ``mmf_dense_flow``'s global scratch: the horizontal blur
    [2, hc, wc], the three pyramid levels [2, h, w] and per level 4 planes
    (two ``it``, the flow)."""
    return 2 * hc * wc + sum((2 + 4) * h * w for h, w in _level_sizes(hc, wc))


def flow_band(hc: int, wc: int):
    """(band, halo, stage, near): the most pixels one block of the cluster
    owns at any level (block r of C = CLUSTER owns the rows
    [r h / C, (r + 1) h / C)), the
    most of its rows and RADIUS more each side (those its box sums read), the
    most floats of both images' rows its vertical blur or a downsample reads,
    and the most of its rows, NEAR more above and NEAR + 1 below (the next
    image's rows its warp reads from shared memory)."""
    sizes = _level_sizes(hc, wc)
    band = halo = stage = near = 0
    for lvl, (h, w) in enumerate(sizes):
        for r in range(CLUSTER):
            y0, y1 = h * r // CLUSTER, h * (r + 1) // CLUSTER
            band = max(band, (y1 - y0) * w)
            halo = max(halo, (min(y1 + RADIUS, h) - max(y0 - RADIUS, 0)) * w)
            near = max(near, (min(y1 + NEAR + 1, h) - max(y0 - NEAR, 0)) * w)
            if lvl == 0:  # the vertical blur's rows
                rows, width = min(y1 + BLUR_RADIUS, h) - max(y0 - BLUR_RADIUS, 0), w
            else:  # the downsample's rows of the finer level
                hf, width = sizes[lvl - 1]
                rows = min(2 * y1 + 1, hf) - max(2 * y0 - 2, 0)
            stage = max(stage, 2 * max(rows, 0) * width)
    return band, halo, stage, near


def dense_flow_cuda(prev: torch.Tensor, nxt: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """K15 on the card: ``csrc/flow.cu`` ``mmf_dense_flow``, the resize, blur,
    pyramids and the three levels in one launch of one ``CLUSTER``-block
    thread-block cluster; [hc, wc, 2]. A block keeps 11 floats a pixel of
    its rows, 3 a pixel of those rows and RADIUS more each side and the next
    image's rows near them in shared memory (and stages the rows the blur
    and the downsamples read there); for a grid that needs more than a block
    has (320x240 at a cluster of 16), in its own part of a global scratch."""
    K.check(prev, F32, "prev")
    K.check(nxt, F32, "next")
    if prev.shape != nxt.shape or prev.dim() != 2:
        raise ValueError("prev and next must be [H, W] of one shape")
    if min(hc, wc) < 5:
        raise ValueError("the CRF grid must be at least 5x5 (a 2x2 coarsest level)")
    band, halo, stage, near = flow_band(hc, wc)
    per_block = max(11 * band + 3 * halo + near, stage)
    h, w = prev.shape
    dev = prev.device
    scratch = torch.empty((flow_scratch_floats(hc, wc),), dtype=F32, device=dev)
    out = torch.empty((hc, wc, 2), dtype=F32, device=dev)
    spill = (torch.empty((CLUSTER * per_block,), dtype=F32, device=dev)
             if 4 * per_block > SMEM_BYTES else None)
    f = K.fn("flow", "mmf_dense_flow", [K.P, K.P, K.I, K.I, K.I, K.I, K.I]
             + [K.F] * (2 * BLUR_RADIUS + 1) + [K.I] * 5 + [K.P] * 3)
    taps = [float(t) for t in imops.gaussian_weights(BLUR_SIGMA, BLUR_RADIUS)]
    K.call("flow", f, K.ptr(prev), K.ptr(nxt), h, w, hc, wc, ITERS, *taps, CLUSTER, band, halo,
           near, stage, K.ptr(scratch), None if spill is None else K.ptr(spill), K.ptr(out))
    return out


def dense_flow(prev: torch.Tensor, nxt: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """[hc, wc, 2] flow in CRF-scale pixels such that next(x + flow) ~ prev(x),
    from the full-resolution intensities ``prev`` and ``nxt`` [H, W]."""
    K.record("flow", prev=prev, nxt=nxt, hc=hc, wc=wc)
    impl = dense_flow_cuda if prev.is_cuda else dense_flow_plain
    return impl(prev, nxt, hc, wc)


def dense_flow_plain(prev: torch.Tensor, nxt: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """Plain PyTorch K15 as a whole: [hc, wc, 2]."""
    pyr = flow_prep_plain(prev, nxt, hc, wc)
    flow = None
    for lvl in range(LEVELS - 1, -1, -1):
        flow = lk_level_plain(pyr[lvl], flow)
    return flow.permute(1, 2, 0).contiguous()
