"""SLIC superpixels of the legacy CRF segmentation (kernels K24a, K24b).

Port of the reference package's ``segmentation/slic.py`` (the gSLICr
wrapper's GIVEN_SIZE segmentation: 16-px cells, coherence 0.6, 5
iterations, no connectivity enforcement) as grid k-means: a regular grid
start, then each iteration takes every superpixel's centre (colour and
position means) and gives every pixel the nearest of the 3x3 centres around
its current label's cell (candidates in (dy, dx) order, strict ``<``).

- ``slic_centres`` (K24a, ``csrc/slic.cu``): the centres of a label image,
  each superpixel's sums taken over its pixels in row-major order (the
  order of the reference's scatter-add on the CPU);
- ``slic_assign`` (K24a): the 3x3 assignment step;
- ``superpixel_means`` (K24b): the means of a stack of images per
  superpixel (``downsample_to_superpixels`` of each), the same ordered sums;
- ``upsample_onehot`` (K24b): a per-superpixel label back on the pixels
  (``upsample_from_superpixels``), one mask per label.

Each wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version (``*_plain``; scatter-adds with ``index_add_``, sequential
in pixel order on the CPU) only for CPU tensors.

A label can move at most one cell per iteration, so after ``t`` assignments
every pixel of superpixel s lies within ``t`` cells of s's grid cell; the
kernels' centre sums scan that window (``radius`` = the assignments so far).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from multimotionfusion_tpu_torch import kernels as K

F32 = torch.float32
I32 = torch.int32
SP_SIZE = 16
COH_WEIGHT = 0.6
ITERATIONS = 5


class SlicResult(NamedTuple):
    labels: torch.Tensor  # [H, W] int32 superpixel id (row-major grid order)
    mean_color: torch.Tensor  # [S, C]
    mean_xy: torch.Tensor  # [S, 2]
    count: torch.Tensor  # [S]
    grid_hw: Tuple[int, int]  # (rows, cols) of the superpixel grid


def grid_shape(h: int, w: int, sp_size: int = SP_SIZE) -> Tuple[int, int]:
    return max(h // sp_size, 1), max(w // sp_size, 1)


def _xy_scale(c: int, sp_size: int, coh_weight: float) -> Tuple[float, float, float]:
    """The float32 factors of the spatial term coh * sqrt(dxy) * sqrt(C) * 255 / sp."""
    coh = float(torch.tensor(coh_weight / float(sp_size), dtype=F32))
    return coh, float(torch.sqrt(torch.tensor(float(c), dtype=F32))), float(sp_size)


# ---------------------------------------------------------------- plain twins

def grid_labels(h: int, w: int, sp_size: int, device) -> torch.Tensor:
    gy, gx = grid_shape(h, w, sp_size)
    ys = torch.arange(h, dtype=F32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=F32, device=device)[None, :].expand(h, w)
    cy = torch.clamp((ys / sp_size).to(I32), 0, gy - 1)
    cx = torch.clamp((xs / sp_size).to(I32), 0, gx - 1)
    return cy * gx + cx


def slic_centres_plain(image: torch.Tensor, labels: torch.Tensor, s: int) -> torch.Tensor:
    """[S, C + 3] per superpixel: mean colour, mean (x, y), pixel count."""
    h, w, c = image.shape
    dev = image.device
    flat = labels.reshape(-1).long()
    ys = torch.arange(h, dtype=F32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=F32, device=dev)[None, :].expand(h, w)
    cnt = torch.zeros((s,), dtype=F32, device=dev).index_add_(
        0, flat, torch.ones((h * w,), dtype=F32, device=dev))
    col = torch.zeros((s, c), dtype=F32, device=dev).index_add_(0, flat, image.reshape(-1, c))
    pxy = torch.zeros((s, 2), dtype=F32, device=dev).index_add_(
        0, flat, torch.stack([xs, ys], -1).reshape(-1, 2))
    denom = torch.clamp(cnt, min=1.0)[:, None]
    return torch.cat([col / denom, pxy / denom, cnt[:, None]], dim=1)


def slic_assign_plain(image: torch.Tensor, labels: torch.Tensor, centres: torch.Tensor,
                      grid_hw: Tuple[int, int], sp_size: int = SP_SIZE,
                      coh_weight: float = COH_WEIGHT) -> torch.Tensor:
    """One assignment step: each pixel's best of the 3x3 centres around its
    label's cell (slic.py:61-76, term for term)."""
    h, w, c = image.shape
    dev = image.device
    gy, gx = grid_hw
    coh, sqrt_c, sp = _xy_scale(c, sp_size, coh_weight)
    ys = torch.arange(h, dtype=F32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=F32, device=dev)[None, :].expand(h, w)
    mc, mxy = centres[:, :c], centres[:, c:c + 2]
    best_d = torch.full((h, w), float("inf"), dtype=F32, device=dev)
    best_l = labels
    base_cy = torch.clamp(torch.div(labels, gx, rounding_mode="floor"), 0, gy - 1)
    base_cx = torch.clamp(torch.remainder(labels, gx), 0, gx - 1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cid = (torch.clamp(base_cy + dy, 0, gy - 1) * gx
                   + torch.clamp(base_cx + dx, 0, gx - 1)).long()
            diff = image - mc[cid]
            sq = diff * diff
            dc = sq[..., 0]
            for k in range(1, c):
                dc = dc + sq[..., k]
            ex = xs - mxy[cid][..., 0]
            ey = ys - mxy[cid][..., 1]
            dxs = ex * ex + ey * ey
            d = torch.sqrt(dc) + coh * torch.sqrt(dxs) * sqrt_c * 255.0 / sp
            better = d < best_d
            best_d = torch.where(better, d, best_d)
            best_l = torch.where(better, cid.to(I32), best_l)
    return best_l


def superpixel_means_plain(images: torch.Tensor, labels: torch.Tensor,
                           count: torch.Tensor) -> torch.Tensor:
    """[N, S] mean of each of the [N, H, W] images per superpixel."""
    n = images.shape[0]
    s = count.shape[0]
    acc = torch.zeros((s, n), dtype=F32, device=images.device).index_add_(
        0, labels.reshape(-1).long(), images.reshape(n, -1).T)
    return (acc / torch.clamp(count, min=1.0)[:, None]).T.contiguous()


def upsample_onehot_plain(lbl_sp: torch.Tensor, labels: torch.Tensor, n_labels: int
                          ) -> torch.Tensor:
    """[L, H, W] bool: pixel p's superpixel carries label l."""
    lbl = lbl_sp[labels.long()]
    ls = torch.arange(n_labels, dtype=lbl.dtype, device=lbl.device)[:, None, None]
    return lbl[None] == ls


# ---------------------------------------------------------------- kernels

def _check_image(image: torch.Tensor) -> None:
    K.check(image, F32, "image")
    if image.dim() != 3 or image.shape[2] != 3:
        raise ValueError("image must be [H, W, 3]")


def slic_centres_cuda(image, labels, s: int, grid_hw, sp_size: int, radius: int) -> torch.Tensor:
    """K24a centres on the card: ``csrc/slic.cu`` ``mmf_slic_centres``;
    ``labels`` None means the regular grid."""
    _check_image(image)
    if labels is not None:
        K.check(labels, I32, "labels")
    h, w, _ = image.shape
    out = torch.empty((s, 6), dtype=F32, device=image.device)
    f = K.fn("slic", "mmf_slic_centres", [K.P, K.P, K.I, K.I, K.I, K.I, K.I, K.I, K.P])
    K.call("slic.centres", f, K.ptr(image), None if labels is None else K.ptr(labels), h, w,
           grid_hw[0], grid_hw[1], sp_size, int(radius), K.ptr(out))
    return out


def slic_assign_cuda(image, labels, centres, grid_hw, sp_size: int,
                     coh_weight: float) -> torch.Tensor:
    """K24a assignment on the card: ``csrc/slic.cu`` ``mmf_slic_assign``."""
    _check_image(image)
    K.check(centres, F32, "centres")
    if labels is not None:
        K.check(labels, I32, "labels")
    h, w, c = image.shape
    coh, sqrt_c, sp = _xy_scale(c, sp_size, coh_weight)
    out = torch.empty((h, w), dtype=I32, device=image.device)
    f = K.fn("slic", "mmf_slic_assign", [K.P, K.P, K.P, K.I, K.I, K.I, K.I, K.I, K.F, K.F,
                                         K.F, K.P])
    K.call("slic.assign", f, K.ptr(image), None if labels is None else K.ptr(labels),
           K.ptr(centres), h, w, grid_hw[0], grid_hw[1], sp_size, coh, sqrt_c, sp, K.ptr(out))
    return out


def superpixel_means_cuda(images, labels, grid_hw, sp_size: int, radius: int) -> torch.Tensor:
    """K24b on the card: ``csrc/slic.cu`` ``mmf_sp_means``, every image in one
    launch (each superpixel's count is found again by the scan)."""
    K.check(images, F32, "images")
    K.check(labels, I32, "labels")
    n, h, w = images.shape
    if tuple(labels.shape) != (h, w):
        raise ValueError("images must be [N, H, W] over the [H, W] labels")
    s = grid_hw[0] * grid_hw[1]
    out = torch.empty((n, s), dtype=F32, device=images.device)
    f = K.fn("slic", "mmf_sp_means", [K.P, K.I, K.P, K.I, K.I, K.I, K.I, K.I, K.I, K.P])
    K.call("sp.downsample", f, K.ptr(images), n, K.ptr(labels), h, w, grid_hw[0], grid_hw[1],
           sp_size, int(radius), K.ptr(out))
    return out


def upsample_onehot_cuda(lbl_sp, labels, n_labels: int) -> torch.Tensor:
    K.check(lbl_sp, I32, "lbl_sp")
    K.check(labels, I32, "labels")
    h, w = labels.shape
    out = torch.empty((n_labels, h, w), dtype=torch.bool, device=labels.device)
    f = K.fn("slic", "mmf_sp_upsample", [K.P, K.P, K.I, K.I, K.P])
    K.call("sp.upsample", f, K.ptr(lbl_sp), K.ptr(labels), h * w, n_labels, K.ptr(out))
    return out


# ---------------------------------------------------------------- API

def slic_centres(image, labels, grid_hw, sp_size: int = SP_SIZE, radius: int = ITERATIONS):
    s = grid_hw[0] * grid_hw[1]
    if image.is_cuda:
        return slic_centres_cuda(image, labels, s, grid_hw, sp_size, radius)
    if labels is None:
        labels = grid_labels(image.shape[0], image.shape[1], sp_size, image.device)
    return slic_centres_plain(image, labels, s)


def slic_assign(image, labels, centres, grid_hw, sp_size: int = SP_SIZE,
                coh_weight: float = COH_WEIGHT):
    if image.is_cuda:
        return slic_assign_cuda(image, labels, centres, grid_hw, sp_size, coh_weight)
    if labels is None:
        labels = grid_labels(image.shape[0], image.shape[1], sp_size, image.device)
    return slic_assign_plain(image, labels, centres, grid_hw, sp_size, coh_weight)


def slic(image: torch.Tensor, sp_size: int = SP_SIZE, coh_weight: float = COH_WEIGHT,
         iterations: int = ITERATIONS) -> SlicResult:
    """SLIC of an [H, W, C] float image (RGB 0..255): the centres and the
    assignment alternate ``iterations`` times from the regular grid, then the
    final centres."""
    K.record("slic", image=image, sp_size=sp_size, coh_weight=coh_weight, iterations=iterations)
    h, w, c = image.shape
    grid_hw = grid_shape(h, w, sp_size)
    labels = None  # the regular grid
    for it in range(iterations):
        centres = slic_centres(image, labels, grid_hw, sp_size, it)
        labels = slic_assign(image, labels, centres, grid_hw, sp_size, coh_weight)
    if labels is None:
        labels = grid_labels(h, w, sp_size, image.device)
    centres = slic_centres(image, labels, grid_hw, sp_size, iterations)
    return SlicResult(labels, centres[:, :c], centres[:, c:c + 2], centres[:, c + 2], grid_hw)


def superpixel_means(images: torch.Tensor, res: SlicResult,
                     radius: int = ITERATIONS) -> torch.Tensor:
    """[N, S] mean of each [N, H, W] image per superpixel of ``res``
    (``downsample_to_superpixels`` of every image)."""
    K.record("sp.downsample", images=images, labels=res.labels, count=res.count,
             grid_hw=res.grid_hw, radius=radius)
    if images.is_cuda:
        return superpixel_means_cuda(images, res.labels, res.grid_hw, SP_SIZE, radius)
    return superpixel_means_plain(images, res.labels, res.count)


def upsample_onehot(lbl_sp: torch.Tensor, labels: torch.Tensor, n_labels: int) -> torch.Tensor:
    """[L, H, W] bool masks ``lbl_sp[labels] == l`` (Slic::upsample, one mask per label)."""
    K.record("sp.upsample", lbl_sp=lbl_sp, labels=labels, n_labels=n_labels)
    if labels.is_cuda:
        return upsample_onehot_cuda(lbl_sp, labels, n_labels)
    return upsample_onehot_plain(lbl_sp, labels, n_labels)

