"""Image-space ops: intensity, pyramids, Sobel gradients, bilateral depth filter.

Port of the reference package's ``ops/image.py`` in plain PyTorch: the plain
versions of kernels K1 (``csrc/frame_maps.cu``, the bilateral filter) and K2
(``csrc/pyramid.cu``, the pyramids and Sobel), which the CPU tests and the
kernel checks use. Every stencil keeps the reference's tap order so float sums
round identically: a tap loop accumulates ``out + w * shifted`` in row-major
tap order. Invalid depth is 0.0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# 5x5 binomial kernel of all pyramid downsamples (cudafuncs.cu:517-521)
_GAUSS5 = np.outer([1.0, 4.0, 6.0, 4.0, 1.0], [1.0, 4.0, 6.0, 4.0, 1.0])

# Gaussian-Sobel derivative taps (cross-correlation form, positive
# rightward/downward), as in the reference package
_SOBEL_X = np.array(
    [
        [-0.52201, 0.00000, 0.52201],
        [-0.79451, 0.00000, 0.79451],
        [-0.52201, 0.00000, 0.52201],
    ],
    dtype=np.float32,
)
_SOBEL_Y = _SOBEL_X.T.copy()


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [H,W,3] (0..255) -> floor'd intensity [H,W]; BGR weights on RGB
    channels (reference quirk, bgr2IntensityKernel)."""
    v = rgb[..., 0] * 0.114 + rgb[..., 1] * 0.299 + rgb[..., 2] * 0.587
    return torch.floor(v)


def div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s rounded once, as the kernels round it: on the card PyTorch
    computes ``tensor / python_scalar`` as a multiply by the reciprocal, which
    can differ in the last bit (enough to flip a tie between coplanar surfels)."""
    return a / torch.full((), s, dtype=a.dtype, device=a.device)


def decimate2(img: torch.Tensor) -> torch.Tensor:
    """img[..., ::2, ::2] (the reference package needs a one-hot matmul on TPU)."""
    return img[..., ::2, ::2]


def _shift2d(img: torch.Tensor, oy: int, ox: int, fill=0) -> torch.Tensor:
    """out[..., y, x] = img[..., y + oy, x + ox], ``fill`` outside the image."""
    h, w = img.shape[-2:]
    out = torch.full_like(img, fill)
    ys, ye = max(0, -oy), min(h, h - oy)
    xs, xe = max(0, -ox), min(w, w - ox)
    if ys < ye and xs < xe:
        out[..., ys:ye, xs:xe] = img[..., ys + oy : ye + oy, xs + ox : xe + ox]
    return out


def _conv2d(img: torch.Tensor, kernel: np.ndarray, stride: int = 1) -> torch.Tensor:
    """Zero-padded cross-correlation of [..., H, W] by [k, k], evaluated only at
    the output positions of ``stride`` (same per-pixel tap order)."""
    k = kernel.shape[0]
    r = k // 2
    h, w = img.shape[-2:]
    padded = F.pad(img, (r, r, r, r))
    out = None
    for oy in range(-r, k - r):
        for ox in range(-r, k - r):
            wgt = float(kernel[oy + r, ox + r])
            if wgt == 0.0:
                continue
            tap = padded[..., r + oy : r + oy + h : stride, r + ox : r + ox + w : stride]
            term = wgt * tap
            out = term if out is None else out + term
    return out


def pyr_down_gauss(img: torch.Tensor, valid_gate: float = 0.0) -> torch.Tensor:
    """Validity-renormalised 5x5 Gaussian downsample by 2 (pyrDownGaussKernel).

    Works on [..., H, W]; output pixel (x, y) is centred on input (2x, 2y)."""
    valid = (img > valid_gate).to(img.dtype)
    both = _conv2d(torch.stack([img * valid, valid]), _GAUSS5, stride=2)
    num, den = both[0], both[1]
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12), torch.zeros_like(num))


def build_pyramid(img: torch.Tensor, levels: int, valid_gate: float = 0.0):
    """List of ``levels`` images, level 0 = input, each subsequent halved."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down_gauss(pyr[-1], valid_gate))
    return pyr


def build_pyramid_nearest(img: torch.Tensor, levels: int):
    """Nearest (top-left) pyramid, for label/mask images."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(decimate2(pyr[-1]))
    return pyr


def sobel_gradients(intensity: torch.Tensor):
    """(dI/dx, dI/dy), truncated like the reference's int16 store."""
    dx = torch.trunc(_conv2d(intensity, _SOBEL_X))
    dy = torch.trunc(_conv2d(intensity, _SOBEL_Y))
    return dx, dy


def bilateral_depth_filter(
    depth: torch.Tensor,
    max_depth: float = 20.0,
    min_depth: float = 0.3,
    sigma_space2_inv_half: float = 0.024691358,
    sigma_color2_inv_half: float = 555.556,
    radius: int = 6,
) -> torch.Tensor:
    """13x13 bilateral depth filter (depth_bilateral_metric.frag).

    sigma_space ~ 4.5 px, sigma_color ~ 0.03 m; depth outside
    [min_depth, max_depth] maps to 0. Accumulates tap by tap in row-major
    order, with the spatial term rounded from double as the reference
    computes it (a Python float product), so the kernel, this version and the
    reference sum in the same order."""
    d = radius
    h, w = depth.shape
    valid = (depth >= min_depth) & (depth <= max_depth)
    base = torch.where(valid, depth, torch.zeros_like(depth))
    padded = F.pad(base, (d, d, d, d))
    sum1 = torch.zeros_like(depth)
    sum2 = torch.zeros_like(depth)
    for oy in range(-d, d + 1):
        for ox in range(-d, d + 1):
            shifted = padded[d + oy : d + oy + h, d + ox : d + ox + w]
            space = float(ox * ox + oy * oy) * sigma_space2_inv_half
            color2 = (base - shifted) ** 2
            wgt = torch.exp(-(space + color2 * sigma_color2_inv_half))
            wgt = torch.where(shifted > 0, wgt, torch.zeros_like(wgt))
            sum1 = sum1 + shifted * wgt
            sum2 = sum2 + wgt
    out = torch.where(sum2 > 0, sum1 / torch.clamp(sum2, min=1e-12), torch.zeros_like(sum1))
    return torch.where(valid, out, torch.zeros_like(out))
