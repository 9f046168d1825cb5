"""Image-space ops: intensity, pyramids, Sobel gradients, bilateral depth
filter, the keypoint detectors' Gaussian blur and bilinear sampling, and the
bilinear resize of the flow-CRF.

Port of the reference package's ``ops/image.py`` in plain PyTorch: the plain
versions of kernels K1 (``csrc/frame_maps.cu``, the bilateral filter) and K2
(``csrc/pyramid.cu``, the pyramids and Sobel), and of K15's front end
(``csrc/flow.cu``: resize, blur, pyramid), which the CPU tests and the
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


def gaussian_weights(sigma: float, radius: int) -> np.ndarray:
    """The reference's normalised 1-D Gaussian taps, computed as it computes
    them (numpy float32), so the port's weights are the same float32 values."""
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(xs**2) / (2.0 * sigma**2))
    k /= k.sum()
    return k


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int) -> torch.Tensor:
    """Separable Gaussian blur of [H, W]: horizontal then vertical, zero
    padding, taps accumulated in order from a zero image (the reference's)."""
    k = gaussian_weights(sigma, radius)
    h, w = img.shape
    padded = F.pad(img, (radius, radius))
    out = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + float(k[i]) * padded[:, i:i + w]
    padded = F.pad(out, (0, 0, radius, radius))
    out2 = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out2 = out2 + float(k[i]) * padded[i:i + h, :]
    return out2


def resize_taps(n_in: int, n_out: int):
    """(i0, i1, w0, w1) of the align-corners=False bilinear resize of one axis
    from ``n_in`` to ``n_out`` samples: output k blends input i0[k] with
    weight w0[k] and i1[k] with w1[k] (the two nonzero entries of each row of
    the reference's ``_resize_matrix``, computed as it computes them)."""
    xs = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    xs = np.clip(xs, 0.0, n_in - 1.0)
    x0 = np.floor(xs).astype(np.int64)
    f = (xs - x0).astype(np.float32)
    x1 = np.minimum(x0 + 1, n_in - 1)
    return x0, x1, (1.0 - f).astype(np.float32), f


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Resize [H, W] to ``out_hw`` with bilinear sampling (align corners =
    False): rows first, then columns, each output the two-tap blend
    ``w0 * a + w1 * b`` (the reference's separable resize matrices)."""
    oh, ow = out_hw
    h, w = img.shape
    dev = img.device
    y0, y1, wy0, wy1 = (torch.as_tensor(a).to(dev) for a in resize_taps(h, oh))
    x0, x1, wx0, wx1 = (torch.as_tensor(a).to(dev) for a in resize_taps(w, ow))
    rows = wy0[:, None] * img[y0] + wy1[:, None] * img[y1]
    return wx0 * rows[:, x0] + wx1 * rows[:, x1]


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of [H, W] or [H, W, C] at float pixel coords,
    clamped to the border (GL_CLAMP_TO_EDGE)."""
    h, w = img.shape[:2]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0.to(img.dtype)
    fy = y - y0.to(img.dtype)
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


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
