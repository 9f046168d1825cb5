"""Keypoint detection and description (kernel K19, ``csrc/keypoints.cu``).

Port of the reference package's ``tracking/superpoint.py``. Two detectors
behind one fixed-shape contract (``Keypoints``: xy, score, desc, valid):

- ``patch_detect``, the weights-free default: ``patch_score`` (Shi-Tomasi
  minimum eigenvalue of the blurred structure tensor of the int16-truncated
  Sobel, zero in the 8-pixel border, and the sigma-1 blurred intensity the
  descriptor samples, one tiled launch) -> ``nms_topk`` (max-window NMS and
  the exact top-k of the peak scores, ties to the lower flat index) ->
  ``patch_desc`` (8x8 samples of the blurred intensity, zero-mean,
  L2-normalised, one warp per keypoint);
- ``superpoint_detect``: the SuperPoint network (``SuperPointNet``, the
  MagicLeap layer names) whose convolutions are library calls, then the same
  ``nms_topk`` kernel and bilinear descriptor sampling.

The reference computes its top-k with ``approx_max_k``, which on its TPU
target is approximate (recall 0.95) and on the CPU falls back to the exact
top-k; the port computes the exact top-k on every device.

Each wrapper launches the CUDA kernel for CUDA tensors and takes the plain
PyTorch version (``*_plain``) only for CPU tensors. The plain versions sum in
the kernels' order, so the two agree bit for bit on the card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.ops import image as imops

F32 = torch.float32
PATCH_DESC_DIM = 64
BORDER = 8  # the descriptor's support; patch scores are zero within it
_MAX_NMS_RADIUS = 8
_MAX_KP = 1024


class Keypoints(NamedTuple):
    xy: torch.Tensor  # [K, 2] float32 pixel coordinates (x, y)
    score: torch.Tensor  # [K]
    desc: torch.Tensor  # [K, D] L2-normalised descriptors
    valid: torch.Tensor  # [K] bool


# ---------------------------------------------------------------- patch_score

def patch_score_plain(intensity: torch.Tensor):
    """(Shi-Tomasi score [H, W], sigma-1 blurred intensity [H, W])."""
    h, w = intensity.shape
    gx, gy = imops.sobel_gradients(intensity)
    ixx = imops.gaussian_blur(gx * gx, 1.5, 2)
    iyy = imops.gaussian_blur(gy * gy, 1.5, 2)
    ixy = imops.gaussian_blur(gx * gy, 1.5, 2)
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    min_eig = tr / 2.0 - disc
    ys = torch.arange(h, device=intensity.device)[:, None]
    xs = torch.arange(w, device=intensity.device)[None, :]
    border = (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)
    score = torch.where(border, min_eig, torch.zeros_like(min_eig))
    return score, imops.gaussian_blur(intensity, 1.0, 2)


def patch_score_cuda(intensity: torch.Tensor):
    K.check(intensity, F32, "intensity")
    h, w = intensity.shape
    score = torch.empty_like(intensity)
    blurred = torch.empty_like(intensity)
    k15 = [float(v) for v in imops.gaussian_weights(1.5, 2)]
    k10 = [float(v) for v in imops.gaussian_weights(1.0, 2)]
    f = K.fn("keypoints", "mmf_patch_score", [K.P, K.I, K.I] + [K.F] * 10 + [K.P, K.P])
    K.call("patch_score", f, K.ptr(intensity), h, w, *k15, *k10, K.ptr(score), K.ptr(blurred))
    return score, blurred


def patch_score(intensity: torch.Tensor):
    K.record("patch_score", intensity=intensity)
    impl = patch_score_cuda if intensity.is_cuda else patch_score_plain
    return impl(intensity)


# ---------------------------------------------------------------- nms_topk

def peak_scores(heat: torch.Tensor, conf_thresh: float, nms_radius: int) -> torch.Tensor:
    """Flat [H*W] scores of the NMS peaks (0 elsewhere): the (2r+1)^2 max
    window with -inf padding (SAME), a peak equals its window's max and
    exceeds ``conf_thresh``."""
    r = nms_radius
    h, w = heat.shape
    padded = F.pad(heat, (r, r, r, r), value=float("-inf"))
    local_max = torch.full_like(heat, float("-inf"))
    for oy in range(2 * r + 1):
        for ox in range(2 * r + 1):
            local_max = torch.maximum(local_max, padded[oy:oy + h, ox:ox + w])
    is_peak = (heat == local_max) & (heat > float(np.float32(conf_thresh)))
    return torch.where(is_peak, heat, torch.zeros_like(heat)).reshape(-1)


def nms_topk_plain(heat: torch.Tensor, max_kp: int, conf_thresh: float, nms_radius: int):
    """(xy [K, 2], score [K], valid [K]): the exact top-``max_kp`` of the
    peak scores, ties to the lower flat index (a stable descending sort)."""
    w = heat.shape[1]
    scores = peak_scores(heat, conf_thresh, nms_radius)
    top, idx = torch.sort(scores, descending=True, stable=True)
    top, idx = top[:max_kp], idx[:max_kp]
    xy = torch.stack([(idx % w).to(F32), (idx // w).to(F32)], dim=-1)
    return xy, top, top > 0


def nms_topk_cuda(heat: torch.Tensor, max_kp: int, conf_thresh: float, nms_radius: int):
    K.check(heat, F32, "heat")
    h, w = heat.shape
    n = h * w
    if not 0 < max_kp <= min(_MAX_KP, n):
        raise ValueError(f"max_kp must be in 1..{min(_MAX_KP, n)}")
    if not 0 <= nms_radius <= _MAX_NMS_RADIUS:
        raise ValueError(f"nms_radius must be in 0..{_MAX_NMS_RADIUS}")
    dev = heat.device
    scores = torch.empty((n,), dtype=F32, device=dev)  # the peak scores
    xy = torch.empty((max_kp, 2), dtype=F32, device=dev)
    score = torch.empty((max_kp,), dtype=F32, device=dev)
    valid = torch.empty((max_kp,), dtype=torch.bool, device=dev)
    f = K.fn("keypoints", "mmf_nms_topk", [K.P, K.I, K.I, K.I, K.F, K.I] + [K.P] * 4)
    K.call("nms_topk", f, K.ptr(heat), h, w, max_kp, float(np.float32(conf_thresh)), nms_radius,
           K.ptr(scores), K.ptr(xy), K.ptr(score), K.ptr(valid))
    return xy, score, valid


def nms_topk(heat: torch.Tensor, max_kp: int, conf_thresh: float, nms_radius: int):
    """Max-window NMS and exact top-k of ``heat`` [H, W] (reference ``_nms_topk``)."""
    K.record("nms_topk", heat=heat, max_kp=max_kp, conf_thresh=conf_thresh,
             nms_radius=nms_radius)
    impl = nms_topk_cuda if heat.is_cuda else nms_topk_plain
    return impl(heat, max_kp, conf_thresh, nms_radius)


# ---------------------------------------------------------------- patch_desc

def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (64) in the kernel's order: lane l adds
    elements l and l + 32, then a shuffle-down tree over the 32 lanes."""
    a = x[..., :32] + x[..., 32:]
    for half in (16, 8, 4, 2, 1):
        a = a[..., :half] + a[..., half:2 * half]
    return a[..., 0]


def _patch_coords(xy: torch.Tensor, h: int, w: int):
    offs = (torch.arange(8, dtype=F32, device=xy.device) - 3.5) * 2.0
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    px = xy[:, 0:1] + ox.reshape(1, -1)
    py = xy[:, 1:2] + oy.reshape(1, -1)
    xi = torch.clamp(torch.round(px).to(torch.int64), 0, w - 1)  # round: half to even
    yi = torch.clamp(torch.round(py).to(torch.int64), 0, h - 1)
    return yi, xi


def patch_desc_plain(blurred: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[K, 64] zero-mean, unit descriptors of the 8x8 samples at odd offsets
    -7..7 around each keypoint (nearest pixel, clamped)."""
    h, w = blurred.shape
    yi, xi = _patch_coords(xy, h, w)
    patches = blurred[yi, xi]
    mean = _warp_sum(patches) / 64.0
    c = patches - mean[:, None]
    norm = torch.sqrt(_warp_sum(c * c))
    return c / torch.clamp(norm, min=1e-12)[:, None]


def patch_desc_cuda(blurred: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    K.check(blurred, F32, "blurred")
    K.check(xy, F32, "xy")
    h, w = blurred.shape
    k = xy.shape[0]
    desc = torch.empty((k, PATCH_DESC_DIM), dtype=F32, device=xy.device)
    f = K.fn("keypoints", "mmf_patch_desc", [K.P, K.I, K.I, K.P, K.I, K.P])
    K.call("patch_desc", f, K.ptr(blurred), h, w, K.ptr(xy), k, K.ptr(desc))
    return desc


def patch_desc(blurred: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    K.record("patch_desc", blurred=blurred, xy=xy)
    impl = patch_desc_cuda if blurred.is_cuda else patch_desc_plain
    return impl(blurred, xy)


def patch_detect(intensity: torch.Tensor, max_kp: int, conf_thresh: float = 1.0,
                 nms_radius: int = 4) -> Keypoints:
    """Weights-free detector: Shi-Tomasi corners and normalised patches."""
    score, blurred = patch_score(intensity)
    xy, s, valid = nms_topk(score, max_kp, conf_thresh, nms_radius)
    return Keypoints(xy=xy, score=s, desc=patch_desc(blurred, xy), valid=valid)


# ---------------------------------------------------------------- SuperPoint

_SP_LAYERS = [
    ("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64), ("conv2b", 64, 64),
    ("conv3a", 64, 128), ("conv3b", 128, 128), ("conv4a", 128, 128), ("conv4b", 128, 128),
]
_SP_HEADS = [("convPa", 128, 256), ("convPb", 256, 65), ("convDa", 128, 256),
             ("convDb", 256, 256)]


class SuperPointNet(nn.Module):
    """SuperPoint (DeTone et al.) with the MagicLeap release's layer names."""

    def __init__(self):
        super().__init__()
        for name, cin, cout in _SP_LAYERS + _SP_HEADS:
            k = 1 if name in ("convPb", "convDb") else 3
            setattr(self, name, nn.Conv2d(cin, cout, k, 1, k // 2))

    def forward(self, x: torch.Tensor):
        """x [N, 1, H, W] in 0..1 -> (semi [N, 65, H/8, W/8], desc [N, 256, H/8, W/8])."""
        for i, (name, _, _) in enumerate(_SP_LAYERS):
            x = F.relu(getattr(self, name)(x))
            if i in (1, 3, 5):
                x = F.max_pool2d(x, 2, 2)
        semi = self.convPb(F.relu(self.convPa(x)))
        desc = self.convDb(F.relu(self.convDa(x)))
        return semi, desc


def params_from_numpy(params: Dict[str, np.ndarray]) -> SuperPointNet:
    """The reference package's parameter pytree (``{name}.w`` HWIO and
    ``{name}.b``, as numpy) as a ``SuperPointNet`` (OIHW)."""
    net = SuperPointNet()
    state = {}
    for name, _, _ in _SP_LAYERS + _SP_HEADS:
        w = np.asarray(params[f"{name}.w"], np.float32)
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(params[f"{name}.b"], np.float32))
    net.load_state_dict(state)
    return net.eval()


def load_torchscript(path: str) -> SuperPointNet:
    """A TorchScript ``SuperPointNet.pt`` (the reference's weights) as a
    ``SuperPointNet``; keys ``{name}.weight`` or ``module.{name}.weight``."""
    state = dict(torch.jit.load(path, map_location="cpu").state_dict())
    out = {}
    for name, _, _ in _SP_LAYERS + _SP_HEADS:
        for prefix in ("", "module."):
            if f"{prefix}{name}.weight" in state:
                out[f"{name}.weight"] = state[f"{prefix}{name}.weight"].float()
                out[f"{name}.bias"] = state[f"{prefix}{name}.bias"].float()
                break
        else:
            raise KeyError(f"SuperPoint weight {name} not found in {path}")
    net = SuperPointNet()
    net.load_state_dict(out)
    return net.eval()


@torch.no_grad()
def superpoint_apply(net: SuperPointNet, gray01: torch.Tensor):
    """gray01 [H, W] in 0..1 -> (heat [H, W], coarse desc [H/8, W/8, 256]).

    The convolutions run in full float32 (cuDNN's TF32 off)."""
    h, w = gray01.shape
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        semi, desc = net(gray01[None, None])
    dense = torch.softmax(semi[0], dim=0)[:64]  # [64, H/8, W/8], dustbin dropped
    hc, wc = dense.shape[1:]
    heat = dense.reshape(8, 8, hc, wc).permute(2, 0, 3, 1).reshape(hc * 8, wc * 8)
    desc = desc[0].permute(1, 2, 0)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-12)
    return heat[:h, :w], desc


def superpoint_detect(net: SuperPointNet, intensity: torch.Tensor, max_kp: int,
                      conf_thresh: float = 0.015, nms_radius: int = 4) -> Keypoints:
    heat, coarse = superpoint_apply(net, intensity / 255.0)
    xy, score, valid = nms_topk(heat.contiguous(), max_kp, conf_thresh, nms_radius)
    d = imops.bilinear_sample(coarse, xy[:, 0] / 8.0 - 0.5, xy[:, 1] / 8.0 - 0.5)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    return Keypoints(xy=xy, score=score, desc=d, valid=valid)
