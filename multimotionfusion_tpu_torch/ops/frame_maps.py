"""The frame's filtered depth and surfel candidates (kernel K1, ``csrc/frame_maps.cu``).

- ``frame_depth``: raw depth (uint16 millimetres carried as int16 bits, or
  metres) -> (metric depth, bilateral-filtered depth), launch 1;
- ``frame_surfels``: raw and filtered vertex maps, the filtered normals and
  the [16, H*W] surfel candidates with their valid mask, launch 2. The fusion
  weighting is a 0-dim tensor that the kernel reads on the card.

Each wrapper launches the CUDA kernel for CUDA tensors and takes the plain
PyTorch version (``*_plain``, the reference package's functions composed)
only for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel
from multimotionfusion_tpu_torch.model import surfel_map as sm
from multimotionfusion_tpu_torch.ops import image as imops
from multimotionfusion_tpu_torch.ops import maps as mapops

F32 = torch.float32
# bilateral_depth_filter's defaults
_MIN_D, _MAX_D, _SIGMA_SPACE, _SIGMA_COLOR = 0.3, 20.0, 0.024691358, 555.556


def frame_depth_plain(depth_raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d = depth_raw
    if not d.is_floating_point():  # raw sensor millimetres (uint16 carried as int16 bits)
        d = (d.to(torch.int32) & 0xFFFF).to(F32) * 0.001
    return d, imops.bilateral_depth_filter(d)


def frame_depth_cuda(depth_raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    is_mm = not depth_raw.is_floating_point()
    K.check(depth_raw, torch.int16 if is_mm else F32, "depth_raw")
    h, w = depth_raw.shape
    depth_m = torch.empty((h, w), dtype=F32, device=depth_raw.device)
    depth_filt = torch.empty_like(depth_m)
    f = K.fn("frame_maps", "mmf_frame_depth",
             [K.P, K.I, K.I, K.I, K.F, K.F, K.D, K.F, K.P, K.P])
    K.call("frame_maps.filter", f, K.ptr(depth_raw), int(is_mm), h, w, _MIN_D, _MAX_D,
           _SIGMA_SPACE, _SIGMA_COLOR, K.ptr(depth_m), K.ptr(depth_filt))
    return depth_m, depth_filt


def frame_depth(depth_raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(metric depth, filtered depth), both [H, W] float32 metres."""
    K.record("frame_maps.filter", depth_raw=depth_raw)
    impl = frame_depth_cuda if depth_raw.is_cuda else frame_depth_plain
    return impl(depth_raw)


def frame_surfels_plain(rgb_u8, depth_m, depth_filt, cam: CameraModel, time, max_depth: float,
                        weighting) -> sm.FrameSurfels:
    vmap_raw = mapops.create_vmap(depth_m, cam, max_depth)
    vmap_f = mapops.create_vmap(depth_filt, cam, max_depth)
    nmap_f = mapops.create_nmap(vmap_f)
    return sm.compute_frame_surfels(rgb_u8.to(F32), vmap_raw, vmap_f, nmap_f, cam, time,
                                    max_depth, weighting)


def frame_surfels_cuda(rgb_u8, depth_m, depth_filt, cam: CameraModel, time, max_depth: float,
                       weighting) -> sm.FrameSurfels:
    K.check(rgb_u8, torch.uint8, "rgb")
    K.check(depth_m, F32, "depth_m")
    K.check(depth_filt, F32, "depth_filt")
    K.check(weighting, F32, "weighting")
    h, w = depth_m.shape
    if tuple(rgb_u8.shape) != (h, w, 3) or (h, w) != (cam.height, cam.width):
        raise ValueError("rgb must be [H, W, 3] and the depths [H, W] of the camera")
    dev = depth_m.device
    data = torch.empty((sm.CHANNELS, h * w), dtype=F32, device=dev)
    valid = torch.empty((h * w,), dtype=torch.bool, device=dev)
    f = K.fn("frame_maps", "mmf_frame_surfels",
             [K.P, K.P, K.P, K.I, K.I] + [K.F] * 6 + [K.F, K.F, K.F, K.P, K.F, K.P, K.P])
    mean_focal = (abs(cam.fx) + abs(cam.fy)) / 2.0
    K.call("frame_maps.surfels", f, K.ptr(depth_m), K.ptr(depth_filt), K.ptr(rgb_u8), h, w,
           cam.fx, cam.fy, cam.cx, cam.cy, 1.0 / cam.fx, 1.0 / cam.fy, float(max_depth),
           float(max_depth), float(time), K.ptr(weighting), 1.4142135623730951 / mean_focal,
           K.ptr(data), K.ptr(valid))
    return sm.FrameSurfels(data=data, valid=valid)


def frame_surfels(rgb_u8, depth_m, depth_filt, cam: CameraModel, time, max_depth: float,
                  weighting) -> sm.FrameSurfels:
    """Surfel candidates of the frame: positions from the raw depth, normals
    and radius from the filtered depth, confidence scaled by ``weighting``
    (a 0-dim float32 tensor on the frame's device)."""
    K.record("frame_maps.surfels", rgb_u8=rgb_u8, depth_m=depth_m, depth_filt=depth_filt, cam=cam,
             time=time, max_depth=max_depth, weighting=weighting)
    impl = frame_surfels_cuda if depth_m.is_cuda else frame_surfels_plain
    return impl(rgb_u8, depth_m, depth_filt, cam, time, max_depth, weighting)
