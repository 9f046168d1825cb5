"""Hole-filling of predicted maps with the live frame (FillIn + fill_*.frag).

Port of the reference package's ``model/fillin.py``: wherever the splatted
prediction has no coverage (or passthrough is forced), the live frame stands in,
so the odometry always tracks against a complete reference image.

``splat_fill`` is the engine's call: the splat resolve (kernel K10) with
fill-in as its epilogue (``csrc/splat_resolve.cu``), so the resolve writes
the filled maps directly; ``fill_in`` is the plain version of the epilogue.
The multi-model step resolves in composite mode and fills only the global
model's pixels (``FillFrame.gate``: the mask is 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel
from multimotionfusion_tpu_torch.model import surfel_map as sm
from multimotionfusion_tpu_torch.ops import maps as mapops
from multimotionfusion_tpu_torch.ops import rasterize as R
from multimotionfusion_tpu_torch.ops.rasterize import Composite, FillFrame, IndexMap, PredictedMaps


class FilledMaps(NamedTuple):
    color: torch.Tensor  # [H, W, 3]
    vertex_conf: torch.Tensor  # [H, W, 4] camera frame
    normal_rad: torch.Tensor  # [H, W, 4] camera frame


def fill_in(
    pred: PredictedMaps,
    frame_rgb: torch.Tensor,  # [H, W, 3]
    frame_vmap: torch.Tensor,  # [H, W, 3]
    frame_nmap: torch.Tensor,  # [H, W, 3]
    frame_conf: torch.Tensor,  # [H, W]
    frame_rad: torch.Tensor,  # [H, W]
    passthrough: bool = False,
    gate: torch.Tensor | None = None,  # [H, W] bool: fill only where True
) -> FilledMaps:
    use_frame = ~pred.valid
    if passthrough:
        use_frame = torch.ones_like(use_frame)
    if gate is not None:
        use_frame = use_frame & gate
    use_frame = use_frame[..., None]
    color = torch.where(use_frame, frame_rgb, pred.color)
    vc_frame = torch.cat([frame_vmap, frame_conf[..., None]], dim=-1)
    nr_frame = torch.cat([frame_nmap, frame_rad[..., None]], dim=-1)
    vertex_conf = torch.where(use_frame, vc_frame, pred.vertex_conf)
    normal_rad = torch.where(use_frame, nr_frame, pred.normal_rad)
    return FilledMaps(color=color, vertex_conf=vertex_conf, normal_rad=normal_rad)


def frame_fill_maps(fill: FillFrame, cam: CameraModel):
    """(colour, filtered vertices, normals, confidence at weighting 1.0,
    radius) of the live frame, the inputs ``fill_in`` takes."""
    h, w = cam.height, cam.width
    fd = fill.frame_data.reshape(sm.CHANNELS, h, w)
    vmap = mapops.create_vmap(fill.depth_filt, cam, fill.depth_cutoff)
    nmap = torch.stack([fd[sm.NX], fd[sm.NY], fd[sm.NZ]], dim=-1)
    conf = sm.pixel_confidence(cam, 1.0, device=fill.depth_filt.device)
    return fill.rgb.to(torch.float32), vmap, nmap, conf, fd[sm.RADIUS]


def splat_fill_plain(index, data_local, cam: CameraModel, conf_threshold, time, max_time,
                     time_delta, window: int, fill: FillFrame,
                     composite: Composite | None = None):
    """Plain K10 + fill-in: (predicted maps, filled maps)."""
    pred = R.splat_resolve_plain(index, data_local, cam, conf_threshold, time, max_time,
                                 time_delta, window, composite)
    gate = None if fill.gate is None else fill.gate == 0
    return pred, fill_in(pred, *frame_fill_maps(fill, cam), passthrough=fill.passthrough,
                         gate=gate)


def splat_fill(index_map: IndexMap, cam: CameraModel, conf_threshold, time, max_time,
               time_delta, window: int, fill: FillFrame,
               composite: Composite | None = None) -> FilledMaps:
    """The next frame's prediction, filled in from the live frame."""
    K.record("splat_resolve" if composite is None else "splat_resolve.composite",
             index=index_map.index, data_local=index_map.data_local, cam=cam,
             conf_threshold=conf_threshold, time=time, max_time=max_time,
             time_delta=time_delta, window=window, fill=fill, composite=composite)
    if index_map.index.is_cuda:
        p = R.splat_resolve_cuda(index_map.index, index_map.data_local, cam, conf_threshold, time,
                                 max_time, time_delta, window, fill, composite)
        return FilledMaps(p.color, p.vertex_conf, p.normal_rad)
    return splat_fill_plain(index_map.index, index_map.data_local, cam, conf_threshold, time,
                            max_time, time_delta, window, fill, composite)[1]
