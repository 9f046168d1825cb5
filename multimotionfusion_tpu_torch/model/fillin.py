"""Hole-filling of predicted maps with the live frame (FillIn + fill_*.frag).

Port of the reference package's ``model/fillin.py``: wherever the splatted
prediction has no coverage (or passthrough is forced), the live frame stands in,
so the odometry always tracks against a complete reference image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimotionfusion_tpu_torch.ops.rasterize import PredictedMaps


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
) -> FilledMaps:
    use_frame = ~pred.valid
    if passthrough:
        use_frame = torch.ones_like(use_frame)
    use_frame = use_frame[..., None]
    color = torch.where(use_frame, frame_rgb, pred.color)
    vc_frame = torch.cat([frame_vmap, frame_conf[..., None]], dim=-1)
    nr_frame = torch.cat([frame_nmap, frame_rad[..., None]], dim=-1)
    vertex_conf = torch.where(use_frame, vc_frame, pred.vertex_conf)
    normal_rad = torch.where(use_frame, nr_frame, pred.normal_rad)
    return FilledMaps(color=color, vertex_conf=vertex_conf, normal_rad=normal_rad)
