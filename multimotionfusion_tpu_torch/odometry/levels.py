"""Per-level odometry inputs from the frame and the prediction images.

Port of the reference package's ``odometry/levels.py``: frame pyramids are
built once per frame; the prediction side stays in the prediction camera
frame, and its coarse vertex/normal maps are rebuilt from a depth pyramid so
every level is ray-aligned.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from multimotionfusion_tpu_torch.config import CameraModel, OdometryConfig
from multimotionfusion_tpu_torch.odometry.rgbd import LevelData
from multimotionfusion_tpu_torch.ops import image as imops
from multimotionfusion_tpu_torch.ops import maps as mapops


class FramePyramids(NamedTuple):
    depth: List[torch.Tensor]  # filtered metric depth
    intensity: List[torch.Tensor]
    mask: List[torch.Tensor]  # int32 model ids
    didx: List[torch.Tensor]
    didy: List[torch.Tensor]


def build_frame_pyramids(depth, rgb, mask, cfg: OdometryConfig) -> FramePyramids:
    depth_pyr = imops.build_pyramid(depth, cfg.num_pyr)
    int_pyr = imops.build_pyramid(imops.rgb_to_intensity(rgb), cfg.num_pyr)
    mask_pyr = imops.build_pyramid_nearest(mask.to(torch.int32), cfg.num_pyr)
    didx, didy = [], []
    for lvl in range(cfg.num_pyr):
        gx, gy = imops.sobel_gradients(int_pyr[lvl])
        didx.append(gx)
        didy.append(gy)
    return FramePyramids(depth_pyr, int_pyr, mask_pyr, didx, didy)


def build_level_data(
    frame: FramePyramids,
    pred_vmap_cam: torch.Tensor,  # [H,W,3] prediction vertices, prediction camera frame
    pred_nmap_cam: torch.Tensor,
    pred_intensity: torch.Tensor,  # [H,W]
    cam: CameraModel,
    cfg: OdometryConfig,
    mask_id: int = 0,
) -> List[LevelData]:
    pdepth_pyr = imops.build_pyramid(pred_vmap_cam[..., 2], cfg.num_pyr)
    vpyr = [pred_vmap_cam]
    npyr = [pred_nmap_cam]
    for lvl in range(1, cfg.num_pyr):
        v = mapops.create_vmap(pdepth_pyr[lvl], cam.level(lvl), 1e9)
        vpyr.append(v)
        npyr.append(mapops.create_nmap(v))
    depth_last = imops.build_pyramid(
        mapops.vertices_to_depth(pred_vmap_cam, cfg.max_depth_rgb), cfg.num_pyr
    )
    img_last = imops.build_pyramid(pred_intensity, cfg.num_pyr)

    levels = []
    for lvl in range(cfg.num_pyr):
        mask_lvl = frame.mask[lvl]
        vmap_curr = mapops.create_vmap(
            frame.depth[lvl], cam.level(lvl), cfg.max_depth_rgb,
            mask=mask_lvl if cfg.mask_icp else None, mask_id=mask_id,
        )
        levels.append(
            LevelData(
                vmap_curr=vmap_curr,
                nmap_curr=mapops.create_nmap(vmap_curr),
                vmap_prev=vpyr[lvl],
                nmap_prev=npyr[lvl],
                depth_last=depth_last[lvl],
                depth_next=frame.depth[lvl],
                img_last=img_last[lvl],
                img_next=frame.intensity[lvl],
                mask_next=mask_lvl,
                didx=frame.didx[lvl],
                didy=frame.didy[lvl],
            )
        )
    return levels
