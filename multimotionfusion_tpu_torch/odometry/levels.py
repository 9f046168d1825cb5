"""Per-level odometry inputs from the frame and the prediction images (kernel K2).

Port of the reference package's ``odometry/levels.py``: frame pyramids are
built once per frame; the prediction side stays in the prediction camera
frame, and its coarse vertex/normal maps are rebuilt from a depth pyramid so
every level is ray-aligned.

On the card ``frame_levels`` and ``pred_levels`` launch one kernel of
``csrc/pyramid.cu`` per level and side, each writing every field its level
needs (the frame's depth, intensity, Sobel gradients, masked vertex and
normal maps and static photometric validity; the prediction's sampling map);
on CPU tensors they compose the plain functions below
(``build_frame_pyramids``, ``build_level_data``, the reference's API).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel, OdometryConfig
from multimotionfusion_tpu_torch.odometry import rgbd
from multimotionfusion_tpu_torch.odometry.rgbd import GNLevel, LevelData
from multimotionfusion_tpu_torch.ops import image as imops
from multimotionfusion_tpu_torch.ops import maps as mapops

F32 = torch.float32


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


def _pred_pyramids(pred_vmap_cam, pred_nmap_cam, pred_intensity, cam: CameraModel,
                   cfg: OdometryConfig):
    """(vertices, normals, RGB depth, intensity) per level of the prediction."""
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
    return vpyr, npyr, depth_last, img_last


def _frame_vmap(depth, mask, cam_l: CameraModel, cfg: OdometryConfig, mask_id):
    return mapops.create_vmap(depth, cam_l, cfg.max_depth_rgb,
                              mask=mask if cfg.mask_icp else None, mask_id=mask_id)


def build_level_data(
    frame: FramePyramids,
    pred_vmap_cam: torch.Tensor,  # [H,W,3] prediction vertices, prediction camera frame
    pred_nmap_cam: torch.Tensor,
    pred_intensity: torch.Tensor,  # [H,W]
    cam: CameraModel,
    cfg: OdometryConfig,
    mask_id: int = 0,
) -> List[LevelData]:
    vpyr, npyr, depth_last, img_last = _pred_pyramids(pred_vmap_cam, pred_nmap_cam,
                                                      pred_intensity, cam, cfg)
    levels = []
    for lvl in range(cfg.num_pyr):
        vmap_curr = _frame_vmap(frame.depth[lvl], frame.mask[lvl], cam.level(lvl), cfg, mask_id)
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
                mask_next=frame.mask[lvl],
                didx=frame.didx[lvl],
                didy=frame.didy[lvl],
            )
        )
    return levels


class FrameLevel(NamedTuple):
    """One level of the frame side (what the GN loop and the next frame read)."""

    depth: torch.Tensor  # [H,W] filtered depth
    img: torch.Tensor  # [H,W] intensity
    didx: torch.Tensor  # [H,W] Sobel (int16-truncated)
    didy: torch.Tensor
    vmap: torch.Tensor  # [H,W,3] masked vertices (max_depth_rgb cutoff)
    nmap: torch.Tensor  # [H,W,3]
    static_valid: torch.Tensor  # [H,W] bool, rgb_static_valid


def _min_scale(cfg: OdometryConfig, lvl: int) -> float:
    return (cfg.min_grad_magnitudes[lvl] ** 2) / (cfg.sobel_scale**2)


def _use_terms(cfg: OdometryConfig):
    return (not cfg.rgb_only) and cfg.icp_weight > 0, cfg.rgb_only or cfg.icp_weight < 100


def frame_levels_plain(depth_filt, rgb_u8, mask, cam: CameraModel, cfg: OdometryConfig,
                       mask_id: int = 0) -> List[FrameLevel]:
    fp = build_frame_pyramids(depth_filt, rgb_u8.to(F32), mask, cfg)
    _, use_rgb = _use_terms(cfg)
    out = []
    for lvl in range(cfg.num_pyr):
        vmap = _frame_vmap(fp.depth[lvl], fp.mask[lvl], cam.level(lvl), cfg, mask_id)
        if use_rgb:
            sv = rgbd.static_valid(fp.intensity[lvl], fp.mask[lvl], fp.didx[lvl], fp.didy[lvl],
                                   fp.depth[lvl], _min_scale(cfg, lvl), mask_id, cfg.mask_rgb)
        else:
            sv = torch.zeros(fp.depth[lvl].shape, dtype=torch.bool, device=depth_filt.device)
        out.append(FrameLevel(fp.depth[lvl], fp.intensity[lvl], fp.didx[lvl], fp.didy[lvl],
                              vmap, mapops.create_nmap(vmap), sv))
    return out


_FRAME_ARGS = [K.I] * 5 + [K.P] * 4 + [K.I] * 5 + [K.F] * 8 + [K.P] * 7


def frame_level_cuda(lvl: int, finer, depth_filt, rgb_u8, mask, cam: CameraModel,
                     cfg: OdometryConfig, mask_id: int = 0) -> FrameLevel:
    """Level ``lvl`` of the frame side on the card (``csrc/pyramid.cu``) from
    the finer level (``finer``, None at level 0: the filtered depth and the
    colour)."""
    h0, w0 = depth_filt.shape
    cam_l = cam.level(lvl)
    h, w = cam_l.height, cam_l.width
    hp, wp = (h0, w0) if finer is None else finer.img.shape
    dev = depth_filt.device
    new = lambda *s: torch.empty(s, dtype=F32, device=dev)  # noqa: E731
    depth = depth_filt if lvl == 0 else new(h, w)
    img, didx, didy, vmap, nmap = new(h, w), new(h, w), new(h, w), new(h, w, 3), new(h, w, 3)
    sv = torch.empty((h, w), dtype=torch.bool, device=dev)
    _, use_rgb = _use_terms(cfg)
    f = K.fn("pyramid", "mmf_pyramid_frame", _FRAME_ARGS)
    K.call(
        f"pyramid.frame.L{lvl}", f, lvl, h, w, hp, wp,
        K.ptr(depth_filt if finer is None else finer.depth),
        None if finer is None else K.ptr(finer.img), K.ptr(rgb_u8), K.ptr(mask), w0,
        int(mask_id), int(cfg.mask_icp), int(cfg.mask_rgb), int(use_rgb),
        cam_l.fx, cam_l.fy, cam_l.cx, cam_l.cy, 1.0 / cam_l.fx, 1.0 / cam_l.fy,
        float(cfg.max_depth_rgb), _min_scale(cfg, lvl),
        None if lvl == 0 else K.ptr(depth), K.ptr(img), K.ptr(didx), K.ptr(didy), K.ptr(vmap),
        K.ptr(nmap), K.ptr(sv),
    )
    return FrameLevel(depth, img, didx, didy, vmap, nmap, sv)


def frame_levels(depth_filt, rgb_u8, mask, cam: CameraModel, cfg: OdometryConfig,
                 mask_id: int = 0) -> List[FrameLevel]:
    """The frame side of every level, index 0 = finest."""
    K.record("pyramid.frame", depth_filt=depth_filt, rgb_u8=rgb_u8, mask=mask, cam=cam,
             cfg=cfg, mask_id=mask_id)
    if not depth_filt.is_cuda:
        return frame_levels_plain(depth_filt, rgb_u8, mask, cam, cfg, mask_id)
    K.check(depth_filt, F32, "depth_filt")
    K.check(rgb_u8, torch.uint8, "rgb")
    K.check(mask, torch.int32, "mask")
    if tuple(rgb_u8.shape) != tuple(depth_filt.shape) + (3,) or mask.shape != depth_filt.shape:
        raise ValueError("rgb must be [H, W, 3] and mask [H, W] like the depth")
    out = []
    for lvl in range(cfg.num_pyr):
        out.append(frame_level_cuda(lvl, out[-1] if out else None, depth_filt, rgb_u8, mask,
                                    cam, cfg, mask_id))
    return out


def pred_levels_plain(vertex_conf, normal_rad, color, cam: CameraModel,
                      cfg: OdometryConfig) -> List[torch.Tensor]:
    use_icp, _ = _use_terms(cfg)
    vpyr, npyr, depth_last, img_last = _pred_pyramids(
        vertex_conf[..., :3], normal_rad[..., :3], imops.rgb_to_intensity(color), cam, cfg)
    return [rgbd.pred_map(vpyr[lvl], npyr[lvl], depth_last[lvl], img_last[lvl], use_icp and lvl == 0) for lvl in range(cfg.num_pyr)]


_PRED_ARGS = [K.I] * 6 + [K.P] * 6 + [K.F] * 7 + [K.P] * 4


def pred_level_cuda(lvl: int, finer, vertex_conf, normal_rad, color, cam: CameraModel,
                    cfg: OdometryConfig):
    """Level ``lvl`` of the prediction side on the card (``csrc/pyramid.cu``):
    (sampling map, (depth, RGB depth, intensity) pyramids of this level for
    the next one; None at level 0). ``finer`` is the finer level's pyramids
    (None at levels 0 and 1, which read the filled prediction)."""
    use_icp, _ = _use_terms(cfg)
    cam_l = cam.level(lvl)
    h, w = cam_l.height, cam_l.width
    hp, wp = (cam.height, cam.width) if finer is None else finer[0].shape
    dev = vertex_conf.device
    compact = use_icp and lvl == 0
    pred = torch.empty((h, w, 8), dtype=torch.bfloat16 if compact else F32, device=dev)
    cur = None if lvl == 0 else tuple(torch.empty((h, w), dtype=F32, device=dev) for _ in range(3))
    f = K.fn("pyramid", "mmf_pyramid_pred", _PRED_ARGS)
    K.call(
        f"pyramid.pred.L{lvl}", f, lvl, h, w, hp, wp, int(compact),
        K.ptr(vertex_conf), K.ptr(normal_rad), K.ptr(color),
        *((None,) * 3 if finer is None else (K.ptr(t) for t in finer)),
        cam_l.fx, cam_l.fy, cam_l.cx, cam_l.cy, 1.0 / cam_l.fx, 1.0 / cam_l.fy,
        float(cfg.max_depth_rgb), *((None,) * 3 if cur is None else (K.ptr(t) for t in cur)),
        K.ptr(pred),
    )
    return pred, cur


def pred_levels(vertex_conf, normal_rad, color, cam: CameraModel,
                cfg: OdometryConfig) -> List[torch.Tensor]:
    """The prediction's sampling map of every level (``GNLevel.pred``) from
    the filled prediction ([H,W,4] vertex+conf, [H,W,4] normal+radius,
    [H,W,3] colour)."""
    K.record("pyramid.pred", vertex_conf=vertex_conf, normal_rad=normal_rad, color=color,
             cam=cam, cfg=cfg)
    if not vertex_conf.is_cuda:
        return pred_levels_plain(vertex_conf, normal_rad, color, cam, cfg)
    for t, c, name in ((vertex_conf, 4, "vertex_conf"), (normal_rad, 4, "normal_rad"),
                       (color, 3, "color")):
        K.check(t, F32, name)
        if tuple(t.shape) != (cam.height, cam.width, c):
            raise ValueError(f"{name} must be [H, W, {c}]")
    maps, finer = [], None
    for lvl in range(cfg.num_pyr):
        pred, cur = pred_level_cuda(lvl, finer, vertex_conf, normal_rad, color, cam, cfg)
        maps.append(pred)
        finer = cur
    return maps


def gn_levels(frame: List[FrameLevel], preds: List[torch.Tensor], cam: CameraModel,
              cfg: OdometryConfig) -> List[GNLevel]:
    """The GN loop's per-level inputs (no data moves: views of both sides)."""
    use_icp, _ = _use_terms(cfg)
    return [
        GNLevel(pred=preds[i], compact=use_icp and i == 0, vmap=f.vmap, nmap=f.nmap, img=f.img,
                didx=f.didx, didy=f.didy, static_valid=f.static_valid,
                stride=rgbd.level_stride(i, cfg, cam))
        for i, f in enumerate(frame)
    ]
