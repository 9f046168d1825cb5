"""Per-level odometry inputs from the frame and the prediction images (kernel K2).

Port of the reference package's ``odometry/levels.py``: frame pyramids are
built once per frame; the prediction side stays in the prediction camera
frame, and its coarse vertex/normal maps are rebuilt from a depth pyramid so
every level is ray-aligned.

On the card ``frame_levels`` and ``pred_levels`` launch one kernel of
``csrc/pyramid.cu`` a side, which writes every field of every level (the
frame's depth, intensity, Sobel gradients, masked vertex and normal maps and
static photometric validity; the prediction's sampling map); on CPU tensors
they compose the plain functions below (``build_frame_pyramids``,
``build_level_data``, the reference's API). ``regions``, ``tile`` and
``grid`` state the kernels' tiling.
"""

from __future__ import annotations

import ctypes
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


# csrc/pyramid.cu's plan: one launch a side builds every level (at most
# MAX_LEVELS), a block per TILE x TILE tile of level 2 and the tiles of levels
# 1 and 0 above it (each twice the size of the next coarser). A block stages
# each level's base fields on its tile widened by a halo (before, after):
# what the level's outputs read around a pixel (OUT_HALO) and what the next
# coarser level's base cells read of it (the 5x5 Gaussian centred on 2x).
MAX_LEVELS = 3
TILE = 8
# frame: Sobel, normals and the static-validity window read [x - 2, x + 1];
# prediction: the coarse maps' normals read x + 1, level 0's map x alone
OUT_HALO = {"frame": ((2, 1),) * MAX_LEVELS, "pred": ((0, 0), (0, 1), (0, 1))}
GAUSS_REACH = 2  # a coarse cell x reads the finer [2x - 2, 2x + 2]


def level_sizes(h: int, w: int, levels: int):
    """(height, width) of each level: halved rounding up, as the plain
    version's strided taps give them (the camera's ``level`` rounds down; the
    two agree wherever a size stays even)."""
    sizes = [(h, w)]
    for _ in range(levels - 1):
        h, w = (h + 1) // 2, (w + 1) // 2
        sizes.append((h, w))
    return sizes


def regions(side: str):
    """(before, after) of each level's staged region around its tile: the
    level's own output halo and what the next coarser level's region reads."""
    need = [None] * MAX_LEVELS
    for lvl in reversed(range(MAX_LEVELS)):
        b, a = OUT_HALO[side][lvl]
        if lvl + 1 < MAX_LEVELS:
            # the coarser region [t - cb, t + T + ca) reads [2t - 2cb - 2, 2t + 2T + 2ca + 1)
            cb, ca = need[lvl + 1]
            b, a = max(b, 2 * cb + GAUSS_REACH), max(a, 2 * ca + GAUSS_REACH - 1)
        need[lvl] = (b, a)
    return tuple(need)


def tile(level: int, b: int):
    """[start, stop) of block ``b``'s tile of ``level`` along one axis."""
    size = TILE << (MAX_LEVELS - 1 - level)
    return b * size, (b + 1) * size


def grid(h: int, w: int):
    """(blocks across, blocks down) of a side's launch for an [h, w] level 0."""
    h2, w2 = level_sizes(h, w, MAX_LEVELS)[-1]
    return -(-w2 // TILE), -(-h2 // TILE)


def _level_params(cam: CameraModel, cfg: OdometryConfig, levels: int):
    """Each level's (fx, fy, cx, cy, 1/fx, 1/fy, min_scale), a host array."""
    vals = []
    for lvl in range(MAX_LEVELS):
        if lvl < levels:
            c = cam.level(lvl)
            vals += [c.fx, c.fy, c.cx, c.cy, 1.0 / c.fx, 1.0 / c.fy, _min_scale(cfg, lvl)]
        else:
            vals += [0.0] * 7
    return (ctypes.c_float * len(vals))(*vals)


def _levels(cfg: OdometryConfig) -> int:
    if not 1 <= cfg.num_pyr <= MAX_LEVELS:
        raise ValueError(f"the pyramid kernels build 1 to {MAX_LEVELS} levels, not {cfg.num_pyr}")
    return cfg.num_pyr


_FRAME_ARGS = [K.I] * 3 + [K.P] * 3 + [K.I] * 4 + [K.F] + [K.P] * 2


def frame_levels_cuda(depth_filt, rgb_u8, mask, cam: CameraModel, cfg: OdometryConfig,
                      mask_id: int = 0) -> List[FrameLevel]:
    """Every level of the frame side in one launch of ``csrc/pyramid.cu``."""
    n = _levels(cfg)
    h0, w0 = depth_filt.shape
    dev = depth_filt.device
    new = lambda *s: torch.empty(s, dtype=F32, device=dev)  # noqa: E731
    out, ptrs = [], []
    for lvl, (h, w) in enumerate(level_sizes(h0, w0, n)):
        lv = FrameLevel(depth_filt if lvl == 0 else new(h, w), new(h, w), new(h, w), new(h, w),
                        new(h, w, 3), new(h, w, 3),
                        torch.empty((h, w), dtype=torch.bool, device=dev))
        out.append(lv)
        ptrs += [None if lvl == 0 else K.ptr(lv.depth)] + [K.ptr(t) for t in lv[1:]]
    ptrs += [None] * (7 * (MAX_LEVELS - n))
    _, use_rgb = _use_terms(cfg)
    f = K.fn("pyramid", "mmf_pyramid_frame", _FRAME_ARGS)
    K.call("pyramid.frame", f, h0, w0, n, K.ptr(depth_filt), K.ptr(rgb_u8), K.ptr(mask),
           int(mask_id), int(cfg.mask_icp), int(cfg.mask_rgb), int(use_rgb),
           float(cfg.max_depth_rgb), _level_params(cam, cfg, n),
           (ctypes.c_void_p * len(ptrs))(*ptrs))
    return out


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
    if tuple(depth_filt.shape) != (cam.height, cam.width):
        raise ValueError("the depth must be [H, W] of the camera")
    if tuple(rgb_u8.shape) != tuple(depth_filt.shape) + (3,) or mask.shape != depth_filt.shape:
        raise ValueError("rgb must be [H, W, 3] and mask [H, W] like the depth")
    return frame_levels_cuda(depth_filt, rgb_u8, mask, cam, cfg, mask_id)


def pred_levels_plain(vertex_conf, normal_rad, color, cam: CameraModel,
                      cfg: OdometryConfig) -> List[torch.Tensor]:
    use_icp, _ = _use_terms(cfg)
    vpyr, npyr, depth_last, img_last = _pred_pyramids(
        vertex_conf[..., :3], normal_rad[..., :3], imops.rgb_to_intensity(color), cam, cfg)
    return [rgbd.pred_map(vpyr[lvl], npyr[lvl], depth_last[lvl], img_last[lvl], use_icp and lvl == 0) for lvl in range(cfg.num_pyr)]


_PRED_ARGS = [K.I] * 4 + [K.P] * 3 + [K.F] + [K.P] * 2


def pred_levels_cuda(vertex_conf, normal_rad, color, cam: CameraModel,
                     cfg: OdometryConfig) -> List[torch.Tensor]:
    """Every level's sampling map in one launch of ``csrc/pyramid.cu``."""
    n = _levels(cfg)
    use_icp, _ = _use_terms(cfg)
    dev = vertex_conf.device
    maps = [torch.empty((h, w, 8), dtype=torch.bfloat16 if use_icp and lvl == 0 else F32,
                        device=dev)
            for lvl, (h, w) in enumerate(level_sizes(cam.height, cam.width, n))]
    ptrs = [K.ptr(m) for m in maps] + [None] * (MAX_LEVELS - n)
    f = K.fn("pyramid", "mmf_pyramid_pred", _PRED_ARGS)
    K.call("pyramid.pred", f, cam.height, cam.width, n, int(use_icp), K.ptr(vertex_conf),
           K.ptr(normal_rad), K.ptr(color), float(cfg.max_depth_rgb),
           _level_params(cam, cfg, n), (ctypes.c_void_p * len(ptrs))(*ptrs))
    return maps


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
    return pred_levels_cuda(vertex_conf, normal_rad, color, cam, cfg)


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
