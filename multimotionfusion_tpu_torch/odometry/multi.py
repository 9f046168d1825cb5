"""Composite multi-model dense odometry: all rigid-body models in one pass.

Port of the reference package's ``odometry/multi.py``
(``multi_incremental_transformation``). The previous frame's mask partitions
the pixels between the M models (model 0 = the camera / global map, slot k =
model k + 1), so one image-sized Gauss-Newton pass solves every model: each
pixel is warped by its owner's increment, its prediction taps must belong to
its owner (``bank_own``: the prediction's winner model with a 2-px no-owner
band at global-owned ownership boundaries), and the rows reduce into [M]
per-model ICP and photometric systems.

Kernels (K11):
- ``owner_prep`` (``csrc/gn_multi.cu``): per pyramid level the owner map
  (nearest pyramid of the mask), the eroded prediction owner map (the
  reference's wrap-around ``jnp.roll`` erosion, reproduced) and the
  owner-aware photometric validity (``rgb_static_valid_multi``);
- ``gn_multi`` (``csrc/gn_multi.cu``): one evaluation of all models' 7x7 ICP
  and RGB systems plus counts, in ``gn_reduce``'s two-pass fixed-order shape;
- the M-wide steps of K5 (``csrc/gn_step.cu``): ``multi_init``,
  ``multi_seed`` and ``multi_arbitrate`` (the per-model seed arbitration) and
  ``gn_step_multi`` (the per-model solve, update, convergence and stop flags;
  a level's loop runs while any model has not stopped).

The SO(3) pre-alignment runs once for the camera (K3 ``so3_reduce`` and K5
``so3_step`` on the state's last row) with the reference's convergence test
kept verbatim (``verbatim=True``).

The loop state is [(M + 1) * S_SIZE] floats on the device: row m < M holds
model m's increment, stop flag, errors and counts and its active flag
(``S_ACTIVE``), row M the SO(3) loop and the level loop's done flag and
counters. Nothing is read back.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel, OdometryConfig
from multimotionfusion_tpu_torch.odometry import rgbd
from multimotionfusion_tpu_torch.odometry.levels import FrameLevel, _min_scale
from multimotionfusion_tpu_torch.odometry.rgbd import (
    F32, HOST, S_GN_DONE, S_GN_ITERS, S_GN_J, S_ICP_COUNT, S_ICP_ERR, S_LAST_A, S_LAST_B,
    S_RGB_COUNT, S_RGB_ERR, S_RT, S_RT_INV, S_SIZE, GNLevel, GNParams,
)
from multimotionfusion_tpu_torch.ops.image import _shift2d
from multimotionfusion_tpu_torch.utils import se3

S_ACTIVE = 108  # per-model row: the model is active (holds its pose otherwise)
MAX_MODELS = 8
N_SLOTS = 64  # per-model stride of the sums (layout of rgbd.N_SUMS)


class MultiOdometryResult(NamedTuple):
    poses: torch.Tensor  # [M, 4, 4]
    icp_error: torch.Tensor  # [M]
    icp_count: torch.Tensor
    rgb_error: torch.Tensor
    rgb_count: torch.Tensor
    A: torch.Tensor  # [M, 6, 6]
    b: torch.Tensor  # [M, 6]
    state: torch.Tensor  # [(M + 1) * S_SIZE]


class MultiLevel(NamedTuple):
    """One level's GN inputs: the frame and prediction fields (``gl``, its
    static validity the owner-aware one), the row owner and the tap owner."""

    gl: GNLevel
    own: torch.Tensor  # [H, W] int32 owner of each frame pixel (M or more: none)
    bank_own: torch.Tensor  # [H, W] int32 owner of each prediction pixel


# ---------------------------------------------------------------- owner prep

def erode_owner(pred_own: torch.Tensor, n_models: int) -> torch.Tensor:
    """The 2-px no-owner band: a GLOBAL-owned pixel whose diamond of radius 2
    (two 4-neighbour max/min sweeps, wrapping around the borders like
    jnp.roll) holds another owner becomes ``n_models`` (no owner)."""
    own0 = pred_own.to(torch.int32)
    mx = mn = own0
    for _ in range(2):
        mx2, mn2 = mx, mn
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            mx2 = torch.maximum(mx2, torch.roll(mx, (dy, dx), dims=(0, 1)))
            mn2 = torch.minimum(mn2, torch.roll(mn, (dy, dx), dims=(0, 1)))
        mx, mn = mx2, mn2
    return torch.where((own0 == 0) & (mx != mn), torch.full_like(own0, n_models), own0)


def static_valid_multi(img, own, didx, didy, depth, min_scale: float, n_models: int):
    """``rgb_static_valid_multi``: every in-bounds tap of the 4x4 window
    (offsets -2..+1) intensity-valid and owned by the centre's owner; the
    gradient gate, valid depth, an owner, the right/bottom borders."""
    h, w = img.shape
    dev = img.device
    ok = (img > 0) & (own < n_models)
    neigh = torch.zeros((h, w), dtype=F32, device=dev)
    taps = torch.zeros((h, w), dtype=F32, device=dev)
    okf = ok.to(F32)
    ones = torch.ones((h, w), dtype=F32, device=dev)
    for oy in (-2, -1, 0, 1):
        for ox in (-2, -1, 0, 1):
            same = (_shift2d(own, oy, ox, 0) == own).to(F32)
            neigh = neigh + _shift2d(okf, oy, ox, 0.0) * same
            taps = taps + _shift2d(ones, oy, ox, 0.0)
    valid = neigh >= taps - 1e-3
    xg = torch.arange(w, device=dev)[None, :]
    yg = torch.arange(h, device=dev)[:, None]
    valid = valid & (xg < w - 5) & (yg < h - 1)
    valid = valid & (didx * didx + didy * didy >= min_scale) & (depth > 0) & ok
    return valid


def owner_level_plain(lvl: int, prev_mask, pred_own, fl: FrameLevel, n_models: int,
                      min_scale: float):
    """(own, bank_own, static validity) of pyramid level ``lvl`` (plain)."""
    s = 1 << lvl
    own = prev_mask.to(torch.int32)[::s, ::s].contiguous()
    bank_own = erode_owner(pred_own, n_models)[::s, ::s].contiguous()
    sv = static_valid_multi(fl.img, own, fl.didx, fl.didy, fl.depth, min_scale, n_models)
    return own, bank_own, sv


_OWN_ARGS = [K.I, K.P, K.P, K.I, K.I, K.I, K.I, K.I] + [K.P] * 4 + [K.F] + [K.P] * 3


def owner_level_cuda(lvl: int, prev_mask, pred_own, fl: FrameLevel, n_models: int,
                     min_scale: float):
    """K11's owner prep on the card: ``csrc/gn_multi.cu`` ``mmf_owner_prep``."""
    K.check(prev_mask, torch.int32, "prev_mask")
    K.check(pred_own, torch.int32, "pred_own")
    for name in ("img", "didx", "didy", "depth"):
        K.check(getattr(fl, name), F32, name)
    H0, W0 = prev_mask.shape
    h, w = fl.img.shape
    if pred_own.shape != prev_mask.shape or (H0 >> lvl, W0 >> lvl) != (h, w):
        raise ValueError("pred_own must match the mask, the level must be the mask's >> lvl")
    dev = prev_mask.device
    own = torch.empty((h, w), dtype=torch.int32, device=dev)
    bank_own = torch.empty((h, w), dtype=torch.int32, device=dev)
    sv = torch.empty((h, w), dtype=torch.bool, device=dev)
    f = K.fn("gn_multi", "mmf_owner_prep", _OWN_ARGS)
    K.call(f"owner_prep.L{lvl}", f, lvl, K.ptr(prev_mask), K.ptr(pred_own), H0, W0, h, w,
           n_models, K.ptr(fl.img), K.ptr(fl.didx), K.ptr(fl.didy), K.ptr(fl.depth),
           float(min_scale), K.ptr(own), K.ptr(bank_own), K.ptr(sv))
    return own, bank_own, sv


def owner_levels(prev_mask, pred_own, frame: List[FrameLevel], gl: List[GNLevel],
                 cfg: OdometryConfig, n_models: int) -> List[MultiLevel]:
    """Every level's MultiLevel from the frame side (K2's output, computed
    without masks), the GN inputs and the two owner images."""
    K.record("owner_prep", prev_mask=prev_mask, pred_own=pred_own, frame=frame, gl=gl, cfg=cfg,
             n_models=n_models)
    out = []
    for lvl, (fl, g) in enumerate(zip(frame, gl)):
        impl = owner_level_cuda if prev_mask.is_cuda else owner_level_plain
        own, bank_own, sv = impl(lvl, prev_mask, pred_own, fl, n_models, _min_scale(cfg, lvl))
        out.append(MultiLevel(g._replace(static_valid=sv), own, bank_own))
    return out


# ---------------------------------------------------------------- K11 reduce

def _own_taps_ok(bank_own, uf, vf, own_row):
    """All four bilinear taps (the sampler's clamped corners) owned by the row's model."""
    h, w = bank_own.shape
    u0 = torch.clamp(torch.clamp(torch.floor(uf), -2.0**30, 2.0**30).to(torch.int32), 0, w - 2).long()
    v0 = torch.clamp(torch.clamp(torch.floor(vf), -2.0**30, 2.0**30).to(torch.int32), 0, h - 2).long()
    ok = torch.ones_like(own_row, dtype=torch.bool)
    for dy in (0, 1):
        for dx in (0, 1):
            ok = ok & (bank_own[v0 + dy, u0 + dx] == own_row)
    return ok


def multi_rows(ml: MultiLevel, Tinv_all: torch.Tensor, cam_l: CameraModel, scale2: float,
               p: GNParams, n_models: int):
    """The evaluated grid's masked ICP and RGB rows [P, 7] (the RGB rows
    weighted with each owner's count), each pixel's owner [P] and the [M, 3]
    ICP count, RGB count and sum diff^2 per model."""
    lv = ml.gl
    dev = lv.img.device
    M = n_models
    s = lv.stride
    vmap, nmap = lv.vmap[::s, ::s], lv.nmap[::s, ::s]
    img, didx, didy = lv.img[::s, ::s], lv.didx[::s, ::s], lv.didy[::s, ::s]
    sv = lv.static_valid[::s, ::s]
    own = ml.own[::s, ::s]
    T = Tinv_all.to(dev, F32)
    if T.dim() == 2:
        T = T.expand(M, 4, 4)
    own_c = torch.clamp(own, 0, M - 1).long()
    Tp = T[own_c]  # [h, w, 4, 4]
    Ri, ti = Tp[..., :3, :3], Tp[..., :3, 3]
    vcp = torch.einsum("hwij,hwj->hwi", Ri, vmap) + ti
    z = vcp[..., 2]
    safe_z = torch.where(z != 0, z, torch.ones_like(z))
    uf = vcp[..., 0] * cam_l.fx / safe_z + cam_l.cx
    vf = vcp[..., 1] * cam_l.fy / safe_z + cam_l.cy
    d_cp, d_ok, n_cp, n_ok, dl, dl_ok, il, il_ok = rgbd._sample(lv, uf, vf, cam_l, p)
    own_ok = _own_taps_ok(ml.bank_own, uf, vf, own)
    d_ok, n_ok, dl_ok, il_ok = d_ok & own_ok, n_ok & own_ok, dl_ok & own_ok, il_ok & own_ok

    # ICP rows
    n_cp = n_cp / torch.clamp(torch.linalg.norm(n_cp, dim=-1, keepdim=True), min=1e-12)
    in_bounds = d_ok & n_ok & (z > 0) & (vmap[..., 2] > 0)
    nc_cp = torch.einsum("hwij,hwj->hwi", Ri, nmap)
    dist = torch.linalg.norm(d_cp - vcp, dim=-1)
    sine = torch.linalg.norm(torch.linalg.cross(nc_cp, n_cp, dim=-1), dim=-1)
    ncurr_valid = torch.sum(nmap * nmap, dim=-1) > 0
    found = in_bounds & (sine < p.angle_thresh) & (dist <= p.dist_thresh) & ncurr_valid
    r = torch.sum(n_cp * (vcp - d_cp), dim=-1)
    icp_rows = torch.cat([n_cp, torch.linalg.cross(vcp, n_cp, dim=-1), r[..., None]], dim=-1)
    icp_rows = torch.where(found[..., None], icp_rows, torch.zeros_like(icp_rows)).reshape(-1, 7)

    # RGB correspondences; the row weight needs each owner's count
    valid = sv & dl_ok & il_ok & (torch.abs(z - dl) <= p.max_depth_delta_rgb)
    diff = torch.where(valid, img - il, torch.zeros_like(img))
    own_f = own.reshape(-1)
    counts = torch.zeros((M, 3), dtype=F32, device=dev)
    for m in range(M):
        sel = own_f == m
        counts[m, 0] = torch.sum(found.reshape(-1)[sel]).to(F32)
        counts[m, 1] = torch.sum(valid.reshape(-1)[sel]).to(F32)
        counts[m, 2] = torch.sum((diff * diff).reshape(-1)[sel])
    rgb_rows = torch.zeros_like(icp_rows)
    if p.use_rgb:
        rgb_size = counts[:, 1] * scale2
        tmp_err = torch.sqrt(counts[:, 2] * scale2) / torch.clamp(rgb_size, min=1.0)
        sigma_val = torch.where(tmp_err == 0, torch.ones_like(rgb_size), rgb_size)
        cp = torch.stack([rgbd.div(dl * (uf - cam_l.cx), cam_l.fx),
                          rgbd.div(dl * (vf - cam_l.cy), cam_l.fy), dl], -1)
        w_raw = sigma_val[own_c] + torch.abs(diff)
        wgt = torch.where(w_raw > 1.19209290e-7, 1.0 / w_raw, torch.ones_like(w_raw))
        cz = cp[..., 2]
        invz = torch.where(cz != 0, 1.0 / torch.where(cz != 0, cz, torch.ones_like(cz)),
                           torch.zeros_like(cz))
        v0c = wgt * p.sobel_scale * didx * cam_l.fx * invz
        v1c = wgt * p.sobel_scale * didy * cam_l.fy * invz
        v2c = -(v0c * cp[..., 0] + v1c * cp[..., 1]) * invz
        rows = torch.stack([v0c, v1c, v2c, -cp[..., 2] * v1c + cp[..., 1] * v2c,
                            cp[..., 2] * v0c - cp[..., 0] * v2c,
                            -cp[..., 1] * v0c + cp[..., 0] * v1c, -wgt * diff], dim=-1)
        rgb_rows = torch.where(valid[..., None], rows, torch.zeros_like(rows)).reshape(-1, 7)
    return icp_rows, rgb_rows, own_f, counts


def gn_multi_plain(ml: MultiLevel, Tinv_all: torch.Tensor, cam_l: CameraModel, scale2: float,
                   p: GNParams, n_models: int, done=None) -> torch.Tensor:
    """Plain PyTorch K11: one evaluation of every model's systems -> [M, 64]
    (per model ``gn_reduce``'s layout on the evaluated grid; zeros once
    ``done`` is set). ``Tinv_all`` [M, 4, 4] (or [4, 4] for all models)."""
    dev = ml.gl.img.device
    out = torch.zeros((n_models, N_SLOTS), dtype=F32, device=dev)
    if done is not None and bool(done != 0):
        return out
    icp_rows, rgb_rows, own, counts = multi_rows(ml, Tinv_all, cam_l, scale2, p, n_models)
    iu = rgbd._TRIU.to(dev)
    for m in range(n_models):
        sel = own == m
        ri, rr = icp_rows[sel], rgb_rows[sel]
        out[m, 0:28] = (ri.T @ ri)[iu[0], iu[1]]
        out[m, 28:56] = (rr.T @ rr)[iu[0], iu[1]]
    out[:, 56:59] = counts
    return out


_GNM_ARGS = (
    [K.P, K.I, K.I, K.I]  # pred map, compact, H, W
    + [K.P] * 8  # vmap, nmap, img, didx, didy, static_valid, own, bank_own
    + [K.I, K.I, K.I]  # stride, grid rows, grid cols
    + [K.P, K.I, K.P] + [K.F] * 4  # Tinv, its row stride, done flag, intrinsics
    + [K.I, K.I]  # models, use_rgb
    + [K.F] * 6  # dist, angle, max depth delta, max depth rgb, sobel scale, scale2
    + [K.I, K.P, K.P]  # blocks, partials, sums
)
_GNM_THREADS = 256


def gn_multi_cuda(ml: MultiLevel, Tinv_all: torch.Tensor, cam_l: CameraModel, scale2: float,
                  p: GNParams, n_models: int, done=None, level: int = 0) -> torch.Tensor:
    """K11 on the card: ``csrc/gn_multi.cu`` ``mmf_gn_multi`` (same contract as
    ``gn_multi_plain``; launches counted per level, ``gn_multi.L<level>``).
    ``Tinv_all`` is [M, 4, 4] or, for all models at one pose, [4, 4]; both are
    read by pointer (rows of the loop state). Two device launches (pass 1
    and, with RGB, pass 2); the last block of each sums the per-block
    partials in block order into ``sums``, and pass 1 writes every slot, so
    ``sums`` needs no clearing (zeros once ``done`` is set). Evaluations
    share the kernel library's block tickets: enqueue them on one stream."""
    lv = ml.gl
    K.check(Tinv_all, F32, "Tinv_all", contiguous=False)
    if done is not None:
        K.check(done, F32, "done")
    K.check(lv.pred, torch.bfloat16 if lv.compact else F32, "pred")
    for name in ("vmap", "nmap", "img", "didx", "didy"):
        K.check(getattr(lv, name), F32, name)
    K.check(lv.static_valid, torch.bool, "static_valid")
    K.check(ml.own, torch.int32, "own")
    K.check(ml.bank_own, torch.int32, "bank_own")
    if not 1 <= n_models <= MAX_MODELS:
        raise ValueError(f"gn_multi takes 1..{MAX_MODELS} models")
    if Tinv_all.dim() == 2:
        if tuple(Tinv_all.shape) != (4, 4) or Tinv_all.stride() != (4, 1):
            raise ValueError("a shared Tinv must be a contiguous [4, 4]")
        tstride = 0
    else:
        if tuple(Tinv_all.shape) != (n_models, 4, 4) or Tinv_all.stride()[1:] != (4, 1):
            raise ValueError("Tinv_all must be [M, 4, 4] with contiguous 4x4 blocks")
        tstride = Tinv_all.stride(0)
    h, w = lv.img.shape
    if tuple(lv.pred.shape) != (h, w, 8) or ml.own.shape != (h, w) or ml.bank_own.shape != (h, w):
        raise ValueError("pred must be [H, W, 8], own and bank_own [H, W]")
    s = lv.stride
    hs, ws = (h + s - 1) // s, (w + s - 1) // s
    blocks = max(1, (hs * ws + _GNM_THREADS - 1) // _GNM_THREADS)
    dev = lv.img.device
    partials = torch.empty((blocks, n_models * 31), dtype=F32, device=dev)  # pass 1's 31 slots
    sums = torch.empty((MAX_MODELS, N_SLOTS), dtype=F32, device=dev)
    f = K.fn("gn_multi", "mmf_gn_multi", _GNM_ARGS)
    K.call(
        f"gn_multi.L{level}", f, K.ptr(lv.pred), int(lv.compact), h, w,
        K.ptr(lv.vmap), K.ptr(lv.nmap), K.ptr(lv.img), K.ptr(lv.didx), K.ptr(lv.didy),
        K.ptr(lv.static_valid), K.ptr(ml.own), K.ptr(ml.bank_own), s, hs, ws,
        K.ptr(Tinv_all), tstride, None if done is None else K.ptr(done),
        cam_l.fx, cam_l.fy, cam_l.cx, cam_l.cy, n_models, int(p.use_rgb),
        p.dist_thresh, p.angle_thresh, p.max_depth_delta_rgb, p.max_depth_rgb, p.sobel_scale,
        float(scale2), blocks, K.ptr(partials), K.ptr(sums),
    )
    return sums[:n_models]


def gn_multi(ml: MultiLevel, Tinv_all, cam_l: CameraModel, scale2: float, p: GNParams,
             n_models: int, level: int = 0, done=None) -> torch.Tensor:
    K.record(f"gn_multi.L{level}", ml=ml, Tinv_all=Tinv_all, cam_l=cam_l, scale2=scale2, p=p,
             n_models=n_models, done=done)
    if ml.gl.img.is_cuda:
        return gn_multi_cuda(ml, Tinv_all, cam_l, scale2, p, n_models, done, level)
    return gn_multi_plain(ml, Tinv_all, cam_l, scale2, p, n_models, done)


# ---------------------------------------------------------------- K5, M-wide

def _rows(state: torch.Tensor, M: int) -> torch.Tensor:
    return state.view(M + 1, S_SIZE)


def multi_init_plain(M: int, device) -> torch.Tensor:
    row = rgbd.odo_init_plain(HOST)
    return row.repeat(M + 1).to(device)


def multi_init_cuda(M: int, device) -> torch.Tensor:
    st = torch.empty(((M + 1) * S_SIZE,), dtype=F32, device=device)
    K.call("multi_init", K.fn("gn_step", "mmf_multi_init", [K.P, K.I]), K.ptr(st), M)
    return st


def multi_init(M: int, device) -> torch.Tensor:
    """A fresh multi loop state: every row as ``rgbd.odo_init`` (inactive)."""
    device = torch.device(device)
    K.record("multi_init", M=M, device=device)
    return multi_init_cuda(M, device) if device.type == "cuda" else multi_init_plain(M, device)


def multi_seed_plain(state, seed_Rt, seed_valid, active, M: int) -> None:
    s = _rows(state, M).to(HOST).clone()
    so3 = s[M, S_RT:S_RT + 16].reshape(4, 4).clone()
    for m in range(M):
        cur = seed_Rt[m].to(HOST, F32) if seed_Rt is not None and bool(seed_valid[m]) else so3
        rgbd._write_pose(s[m], cur)
        s[m, S_ACTIVE] = float(bool(active[m]))
    state.copy_(s.reshape(-1))


def multi_seed_cuda(state, seed_Rt, seed_valid, active, M: int) -> None:
    K.check(state, F32, "state")
    K.check(active, torch.bool, "active")
    if seed_Rt is not None:
        K.check(seed_Rt, F32, "seed_Rt")
        K.check(seed_valid, torch.bool, "seed_valid")
        if tuple(seed_Rt.shape) != (M, 4, 4) or seed_valid.shape != (M,):
            raise ValueError("seed_Rt must be [M, 4, 4] and seed_valid [M]")
    f = K.fn("gn_step", "mmf_multi_seed", [K.P, K.P, K.P, K.P, K.I])
    K.call("multi_seed", f, K.ptr(state), None if seed_Rt is None else K.ptr(seed_Rt),
           None if seed_Rt is None else K.ptr(seed_valid), K.ptr(active), M)


def multi_seed(state, seed_Rt, seed_valid, active, M: int) -> None:
    """Each model's start: its seed where valid, else the SO(3) pose (the last
    row's), and its active flag, in place."""
    K.record("multi_seed", state=state, seed_Rt=seed_Rt, seed_valid=seed_valid, active=active,
             M=M)
    (multi_seed_cuda if state.is_cuda else multi_seed_plain)(state, seed_Rt, seed_valid,
                                                             active, M)


def multi_arbitrate_plain(state, sums_cur, sums_so3, M: int, scale2: float) -> None:
    s = _rows(state, M).to(HOST).clone()
    so3 = s[M, S_RT:S_RT + 16].reshape(4, 4).clone()
    for m in range(M):
        e_cur = rgbd.arbitration_error(sums_cur[m], scale2, True)
        e_so3 = rgbd.arbitration_error(sums_so3[m], scale2, True)
        if not bool(e_cur <= e_so3):
            rgbd._write_pose(s[m], so3)
    state.copy_(s.reshape(-1))


def multi_arbitrate_cuda(state, sums_cur, sums_so3, M: int, scale2: float) -> None:
    K.check(state, F32, "state")
    K.check(sums_cur, F32, "sums_cur")
    K.check(sums_so3, F32, "sums_so3")
    f = K.fn("gn_step", "mmf_multi_arbitrate", [K.P, K.P, K.P, K.I, K.F])
    K.call("multi_arbitrate", f, K.ptr(state), K.ptr(sums_cur), K.ptr(sums_so3), M, float(scale2))


def multi_arbitrate(state, sums_cur, sums_so3, M: int, scale2: float) -> None:
    """Per-model seed arbitration (the dense ICP error at the start against
    the SO(3) pose's), in place."""
    K.record("multi_arbitrate", state=state, sums_cur=sums_cur, sums_so3=sums_so3, M=M,
             scale2=scale2)
    (multi_arbitrate_cuda if state.is_cuda else multi_arbitrate_plain)(state, sums_cur, sums_so3,
                                                                       M, scale2)


def gn_step_multi_plain(state, sums, M: int, sp: rgbd.StepParams, last: bool) -> None:
    """Plain K5 (M-wide GN): one body of the reference's per-level
    while_loop for all models, in place."""
    s = _rows(state, M).to(HOST).clone()
    sums = sums.to(HOST)
    G = s[M]
    t32 = lambda v: torch.tensor(v, dtype=F32)  # noqa: E731
    if G[S_GN_DONE] == 0:
        for m in range(M):
            r = s[m]
            S_icp, icp_cnt, S_rgb, rgb_size, tmp_err = rgbd.systems_from_sums(sums[m], sp.scale2)
            if not sp.use_rgb:
                rgb_size, tmp_err = t32(0.0), t32(0.0)
            if sp.use_rgb:
                w2 = t32(sp.icp_weight) * t32(sp.icp_weight)
                A = S_rgb[:6, :6] + w2 * S_icp[:6, :6]
                b = S_rgb[:6, 6] + w2 * S_icp[:6, 6]
            else:
                A, b = S_icp[:6, :6], S_icp[:6, 6]
            x = rgbd.clamp_step(rgbd.solve_preconditioned(A, b))
            enough = bool(icp_cnt + rgb_size >= 60)
            upd = r[S_GN_DONE] == 0 and enough and r[S_ACTIVE] != 0
            converged = upd and bool(torch.linalg.norm(x[0:3]) < sp.eps) and bool(
                torch.linalg.norm(x[3:6]) < sp.eps)
            if upd:
                rgbd._write_pose(r, se3.gn_update_pose(r[S_RT:S_RT + 16].reshape(4, 4), x))
                r[S_ICP_ERR] = torch.sqrt(S_icp[6, 6]) / torch.clamp(icp_cnt, min=1.0)
                r[S_ICP_COUNT] = icp_cnt
                r[S_RGB_ERR], r[S_RGB_COUNT] = tmp_err, rgb_size
                r[S_LAST_A:S_LAST_A + 36] = A.reshape(-1)
                r[S_LAST_B:S_LAST_B + 6] = b
            if not enough or converged:
                r[S_GN_DONE] = 1.0
        G[S_GN_J] += 1
        G[S_GN_ITERS + sp.level] = G[S_GN_J]
        if all(s[m, S_GN_DONE] != 0 for m in range(M)):
            G[S_GN_DONE] = 1.0
    if last:
        G[S_GN_DONE], G[S_GN_J] = 0.0, 0.0
        s[:M, S_GN_DONE] = 0.0
    state.copy_(s.reshape(-1))


def gn_step_multi_cuda(state, sums, M: int, sp: rgbd.StepParams, last: bool) -> None:
    """K5 (M-wide GN) on the card: ``csrc/gn_step.cu`` ``mmf_gn_step_multi``,
    one block, one thread a model; a model's 6x6 solve (in registers) runs
    only where its update is applied."""
    K.check(state, F32, "state")
    K.check(sums, F32, "sums", contiguous=False)
    if sums.stride() != (N_SLOTS, 1):
        raise ValueError("sums must be [M, 64] rows of the reduction's output")
    w = np.float32(sp.icp_weight)
    f = K.fn("gn_step", "mmf_gn_step_multi", [K.P, K.P, K.I, K.F, K.F, K.F, K.I, K.I, K.I])
    K.call("gn_step_multi", f, K.ptr(state), K.ptr(sums), M, float(sp.scale2), float(w * w),
           float(sp.eps), int(sp.use_rgb), int(sp.level), int(last))


def gn_step_multi(state, sums, M: int, sp: rgbd.StepParams, last: bool) -> None:
    K.record("gn_step_multi", state=state, sums=sums, M=M, sp=sp, last=last)
    (gn_step_multi_cuda if state.is_cuda else gn_step_multi_plain)(state, sums, M, sp, last)


# ---------------------------------------------------------------- the loop

def multi_track(T_prev: torch.Tensor, levels: List[MultiLevel], last_next_img_l2: torch.Tensor,
                cfg: OdometryConfig, cam: CameraModel, n_models: int,
                T_init: Optional[torch.Tensor] = None, seed_valid: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None) -> MultiOdometryResult:
    """All models' Gauss-Newton solves (``multi_incremental_transformation``):
    ``T_prev`` [M, 4, 4] previous poses (0 = global), ``levels`` index 0 =
    finest, optional per-model seeds ``T_init`` [M, 4, 4] with ``seed_valid``
    [M] and ``active`` [M] (inactive models hold their pose). The fixed
    iteration budget is enqueued; nothing is read back."""
    use_icp = (not cfg.rgb_only) and cfg.icp_weight > 0
    use_rgb = cfg.rgb_only or cfg.icp_weight < 100
    if not use_icp:
        raise ValueError("composite multi-model odometry requires the ICP term")
    if cfg.rgb_only:
        raise NotImplementedError("rgb_only is not ported for the multi path")
    # cfg.error_images is not read here: the composite odometry writes no
    # error images, as the reference's odometry/multi.py does not
    M = n_models
    K.record("multi_track", T_prev=T_prev, levels=levels, last_next_img_l2=last_next_img_l2,
             cfg=cfg, cam=cam, n_models=n_models, T_init=T_init, seed_valid=seed_valid,
             active=active)
    dev = T_prev.device
    T_prev = T_prev.to(F32)
    if active is None:
        active = torch.ones((M,), dtype=torch.bool, device=dev)
    st = multi_init(M, dev)
    rows = _rows(st, M)
    G = rows[M]
    if cfg.so3_prealign and cfg.so3_iterations > 0:
        lvl = cfg.num_pyr - 1
        cam_l = cam.level(lvl)
        for _ in range(cfg.so3_iterations):
            rgbd.so3_step(G, rgbd.so3_reduce(last_next_img_l2, levels[lvl].gl.img, cam_l, G),
                          verbatim=True)

    seed_Rt = None
    if T_init is not None:
        if seed_valid is None:
            seed_valid = torch.ones((M,), dtype=torch.bool, device=dev)
        seed_Rt = (se3.inverse_T(T_init.to(F32)) @ T_prev).contiguous()
    multi_seed(st, seed_Rt, seed_valid, active, M)

    params = GNParams(use_icp, use_rgb, cfg.rgb_only, cfg.dist_thresh, cfg.angle_thresh,
                      cfg.max_depth_delta_rgb, cfg.max_depth_rgb, cfg.sobel_scale)
    schedule = cfg.schedule()
    Tinv = rows[:M, S_RT_INV:S_RT_INV + 16].view(M, 4, 4)
    done = G[S_GN_DONE]
    for i in range(cfg.num_pyr - 1, -1, -1):
        iters = schedule[i]
        if iters == 0:
            continue
        ml = levels[i]
        cam_l = cam.level(i)
        scale2 = float(ml.gl.stride * ml.gl.stride)
        if i == cfg.num_pyr - 1 and T_init is not None:
            sums_cur = gn_multi(ml, Tinv, cam_l, scale2, params, M, level=i)
            sums_so3 = gn_multi(ml, G[S_RT_INV:S_RT_INV + 16].view(4, 4), cam_l, scale2, params,
                                M, level=i)
            multi_arbitrate(st, sums_cur, sums_so3, M, scale2)
        sp = rgbd.StepParams(scale2, use_icp, use_rgb, cfg.rgb_only, cfg.icp_weight,
                             cfg.convergence_eps, i)
        for j in range(iters):
            sums = gn_multi(ml, Tinv, cam_l, scale2, params, M, level=i, done=done)
            gn_step_multi(st, sums, M, sp, last=j == iters - 1)

    T_new = T_prev @ Tinv
    if use_rgb:
        diverged = torch.linalg.norm(T_new[:, :3, 3] - T_prev[:, :3, 3], dim=-1) \
            > cfg.divergence_trans_norm
        T_new = torch.where(diverged[:, None, None], T_prev, T_new)
    T_new = torch.where(active.to(dev)[:, None, None], T_new, T_prev)
    return MultiOdometryResult(
        T_new, rows[:M, S_ICP_ERR], rows[:M, S_ICP_COUNT], rows[:M, S_RGB_ERR],
        rows[:M, S_RGB_COUNT], rows[:M, S_LAST_A:S_LAST_A + 36].view(M, 6, 6),
        rows[:M, S_LAST_B:S_LAST_B + 6], st,
    )


def loop_iterations(result: MultiOdometryResult) -> dict:
    """Iterations each loop ran, {"so3": n, "L0": n, "L1": n, "L2": n} (a host read)."""
    G = result.state.to(HOST).view(-1, S_SIZE)[-1]
    out = {"so3": int(G[rgbd.S_SO3_ITERS])}
    for lvl in range(3):
        out[f"L{lvl}"] = int(G[S_GN_ITERS + lvl])
    return out
