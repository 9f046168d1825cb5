"""Dense joint ICP + photometric RGB-D odometry (Gauss-Newton, 3-level pyramid).

Port of the reference package's ``odometry/rgbd.py``, with its loops on the card:
- SO(3) pre-alignment at the coarsest level, <= 10 iterations: ``so3_reduce``
  (kernel K3, ``csrc/gn_step.cu``) reduces the rotation-only photometric 4x4
  system (the bf16 rounding of the reference's tap bank reproduced) and
  ``so3_step`` (K5) solves, clamps and applies it and tests the exits;
- coarse-to-fine joint ICP + RGB Gauss-Newton over {10, 5, 4} iterations; each
  iteration evaluates both 7x7 normal systems with ``gn_reduce`` (K4,
  ``csrc/gn_reduce.cu``: warp, bilinear taps, gates, rows and the reduction in
  one pass; no [P, 7] row matrix) and ``gn_step`` (K5) combines them, solves
  the Jacobi-scaled eigen-truncated 6x6 system, clamps the step, updates the
  pose and tests the exits;
- the loop state (pose increment, carried errors and counts, done flags)
  lives in a small float buffer on the state's device (layout ``S_*``, the
  same as the kernels'). The host enqueues the fixed iteration budget and
  reads nothing back: the reductions return at once once their loop is done,
  as the reference's ``lax.while_loop`` skips the remaining iterations;
- a seeded solve (an external pose seed ``T_init`` with its validity flag
  on the card, the keypoint initialisation) starts the Gauss-Newton loop from
  the seed or the SO(3) pose: ``seed_select`` (K5) picks by validity and, by
  two ``gn_reduce`` evaluations at the coarsest level, by the dense error;
- with ``cfg.error_images`` (the legacy CRF's input) one more level-0
  evaluation on the full grid at the final pose writes the per-pixel ICP
  and photometric error images (K4's error-image mode, enqueued after the
  loop);
- the 0.3 m divergence guard reverts the whole update (a device select).

On CPU tensors every wrapper takes its plain PyTorch version (same module).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel, OdometryConfig
from multimotionfusion_tpu_torch.ops.image import _shift2d
from multimotionfusion_tpu_torch.ops.rasterize import div, check_pose
from multimotionfusion_tpu_torch.utils import se3

F32 = torch.float32
HOST = torch.device("cpu")


class OdometryResult(NamedTuple):
    pose: torch.Tensor  # [4,4] new camera pose (on the inputs' device)
    icp_error: torch.Tensor
    icp_count: torch.Tensor
    rgb_error: torch.Tensor
    rgb_count: torch.Tensor
    so3_error: torch.Tensor
    so3_count: torch.Tensor
    A: torch.Tensor  # [6,6] last fused normal matrix
    b: torch.Tensor  # [6]
    state: torch.Tensor  # [S_SIZE] the loop state the fields above view
    # with ``cfg.error_images``: level 0's per-pixel ICP distance and
    # 0.001 diff^2 at the final pose (the legacy CRF's input), else None
    icp_error_image: Optional[torch.Tensor] = None
    rgb_error_image: Optional[torch.Tensor] = None


class LevelData(NamedTuple):
    """Per-pyramid-level inputs for one model's tracking."""

    vmap_curr: torch.Tensor  # [H,W,3] current frame vertices
    nmap_curr: torch.Tensor  # [H,W,3]
    vmap_prev: torch.Tensor  # [H,W,3] prediction vertices (prediction camera frame)
    nmap_prev: torch.Tensor  # [H,W,3]
    depth_last: torch.Tensor  # [H,W] prediction depth (m)
    depth_next: torch.Tensor  # [H,W] frame depth (m)
    img_last: torch.Tensor  # [H,W] prediction intensity
    img_next: torch.Tensor  # [H,W] frame intensity
    mask_next: torch.Tensor  # [H,W] frame mask ids (int32)
    didx: torch.Tensor  # [H,W] Sobel d/dx of img_next
    didy: torch.Tensor  # [H,W]


# ---------------------------------------------------------------- K5 (plain)

def solve_preconditioned(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b: Jacobi scaling + truncated eigensolve (near-null
    eigendirections get a zero step, healthy ones the full Newton step)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-12))
    dinv = 1.0 / d
    Ah = A * dinv[:, None] * dinv[None, :]
    bh = b * dinv
    w, V = torch.linalg.eigh(Ah)
    wmax = torch.clamp(w[-1], min=1e-12)
    inv_w = torch.where(w > 1e-4 * wmax, 1.0 / torch.where(w == 0, torch.ones_like(w), w),
                        torch.zeros_like(w))
    y = V @ (inv_w * (V.T @ bh))
    x = y * dinv
    return torch.where(torch.all(torch.isfinite(x)), x, torch.zeros_like(x))


def clamp_step(x: torch.Tensor, max_trans: float = 0.1, max_rot: float = 0.1) -> torch.Tensor:
    """Trust-region clamp on one GN step (scales the whole step)."""
    tn = torch.linalg.norm(x[0:3])
    rn = torch.linalg.norm(x[3:6])
    scale = torch.clamp(
        torch.minimum(max_trans / torch.clamp(tn, min=1e-12), max_rot / torch.clamp(rn, min=1e-12)),
        max=1.0,
    )
    return x * scale


# ---------------------------------------------------------------- K3 (plain)

def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back (the reference's default tap-bank dtype)."""
    return x.to(torch.bfloat16).to(F32)


def central_grads(img: torch.Tensor):
    """(d/dx, d/dy) central differences, positive leftward/upward."""
    gx = (_shift2d(img, 0, -1) - _shift2d(img, 0, 1)) * 0.5
    gy = (_shift2d(img, -1, 0) - _shift2d(img, 1, 0)) * 0.5
    return gx, gy


def _taps(bank: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Four bilinear taps of ``bank`` [H, W, C] at float coords; (taps, fu, fv,
    inb). Same index arithmetic as the reference's pre-shifted tap bank."""
    h, w = bank.shape[:2]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    u0i = torch.clamp(u0, -2.0**30, 2.0**30).to(torch.int32)
    v0i = torch.clamp(v0, -2.0**30, 2.0**30).to(torch.int32)
    inb = (u0i >= 0) & (v0i >= 0) & (u0i < w - 1) & (v0i < h - 1)
    u0c = torch.clamp(u0i, 0, w - 2).long()
    v0c = torch.clamp(v0i, 0, h - 2).long()
    taps = [bank[v0c, u0c].to(F32), bank[v0c, u0c + 1].to(F32),
            bank[v0c + 1, u0c].to(F32), bank[v0c + 1, u0c + 1].to(F32)]
    return taps, u - u0, v - v0, inb


def so3_system(last_img, so3_bank, last_grads, image_basis, kinv, krlr):
    """Rotation-only photometric system (SO3Reduction): ([4,4], count)."""
    rows, found = so3_rows(last_img, so3_bank, last_grads, image_basis, kinv, krlr)
    return rows.T @ rows, torch.sum(found)


def so3_rows(last_img, so3_bank, last_grads, image_basis, kinv, krlr):
    """[P, 4] rows (3 Jacobian entries, residual; zeros where not found) and
    the [H, W] found mask of ``so3_system``."""
    h, w = last_img.shape
    dev = last_img.device
    xg = torch.arange(w, dtype=F32, device=dev)[None, :].expand(h, w)
    yg = torch.arange(h, dtype=F32, device=dev)[:, None].expand(h, w)
    px = image_basis[0, 0] * xg + image_basis[0, 1] * yg + image_basis[0, 2]
    py = image_basis[1, 0] * xg + image_basis[1, 1] * yg + image_basis[1, 2]
    pz = image_basis[2, 0] * xg + image_basis[2, 1] * yg + image_basis[2, 2]
    safe_pz = torch.where(pz != 0, pz, torch.ones_like(pz))
    wu = px / safe_pz
    wv = py / safe_pz
    found = (
        (wu >= 1) & (wu < w - 2) & (wv >= 1) & (wv < h - 2)
        & (xg >= 1) & (xg < w - 1) & (yg >= 1) & (yg < h - 1)
    )
    taps, fu, fv, _ = _taps(so3_bank, wu, wv)
    fuc, fvc = fu[..., None], fv[..., None]
    warped = (
        taps[0] * (1 - fuc) * (1 - fvc) + taps[1] * fuc * (1 - fvc)
        + taps[2] * (1 - fuc) * fvc + taps[3] * fuc * fvc
    )
    lgx, lgy = last_grads
    gx = (warped[..., 1] + lgx) * 0.5
    gy = (warped[..., 2] + lgy) * 0.5
    pt = torch.stack(
        [kinv[r, 0] * xg + kinv[r, 1] * yg + kinv[r, 2] for r in range(3)], dim=-1
    )
    z2 = pt[..., 2] ** 2
    a, b_, c = krlr[0, 0], krlr[0, 1], krlr[0, 2]
    d, e, f = krlr[1, 0], krlr[1, 1], krlr[1, 2]
    g, h_, i_ = krlr[2, 0], krlr[2, 1], krlr[2, 2]
    left = torch.stack(
        [
            (pt[..., 2] * (d * gy + a * gx) - gy * g * yg - gx * g * xg) / z2,
            (pt[..., 2] * (e * gy + b_ * gx) - gy * h_ * yg - gx * h_ * xg) / z2,
            (pt[..., 2] * (f * gy + c * gx) - gy * i_ * yg - gx * i_ * xg) / z2,
        ],
        dim=-1,
    )
    jac = torch.linalg.cross(left, pt, dim=-1)
    resid = -(warped[..., 0] - last_img)
    rows = torch.cat([jac, resid[..., None]], dim=-1)
    rows = torch.where(found[..., None], rows, torch.zeros_like(rows)).reshape(-1, 4)
    return rows, found


def _K(cam: CameraModel) -> torch.Tensor:
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], dtype=F32)


def _K_inv(cam: CameraModel) -> torch.Tensor:
    return torch.tensor(
        [[1.0 / cam.fx, 0.0, -cam.cx / cam.fx], [0.0, 1.0 / cam.fy, -cam.cy / cam.fy],
         [0.0, 0.0, 1.0]],
        dtype=F32,
    )


def rgb_static_valid(level: LevelData, min_scale: float, mask_id, use_mask: bool) -> torch.Tensor:
    """Iteration-invariant part of the photometric validity: 4x4 neighbourhood
    support (window [i-2, i+2), clamped at borders), gradient gate, valid
    depth, borders (residualKernel)."""
    return static_valid(level.img_next, level.mask_next, level.didx, level.didy,
                        level.depth_next, min_scale, mask_id, use_mask)


def static_valid(img_next, mask_next, didx, didy, depth_next, min_scale: float, mask_id,
                 use_mask: bool) -> torch.Tensor:
    """``rgb_static_valid`` on the level's fields."""
    h, w = img_next.shape
    dev = img_next.device
    ok = img_next > 0
    if use_mask:
        ok = ok & (mask_next == mask_id)
    okf = ok.to(F32)

    def win_sum(x):
        acc = torch.zeros_like(x)
        for oy in (-2, -1, 0, 1):
            acc = acc + _shift2d(x, oy, 0)
        out = torch.zeros_like(x)
        for ox in (-2, -1, 0, 1):
            out = out + _shift2d(acc, 0, ox)
        return out

    valid = win_sum(okf) >= win_sum(torch.ones_like(okf)) - 1e-3
    xg = torch.arange(w, device=dev)[None, :]
    yg = torch.arange(h, device=dev)[:, None]
    valid = valid & (xg < w - 5) & (yg < h - 1)
    valid = valid & (didx**2 + didy**2 >= min_scale)
    return valid & (depth_next > 0)


# ---------------------------------------------------------------- K4

class GNLevel(NamedTuple):
    """Loop-invariant inputs of one level's GN evaluations.

    ``pred`` is the prediction sampling map [H, W, 8]: at level 0 (``compact``)
    bf16 channels [z_hi, z_lo, nx, ny, nz, img, 0, 0] (the reference's hi/lo
    depth split; vertices are rebuilt per tap from the pixel ray), at coarse
    levels f32 [vx, vy, vz, nx, ny, nz, depth, img]. Per-pixel fields are full
    resolution; ``stride`` picks the evaluated grid."""

    pred: torch.Tensor
    compact: bool
    vmap: torch.Tensor  # [H, W, 3]
    nmap: torch.Tensor  # [H, W, 3]
    img: torch.Tensor  # [H, W]
    didx: torch.Tensor
    didy: torch.Tensor
    static_valid: torch.Tensor  # [H, W] bool
    stride: int


class GNParams(NamedTuple):
    use_icp: bool
    use_rgb: bool
    rgb_only: bool
    dist_thresh: float
    angle_thresh: float
    max_depth_delta_rgb: float
    max_depth_rgb: float
    sobel_scale: float


# layout of gn_reduce's output: upper triangles of S_icp (28) and S_rgb (28),
# then icp count, rgb count, sum of squared photometric differences
N_SUMS = 59
_TRIU = torch.triu_indices(7, 7)


def build_pred_map(level: LevelData, compact: bool) -> torch.Tensor:
    """The prediction's sampling map of one level (``GNLevel.pred``)."""
    return pred_map(level.vmap_prev, level.nmap_prev, level.depth_last, level.img_last, compact)


def pred_map(vmap_prev, nmap_prev, depth_last, img_last, compact: bool) -> torch.Tensor:
    """``build_pred_map`` on the level's fields."""
    if compact:
        depth = vmap_prev[..., 2]
        zhi = depth.to(torch.bfloat16)
        zlo = (depth - zhi.to(F32)).to(torch.bfloat16)
        rest = torch.cat([nmap_prev, img_last[..., None]], dim=-1).to(torch.bfloat16)
        pad = torch.zeros_like(zhi)
        return torch.cat([zhi[..., None], zlo[..., None], rest, pad[..., None], pad[..., None]],
                         dim=-1).contiguous()
    return torch.cat([vmap_prev, nmap_prev, depth_last[..., None], img_last[..., None]],
                     dim=-1).contiguous()


def _interp_valid(taps, fu, fv, inb, sl: slice):
    t00, t01, t10, t11 = (t[..., sl] for t in taps)
    ok = inb & torch.any(t00 != 0, -1) & torch.any(t01 != 0, -1) & torch.any(t10 != 0, -1) \
        & torch.any(t11 != 0, -1)
    fuc, fvc = fu[..., None], fv[..., None]
    val = t00 * (1 - fuc) * (1 - fvc) + t01 * fuc * (1 - fvc) + t10 * (1 - fuc) * fvc \
        + t11 * fuc * fvc
    return torch.where(ok[..., None], val, torch.zeros_like(val)), ok


def _sample(lv: GNLevel, uf, vf, cam_l: CameraModel, p: GNParams):
    """(d_cp, d_ok, n_cp, n_ok, dl, dl_ok, il, il_ok) at the warp coordinates."""
    taps, fu, fv, inb = _taps(lv.pred, uf, vf)
    if not lv.compact:
        d_cp, d_ok = _interp_valid(taps, fu, fv, inb, slice(0, 3))
        n_cp, n_ok = _interp_valid(taps, fu, fv, inb, slice(3, 6))
        dl, dl_ok = _interp_valid(taps, fu, fv, inb, slice(6, 7))
        il, il_ok = _interp_valid(taps, fu, fv, inb, slice(7, 8))
        return d_cp, d_ok, n_cp, n_ok, dl[..., 0], dl_ok, il[..., 0], il_ok
    h, w = lv.pred.shape[:2]
    u0 = torch.clamp(torch.floor(uf), 0, w - 2)
    v0 = torch.clamp(torch.floor(vf), 0, h - 2)
    fuc, fvc = fu[..., None], fv[..., None]
    wgt = [(1 - fuc) * (1 - fvc), fuc * (1 - fvc), (1 - fuc) * fvc, fuc * fvc]
    offs = [(0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (1.0, 1.0)]
    d_cp = torch.zeros(uf.shape + (3,), dtype=F32, device=uf.device)
    d_ok = inb
    dl = torch.zeros_like(uf)
    dl_ok = inb
    for t, wg, (dy, dx) in zip(taps, wgt, offs):
        z = t[..., 0] + t[..., 1]
        d_ok = d_ok & (t[..., 0] != 0)
        lx = div(u0 + dx - cam_l.cx, cam_l.fx)
        ly = div(v0 + dy - cam_l.cy, cam_l.fy)
        d_cp = d_cp + wg * torch.stack([lx * z, ly * z, z], dim=-1)
        zr = torch.where(z <= p.max_depth_rgb, z, torch.zeros_like(z))
        dl_ok = dl_ok & (zr > 0)
        dl = dl + wg[..., 0] * zr
    d_cp = torch.where(d_ok[..., None], d_cp, torch.zeros_like(d_cp))
    n_cp, n_ok = _interp_valid(taps, fu, fv, inb, slice(2, 5))
    il, il_ok = _interp_valid(taps, fu, fv, inb, slice(5, 6))
    dl = torch.where(dl_ok, dl, torch.zeros_like(dl))
    return d_cp, d_ok, n_cp, n_ok, dl, dl_ok, il[..., 0], il_ok


def gn_rows(lv: GNLevel, Rt_inv: torch.Tensor, cam_l: CameraModel, scale2: float, p: GNParams):
    """Masked ICP and RGB rows [P, 7] of one evaluation (zeros where a gate
    fails), plus (icp count, rgb count, sum diff^2), all on the evaluated grid."""
    s = lv.stride
    dev = lv.img.device
    vmap, nmap = lv.vmap[::s, ::s], lv.nmap[::s, ::s]
    img, didx, didy = lv.img[::s, ::s], lv.didx[::s, ::s], lv.didy[::s, ::s]
    static_valid = lv.static_valid[::s, ::s]
    Rt_inv = Rt_inv.to(dev, F32)
    Ri, ti = Rt_inv[:3, :3], Rt_inv[:3, 3]
    vcp = torch.einsum("ij,hwj->hwi", Ri, vmap) + ti
    z = vcp[..., 2]
    safe_z = torch.where(z != 0, z, torch.ones_like(z))
    uf = vcp[..., 0] * cam_l.fx / safe_z + cam_l.cx
    vf = vcp[..., 1] * cam_l.fy / safe_z + cam_l.cy
    d_cp, d_ok, n_cp, n_ok, dl, dl_ok, il, il_ok = _sample(lv, uf, vf, cam_l, p)
    zero = torch.zeros((), dtype=F32, device=dev)
    icp_rows = rgb_rows = torch.zeros((uf.numel(), 7), dtype=F32, device=dev)
    icp_cnt = rgb_cnt = sigma_raw = zero

    if p.use_rgb:
        valid = static_valid & dl_ok & il_ok & (torch.abs(z - dl) <= p.max_depth_delta_rgb)
        cp = torch.stack([div(dl * (uf - cam_l.cx), cam_l.fx), div(dl * (vf - cam_l.cy), cam_l.fy),
                          dl], -1)
        diff = torch.where(valid, img - il, torch.zeros_like(img))
        sigma_raw = torch.sum(diff * diff)
        rgb_cnt = torch.sum(valid).to(F32)
        rgb_size = rgb_cnt * scale2
        tmp_err = torch.sqrt(sigma_raw * scale2) / torch.clamp(rgb_size, min=1.0)
        sigma_val = torch.where(tmp_err == 0, torch.ones_like(rgb_size), rgb_size)
        w_raw = sigma_val + torch.abs(diff)
        wgt = torch.where(w_raw > 1.19209290e-7, 1.0 / w_raw, torch.ones_like(w_raw))
        if p.rgb_only:
            wgt = torch.ones_like(w_raw)
        cz = cp[..., 2]
        invz = torch.where(cz != 0, 1.0 / torch.where(cz != 0, cz, torch.ones_like(cz)),
                           torch.zeros_like(cz))
        dI_dx = wgt * p.sobel_scale * didx
        dI_dy = wgt * p.sobel_scale * didy
        v0c = dI_dx * cam_l.fx * invz
        v1c = dI_dy * cam_l.fy * invz
        v2c = -(v0c * cp[..., 0] + v1c * cp[..., 1]) * invz
        rows = torch.stack(
            [v0c, v1c, v2c,
             -cp[..., 2] * v1c + cp[..., 1] * v2c,
             cp[..., 2] * v0c - cp[..., 0] * v2c,
             -cp[..., 1] * v0c + cp[..., 0] * v1c,
             -wgt * diff], dim=-1)
        rgb_rows = torch.where(valid[..., None], rows, torch.zeros_like(rows)).reshape(-1, 7)

    if p.use_icp:
        nprev_norm = torch.linalg.norm(n_cp, dim=-1, keepdim=True)
        n_cp = n_cp / torch.clamp(nprev_norm, min=1e-12)
        in_bounds = d_ok & n_ok & (z > 0) & (vmap[..., 2] > 0)
        nc_cp = torch.einsum("ij,hwj->hwi", Ri, nmap)
        dist = torch.linalg.norm(d_cp - vcp, dim=-1)
        sine = torch.linalg.norm(torch.linalg.cross(nc_cp, n_cp, dim=-1), dim=-1)
        ncurr_valid = torch.sum(nmap * nmap, dim=-1) > 0
        found = in_bounds & (sine < p.angle_thresh) & (dist <= p.dist_thresh) & ncurr_valid
        r = torch.sum(n_cp * (vcp - d_cp), dim=-1)
        rows = torch.cat([n_cp, torch.linalg.cross(vcp, n_cp, dim=-1), r[..., None]], dim=-1)
        icp_rows = torch.where(found[..., None], rows, torch.zeros_like(rows)).reshape(-1, 7)
        icp_cnt = torch.sum(found).to(F32)
    return icp_rows, rgb_rows, torch.stack([icp_cnt, rgb_cnt, sigma_raw])


def gn_reduce_plain(lv: GNLevel, Rt_inv: torch.Tensor, cam_l: CameraModel, scale2: float,
                    p: GNParams, done=None) -> torch.Tensor:
    """Plain PyTorch K4: one evaluation of both 7x7 systems -> [N_SUMS] sums
    (on the evaluated grid; ``scale2`` only enters the RGB weight); zeros
    once ``done`` is set."""
    if done is not None and bool(done != 0):
        return torch.zeros((N_SUMS,), dtype=F32, device=lv.img.device)
    icp_rows, rgb_rows, counts = gn_rows(lv, Rt_inv, cam_l, scale2, p)
    iu = _TRIU.to(icp_rows.device)
    return torch.cat([(icp_rows.T @ icp_rows)[iu[0], iu[1]], (rgb_rows.T @ rgb_rows)[iu[0], iu[1]],
                      counts])


_GN_ARGS = (
    [K.P, K.I, K.I, K.I]  # pred map, compact, H, W
    + [K.P] * 6  # vmap, nmap, img, didx, didy, static_valid
    + [K.I, K.I, K.I]  # stride, grid rows, grid cols
    + [K.P, K.P] + [K.F] * 4  # Rt_inv, done flag, intrinsics
    + [K.I, K.I, K.I]  # use_icp, use_rgb, rgb_only
    + [K.F] * 6  # dist, angle, max depth delta, max depth rgb, sobel scale, scale2
    + [K.I, K.P, K.P]  # blocks, partials, sums
)
_GN_THREADS = 256
_GN_MAX_BLOCKS = 1024
_GN_STRIDE_SUMS = 64
GN_PASS_ACCS = (31, 28)  # accumulators of gn_reduce's pass 1 and pass 2


def gn_partials_layout(blocks: int):
    """Offsets and lengths (floats) of gn_reduce's pass-1 and pass-2 partials
    in its buffer: [blocks, 31], then [blocks, 28] from the next 16-byte
    boundary (``csrc/gn_reduce.cu`` ``mmf_gn_reduce``)."""
    n1, n2 = (blocks * a for a in GN_PASS_ACCS)
    off2 = (n1 + 3) & ~3
    return (0, n1), (off2, n2)


def gn_reduce_cuda(lv: GNLevel, Rt_inv: torch.Tensor, cam_l: CameraModel, scale2: float,
                   p: GNParams, done=None, level: int = 0, with_partials: bool = False):
    """K4 on the card: ``csrc/gn_reduce.cu`` (same contract as ``gn_reduce_plain``;
    launches are counted per pyramid level, ``gn_reduce.L<level>``). ``Rt_inv``
    ([4, 4]) and ``done`` (0-dim, or None) are read by pointer. With
    ``with_partials`` also returns the per-block partials of pass 1 and pass
    2 ([blocks, 31], [blocks, 28]; pass 2's are unwritten without RGB or once
    ``done`` is set), from which the kernel's last blocks summed ``sums``."""
    check_pose(Rt_inv, "Rt_inv")
    if done is not None:
        K.check(done, F32, "done")
    K.check(lv.pred, torch.bfloat16 if lv.compact else F32, "pred")
    for name in ("vmap", "nmap", "img", "didx", "didy"):
        K.check(getattr(lv, name), F32, name)
    K.check(lv.static_valid, torch.bool, "static_valid")
    h, w = lv.img.shape
    if tuple(lv.pred.shape) != (h, w, 8):
        raise ValueError("pred must be [H, W, 8]")
    s = lv.stride
    hs, ws = (h + s - 1) // s, (w + s - 1) // s
    blocks = max(1, min((hs * ws + _GN_THREADS - 1) // _GN_THREADS, _GN_MAX_BLOCKS))
    dev = lv.img.device
    (_, n1), (off2, n2) = gn_partials_layout(blocks)
    partials = torch.empty((off2 + n2,), dtype=F32, device=dev)
    sums = torch.empty((_GN_STRIDE_SUMS,), dtype=F32, device=dev)
    f = K.fn("gn_reduce", "mmf_gn_reduce", _GN_ARGS)
    K.call(
        f"gn_reduce.L{level}", f, K.ptr(lv.pred), int(lv.compact), h, w,
        K.ptr(lv.vmap), K.ptr(lv.nmap), K.ptr(lv.img), K.ptr(lv.didx), K.ptr(lv.didy),
        K.ptr(lv.static_valid), s, hs, ws,
        K.ptr(Rt_inv), None if done is None else K.ptr(done), cam_l.fx, cam_l.fy, cam_l.cx, cam_l.cy,
        int(p.use_icp), int(p.use_rgb), int(p.rgb_only),
        p.dist_thresh, p.angle_thresh, p.max_depth_delta_rgb, p.max_depth_rgb, p.sobel_scale,
        float(scale2), blocks, K.ptr(partials), K.ptr(sums),
    )
    if with_partials:
        return (sums[:N_SUMS], partials[:n1].view(blocks, GN_PASS_ACCS[0]),
                partials[off2:].view(blocks, GN_PASS_ACCS[1]))
    return sums[:N_SUMS]


def gn_reduce(lv: GNLevel, Rt_inv: torch.Tensor, cam_l: CameraModel, scale2: float,
              p: GNParams, level: int = 0, done=None) -> torch.Tensor:
    K.record(f"gn_reduce.L{level}", lv=lv, Rt_inv=Rt_inv, cam_l=cam_l, scale2=scale2, p=p,
             done=done)
    if lv.img.is_cuda:
        return gn_reduce_cuda(lv, Rt_inv, cam_l, scale2, p, done, level)
    return gn_reduce_plain(lv, Rt_inv, cam_l, scale2, p, done)


def error_images_plain(lv: GNLevel, Rt_inv: torch.Tensor, cam_l: CameraModel, p: GNParams):
    """Plain K4 error-image mode: (ICP distance [H, W] where the association
    is in bounds and finite, 0.001 diff^2 [H, W] where the photometric
    correspondence is valid; zeros elsewhere and for a term that is off) on
    the full grid of ``lv`` (rgbd.py:450 icp_system, :532 rgb_correspondences)."""
    dev = lv.img.device
    Rt_inv = Rt_inv.to(dev, F32)
    Ri, ti = Rt_inv[:3, :3], Rt_inv[:3, 3]
    vcp = torch.einsum("ij,hwj->hwi", Ri, lv.vmap) + ti
    z = vcp[..., 2]
    safe_z = torch.where(z != 0, z, torch.ones_like(z))
    uf = vcp[..., 0] * cam_l.fx / safe_z + cam_l.cx
    vf = vcp[..., 1] * cam_l.fy / safe_z + cam_l.cy
    d_cp, d_ok, _, n_ok, dl, dl_ok, il, il_ok = _sample(lv, uf, vf, cam_l, p)
    zero = torch.zeros_like(z)
    icp_img = rgb_img = zero
    if p.use_icp:
        in_bounds = d_ok & n_ok & (z > 0) & (lv.vmap[..., 2] > 0)
        e = d_cp - vcp
        dist = torch.sqrt(e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2])
        icp_img = torch.where(in_bounds & torch.isfinite(dist), dist, zero)
    if p.use_rgb:
        valid = lv.static_valid & dl_ok & il_ok & (torch.abs(z - dl) <= p.max_depth_delta_rgb)
        diff = torch.where(valid, lv.img - il, zero)
        rgb_img = torch.where(valid, 0.001 * diff * diff, zero)
    return icp_img, rgb_img


_ERR_ARGS = ([K.P, K.I, K.I, K.I] + [K.P] * 6 + [K.P] + [K.F] * 4 + [K.I, K.I] + [K.F] * 4
             + [K.P, K.P])


def error_images_cuda(lv: GNLevel, Rt_inv: torch.Tensor, cam_l: CameraModel, p: GNParams):
    """K4's error-image mode on the card: ``csrc/gn_reduce.cu``
    ``mmf_gn_error_images``, one launch over the full level-0 grid; ``Rt_inv``
    is read by pointer."""
    check_pose(Rt_inv, "Rt_inv")
    K.check(lv.pred, torch.bfloat16 if lv.compact else F32, "pred")
    for name in ("vmap", "nmap", "img", "didx", "didy"):
        K.check(getattr(lv, name), F32, name)
    K.check(lv.static_valid, torch.bool, "static_valid")
    h, w = lv.img.shape
    if tuple(lv.pred.shape) != (h, w, 8):
        raise ValueError("pred must be [H, W, 8]")
    icp_img = torch.empty((h, w), dtype=F32, device=lv.img.device)
    rgb_img = torch.empty((h, w), dtype=F32, device=lv.img.device)
    f = K.fn("gn_reduce", "mmf_gn_error_images", _ERR_ARGS)
    K.call(
        "gn_reduce.error_images", f, K.ptr(lv.pred), int(lv.compact), h, w, K.ptr(lv.vmap),
        K.ptr(lv.nmap), K.ptr(lv.img), K.ptr(lv.didx), K.ptr(lv.didy), K.ptr(lv.static_valid),
        K.ptr(Rt_inv), cam_l.fx, cam_l.fy, cam_l.cx, cam_l.cy, int(p.use_icp), int(p.use_rgb),
        p.dist_thresh, p.angle_thresh, p.max_depth_delta_rgb, p.max_depth_rgb,
        K.ptr(icp_img), K.ptr(rgb_img),
    )
    return icp_img, rgb_img


def error_images(lv: GNLevel, Rt_inv: torch.Tensor, cam_l: CameraModel, p: GNParams):
    """(ICP error image, RGB error image) of ``lv``'s full grid at ``Rt_inv``."""
    K.record("gn_reduce.error_images", lv=lv, Rt_inv=Rt_inv, cam_l=cam_l, p=p)
    impl = error_images_cuda if lv.img.is_cuda else error_images_plain
    return impl(lv, Rt_inv, cam_l, p)


def _sym(tri: torch.Tensor, n: int = 7) -> torch.Tensor:
    iu = torch.triu_indices(n, n)
    S = torch.zeros((n, n), dtype=F32)
    S[iu[0], iu[1]] = tri
    S[iu[1], iu[0]] = tri
    return S


def systems_from_sums(sums: torch.Tensor, scale2: float):
    """Host unpacking of gn_reduce's output (the plain GN step and the tests;
    the kernel step reads the sums on the card): (S_icp, icp_cnt, S_rgb,
    rgb_size, tmp_err), all scaled to full-grid units."""
    sums = sums.to(HOST)
    sc = torch.tensor(scale2, dtype=F32)
    S_icp = sc * _sym(sums[0:28])
    S_rgb = sc * _sym(sums[28:56])
    icp_cnt = sums[56] * sc
    rgb_size = sums[57] * sc
    tmp_err = torch.sqrt(sums[58] * sc) / torch.clamp(rgb_size, min=1.0)
    return S_icp, icp_cnt, S_rgb, rgb_size, tmp_err




# ---------------------------------------------------------------- loop state

# layout of the odometry's state buffer (csrc/gn_step.cu has the same)
S_R, S_LAST_R = 0, 9  # [9] SO(3) rotation, [9] the previous one
S_SO3_LAST_ERR, S_SO3_LAST_COUNT, S_SO3_ERR, S_SO3_COUNT = 18, 19, 20, 21
S_SO3_DONE, S_SO3_ITERS = 22, 23
S_RT, S_RT_INV = 24, 40  # [16] result_Rt, [16] its inverse
S_GN_DONE, S_LAST_RGB_ERR = 56, 57
S_ICP_ERR, S_ICP_COUNT, S_RGB_ERR, S_RGB_COUNT = 58, 59, 60, 61
S_GN_ITERS, S_GN_J = 62, 65  # [3] iterations run per level, running level's counter
S_LAST_A, S_LAST_B = 66, 102  # [36], [6]
S_SIZE = 128
_BIG = 3.4e38
N_SO3_SUMS = 11  # upper triangle of the 4x4 system + count
_SO3_THREADS = 256
_SO3_MAX_BLOCKS = 1024


def odo_init_plain(device) -> torch.Tensor:
    st = torch.zeros((S_SIZE,), dtype=F32)
    eye3 = torch.eye(3, dtype=F32).reshape(-1)
    st[S_R:S_R + 9] = eye3
    st[S_LAST_R:S_LAST_R + 9] = eye3
    st[S_SO3_LAST_ERR] = st[S_SO3_LAST_COUNT] = _BIG / 2
    st[S_RT:S_RT + 16] = torch.eye(4, dtype=F32).reshape(-1)
    st[S_RT_INV:S_RT_INV + 16] = torch.eye(4, dtype=F32).reshape(-1)
    st[S_LAST_RGB_ERR] = _BIG
    return st.to(device)


def odo_init_cuda(device) -> torch.Tensor:
    st = torch.empty((S_SIZE,), dtype=F32, device=device)
    K.call("odo_init", K.fn("gn_step", "mmf_odo_init", [K.P]), K.ptr(st))
    return st


def odo_init(device) -> torch.Tensor:
    """A fresh loop state: R = I, result_Rt = I, both loops running."""
    device = torch.device(device)
    K.record("odo_init", device=device)
    return odo_init_cuda(device) if device.type == "cuda" else odo_init_plain(device)


# ---------------------------------------------------------------- K3

def _so3_bank(next_img: torch.Tensor) -> torch.Tensor:
    ngx, ngy = central_grads(next_img)
    return _bf16(torch.stack([next_img, ngx, ngy], dim=-1))


def so3_inputs(last_img, next_img, cam_l: CameraModel, state):
    """``so3_system``'s arguments at the state's rotation."""
    dev = last_img.device
    R = state[S_R:S_R + 9].reshape(3, 3).to(dev)
    Km, Kinv = _K(cam_l).to(dev), _K_inv(cam_l).to(dev)
    return (last_img, _so3_bank(next_img), central_grads(last_img), Km @ R @ Kinv, Kinv,
            Km @ R)


def so3_reduce_plain(last_img, next_img, cam_l: CameraModel, state) -> torch.Tensor:
    """Plain K3: [11] = upper triangle of the 4x4 system, count (zeros once
    the SO(3) loop is done)."""
    dev = last_img.device
    if bool(state[S_SO3_DONE] != 0):
        return torch.zeros((N_SO3_SUMS,), dtype=F32, device=dev)
    S, cnt = so3_system(*so3_inputs(last_img, next_img, cam_l, state))
    iu = torch.triu_indices(4, 4, device=dev)
    return torch.cat([S[iu[0], iu[1]], cnt.to(F32)[None]])


def so3_reduce_cuda(last_img, next_img, cam_l: CameraModel, state) -> torch.Tensor:
    """K3 on the card: ``csrc/gn_step.cu`` (same contract as ``so3_reduce_plain``)."""
    K.check(last_img, F32, "last_img")
    K.check(next_img, F32, "next_img")
    K.check(state, F32, "state")
    h, w = next_img.shape
    if tuple(last_img.shape) != (h, w) or (h, w) != (cam_l.height, cam_l.width):
        raise ValueError("the SO(3) images must be the coarsest level's [H, W]")
    dev = next_img.device
    blocks = max(1, min((h * w + _SO3_THREADS - 1) // _SO3_THREADS, _SO3_MAX_BLOCKS))
    partials = torch.empty((blocks, 16), dtype=F32, device=dev)
    sums = torch.zeros((16,), dtype=F32, device=dev)
    f = K.fn("gn_step", "mmf_so3_reduce", [K.P, K.P, K.I, K.I] + [K.F] * 8 + [K.P, K.I, K.P, K.P])
    K.call("so3_reduce", f, K.ptr(last_img), K.ptr(next_img), h, w, cam_l.fx, cam_l.fy,
           cam_l.cx, cam_l.cy, 1.0 / cam_l.fx, -cam_l.cx / cam_l.fx, 1.0 / cam_l.fy,
           -cam_l.cy / cam_l.fy, K.ptr(state), blocks, K.ptr(partials), K.ptr(sums))
    return sums[:N_SO3_SUMS]


def so3_reduce(last_img, next_img, cam_l: CameraModel, state) -> torch.Tensor:
    K.record("so3_reduce", last_img=last_img, next_img=next_img, cam_l=cam_l, state=state)
    impl = so3_reduce_cuda if next_img.is_cuda else so3_reduce_plain
    return impl(last_img, next_img, cam_l, state)


# ---------------------------------------------------------------- K5

def _write_pose(s: torch.Tensor, Rt: torch.Tensor) -> None:
    s[S_RT:S_RT + 16] = Rt.reshape(-1)
    s[S_RT_INV:S_RT_INV + 16] = se3.inverse_T(Rt).reshape(-1)


def so3_step_plain(state: torch.Tensor, sums: torch.Tensor, verbatim: bool = False) -> None:
    """Plain K5 (SO(3)): one body of the reference's SO(3) while_loop on the
    state, in place. The static path's convergence test is count stability
    (|last count - count| < 0.5); ``verbatim`` keeps the reference's own
    formula |last error - count| < 0.001, as the multi-model path does."""
    s, sm_ = state.to(HOST).clone(), sums.to(HOST)
    R = s[S_R:S_R + 9].reshape(3, 3).clone()
    last_R = s[S_LAST_R:S_LAST_R + 9].reshape(3, 3).clone()
    if s[S_SO3_DONE] == 0:
        S = _sym(sm_[:10], 4)
        cntf = sm_[10]
        last_err, last_count = s[S_SO3_LAST_ERR].clone(), s[S_SO3_LAST_COUNT].clone()
        err = torch.sqrt(S[3, 3]) / torch.clamp(cntf, min=1.0)
        if verbatim:
            converged = bool((err < last_err) & (torch.abs(last_err - cntf) < 0.001))
        else:
            converged = bool((err < last_err) & (torch.abs(last_count - cntf) < 0.5))
        diverging = bool(err > last_err + 0.001)
        delta = solve_preconditioned(S[:3, :3], S[:3, 3])
        dn = torch.linalg.norm(delta)
        delta = delta * torch.clamp(0.1 / torch.clamp(dn, min=1e-12), max=1.0)
        if not bool(cntf >= 60):
            delta = torch.zeros_like(delta)
        R_new = se3.so3_exp(delta) @ R
        R_out = R if converged else (last_R if diverging else R_new)
        s[S_SO3_ERR] = last_err if diverging else err
        s[S_SO3_COUNT] = last_count if diverging else cntf
        s[S_SO3_LAST_ERR], s[S_SO3_LAST_COUNT] = err, cntf
        s[S_LAST_R:S_LAST_R + 9] = R.reshape(-1)
        s[S_R:S_R + 9] = R_out.reshape(-1)
        s[S_SO3_ITERS] += 1
        if converged or diverging:
            s[S_SO3_DONE] = 1.0
        R = R_out
    Rt = torch.eye(4, dtype=F32)
    Rt[:3, :3] = R
    _write_pose(s, Rt)
    state.copy_(s)


def so3_step_cuda(state: torch.Tensor, sums: torch.Tensor, verbatim: bool = False) -> None:
    """K5 (SO(3)) on the card: ``csrc/gn_step.cu`` ``mmf_so3_step``, one
    thread; the 3x3 solve (in registers) runs only where the step is
    applied."""
    K.check(state, F32, "state")
    K.check(sums, F32, "sums")
    K.call("so3_step", K.fn("gn_step", "mmf_so3_step", [K.P, K.P, K.I]), K.ptr(state),
           K.ptr(sums), int(verbatim))


def so3_step(state: torch.Tensor, sums: torch.Tensor, verbatim: bool = False) -> None:
    K.record("so3_step", state=state, sums=sums, verbatim=verbatim)
    (so3_step_cuda if state.is_cuda else so3_step_plain)(state, sums, verbatim)


class StepParams(NamedTuple):
    """Loop-invariant inputs of one level's GN steps."""

    scale2: float
    use_icp: bool
    use_rgb: bool
    rgb_only: bool
    icp_weight: float
    eps: float
    level: int


def gn_step_plain(state: torch.Tensor, sums: torch.Tensor, sp: StepParams, last: bool) -> None:
    """Plain K5 (GN): one body of the reference's level while_loop on the
    state, in place; ``last`` resets the loop carries for the next level."""
    s = state.to(HOST).clone()
    if s[S_GN_DONE] == 0:
        t32 = lambda v: torch.tensor(v, dtype=F32)  # noqa: E731
        S_icp, icp_cnt, S_rgb, rgb_size, tmp_err = systems_from_sums(sums, sp.scale2)
        if not sp.use_rgb:
            rgb_size, tmp_err = t32(0.0), t32(0.0)
        if not sp.use_icp:
            icp_cnt = t32(0.0)
        diverging = bool(sp.rgb_only and tmp_err > s[S_LAST_RGB_ERR])
        A_icp, b_icp = S_icp[:6, :6], S_icp[:6, 6]
        A_rgbd, b_rgbd = S_rgb[:6, :6], S_rgb[:6, 6]
        if sp.use_icp and sp.use_rgb:
            # consistent least-squares fusion: w^2 on both A and b
            w2 = t32(sp.icp_weight) * t32(sp.icp_weight)
            A, b = A_rgbd + w2 * A_icp, b_rgbd + w2 * b_icp
        elif sp.use_icp:
            A, b = A_icp, b_icp
        else:
            A, b = A_rgbd, b_rgbd
        x = clamp_step(solve_preconditioned(A, b))
        enough = bool(icp_cnt + rgb_size >= 60)
        upd = (not diverging) and enough
        converged = upd and bool(torch.linalg.norm(x[0:3]) < sp.eps) and bool(
            torch.linalg.norm(x[3:6]) < sp.eps)
        if upd:
            _write_pose(s, se3.gn_update_pose(s[S_RT:S_RT + 16].reshape(4, 4), x))
            if sp.use_icp:
                s[S_ICP_ERR] = torch.sqrt(S_icp[6, 6]) / torch.clamp(icp_cnt, min=1.0)
                s[S_ICP_COUNT] = icp_cnt
            s[S_RGB_ERR], s[S_RGB_COUNT] = tmp_err, rgb_size
            s[S_LAST_A:S_LAST_A + 36] = A.reshape(-1)
            s[S_LAST_B:S_LAST_B + 6] = b
            s[S_LAST_RGB_ERR] = tmp_err
        s[S_GN_J] += 1
        s[S_GN_ITERS + sp.level] = s[S_GN_J]
        if diverging or not enough or converged:
            s[S_GN_DONE] = 1.0
    if last:
        s[S_GN_DONE], s[S_LAST_RGB_ERR], s[S_GN_J] = 0.0, _BIG, 0.0
    state.copy_(s)


def gn_step_cuda(state: torch.Tensor, sums: torch.Tensor, sp: StepParams, last: bool) -> None:
    """K5 (GN) on the card: ``csrc/gn_step.cu`` ``mmf_gn_step``, one thread;
    the 6x6 solve (in registers) runs only where the update is applied."""
    K.check(state, F32, "state")
    K.check(sums, F32, "sums")
    w = np.float32(sp.icp_weight)
    f = K.fn("gn_step", "mmf_gn_step", [K.P, K.P, K.F, K.F, K.F] + [K.I] * 5)
    K.call("gn_step", f, K.ptr(state), K.ptr(sums), float(sp.scale2), float(w * w), float(sp.eps),
           int(sp.use_icp), int(sp.use_rgb), int(sp.rgb_only), int(sp.level), int(last))


def solve_cases_cuda(A: torch.Tensor, b: torch.Tensor):
    """Test entry of K5's solve on the card (``mmf_solve_cases``): the
    kernel's ``solve_preconditioned<N>`` on each of n systems, A [n, N, N]
    and b [n, N] with N = 3 or 6; returns (x [n, N], the Jacobi-scaled
    system's eigenvalues w [n, N], ascending). On no path of the engine."""
    K.check(A, F32, "A")
    K.check(b, F32, "b")
    n, N = b.shape
    if N not in (3, 6) or tuple(A.shape) != (n, N, N):
        raise ValueError("solve_cases takes A [n, N, N] and b [n, N] with N = 3 or 6")
    x = torch.empty_like(b)
    w = torch.empty_like(b)
    f = K.fn("gn_step", "mmf_solve_cases", [K.P, K.P, K.I, K.I, K.P, K.P])
    K.call("solve_cases", f, K.ptr(A), K.ptr(b), n, N, K.ptr(x), K.ptr(w))
    return x, w


def gn_step(state: torch.Tensor, sums: torch.Tensor, sp: StepParams, last: bool) -> None:
    K.record("gn_step", state=state, sums=sums, sp=sp, last=last)
    (gn_step_cuda if state.is_cuda else gn_step_plain)(state, sums, sp, last)


def arbitration_error(sums: torch.Tensor, scale2: float, use_icp: bool) -> torch.Tensor:
    """Error of one seed-arbitration evaluation: the ICP error when ICP is
    on, else the photometric error; inf under 60 correspondences."""
    s = sums.to(HOST)
    sc = torch.tensor(scale2, dtype=F32)
    if use_icp:
        cnt = s[56] * sc
        e = torch.sqrt(sc * s[27]) / torch.clamp(cnt, min=1.0)
    else:
        cnt = s[57] * sc
        e = torch.sqrt(s[58] * sc) / torch.clamp(cnt, min=1.0)
    return torch.where(cnt >= 60, e, torch.full_like(e, float("inf")))


def seed_select_plain(state, seed_Rt, seed_valid, sums_cur, sums_so3, scale2: float,
                      use_icp: bool, arbitrate: bool) -> None:
    """Plain K5 (seed selection), in place: result_Rt = the seed where it is
    valid, else the SO(3) pose; with ``arbitrate`` the choice is kept only
    when its error is no worse than the SO(3) pose's."""
    s = state.to(HOST).clone()
    so3 = s[S_RT:S_RT + 16].reshape(4, 4).clone()
    cur = seed_Rt.to(HOST, F32) if bool(seed_valid) else so3
    keep = True
    if arbitrate:
        keep = bool(arbitration_error(sums_cur, scale2, use_icp)
                    <= arbitration_error(sums_so3, scale2, use_icp))
    _write_pose(s, cur if keep else so3)
    state.copy_(s)


def seed_select_cuda(state, seed_Rt, seed_valid, sums_cur, sums_so3, scale2: float,
                     use_icp: bool, arbitrate: bool) -> None:
    """K5 (seed selection) on the card: ``csrc/gn_step.cu``."""
    K.check(state, F32, "state")
    check_pose(seed_Rt, "seed_Rt")
    K.check(seed_valid, torch.bool, "seed_valid")
    if arbitrate:
        K.check(sums_cur, F32, "sums_cur")
        K.check(sums_so3, F32, "sums_so3")
    f = K.fn("gn_step", "mmf_seed_select", [K.P] * 5 + [K.F, K.I, K.I])
    K.call("seed_select", f, K.ptr(state), K.ptr(seed_Rt), K.ptr(seed_valid),
           K.ptr(sums_cur) if arbitrate else None, K.ptr(sums_so3) if arbitrate else None,
           float(scale2), int(use_icp), int(arbitrate))


def seed_select(state, seed_Rt, seed_valid, sums_cur, sums_so3, scale2: float, use_icp: bool,
                arbitrate: bool) -> None:
    K.record("seed_select", state=state, seed_Rt=seed_Rt, seed_valid=seed_valid,
             sums_cur=sums_cur, sums_so3=sums_so3, scale2=scale2, use_icp=use_icp,
             arbitrate=arbitrate)
    impl = seed_select_cuda if state.is_cuda else seed_select_plain
    impl(state, seed_Rt, seed_valid, sums_cur, sums_so3, scale2, use_icp, arbitrate)


# ---------------------------------------------------------------- driver

def gn_level(level: LevelData, i: int, cfg: OdometryConfig, cam: CameraModel,
             mask_id: int = 0) -> GNLevel:
    """Loop-invariant GN inputs of pyramid level ``i`` from its LevelData
    (plain; the engine builds them with kernel K2, odometry/levels.py)."""
    use_icp = (not cfg.rgb_only) and cfg.icp_weight > 0
    use_rgb = cfg.rgb_only or cfg.icp_weight < 100
    if use_rgb:
        min_scale = (cfg.min_grad_magnitudes[i] ** 2) / (cfg.sobel_scale**2)
        sv = rgb_static_valid(level, min_scale, mask_id, cfg.mask_rgb)
    else:
        sv = torch.zeros(level.img_next.shape, dtype=torch.bool, device=level.img_next.device)
    return GNLevel(
        pred=build_pred_map(level, use_icp and i == 0),
        compact=use_icp and i == 0,
        vmap=level.vmap_curr.contiguous(), nmap=level.nmap_curr.contiguous(),
        img=level.img_next.contiguous(), didx=level.didx.contiguous(),
        didy=level.didy.contiguous(), static_valid=sv.contiguous(),
        stride=level_stride(i, cfg, cam),
    )


def level_stride(i: int, cfg: OdometryConfig, cam: CameraModel) -> int:
    """Evaluation grid stride of level ``i`` (fine_subsample / mid_subsample)."""
    cam_l = cam.level(i)
    if i == 0:
        return cfg.fine_subsample
    if i == 1 and cam_l.width * cam_l.height >= 65536:
        return cfg.mid_subsample
    return 1


def track(T_prev: torch.Tensor, gl: List[GNLevel], last_next_img_l2: torch.Tensor,
          cfg: OdometryConfig, cam: CameraModel, T_init: Optional[torch.Tensor] = None,
          seed_valid: Optional[torch.Tensor] = None) -> OdometryResult:
    """SO(3) pre-alignment then the coarse-to-fine GN loop on ``gl`` (index 0
    = finest), every iteration enqueued; nothing is read back. Returns views
    of the loop state.

    With ``T_init`` (a pose seed, e.g. the keypoint initialisation) the GN
    loop starts from ``inv(T_init) @ T_prev`` where ``seed_valid`` (0-dim
    bool on the device; True when None) is set and the SO(3) pose otherwise,
    and before the coarsest level the dense error at that start and at the
    SO(3) pose decides which one it keeps."""
    use_icp = (not cfg.rgb_only) and cfg.icp_weight > 0
    use_rgb = cfg.rgb_only or cfg.icp_weight < 100
    K.record("track", T_prev=T_prev, gl=gl, last_next_img_l2=last_next_img_l2, cfg=cfg, cam=cam,
             T_init=T_init, seed_valid=seed_valid)
    T_prev = T_prev.to(F32)
    st = odo_init(T_prev.device)
    if cfg.so3_prealign and cfg.so3_iterations > 0:
        lvl = cfg.num_pyr - 1
        cam_l = cam.level(lvl)
        for _ in range(cfg.so3_iterations):
            so3_step(st, so3_reduce(last_next_img_l2, gl[lvl].img, cam_l, st))

    params = GNParams(use_icp, use_rgb, cfg.rgb_only, cfg.dist_thresh, cfg.angle_thresh,
                      cfg.max_depth_delta_rgb, cfg.max_depth_rgb, cfg.sobel_scale)
    schedule = cfg.schedule()
    Rt_inv = st[S_RT_INV:S_RT_INV + 16].view(4, 4)
    done = st[S_GN_DONE]
    if T_init is not None:
        _seed(st, T_prev, T_init, seed_valid, gl, params, cfg, cam, use_icp)
    for i in range(cfg.num_pyr - 1, -1, -1):
        iters = schedule[i]
        if iters == 0:
            continue
        lv = gl[i]
        sp = StepParams(float(lv.stride * lv.stride), use_icp, use_rgb, cfg.rgb_only,
                        cfg.icp_weight, cfg.convergence_eps, i)
        for j in range(iters):
            sums = gn_reduce(lv, Rt_inv, cam.level(i), sp.scale2, params, level=i, done=done)
            gn_step(st, sums, sp, last=j == iters - 1)

    # the optional error images (the legacy CRF's input): one more level-0
    # evaluation on the full grid at the final pose (rgbd.py:1062-1075)
    err_imgs = (None, None)
    if cfg.error_images:
        h, w = gl[0].img.shape
        err_imgs = (torch.zeros((h, w), dtype=F32, device=T_prev.device),) * 2
        if schedule[0] > 0:
            err_imgs = error_images(gl[0]._replace(stride=1), Rt_inv, cam.level(0), params)

    T_new = T_prev @ Rt_inv
    if use_rgb:
        diverged = torch.linalg.norm(T_new[:3, 3] - T_prev[:3, 3]) > cfg.divergence_trans_norm
        T_new = torch.where(diverged, T_prev, T_new)
    return OdometryResult(
        T_new, st[S_ICP_ERR], st[S_ICP_COUNT], st[S_RGB_ERR], st[S_RGB_COUNT], st[S_SO3_ERR],
        st[S_SO3_COUNT], st[S_LAST_A:S_LAST_A + 36].view(6, 6), st[S_LAST_B:S_LAST_B + 6], st,
        *err_imgs,
    )


def _seed(st, T_prev, T_init, seed_valid, gl, params: GNParams, cfg: OdometryConfig,
          cam: CameraModel, use_icp: bool) -> None:
    """Seed selection of a seeded solve: two evaluations at the coarsest
    level (at the chosen start and at the SO(3) pose), then ``seed_select``."""
    dev = T_prev.device
    seed_Rt = (se3.inverse_T(T_init.to(F32)) @ T_prev).contiguous()
    if seed_valid is None:
        seed_valid = torch.ones((), dtype=torch.bool, device=dev)
    lvl = cfg.num_pyr - 1
    lv = gl[lvl]
    scale2 = float(lv.stride * lv.stride)
    arbitrate = cfg.schedule()[lvl] > 0
    sums_cur = sums_so3 = None
    if arbitrate:
        so3_Rt = st[S_RT:S_RT + 16].view(4, 4)
        cur_inv = se3.inverse_T(torch.where(seed_valid, seed_Rt, so3_Rt)).contiguous()
        so3_inv = st[S_RT_INV:S_RT_INV + 16].view(4, 4)
        sums_cur = gn_reduce(lv, cur_inv, cam.level(lvl), scale2, params, level=lvl)
        sums_so3 = gn_reduce(lv, so3_inv, cam.level(lvl), scale2, params, level=lvl)
    seed_select(st, seed_Rt, seed_valid, sums_cur, sums_so3, scale2, use_icp, arbitrate)


def loop_iterations(result: OdometryResult) -> dict:
    """Iterations each loop ran, {"so3": n, "L0": n, "L1": n, "L2": n} (a host read)."""
    st = result.state.to(HOST)
    out = {"so3": int(st[S_SO3_ITERS])}
    for lvl in range(3):
        out[f"L{lvl}"] = int(st[S_GN_ITERS + lvl])
    return out


def get_incremental_transformation(
    T_prev: torch.Tensor,
    levels: Sequence[LevelData],
    last_next_img_l2: torch.Tensor,
    cfg: OdometryConfig,
    cam: CameraModel,
    mask_id: int = 0,
    T_init: Optional[torch.Tensor] = None,
    seed_valid: Optional[torch.Tensor] = None,
) -> OdometryResult:
    """Multi-level GN odometry (RGBDOdometry::getIncrementalTransformation).

    T_prev: previous camera pose (camera -> global), the pose the prediction
    was rendered at. levels: per-level inputs, index 0 = finest.
    last_next_img_l2: previous frame's coarsest intensity."""
    gl = [gn_level(levels[i], i, cfg, cam, mask_id) for i in range(cfg.num_pyr)]
    return track(T_prev, gl, last_next_img_l2, cfg, cam, T_init, seed_valid)
