"""Dense joint ICP + photometric RGB-D odometry (Gauss-Newton, 3-level pyramid).

Port of the reference package's ``odometry/rgbd.py``:
- SO(3) pre-alignment at the coarsest level (plain PyTorch ``so3_system``, K3,
  with the bf16 rounding of its tap bank reproduced), <= 10 iterations;
- coarse-to-fine joint ICP + RGB Gauss-Newton over {10, 5, 4} iterations; each
  iteration evaluates both 7x7 normal systems with ``gn_reduce`` (kernel K4,
  ``csrc/gn_reduce.cu``: warp, bilinear taps, gates, rows and the reduction in
  one pass; no [P, 7] row matrix);
- the 6x6 solve (K5: Jacobi-scaled, eigen-truncated), the trust clamp and the
  SE(3) update run on the host in float32, like the reference's host-side
  solve: the systems come back once per iteration, and that read doubles as
  the early-exit test of the loop;
- the 0.3 m divergence guard reverts the whole update.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel, OdometryConfig
from multimotionfusion_tpu_torch.ops.image import _shift2d
from multimotionfusion_tpu_torch.ops.rasterize import _pose_args, div
from multimotionfusion_tpu_torch.utils import se3

F32 = torch.float32
HOST = torch.device("cpu")


class OdometryResult(NamedTuple):
    pose: torch.Tensor  # [4,4] new camera pose (host)
    icp_error: torch.Tensor
    icp_count: torch.Tensor
    rgb_error: torch.Tensor
    rgb_count: torch.Tensor
    so3_error: torch.Tensor
    so3_count: torch.Tensor
    A: torch.Tensor  # [6,6] last fused normal matrix
    b: torch.Tensor  # [6]


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


# ---------------------------------------------------------------- K5 (host)

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
    return rows.T @ rows, torch.sum(found)


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
    h, w = level.img_next.shape
    dev = level.img_next.device
    ok = level.img_next > 0
    if use_mask:
        ok = ok & (level.mask_next == mask_id)
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
    valid = valid & (level.didx**2 + level.didy**2 >= min_scale)
    return valid & (level.depth_next > 0)


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
    if compact:
        depth = level.vmap_prev[..., 2]
        zhi = depth.to(torch.bfloat16)
        zlo = (depth - zhi.to(F32)).to(torch.bfloat16)
        rest = torch.cat([level.nmap_prev, level.img_last[..., None]], dim=-1).to(torch.bfloat16)
        pad = torch.zeros_like(zhi)
        return torch.cat([zhi[..., None], zlo[..., None], rest, pad[..., None], pad[..., None]],
                         dim=-1).contiguous()
    return torch.cat(
        [level.vmap_prev, level.nmap_prev, level.depth_last[..., None], level.img_last[..., None]],
        dim=-1,
    ).contiguous()


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
                    p: GNParams) -> torch.Tensor:
    """Plain PyTorch K4: one evaluation of both 7x7 systems -> [N_SUMS] sums
    (on the evaluated grid; ``scale2`` only enters the RGB weight)."""
    icp_rows, rgb_rows, counts = gn_rows(lv, Rt_inv, cam_l, scale2, p)
    iu = _TRIU.to(icp_rows.device)
    return torch.cat([(icp_rows.T @ icp_rows)[iu[0], iu[1]], (rgb_rows.T @ rgb_rows)[iu[0], iu[1]],
                      counts])


_GN_ARGS = (
    [K.P, K.I, K.I, K.I]  # pred map, compact, H, W
    + [K.P] * 6  # vmap, nmap, img, didx, didy, static_valid
    + [K.I, K.I, K.I]  # stride, grid rows, grid cols
    + [K.F] * 12 + [K.F] * 4  # Rt_inv, intrinsics
    + [K.I, K.I, K.I]  # use_icp, use_rgb, rgb_only
    + [K.F] * 6  # dist, angle, max depth delta, max depth rgb, sobel scale, scale2
    + [K.I, K.P, K.P]  # blocks, partials, sums
)
_GN_THREADS = 256
_GN_MAX_BLOCKS = 1024
_GN_STRIDE_SUMS = 64


def gn_reduce_cuda(lv: GNLevel, Rt_inv: torch.Tensor, cam_l: CameraModel, scale2: float,
                   p: GNParams, level: int = 0) -> torch.Tensor:
    """K4 on the card: ``csrc/gn_reduce.cu`` (same contract as ``gn_reduce_plain``;
    launches are counted per pyramid level, ``gn_reduce.L<level>``)."""
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
    partials = torch.empty((blocks, _GN_STRIDE_SUMS), dtype=F32, device=dev)
    sums = torch.empty((_GN_STRIDE_SUMS,), dtype=F32, device=dev)
    f = K.fn("gn_reduce", "mmf_gn_reduce", _GN_ARGS)
    K.call(
        f"gn_reduce.L{level}", f, K.ptr(lv.pred), int(lv.compact), h, w,
        K.ptr(lv.vmap), K.ptr(lv.nmap), K.ptr(lv.img), K.ptr(lv.didx), K.ptr(lv.didy),
        K.ptr(lv.static_valid), s, hs, ws,
        *_pose_args(Rt_inv), cam_l.fx, cam_l.fy, cam_l.cx, cam_l.cy,
        int(p.use_icp), int(p.use_rgb), int(p.rgb_only),
        p.dist_thresh, p.angle_thresh, p.max_depth_delta_rgb, p.max_depth_rgb, p.sobel_scale,
        float(scale2), blocks, K.ptr(partials), K.ptr(sums),
    )
    return sums[:N_SUMS]


def gn_reduce(lv: GNLevel, Rt_inv: torch.Tensor, cam_l: CameraModel, scale2: float,
              p: GNParams, level: int = 0) -> torch.Tensor:
    K.record(f"gn_reduce.L{level}", lv=lv, Rt_inv=Rt_inv, cam_l=cam_l, scale2=scale2, p=p)
    if lv.img.is_cuda:
        return gn_reduce_cuda(lv, Rt_inv, cam_l, scale2, p, level)
    return gn_reduce_plain(lv, Rt_inv, cam_l, scale2, p)


def _sym(tri: torch.Tensor) -> torch.Tensor:
    S = torch.zeros((7, 7), dtype=F32)
    S[_TRIU[0], _TRIU[1]] = tri
    S[_TRIU[1], _TRIU[0]] = tri
    return S


def systems_from_sums(sums: torch.Tensor, scale2: float):
    """Host unpacking of gn_reduce's output: (S_icp, icp_cnt, S_rgb, rgb_size,
    tmp_err), all scaled to full-grid units."""
    sums = sums.to(HOST)
    sc = torch.tensor(scale2, dtype=F32)
    S_icp = sc * _sym(sums[0:28])
    S_rgb = sc * _sym(sums[28:56])
    icp_cnt = sums[56] * sc
    rgb_size = sums[57] * sc
    tmp_err = torch.sqrt(sums[58] * sc) / torch.clamp(rgb_size, min=1.0)
    return S_icp, icp_cnt, S_rgb, rgb_size, tmp_err


# ---------------------------------------------------------------- driver

def get_incremental_transformation(
    T_prev: torch.Tensor,
    levels: Sequence[LevelData],
    last_next_img_l2: torch.Tensor,
    cfg: OdometryConfig,
    cam: CameraModel,
    mask_id: int = 0,
) -> OdometryResult:
    """Multi-level GN odometry (RGBDOdometry::getIncrementalTransformation).

    T_prev: previous camera pose (camera -> global), the pose the prediction
    was rendered at. levels: per-level inputs, index 0 = finest, on the
    compute device. last_next_img_l2: previous frame's coarsest intensity."""
    if cfg.error_images:
        raise NotImplementedError("odometry error images are not ported yet (ROADMAP.md)")
    use_icp = (not cfg.rgb_only) and cfg.icp_weight > 0
    use_rgb = cfg.rgb_only or cfg.icp_weight < 100
    dev = levels[0].img_next.device
    T_prev = T_prev.to(HOST, F32)
    t32 = lambda v: torch.tensor(v, dtype=F32)  # noqa: E731

    so3_err = t32(0.0)
    so3_count = t32(0.0)
    R = torch.eye(3, dtype=F32)
    if cfg.so3_prealign and cfg.so3_iterations > 0:
        lvl = cfg.num_pyr - 1
        cam_l = cam.level(lvl)
        Km, Kinv = _K(cam_l), _K_inv(cam_l)
        img_l = levels[lvl].img_next
        ngx, ngy = central_grads(img_l)
        so3_bank = _bf16(torch.stack([img_l, ngx, ngy], dim=-1))
        last_grads = central_grads(last_next_img_l2)
        last_err = last_count = t32(3.4e38 / 2)
        last_R = torch.eye(3, dtype=F32)
        for _ in range(cfg.so3_iterations):
            S, cnt = so3_system(last_next_img_l2, so3_bank, last_grads,
                                (Km @ R @ Kinv).to(dev), Kinv.to(dev), (Km @ R).to(dev))
            S = S.to(HOST)
            cntf = cnt.to(HOST).to(F32)
            err = torch.sqrt(S[3, 3]) / torch.clamp(cntf, min=1.0)
            converged = bool((err < last_err) & (torch.abs(last_count - cntf) < 0.5))
            diverging = bool(err > last_err + 0.001)
            delta = solve_preconditioned(S[:3, :3], S[:3, 3])
            dn = torch.linalg.norm(delta)
            delta = delta * torch.clamp(0.1 / torch.clamp(dn, min=1e-12), max=1.0)
            if not bool(cntf >= 60):
                delta = torch.zeros_like(delta)
            R_new = se3.so3_exp(delta) @ R
            R_out = R if converged else (last_R if diverging else R_new)
            so3_err = last_err if diverging else err
            so3_count = last_count if diverging else cntf
            last_err, last_count, last_R = err, cntf, R
            R = R_out
            if converged or diverging:
                break
    result_Rt = torch.eye(4, dtype=F32)
    result_Rt[:3, :3] = R

    params = GNParams(use_icp, use_rgb, cfg.rgb_only, cfg.dist_thresh, cfg.angle_thresh,
                      cfg.max_depth_delta_rgb, cfg.max_depth_rgb, cfg.sobel_scale)
    schedule = cfg.schedule()
    icp_err, icp_count = t32(0.0), t32(0.0)
    rgb_err, rgb_count = t32(0.0), t32(0.0)
    lastA = torch.zeros((6, 6), dtype=F32)
    lastb = torch.zeros((6,), dtype=F32)
    for i in range(cfg.num_pyr - 1, -1, -1):
        iters = schedule[i]
        if iters == 0:
            continue
        cam_l = cam.level(i)
        level = levels[i]
        min_scale = (cfg.min_grad_magnitudes[i] ** 2) / (cfg.sobel_scale**2)
        if use_rgb:
            static_valid = rgb_static_valid(level, min_scale, mask_id, cfg.mask_rgb)
        else:
            static_valid = torch.zeros(level.img_next.shape, dtype=torch.bool, device=dev)
        sub = (cfg.fine_subsample if i == 0
               else cfg.mid_subsample if i == 1 and cam_l.width * cam_l.height >= 65536 else 1)
        lv = GNLevel(
            pred=build_pred_map(level, use_icp and i == 0), compact=use_icp and i == 0,
            vmap=level.vmap_curr.contiguous(), nmap=level.nmap_curr.contiguous(),
            img=level.img_next.contiguous(), didx=level.didx.contiguous(),
            didy=level.didy.contiguous(), static_valid=static_valid.contiguous(), stride=sub,
        )
        scale2 = float(sub * sub)
        last_rgb_err = t32(3.4e38)
        for _ in range(iters):
            sums = gn_reduce(lv, se3.inverse_T(result_Rt), cam_l, scale2, params, level=i)
            S_icp, icp_cnt, S_rgb, rgb_size, tmp_err = systems_from_sums(sums, scale2)
            if not use_rgb:
                rgb_size, tmp_err = t32(0.0), t32(0.0)
            if not use_icp:
                icp_cnt = t32(0.0)
            diverging = bool(cfg.rgb_only and tmp_err > last_rgb_err)
            A_icp, b_icp = S_icp[:6, :6], S_icp[:6, 6]
            A_rgbd, b_rgbd = S_rgb[:6, :6], S_rgb[:6, 6]
            if use_icp and use_rgb:
                # consistent least-squares fusion: w^2 on both A and b
                w2 = t32(cfg.icp_weight) * t32(cfg.icp_weight)
                A = A_rgbd + w2 * A_icp
                b = b_rgbd + w2 * b_icp
            elif use_icp:
                A, b = A_icp, b_icp
            else:
                A, b = A_rgbd, b_rgbd
            x = clamp_step(solve_preconditioned(A, b))
            Rt_new = se3.gn_update_pose(result_Rt, x)
            enough = bool(icp_cnt + rgb_size >= 60)
            upd = (not diverging) and enough
            eps = cfg.convergence_eps
            converged = upd and bool(torch.linalg.norm(x[0:3]) < eps) and bool(
                torch.linalg.norm(x[3:6]) < eps)
            if upd:
                result_Rt = Rt_new
                if use_icp:
                    icp_err = torch.sqrt(S_icp[6, 6]) / torch.clamp(icp_cnt, min=1.0)
                    icp_count = icp_cnt
                rgb_err, rgb_count = tmp_err, rgb_size
                lastA, lastb = A, b
                last_rgb_err = tmp_err
            if diverging or not enough or converged:
                break

    T_new = T_prev @ se3.inverse_T(result_Rt)
    if use_rgb:
        diverged = torch.linalg.norm(T_new[:3, 3] - T_prev[:3, 3]) > cfg.divergence_trans_norm
        if bool(diverged):
            T_new = T_prev
    return OdometryResult(T_new, icp_err, icp_count, rgb_err, rgb_count, so3_err, so3_count,
                          lastA, lastb)
