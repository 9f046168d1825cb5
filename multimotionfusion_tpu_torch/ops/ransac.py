"""Rigid (SE(3)) fitting: weighted Kabsch and batched RANSAC (kernel K21,
``csrc/ransac.cu``).

Port of the reference package's ``ops/ransac.py``. The model maps p1 -> p0
(p0 ~ T @ p1); a candidate passes when #inliers > max(rint(inlier_fraction *
n_valid), 3); the winner is the passing candidate with the least mean inlier
distance after a refit on its inliers (first index on ties); with none
passing, the least-squares fit over all valid points with error = inf.

The random numbers are an argument: ``u`` [C, 3] uniforms in [0, 1) pick the
minimal sets (the engine draws them from its own ``torch.Generator``, one
``torch.rand((C, 3))`` a fit, ``draw_uniforms``; the tests hand in the
reference's).

``ransac_fit_batch`` runs B fits in one set of three launches (the engine's
per-model seeds share one pair of points; the back-dating fits each have
their own); ``ransac_fit`` is its B = 1 case. On the card one block per
candidate and fit samples its minimal set, fits it (Horn's quaternion
method, 40 power steps), counts its inliers and refits on them; every sum
over the N points runs in one fixed order that does not depend on the
candidate (each of 256 threads sums its strided points in order, then a warp
tree, then the 8 warp sums in order; ``block_sum``), so candidates that share
an inlier set get bit-equal refits and the argmin keeps the first. A fit
whose valid count is at most its gate cannot pass, and its candidates stop
after drawing their minimal sets. A final block a fit picks the winner and
computes the fallback. The plain version (``ransac_fit_plain``, per row
``ransac_fit_batch_plain``) sums in the same orders.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import RansacConfig

F32 = torch.float32
THREADS = 256
WARPS = THREADS // 32
_V0 = (1.0, 0.17, 0.23, 0.31)  # the power iteration's start vector (before normalising)
_POWER_STEPS = 40


class RansacResult(NamedTuple):
    transform: torch.Tensor  # [4, 4]
    error: torch.Tensor  # 0-dim, mean inlier distance (inf if no candidate passed)
    inliers: torch.Tensor  # [N] bool
    num_inliers: torch.Tensor  # 0-dim int32
    ok: torch.Tensor  # 0-dim bool: some candidate passed the gate


# ---------------------------------------------------------------- sum orders

def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, element by element from 0 (one thread)."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def block_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernel's block order: thread t sums
    elements t, t + 256, ... in order, then a shuffle-down tree per warp,
    then the warp sums in order."""
    n = x.shape[-1]
    rounds = max(1, -(-n // THREADS))
    x = F.pad(x, (0, rounds * THREADS - n)).reshape(x.shape[:-1] + (rounds, THREADS))
    acc = torch.zeros(x.shape[:-2] + (THREADS,), dtype=x.dtype, device=x.device)
    for r in range(rounds):
        acc = acc + x[..., r, :]
    acc = acc.reshape(acc.shape[:-1] + (WARPS, 32))
    for half in (16, 8, 4, 2, 1):
        acc = acc[..., :half] + acc[..., half:2 * half]
    return seq_sum(acc[..., 0])


# ---------------------------------------------------------------- Kabsch / Horn

def horn_rotation(A: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] A = sum_i q0_i q1_i^T -> the rotation maximising tr(R A^T):
    Horn's quaternion, the top eigenvector of the 4x4 N matrix of S = A^T by
    40 steps of power iteration on N + (|N|_F + 1e-12) I."""
    S = A.transpose(-1, -2)
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = [
        [sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
        [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
        [szx - sxz, sxy + syx, syy - sxx - szz, syz + szy],
        [sxy - syx, szx + sxz, syz + szy, szz - sxx - syy],
    ]
    fro = torch.zeros_like(sxx)
    for i in range(4):
        for j in range(4):
            fro = fro + N[i][j] * N[i][j]
    c = torch.sqrt(fro) + 1e-12
    Ns = [[N[i][j] + c if i == j else N[i][j] for j in range(4)] for i in range(4)]
    v0 = torch.tensor(_V0, dtype=F32, device=A.device)
    n0 = torch.sqrt(seq_sum(v0 * v0))
    v = [torch.zeros_like(sxx) + v0[i] / n0 for i in range(4)]
    for _ in range(_POWER_STEPS):
        wv = []
        for i in range(4):
            acc = torch.zeros_like(sxx)
            for j in range(4):
                acc = acc + Ns[i][j] * v[j]
            wv.append(acc)
        nrm = torch.zeros_like(sxx)
        for i in range(4):
            nrm = nrm + wv[i] * wv[i]
        nrm = torch.clamp(torch.sqrt(nrm), min=1e-20)
        v = [wv[i] / nrm for i in range(4)]
    qw, qx, qy, qz = v
    rows = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _kabsch(p0, p1, w, sum_fn):
    """Weighted rigid fit over the second-to-last axis of p0, p1 [..., n, 3]
    with weights w [..., n]; identity where sum(w) < 3."""
    wsum = sum_fn(w)
    safe = torch.clamp(wsum, min=1e-12)
    p0m = torch.stack([sum_fn(p0[..., a] * w) for a in range(3)], dim=-1) / safe[..., None]
    p1m = torch.stack([sum_fn(p1[..., a] * w) for a in range(3)], dim=-1) / safe[..., None]
    q0 = (p0 - p0m[..., None, :]) * w[..., None]
    q1 = p1 - p1m[..., None, :]
    A = torch.stack([torch.stack([sum_fn(q0[..., a] * q1[..., b]) for b in range(3)], dim=-1)
                     for a in range(3)], dim=-2)
    R = horn_rotation(A)
    t = torch.stack([p0m[..., i] - (R[..., i, 0] * p1m[..., 0] + R[..., i, 1] * p1m[..., 1]
                                    + R[..., i, 2] * p1m[..., 2]) for i in range(3)], dim=-1)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=F32, device=p0.device)[3:].expand(R.shape[:-2] + (1, 4))
    T = torch.cat([top, bottom], dim=-2)
    eye = torch.eye(4, dtype=F32, device=p0.device).expand_as(T)
    return torch.where((wsum >= 2.999999)[..., None, None], T, eye)


def kabsch_fit(p0: torch.Tensor, p1: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """T (4x4) minimising sum_i w_i |T p1_i - p0_i|^2 over [N, 3] points
    (weights bool or float; identity when they sum to less than 3); the sums
    in ``block_sum`` order."""
    return _kabsch(p0, p1, weights.to(F32), block_sum)


def residual_norms(T: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """|p0_i - T p1_i| for T [..., 4, 4] and points [N, 3] -> [..., N]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    d = []
    for i in range(3):
        p1t = (R[..., i, 0, None] * p1[:, 0] + R[..., i, 1, None] * p1[:, 1]
               + R[..., i, 2, None] * p1[:, 2]) + t[..., i, None]
        d.append(p0[:, i] - p1t)
    return torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])


def sample_minimal_sets(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[C, 3] distinct valid indices per candidate from the uniforms ``u``:
    three distinct ranks in [1, n_valid] by sequential shifted sampling, each
    mapped to the rank-th valid index (searchsorted, side left)."""
    n = valid.shape[0]
    cnt = torch.cumsum(valid.to(torch.int32), 0).to(torch.int32)
    total = cnt[-1].to(F32)
    r0 = torch.floor(u[:, 0] * torch.clamp(total, min=1.0)).to(torch.int32) + 1
    r1 = torch.floor(u[:, 1] * torch.clamp(total - 1.0, min=1.0)).to(torch.int32) + 1
    r1 = r1 + (r1 >= r0).to(torch.int32)
    r2 = torch.floor(u[:, 2] * torch.clamp(total - 2.0, min=1.0)).to(torch.int32) + 1
    lo, hi = torch.minimum(r0, r1), torch.maximum(r0, r1)
    r2 = r2 + (r2 >= lo).to(torch.int32)
    r2 = r2 + (r2 >= hi).to(torch.int32)
    r = torch.clamp(torch.stack([r0, r1, r2], dim=-1), min=1)
    r = torch.minimum(r, torch.clamp(total.to(torch.int32), min=1))
    idx = torch.searchsorted(cnt, r.contiguous(), side="left")
    return torch.clamp(idx, 0, n - 1)


# ---------------------------------------------------------------- ransac_fit

def _thresholds(cfg: RansacConfig):
    return float(np.float32(cfg.inlier_threshold)), float(np.float32(cfg.inlier_fraction))


def hopeless(valid: torch.Tensor, cfg: RansacConfig) -> torch.Tensor:
    """[...] fits over ``valid`` [..., N] that no candidate can pass: the
    valid count is at most the gate max(rint(frac * count), 3), and a
    candidate's inliers are valid points. The kernel's candidates of such a
    fit stop after drawing their minimal sets."""
    _, frac = _thresholds(cfg)
    total = valid.to(torch.int32).sum(-1)
    return total <= torch.clamp(torch.round(frac * total.to(F32)).to(torch.int32), min=3)


def ransac_fit_plain(u, p0, p1, valid, cfg: RansacConfig, want_idx: bool = False):
    thr, frac = _thresholds(cfg)
    n_valid = valid.to(torch.int32).sum()
    idx = sample_minimal_sets(u, valid)  # [C, 3]
    T_cand = _kabsch(p0[idx], p1[idx], torch.ones(idx.shape, dtype=F32, device=p0.device),
                     seq_sum)
    inl = (residual_norms(T_cand, p0, p1) < thr) & valid[None, :]
    n_inl = inl.to(torch.int32).sum(1)
    gate = torch.clamp(torch.round(frac * n_valid.to(F32)).to(torch.int32), min=3)
    passed = n_inl > gate
    c = idx.shape[0]
    T_refit = _kabsch(p0.expand(c, -1, -1), p1.expand(c, -1, -1), inl.to(F32), block_sum)
    dist2 = residual_norms(T_refit, p0, p1)
    mean_err = block_sum(torch.where(inl, dist2, torch.zeros_like(dist2))) / torch.clamp(
        n_inl.to(F32), min=1.0)
    score = torch.where(passed, mean_err, torch.full_like(mean_err, float("inf")))
    best = torch.argmin(score)  # first index on ties
    ok = passed.any()
    T_fb = kabsch_fit(p0, p1, valid)
    res = RansacResult(
        transform=torch.where(ok, T_refit[best], T_fb),
        error=torch.where(ok, score[best], torch.full_like(score[best], float("inf"))),
        inliers=inl[best] & ok,
        num_inliers=torch.where(ok, n_inl[best], torch.zeros_like(n_inl[best])),
        ok=ok,
    )
    return (res, idx) if want_idx else res


def _row(p: torch.Tensor, b: int) -> torch.Tensor:
    """Fit b's points of shared [N, 3] or per-fit [B, N, 3] points."""
    return p if p.dim() == 2 else p[b]


def ransac_fit_batch_plain(u, p0, p1, valid, cfg: RansacConfig, want_idx: bool = False):
    """``ransac_fit_plain`` on each row of the batch, stacked."""
    rows = [ransac_fit_plain(u[b], _row(p0, b), _row(p1, b), valid[b], cfg, want_idx=True)
            for b in range(u.shape[0])]
    res = RansacResult(*(torch.stack(f) for f in zip(*(r for r, _ in rows))))
    return (res, torch.stack([i for _, i in rows])) if want_idx else res


def _strides(p: torch.Tensor, b: int, n: int, name: str):
    """(batch stride, point stride) of shared [N, 3] or per-fit [B, N, 3]
    points, in floats (batch stride 0 for shared points)."""
    K.check(p, F32, name, contiguous=False)
    if tuple(p.shape) == (n, 3):
        bs, ps = 0, p.stride(0)
    elif tuple(p.shape) == (b, n, 3):
        bs, ps = p.stride(0), p.stride(1)
    else:
        raise ValueError(f"{name} must be [N, 3] or [B, N, 3], got {tuple(p.shape)}")
    if p.stride(-1) != 1 or min(bs, ps) < 0 or (b - 1) * bs + (n - 1) * ps + 2 >= 2**31:
        raise ValueError(f"{name} needs unit stride along xyz and 32-bit offsets")
    return bs, ps


def ransac_fit_batch_cuda(u, p0, p1, valid, cfg: RansacConfig, want_idx: bool = False):
    K.check(u, F32, "u")
    K.check(valid, torch.bool, "valid")
    b, c = u.shape[0], u.shape[1]
    n = valid.shape[-1]
    if u.dim() != 3 or u.shape[2] != 3 or tuple(valid.shape) != (b, n):
        raise ValueError("u must be [B, C, 3] and valid [B, N]")
    bs0, ps0 = _strides(p0, b, n, "p0")
    bs1, ps1 = _strides(p1, b, n, "p1")
    dev = valid.device
    thr, frac = _thresholds(cfg)
    i32 = dict(dtype=torch.int32, device=dev)
    pos = torch.empty((b, n + 1), **i32)  # valid positions, then n_valid
    idx = torch.empty((b, c, 3), **i32)
    cand = torch.empty((b, c, 32), dtype=F32, device=dev)  # minimal fit, refit
    score = torch.empty((b, c), dtype=F32, device=dev)
    n_inl = torch.empty((b, c), **i32)
    passed = torch.empty((b, c), dtype=torch.bool, device=dev)
    T = torch.empty((b, 4, 4), dtype=F32, device=dev)
    error = torch.empty((b,), dtype=F32, device=dev)
    inliers = torch.empty((b, n), dtype=torch.bool, device=dev)
    num = torch.empty((b,), **i32)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    f = K.fn("ransac", "mmf_ransac_fit_batch",
             [K.P] * 4 + [K.I] * 7 + [K.F, K.F] + [K.P] * 11)
    K.call("ransac_fit", f, K.ptr(u), K.ptr(p0), K.ptr(p1), K.ptr(valid), bs0, ps0, bs1, ps1,
           b, n, c, thr, frac, K.ptr(pos), K.ptr(idx), K.ptr(cand), K.ptr(score),
           K.ptr(n_inl), K.ptr(passed), K.ptr(T), K.ptr(error), K.ptr(inliers), K.ptr(num),
           K.ptr(ok))
    res = RansacResult(T, error, inliers, num, ok)
    return (res, idx.to(torch.int64)) if want_idx else res


def ransac_fit_cuda(u, p0, p1, valid, cfg: RansacConfig, want_idx: bool = False):
    """One fit on the card: the batch of one."""
    if tuple(p0.shape) != tuple(p1.shape) or p0.dim() != 2 or u.dim() != 2:
        raise ValueError("p0, p1 must be [N, 3] and u [C, 3]")
    out = ransac_fit_batch_cuda(u[None], p0, p1, valid[None], cfg, want_idx)
    res, idx = out if want_idx else (out, None)
    res = RansacResult(*(x[0] for x in res))
    return (res, idx[0]) if want_idx else res


def ransac_fit(u, p0, p1, valid, cfg: RansacConfig) -> RansacResult:
    """Batched RANSAC over fixed-capacity correspondences p0, p1 [N, 3] with
    validity [N]; ``u`` [C, 3] uniforms pick the C = ``cfg.iterations``
    minimal sets."""
    K.record("ransac_fit", u=u, p0=p0, p1=p1, valid=valid, cfg=cfg)
    impl = ransac_fit_cuda if p0.is_cuda else ransac_fit_plain
    return impl(u, p0, p1, valid, cfg)


def ransac_fit_batch(u, p0, p1, valid, cfg: RansacConfig) -> RansacResult:
    """B independent fits in one launch set: ``u`` [B, C, 3], ``valid``
    [B, N], points shared ([N, 3]) or per fit ([B, N, 3], any strides with
    xyz contiguous); every field of the result has a leading B. Row b is
    ``ransac_fit(u[b], p0[b], p1[b], valid[b], cfg)``, bit for bit."""
    K.record("ransac_fit.shared" if p0.dim() == 2 else "ransac_fit.per_fit", u=u, p0=p0, p1=p1,
             valid=valid, cfg=cfg)
    impl = ransac_fit_batch_cuda if valid.is_cuda else ransac_fit_batch_plain
    return impl(u, p0, p1, valid, cfg)


def draw_uniforms(gen: torch.Generator, b: int, c: int, device) -> torch.Tensor:
    """[B, C, 3] uniforms for B fits: B draws of ``torch.rand((C, 3))`` from
    ``gen`` in turn, each written into its row, so every fit keeps the
    numbers it would draw alone."""
    u = torch.empty((b, c, 3), dtype=F32, device=device)
    for row in u:
        torch.rand((c, 3), generator=gen, out=row)
    return u
