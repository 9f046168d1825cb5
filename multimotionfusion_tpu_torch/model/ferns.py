"""Fern keyframe database for relocalisation and loop closure (kernel K22,
``csrc/ferns.cu``).

Port of the reference package's ``model/ferns.py`` (Ferns.{h,cpp}): random
ferns encode a ÷factor RGB-D frame; a keyframe is inserted when its
dissimilarity to the closest stored one exceeds a threshold; retrieval takes
the most similar keyframe, aligns the live frame against it with the dense
odometry (K2-K5 at the fern scale) and verifies the result photometrically.

Each fern is a pixel and four thresholds; its 4-bit code is
(r>tr)<<3 | (g>tg)<<2 | (b>tb)<<1 | (depth_mm>td), 255 where the vertex is
invalid. The store is a fixed-capacity set of tensors on the device updated
in place: ``add_frame`` writes slot ``count`` and bumps ``count`` on the card,
so neither insertion nor retrieval reads anything back.

``create`` draws the conservatory from a ``torch.Generator`` seeded with the
given seed: other numbers than the reference's PRNG gives, so the tests carry
the reference's ``fern_pos`` and ``fern_thresh`` across (``interop``).

The kernel entry points (launch keys): ``ferns.frame`` (the ÷factor frame),
``ferns.encode_hd`` (codes, similarities, first argmax, keyframe fetch),
``ferns.insert`` and ``ferns.photo``. Each takes its plain PyTorch version
(``*_plain``) only for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel, FernConfig, OdometryConfig
from multimotionfusion_tpu_torch.odometry import levels as lv
from multimotionfusion_tpu_torch.odometry import rgbd
from multimotionfusion_tpu_torch.ops.image import bilinear_sample, rgb_to_intensity
from multimotionfusion_tpu_torch.ops.ransac import block_sum
from multimotionfusion_tpu_torch.utils import se3

F32 = torch.float32
U8 = torch.uint8
BAD_CODE = 255


class FernDB(NamedTuple):
    fern_pos: torch.Tensor  # [F, 2] int32 (x, y) at the ÷factor resolution
    fern_thresh: torch.Tensor  # [F, 4] float32 (r, g, b, depth_mm)
    codes: torch.Tensor  # [K, F] uint8
    poses: torch.Tensor  # [K, 4, 4]
    src_time: torch.Tensor  # [K] int32
    rgb: torch.Tensor  # [K, h, w, 3] float32 0..255
    vmap: torch.Tensor  # [K, h, w, 3] camera-frame vertices
    nmap: torch.Tensor  # [K, h, w, 3]
    count: torch.Tensor  # [] int32

    @property
    def capacity(self) -> int:
        return self.codes.shape[0]


FIELDS = FernDB._fields
DTYPES = {"fern_pos": torch.int32, "codes": U8, "src_time": torch.int32, "count": torch.int32}


class FernFrame(NamedTuple):
    """The ÷factor frame (reference ``downsample_frame``, its colour as u8)."""

    rgb: torch.Tensor  # [h, w, 3] uint8
    vmap: torch.Tensor  # [h, w, 3] filtered vertices (depth cutoff applied)
    nmap: torch.Tensor  # [h, w, 3]
    depth: torch.Tensor  # [h, w] = vmap[..., 2]


class Retrieval(NamedTuple):
    """``encode_hd``'s outputs: the query codes, each keyframe's similarity,
    the first argmax and, when fetched, that keyframe as a prediction."""

    codes: torch.Tensor  # [F] uint8
    sim: torch.Tensor  # [K] float32 (-1 at and after count)
    best: torch.Tensor  # [] int32
    best_sim: torch.Tensor  # []
    kf_color: Optional[torch.Tensor] = None  # [h, w, 3]
    kf_vertex: Optional[torch.Tensor] = None  # [h, w, 4] (vertex, 0)
    kf_normal: Optional[torch.Tensor] = None  # [h, w, 4] (normal, 0)
    kf_pose: Optional[torch.Tensor] = None  # [4, 4]


class RelocResult(NamedTuple):
    pose: torch.Tensor  # [4,4] relocalised camera pose
    ok: torch.Tensor  # [] bool: all gates passed
    best: torch.Tensor  # [] int32 keyframe index
    similarity: torch.Tensor
    icp_error: torch.Tensor
    photo_error: torch.Tensor


def fern_camera(cam: CameraModel, factor: int) -> CameraModel:
    """The camera of the ÷factor frame (reference engine ``_fern_cam``)."""
    return CameraModel(width=cam.width // factor, height=cam.height // factor,
                       fx=cam.fx / factor, fy=cam.fy / factor,
                       cx=cam.cx / factor, cy=cam.cy / factor)


def create(cfg: FernConfig, cam: CameraModel, capacity: Optional[int] = None, seed: int = 0,
           device="cpu") -> FernDB:
    """The fern conservatory (Ferns::generateFerns) and an empty keyframe
    store of ``capacity`` slots (default ``cfg.num_ferns``; 0 gives the
    zero-capacity store of a configuration without reloc or loop closure)."""
    capacity = cfg.num_ferns if capacity is None else capacity
    h, w = cam.height // cfg.factor, cam.width // cfg.factor
    gen = torch.Generator().manual_seed(seed)
    n = cfg.num_ferns
    pos = torch.stack([torch.randint(0, w, (n,), generator=gen),
                       torch.randint(0, h, (n,), generator=gen)], dim=-1).to(torch.int32)
    rgb_t = torch.rand((n, 3), generator=gen) * 255.0
    d_t = 400.0 + torch.rand((n, 1), generator=gen) * (cfg.max_depth * 1000.0 - 400.0)
    z = dict(device=device)
    return FernDB(
        fern_pos=pos.to(device),
        fern_thresh=torch.cat([rgb_t, d_t], dim=-1).to(F32).to(device),
        codes=torch.full((capacity, n), BAD_CODE, dtype=U8, **z),
        poses=torch.zeros((capacity, 4, 4), dtype=F32, **z),
        src_time=torch.zeros((capacity,), dtype=torch.int32, **z),
        rgb=torch.zeros((capacity, h, w, 3), dtype=F32, **z),
        vmap=torch.zeros((capacity, h, w, 3), dtype=F32, **z),
        nmap=torch.zeros((capacity, h, w, 3), dtype=F32, **z),
        count=torch.zeros((), dtype=torch.int32, **z),
    )


# ---------------------------------------------------------------- the ÷f frame

def _vertex(depth, X, Y, cam: CameraModel, cutoff: float):
    """``create_vmap`` at pixels (X, Y) ([h, w] int grids; zero outside the image)."""
    H, W = depth.shape
    inside = (X < W) & (Y < H)
    d = depth[Y.clamp(max=H - 1), X.clamp(max=W - 1)]
    ok = inside & (d > 0) & (d < cutoff)
    z = torch.where(ok, d, torch.zeros_like(d))
    zero = torch.zeros_like(z)
    return (torch.where(ok, z * (X.to(F32) - cam.cx) * (1.0 / cam.fx), zero),
            torch.where(ok, z * (Y.to(F32) - cam.cy) * (1.0 / cam.fy), zero), z)


def fern_frame_plain(rgb_u8, depth_filt, cam: CameraModel, cutoff: float, factor: int) -> FernFrame:
    h, w = cam.height // factor, cam.width // factor
    dev = depth_filt.device
    Y = (factor // 2 + factor * torch.arange(h, device=dev))[:, None].expand(h, w)
    X = (factor // 2 + factor * torch.arange(w, device=dev))[None, :].expand(h, w)
    v00 = _vertex(depth_filt, X, Y, cam, cutoff)
    v01 = _vertex(depth_filt, X + 1, Y, cam, cutoff)
    v10 = _vertex(depth_filt, X, Y + 1, cam, cutoff)
    # create_nmap at the sampled pixels, in the kernel's order
    a = [p - q for p, q in zip(v01, v00)]
    b = [p - q for p, q in zip(v10, v00)]
    c = [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]
    nn = torch.sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])
    ok = (v00[2] > 0) & (v01[2] > 0) & (v10[2] > 0) & (nn > 1e-12)
    dn = torch.clamp(nn, min=1e-12)
    n = [torch.where(ok, ci / dn, torch.zeros_like(ci)) for ci in c]
    return FernFrame(rgb_u8[Y, X].contiguous(), torch.stack(v00, -1), torch.stack(n, -1),
                     v00[2].contiguous())


def fern_frame_cuda(rgb_u8, depth_filt, cam: CameraModel, cutoff: float, factor: int) -> FernFrame:
    K.check(rgb_u8, U8, "rgb")
    K.check(depth_filt, F32, "depth_filt")
    H, W = depth_filt.shape
    if tuple(rgb_u8.shape) != (H, W, 3) or (H, W) != (cam.height, cam.width):
        raise ValueError("rgb must be [H, W, 3] and the depth [H, W] of the camera")
    h, w = H // factor, W // factor
    dev = depth_filt.device
    out = FernFrame(torch.empty((h, w, 3), dtype=U8, device=dev),
                    torch.empty((h, w, 3), dtype=F32, device=dev),
                    torch.empty((h, w, 3), dtype=F32, device=dev),
                    torch.empty((h, w), dtype=F32, device=dev))
    f = K.fn("ferns", "mmf_fern_frame", [K.P, K.P] + [K.I] * 5 + [K.F] * 7 + [K.P] * 4)
    K.call("ferns.frame", f, K.ptr(depth_filt), K.ptr(rgb_u8), H, W, factor, h, w, cam.fx,
           cam.fy, cam.cx, cam.cy, 1.0 / cam.fx, 1.0 / cam.fy, float(cutoff),
           *(K.ptr(t) for t in out))
    return out


def fern_frame(rgb_u8, depth_filt, cam: CameraModel, cutoff: float, factor: int) -> FernFrame:
    """The ÷factor frame at pixels (f/2 + f y, f/2 + f x) of the full one:
    colour, filtered vertices (``create_vmap`` with the depth cutoff) and
    normals (``create_nmap`` at full resolution), and depth."""
    K.record("ferns.frame", rgb_u8=rgb_u8, depth_filt=depth_filt, cam=cam, cutoff=cutoff,
             factor=factor)
    impl = fern_frame_cuda if depth_filt.is_cuda else fern_frame_plain
    return impl(rgb_u8, depth_filt, cam, cutoff, factor)


# ---------------------------------------------------------------- encode + similarity

def encode(db: FernDB, rgb_s: torch.Tensor, vmap_s: torch.Tensor) -> torch.Tensor:
    """[F] uint8 fern codes of a ÷factor frame (Ferns.cpp:95-105); ``rgb_s``
    float or uint8 (0..255)."""
    x = db.fern_pos[:, 0].long()
    y = db.fern_pos[:, 1].long()
    pix = rgb_s[y, x].to(F32)
    z = vmap_s[y, x, 2]
    th = db.fern_thresh
    zmm = (z * 1000.0).to(torch.int32)  # truncation toward zero, as astype(int32)
    code = ((pix[:, 0] > th[:, 0]).to(U8) << 3) | ((pix[:, 1] > th[:, 1]).to(U8) << 2) \
        | ((pix[:, 2] > th[:, 2]).to(U8) << 1) | (zmm > th[:, 3].to(torch.int32)).to(U8)
    return torch.where(z > 0, code, torch.full_like(code, BAD_CODE))


def block_hd(db: FernDB, codes: torch.Tensor) -> torch.Tensor:
    """[K] similarity: the share of matching valid codes per keyframe, -1 for
    the slots at and after ``count``."""
    valid_q = codes != BAD_CODE
    eq = (db.codes == codes[None]) & valid_q[None] & (db.codes != BAD_CODE)
    good = torch.clamp(valid_q.to(torch.int32).sum().to(F32), min=1.0)
    sim = eq.to(torch.int32).sum(dim=1).to(F32) / good
    in_db = torch.arange(db.capacity, device=codes.device) < db.count
    return torch.where(in_db, sim, torch.full_like(sim, -1.0))


def _fetch(db: FernDB, best: torch.Tensor):
    b = best.reshape(1).long()
    pad = lambda m: torch.cat([m, torch.zeros_like(m[..., :1])], dim=-1).contiguous()  # noqa: E731
    return (db.rgb.index_select(0, b)[0].contiguous(), pad(db.vmap.index_select(0, b)[0]),
            pad(db.nmap.index_select(0, b)[0]), db.poses.index_select(0, b)[0].contiguous())


def encode_hd_plain(db: FernDB, frame: FernFrame, fetch: bool = False) -> Retrieval:
    codes = encode(db, frame.rgb, frame.vmap)
    sim = block_hd(db, codes)
    best = torch.argmax(sim).to(torch.int32)  # the first index among equal maxima
    out = Retrieval(codes, sim, best, sim[best.long()])
    return out._replace(**dict(zip(("kf_color", "kf_vertex", "kf_normal", "kf_pose"),
                                   _fetch(db, best)))) if fetch else out


def encode_hd_cuda(db: FernDB, frame: FernFrame, fetch: bool = False) -> Retrieval:
    for t, dt, name in ((db.fern_pos, torch.int32, "fern_pos"), (db.fern_thresh, F32, "fern_thresh"),
                        (db.codes, U8, "codes"), (db.count, torch.int32, "count"),
                        (frame.rgb, U8, "rgb_s"), (frame.vmap, F32, "vmap_s")):
        K.check(t, dt, name)
    Kc, F = db.codes.shape
    if Kc < 1:
        raise ValueError("the fern store has no capacity")
    h, w = frame.depth.shape
    dev = frame.depth.device
    codes = torch.empty((F,), dtype=U8, device=dev)
    sim = torch.empty((Kc,), dtype=F32, device=dev)
    best = torch.empty((), dtype=torch.int32, device=dev)
    best_sim = torch.empty((), dtype=F32, device=dev)
    kf = (None,) * 4
    if fetch:
        kf = (torch.empty((h, w, 3), dtype=F32, device=dev),
              torch.empty((h, w, 4), dtype=F32, device=dev),
              torch.empty((h, w, 4), dtype=F32, device=dev),
              torch.empty((4, 4), dtype=F32, device=dev))
    f = K.fn("ferns", "mmf_fern_encode_hd",
             [K.P, K.P, K.I, K.P, K.P, K.I, K.P, K.P, K.I] + [K.P] * 8 + [K.I] + [K.P] * 4)
    K.call("ferns.encode_hd", f, K.ptr(db.fern_pos), K.ptr(db.fern_thresh), F, K.ptr(frame.rgb),
           K.ptr(frame.vmap), w, K.ptr(db.codes), K.ptr(db.count), Kc, K.ptr(codes), K.ptr(sim),
           K.ptr(best), K.ptr(best_sim), K.ptr(db.rgb), K.ptr(db.vmap), K.ptr(db.nmap),
           K.ptr(db.poses), h * w, *(None if t is None else K.ptr(t) for t in kf))
    return Retrieval(codes, sim, best, best_sim, *kf)


def encode_hd(db: FernDB, frame: FernFrame, fetch: bool = False) -> Retrieval:
    """The frame's codes (``encode``), every keyframe's similarity
    (``block_hd``), the first argmax and its similarity, and with ``fetch``
    that keyframe's colour, vertices, normals (4-channel, as a prediction)
    and pose."""
    K.record("ferns.encode_hd", db=db, frame=frame, fetch=fetch)
    impl = encode_hd_cuda if frame.depth.is_cuda else encode_hd_plain
    return impl(db, frame, fetch)


# ---------------------------------------------------------------- insert

def insert_plain(db: FernDB, frame: FernFrame, hd: Retrieval, pose, time: int,
                 threshold: float, skip=None) -> torch.Tensor:
    count = int(db.count)
    dissim = 1.0 - torch.clamp(hd.best_sim, min=0.0)
    ins = bool(((count == 0) | (dissim > threshold)) & (count < db.capacity))
    ins = ins and not (skip is not None and bool(skip))
    if ins:
        db.codes[count] = hd.codes
        db.poses[count] = pose
        db.src_time[count] = int(time)
        db.rgb[count] = frame.rgb.to(F32)
        db.vmap[count] = frame.vmap
        db.nmap[count] = frame.nmap
        db.count.add_(1)
    return torch.tensor(ins, device=db.count.device)


def insert_cuda(db: FernDB, frame: FernFrame, hd: Retrieval, pose, time: int,
                threshold: float, skip=None) -> torch.Tensor:
    for t, dt, name in ((db.codes, U8, "codes"), (db.poses, F32, "poses"),
                        (db.src_time, torch.int32, "src_time"), (db.rgb, F32, "rgb"),
                        (db.vmap, F32, "vmap"), (db.nmap, F32, "nmap"),
                        (db.count, torch.int32, "count"), (hd.codes, U8, "query codes"),
                        (hd.best_sim, F32, "best_sim"), (pose, F32, "pose")):
        K.check(t, dt, name)
    if skip is not None:
        K.check(skip, torch.bool, "skip")
    h, w = frame.depth.shape
    inserted = torch.empty((), dtype=torch.bool, device=db.count.device)
    f = K.fn("ferns", "mmf_fern_insert",
             [K.P, K.P, K.P, K.I, K.F, K.P, K.I, K.P, K.I, K.P, K.P, K.P, K.I] + [K.P] * 7)
    K.call("ferns.insert", f, K.ptr(db.count), K.ptr(hd.best_sim),
           None if skip is None else K.ptr(skip), db.capacity, float(threshold), K.ptr(hd.codes),
           db.codes.shape[1], K.ptr(pose), int(time), K.ptr(frame.rgb), K.ptr(frame.vmap),
           K.ptr(frame.nmap), h * w, K.ptr(db.codes), K.ptr(db.poses), K.ptr(db.src_time),
           K.ptr(db.rgb), K.ptr(db.vmap), K.ptr(db.nmap), K.ptr(inserted))
    return inserted


def add_frame(db: FernDB, frame: FernFrame, hd: Retrieval, pose, time: int, threshold: float,
              skip=None) -> torch.Tensor:
    """Insert the frame at slot ``count`` iff its dissimilarity to the closest
    keyframe (``hd``, this frame's retrieval against ``db``) exceeds
    ``threshold`` or the store is empty, the store is not full and ``skip``
    (a 0-dim bool, e.g. ``lost``) is not set (Ferns::addFrame). Updates ``db``
    in place; returns the decision (0-dim bool on the device)."""
    K.record("ferns.insert", db=db, frame=frame, hd=hd, pose=pose, time=time,
             threshold=threshold, skip=skip)
    impl = insert_cuda if frame.depth.is_cuda else insert_plain
    return impl(db, frame, hd, pose, time, threshold, skip)


# ---------------------------------------------------------------- photometric check

class Gates(NamedTuple):
    min_similarity: float
    max_icp_error: float
    min_icp_count: float
    photo_thresh: float


def photo_plain(T_rel, kf_vertex, kf_color, live_rgb, cam_s: CameraModel, count, best_sim,
                icp_error, icp_count, gates: Gates):
    v = kf_vertex[..., :3].reshape(-1, 3)
    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    T = T_rel
    px = T[0, 0] * vx + T[0, 1] * vy + T[0, 2] * vz + T[0, 3]
    py = T[1, 0] * vx + T[1, 1] * vy + T[1, 2] * vz + T[1, 3]
    pz = T[2, 0] * vx + T[2, 1] * vy + T[2, 2] * vz + T[2, 3]
    z = torch.clamp(pz, min=1e-6)
    u = px * cam_s.fx / z + cam_s.cx
    vv = py * cam_s.fy / z + cam_s.cy
    samp = bilinear_sample(rgb_to_intensity(live_rgb.to(F32)), u, vv)
    kf_i = rgb_to_intensity(kf_color).reshape(-1)
    inb = (u >= 0) & (vv >= 0) & (u < cam_s.width - 1) & (vv < cam_s.height - 1) & (vz > 0)
    diff = torch.where(inb, torch.abs(samp - kf_i), torch.zeros_like(samp))
    n = inb.to(torch.int32).sum().to(F32)
    err = block_sum(diff) / torch.clamp(n, min=1.0)
    ok = ((count > 0) & (best_sim > gates.min_similarity) & (icp_error < gates.max_icp_error)
          & (icp_count > gates.min_icp_count) & (err < gates.photo_thresh))
    return err, ok


def photo_cuda(T_rel, kf_vertex, kf_color, live_rgb, cam_s: CameraModel, count, best_sim,
               icp_error, icp_count, gates: Gates):
    for t, dt, name in ((T_rel, F32, "T_rel"), (kf_vertex, F32, "kf_vertex"),
                        (kf_color, F32, "kf_color"), (live_rgb, U8, "live_rgb"),
                        (count, torch.int32, "count"), (best_sim, F32, "best_sim"),
                        (icp_error, F32, "icp_error"), (icp_count, F32, "icp_count")):
        K.check(t, dt, name)
    h, w = cam_s.height, cam_s.width
    if tuple(kf_vertex.shape) != (h, w, 4) or tuple(live_rgb.shape) != (h, w, 3):
        raise ValueError("kf_vertex must be [h, w, 4] and live_rgb [h, w, 3] of the fern camera")
    dev = T_rel.device
    err = torch.empty((), dtype=F32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    f = K.fn("ferns", "mmf_fern_photo",
             [K.P] * 4 + [K.I, K.I] + [K.F] * 4 + [K.P] * 4 + [K.F] * 4 + [K.P, K.P])
    K.call("ferns.photo", f, K.ptr(T_rel), K.ptr(kf_vertex), K.ptr(kf_color), K.ptr(live_rgb), h,
           w, cam_s.fx, cam_s.fy, cam_s.cx, cam_s.cy, K.ptr(count), K.ptr(best_sim),
           K.ptr(icp_error), K.ptr(icp_count), *map(float, gates), K.ptr(err), K.ptr(ok))
    return err, ok


def photo_check(T_rel, kf_vertex, kf_color, live_rgb, cam_s: CameraModel, count, best_sim,
                icp_error, icp_count, gates: Gates):
    """find_frame's photometric verification and gates: project the
    keyframe's vertices with ``T_rel`` (keyframe camera -> live camera),
    bilinear-sample the live intensity, mean |diff| over the in-bounds pixels
    with a valid vertex; ok = every gate passed. (0-dim error, 0-dim bool.)"""
    K.record("ferns.photo", T_rel=T_rel, kf_vertex=kf_vertex, kf_color=kf_color,
             live_rgb=live_rgb, cam_s=cam_s, count=count, best_sim=best_sim, icp_error=icp_error,
             icp_count=icp_count, gates=gates)
    impl = photo_cuda if T_rel.is_cuda else photo_plain
    return impl(T_rel, kf_vertex, kf_color, live_rgb, cam_s, count, best_sim, icp_error,
                icp_count, gates)


# ---------------------------------------------------------------- retrieval

# the fern-scale alignment's odometry (reference engine _FERN_ODOM and
# loop_closure._reloc_odom): 2 levels, iterations (10, 5), no SO(3)
# pre-align, no masks
FERN_ODOM = OdometryConfig(num_pyr=2, iterations=(10, 5), so3_prealign=False, mask_icp=False,
                           mask_rgb=False, min_grad_magnitudes=(5.0, 3.0))


def find_frame(db: FernDB, frame: FernFrame, hd: Retrieval, cam_s: CameraModel,
               odom_cfg: OdometryConfig = FERN_ODOM, min_similarity: float = 0.3,
               max_icp_error: float = 3e-4, min_icp_count_frac: float = 0.1,
               photo_thresh: float = 115.0) -> RelocResult:
    """Align the live frame against the retrieved keyframe (``hd``, fetched:
    the keyframe is the prediction, the frame the "next" image) with the
    dense odometry at the fern scale, then verify photometrically
    (Ferns::findFrame gates, Ferns.cpp:203-263 and photometricCheck :265-308).
    Everything stays on the device."""
    zeros = torch.zeros(frame.depth.shape, dtype=torch.int32, device=frame.depth.device)
    frame_lv = lv.frame_levels(frame.depth, frame.rgb, zeros, cam_s, odom_cfg)
    preds = lv.pred_levels(hd.kf_vertex, hd.kf_normal, hd.kf_color, cam_s, odom_cfg)
    res = rgbd.track(hd.kf_pose, lv.gn_levels(frame_lv, preds, cam_s, odom_cfg),
                     frame_lv[-1].img, odom_cfg, cam_s)
    T_rel = (se3.inverse_T(res.pose) @ hd.kf_pose).contiguous()
    n_pix = cam_s.width * cam_s.height
    gates = Gates(min_similarity, max_icp_error, float(np.float32(min_icp_count_frac * n_pix)),
                  photo_thresh)
    err, ok = photo_check(T_rel, hd.kf_vertex, hd.kf_color, frame.rgb, cam_s, db.count,
                          hd.best_sim, res.icp_error, res.icp_count, gates)
    return RelocResult(pose=res.pose, ok=ok, best=hd.best, similarity=hd.best_sim,
                       icp_error=res.icp_error, photo_error=err)
