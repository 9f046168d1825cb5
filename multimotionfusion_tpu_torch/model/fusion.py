"""Surfel fusion and map maintenance (port of the reference package's ``model/fusion.py``).

- ``fuse`` (kernel K8, ``csrc/fuse.cu``): per-pixel data association against
  the index map (data.vert 4x4 window search with the zdiff*lambda, ray
  distance and normal gates) on the time-parity checkerboard, a
  confidence-weighted merge into the winning surfel (update.vert) and an
  append of unmatched pixels after the high-water mark. Pixels that pick the
  same surfel are arbitrated deterministically: the lowest source id wins,
  where source ids run row-major over the [H/2, W/2] checkerboard subgrid,
  merges first, then appends; append slots are ``count`` + an exclusive prefix
  sum over the same order (``csrc/surfel.cuh`` ``append_scan``: a decoupled
  look-back scan inside the association kernel, shared with K14).
- ``clean`` (kernels K7 + K9, ``csrc/clean.cu``): redundancy / see-through /
  unstable-age culls and the periodic order-preserving compaction
  (copy_unstable.vert). A pixel pass stages each tile's window of index-map
  winners from data_local in shared memory (K7, no attribute image, K14's
  design) and scatter-mins its verdict per surfel into a persistent
  scratch; a surfel pass applies them (in place where the caller passes
  the map as its own output); every ``compact_every`` frames a one-launch
  compaction repacks the kept surfels with the count on the card.
- ``fuse_flat`` / ``clean_flat`` (kernel K14, ``csrc/fuse_flat.cu``): the
  same two passes for the multi-model step, ONCE over the flat store of all
  models (``FlatLayout``) with the composite index map: a pixel fuses into
  its mask owner's model, appends rank per model in source order, and the
  clean's window tests stay within one model with that model's gates. On
  the card the clean works in place: ``clean_flat_cuda`` consumes the store
  it is given (the engine's freshly fused one) and returns it cleaned.

The camera pose is a [4, 4] tensor on the map's device that the kernels read
by pointer.
"""

from __future__ import annotations

import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel, SurfelConfig
from multimotionfusion_tpu_torch.model import surfel_map as sm
from multimotionfusion_tpu_torch.ops.image import _shift2d
from multimotionfusion_tpu_torch.ops.rasterize import (
    INVALID,
    FlatLayout,
    IndexMap,
    _pixel_rays,
    check_stage_window,
    gather_attr_images,
    check_pose,
    scalar_arg,
    take_small,
    transform_per_model,
)


def _window_offsets(window: int):
    r = window // 2
    return [(dy, dx) for dy in range(-r, window - r) for dx in range(-r, window - r)]


def fuse_plain(data, count, frame_data, frame_valid, index, data_local, mask, mask_id,
               pose, cam: CameraModel, time, cfg: SurfelConfig):
    """Plain PyTorch K8. Returns (data [16, B] new array, count [] int32,
    assoc [H/2 * W/2] int32: per checkerboard pixel the merge target, -1 for a
    new surfel, -2 where the pixel does not participate)."""
    h, w = cam.height, cam.width
    dev = data.device
    lx, ly = _pixel_rays(cam, dev)
    xl, yl = lx, ly
    lam = torch.sqrt(xl * xl + yl * yl + 1.0)

    fz = frame_data[sm.PZ].reshape(h, w)
    fnx = frame_data[sm.NX].reshape(h, w)
    fny = frame_data[sm.NY].reshape(h, w)
    fnz = frame_data[sm.NZ].reshape(h, w)

    ti = int(time)
    par = ti % 2
    xi = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    yi = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    checker = ((xi % 2) == par) & ((yi % 2) == par)
    neigh_ok = (
        (_shift2d(fz, 0, -1, 0.0) > 0)
        & (_shift2d(fz, 0, 1, 0.0) > 0)
        & (_shift2d(fz, -1, 0, 0.0) > 0)
        & (_shift2d(fz, 1, 0, 0.0) > 0)
    )
    participate = (
        checker & (mask == mask_id) & neigh_ok & frame_valid.reshape(h, w)
        & (fz > 0) & (fz <= cfg.depth_cutoff)
    )

    attrs = gather_attr_images(data_local, index)
    best_dist = torch.full((h, w), 1000.0, dtype=torch.float32, device=dev)
    best_tgt = torch.full((h, w), INVALID, dtype=torch.int32, device=dev)
    for dy, dx in _window_offsets(cfg.assoc_window):
        cand = _shift2d(index, dy, dx, INVALID)
        cdat = _shift2d(attrs, dy, dx, 0.0)
        cpx, cpy, cpz = cdat[sm.PX], cdat[sm.PY], cdat[sm.PZ]
        z_ok = torch.abs((cpz - fz) * lam) < cfg.assoc_depth_gate
        rx = yl * cpz - cpy
        ry = cpx - xl * cpz
        rz = xl * cpy - yl * cpx
        dist = torch.sqrt(rx * rx + ry * ry + rz * rz)
        cnx, cny, cnz = cdat[sm.NX], cdat[sm.NY], cdat[sm.NZ]
        cosang = torch.clamp(cnx * fnx + cny * fny + cnz * fnz, -1.0, 1.0)
        n_ok = (torch.abs(cnz) < 0.75) | (torch.abs(torch.arccos(cosang)) < 0.5)
        better = (cand >= 0) & z_ok & n_ok & (dist < best_dist)
        best_dist = torch.where(better, dist, best_dist)
        best_tgt = torch.where(better, cand, best_tgt)

    # every participating pixel lies on the [par::2, par::2] subgrid
    n_cb = (h // 2) * (w // 2)
    merging = (participate & (best_tgt >= 0))[par::2, par::2].reshape(n_cb)
    target = best_tgt[par::2, par::2].reshape(n_cb)
    part = participate[par::2, par::2].reshape(n_cb)
    fdat = frame_data.reshape(sm.CHANNELS, h, w)[:, par::2, par::2].reshape(sm.CHANNELS, n_cb)

    pose = pose.to(dev)
    new_global = sm.transform_surfels(fdat, pose)
    old = sm.transform_surfels(gather_attr_images(data_local, target), pose)
    c_k = old[sm.CONF]
    a = new_global[sm.CONF]
    csum = torch.clamp(c_k + a, min=1e-12)
    rad_ok = new_global[sm.RADIUS] < 1.5 * old[sm.RADIUS]

    def wavg(ch):
        return (c_k * old[ch] + a * new_global[ch]) / csum

    merged = old.clone()
    for ch in (sm.PX, sm.PY, sm.PZ, sm.CR, sm.CG, sm.CB):
        merged[ch] = torch.where(rad_ok, wavg(ch), old[ch])
    nmx, nmy, nmz = wavg(sm.NX), wavg(sm.NY), wavg(sm.NZ)
    nn = torch.sqrt(torch.clamp(nmx * nmx + nmy * nmy + nmz * nmz, min=1e-12))
    merged[sm.NX] = torch.where(rad_ok, nmx / nn, old[sm.NX])
    merged[sm.NY] = torch.where(rad_ok, nmy / nn, old[sm.NY])
    merged[sm.NZ] = torch.where(rad_ok, nmz / nn, old[sm.NZ])
    merged[sm.RADIUS] = torch.where(rad_ok, wavg(sm.RADIUS), old[sm.RADIUS])
    merged[sm.CONF] = c_k + a
    merged[sm.LAST_T] = float(time)

    cap = data.shape[1]
    merge_dst = torch.where(merging, target, torch.full_like(target, cap))
    new_mask = part & ~merging
    new_i = new_mask.to(torch.int32)
    append_dst = count + torch.cumsum(new_i, 0, dtype=torch.int32) - 1
    append_dst = torch.where(new_mask & (append_dst < cap), append_dst, torch.full_like(append_dst, cap))
    dst = torch.cat([merge_dst, append_dst]).long()
    vals = torch.cat([merged, new_global], dim=1)
    n_src = 2 * n_cb
    src_ids = torch.arange(n_src, dtype=torch.int32, device=dev)
    inv = torch.full((cap + 1,), n_src, dtype=torch.int32, device=dev)
    inv.scatter_reduce_(0, dst, src_ids, reduce="amin", include_self=True)
    inv = inv[:cap]
    updated = inv < n_src
    upd = vals[:, torch.clamp(inv, max=n_src - 1).long()]
    out = torch.where(updated[None], upd, data)
    n_new = torch.minimum(torch.sum(new_i).to(torch.int32), cap - count)
    assoc = torch.where(merging, target, torch.where(part, -1, -2).to(torch.int32))
    return out, (count + n_new).to(torch.int32), assoc


SCAN_TILE = 256  # pixels a tile of the append scan (csrc/surfel.cuh)


def scan_scratch(n: int, models: int) -> int:
    """Ints of the append scan's scratch for ``n`` pixels and ``models``
    models: a status word per tile and model, then the ticket."""
    return (n + SCAN_TILE - 1) // SCAN_TILE * models + 1


_FUSE_ARGS = (
    [K.P, K.I, K.I, K.P]  # data, row stride, capacity, count
    + [K.P, K.P, K.P, K.I]  # frame data, frame valid, mask, mask id
    + [K.P, K.P]  # index, data_local
    + [K.P] + [K.F] * 4 + [K.I, K.I]  # pose, intrinsics, W, H
    + [K.F, K.I, K.F, K.F, K.I]  # time, parity, depth cutoff, depth gate, window
    + [K.P] * 6  # target, flags, prefix, inv, count out, data out
)


def fuse_cuda(data, count, frame_data, frame_valid, index, data_local, mask, mask_id,
              pose, cam: CameraModel, time, cfg: SurfelConfig, want_assoc: bool = True):
    """K8 on the card: ``csrc/fuse.cu`` (same contract as ``fuse_plain``; the
    association is assembled only when ``want_assoc``, else None)."""
    check_pose(pose)
    K.check(data, torch.float32, "data", contiguous=False)
    K.check(count, torch.int32, "count")
    K.check(frame_data, torch.float32, "frame_data")
    K.check(frame_valid, torch.bool, "frame_valid")
    K.check(mask, torch.int32, "mask")
    K.check(index, torch.int32, "index")
    K.check(data_local, torch.float32, "data_local")
    h, w = cam.height, cam.width
    cap = data.shape[1]
    if data.stride(1) != 1 or tuple(data_local.shape) != (sm.CHANNELS, cap):
        raise ValueError("data must be [16, B] (unit column stride) and data_local [16, B]")
    if h % 2 or w % 2:
        raise ValueError("fuse needs an even image size (checkerboard subgrid)")
    n_cb = (h // 2) * (w // 2)
    dev = data.device
    target = torch.empty((n_cb,), dtype=torch.int32, device=dev)
    flags = torch.empty((n_cb,), dtype=torch.int32, device=dev)
    prefix = torch.empty((n_cb,), dtype=torch.int32, device=dev)
    inv = torch.empty((cap + scan_scratch(n_cb, 1),), dtype=torch.int32, device=dev)
    count_out = torch.empty((), dtype=torch.int32, device=dev)
    out = torch.empty((sm.CHANNELS, cap), dtype=torch.float32, device=dev)
    f = K.fn("fuse", "mmf_fuse", _FUSE_ARGS)
    K.call(
        "fuse", f, K.ptr(data), data.stride(0), cap, K.ptr(count),
        K.ptr(frame_data), K.ptr(frame_valid), K.ptr(mask), int(mask_id),
        K.ptr(index), K.ptr(data_local),
        K.ptr(pose), cam.fx, cam.fy, cam.cx, cam.cy, w, h,
        float(time), int(time) % 2, float(cfg.depth_cutoff), float(cfg.assoc_depth_gate),
        int(cfg.assoc_window),
        K.ptr(target), K.ptr(flags), K.ptr(prefix), K.ptr(inv), K.ptr(count_out), K.ptr(out),
    )
    if not want_assoc:
        return out, count_out, None
    merging = (flags & 1) > 0
    assoc = torch.where(merging, target, torch.where(flags > 0, -1, -2).to(torch.int32))
    return out, count_out, assoc


def fuse(
    smap: sm.SurfelMap,
    frame: sm.FrameSurfels,
    index_map: IndexMap,
    mask: torch.Tensor,  # [H, W] int32 model-id mask
    mask_id,
    pose: torch.Tensor,  # [4,4] camera -> global (on the map's device)
    cam: CameraModel,
    time,
    cfg: SurfelConfig,
) -> sm.SurfelMap:
    """One fusion step: associate -> merge -> append new unstable surfels."""
    args = (smap.data, smap.count, frame.data, frame.valid, index_map.index,
            index_map.data_local, mask, mask_id, pose, cam, time, cfg)
    K.record("fuse", data=smap.data, count=smap.count, frame_data=frame.data,
             frame_valid=frame.valid, index=index_map.index,
             data_local=index_map.data_local, mask=mask, mask_id=mask_id, pose=pose,
             cam=cam, time=time, cfg=cfg)
    if smap.data.is_cuda:
        data, count, _ = fuse_cuda(*args, want_assoc=False)
    else:
        data, count, _ = fuse_plain(*args)
    return sm.SurfelMap(data=data, count=count)


def clean_plain(smap: sm.SurfelMap, index_map: IndexMap, depth_input, mask, mask_id,
                cam: CameraModel, time, time_delta, conf_threshold, cfg: SurfelConfig,
                compact: bool = False, out=None, skip=None) -> sm.SurfelMap:
    """Plain PyTorch K7 + K9 (same contract as ``clean``)."""
    keep, pen_per_surfel = clean_verdicts(smap, index_map, depth_input, mask, mask_id, cam, time,
                                          time_delta, conf_threshold, cfg)
    cap = smap.capacity
    write = skip is None or not bool(skip)
    data = smap.data.clone()
    data[sm.CONF] = data[sm.CONF] * pen_per_surfel
    if compact:
        packed, new_count = sm.compact_plain(data, keep, cap, out if write else None)
        return sm.SurfelMap(data=packed if write else out, count=new_count)
    data[sm.ALIVE] = torch.where(keep, data[sm.ALIVE], torch.zeros_like(data[sm.ALIVE]))
    if out is not None:
        if write:
            out.copy_(data)
        data = out
    return sm.SurfelMap(data=data, count=smap.count)


def clean_verdicts(smap: sm.SurfelMap, index_map: IndexMap, depth_input, mask, mask_id,
                   cam: CameraModel, time, time_delta, conf_threshold, cfg: SurfelConfig):
    """(keep [B] bool, confidence penalty [B]) of ``clean``."""
    h, w = cam.height, cam.width
    cap = smap.capacity
    dev = smap.data.device
    last_t = smap.data[sm.LAST_T]
    idx_img = index_map.index
    attrs = gather_attr_images(index_map.data_local, idx_img)
    qx, qy, qz = attrs[sm.PX], attrs[sm.PY], attrs[sm.PZ]
    q_init = attrs[sm.INIT_T]
    q_rad = attrs[sm.RADIUS]
    q_nz = torch.abs(attrs[sm.NZ])
    has_winner = idx_img >= 0
    tf = float(time)

    count = torch.zeros((h, w), dtype=torch.int32, device=dev)
    z_count = torch.zeros((h, w), dtype=torch.int32, device=dev)
    for dy, dx in _window_offsets(cfg.assoc_window):
        cand = _shift2d(idx_img, dy, dx, INVALID)
        cdat = _shift2d(attrs, dy, dx, 0.0)
        cvalid = (cand >= 0) & (cand != idx_img) & has_winner
        czp, cconf = cdat[sm.PZ], cdat[sm.CONF]
        cinit, clast = cdat[sm.INIT_T], cdat[sm.LAST_T]
        xy_dist = torch.sqrt((cdat[sm.PX] - qx) ** 2 + (cdat[sm.PY] - qy) ** 2)
        red = (
            cvalid & (cinit < q_init) & (cconf > conf_threshold) & (czp > qz)
            & (czp - qz < 0.01) & (xy_dist < q_rad * 1.4)
        )
        count = count + red.to(torch.int32)
        zc = (
            cvalid & (clast == tf) & (cconf > conf_threshold) & (czp > qz)
            & (czp - qz > 0.01) & (q_nz > 0.85)
        )
        z_count = z_count + zc.to(torch.int32)

    violations = torch.zeros((h, w), dtype=torch.int32, device=dev)
    viol_sum = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            d = _shift2d(depth_input, dy, dx, 0.0)
            delta = d - qz
            hit = has_winner & (d > 0) & (delta > cfg.clean_see_through_gate)
            violations = violations + hit.to(torch.int32)
            viol_sum = viol_sum + torch.where(hit, delta, torch.zeros_like(delta))

    viol = violations > 0
    avg_v = viol_sum / torch.clamp(violations.to(torch.float32), min=1.0)
    one = torch.ones_like(avg_v)
    pen = torch.where(viol, 1.0 / (1.0 + cfg.outlier_coeff * avg_v), one)
    mask_pen = (
        viol & (mask != mask_id) & (depth_input > qz - 0.05) & (depth_input < qz + 0.05)
    )
    pen = torch.where(mask_pen, pen * (0.5 + 0.5 * (1.0 - cfg.outlier_coeff / 10.0)), pen)
    cull_vis = has_winner & ((count > 8) | (z_count > 4))

    # one scatter-min carries both verdicts: a cull vote is -1, else the penalty
    ids = torch.where(has_winner, idx_img, torch.full_like(idx_img, cap)).reshape(-1).long()
    verdict = torch.where(cull_vis, -one, pen).reshape(-1)
    per_surfel = torch.ones((cap + 1,), dtype=torch.float32, device=dev)
    per_surfel.scatter_reduce_(0, ids, verdict, reduce="amin", include_self=True)
    per_surfel = per_surfel[:cap]
    culled = per_surfel < 0.0
    pen_per_surfel = torch.where(culled, torch.ones_like(per_surfel), per_surfel)

    alive = smap.alive_mask()
    keep = alive & ~culled
    unstable_dead = ((tf - last_t) > cfg.unstable_grace) & (smap.data[sm.CONF] < conf_threshold)
    keep = keep & ~unstable_dead
    keep = keep | (alive & (last_t > 0) & (tf - last_t > time_delta))
    return keep, pen_per_surfel


_CLEAN_ARGS = (
    [K.P, K.L, K.I, K.P, K.P, K.P, K.P, K.P, K.I, K.I, K.I, K.I]  # map, index, depth, mask
    + [K.F] * 7 + [K.I]  # time .. mask factor, compact
    + [K.P, K.P, K.I, K.P, K.L, K.P, K.P]  # verdicts, scan words, out, count out, skip
    + [K.P]  # the confidence gate by pointer (or null)
)
VERDICT_NONE = 0x3F800000  # a verdict word with no vote: csrc/surfel.cuh's ford(1.0f)


def verdict_scratch(device, n: int) -> torch.Tensor:
    """K9's verdicts on ``device``: [n] int32, ``VERDICT_NONE`` between calls
    (set once here; a launch sets back every word its pixel pass voted
    into), so no call fills them. One stream at a time, as the kernel's
    header says."""
    return K.scratch("clean.verdicts", n, torch.int32, device, VERDICT_NONE)


def clean_cuda(smap: sm.SurfelMap, index_map: IndexMap, depth_input, mask, mask_id,
               cam: CameraModel, time, time_delta, conf_threshold, cfg: SurfelConfig,
               compact: bool = False, out=None, skip=None) -> sm.SurfelMap:
    """K7 + K9 on the card: ``csrc/clean.cu`` (same contract as ``clean``):
    the pixel pass, then the surfel pass (a flag frame: into ``out``, in
    place where ``out`` is ``smap.data``) or the one-launch compaction."""
    data = smap.data
    K.check(data, torch.float32, "data", contiguous=False)
    K.check(smap.count, torch.int32, "count")
    K.check(index_map.index, torch.int32, "index")
    K.check(index_map.data_local, torch.float32, "data_local")
    K.check(depth_input, torch.float32, "depth")
    K.check(mask, torch.int32, "mask")
    if skip is not None:
        K.check(skip, torch.bool, "skip")
    window = check_stage_window(cfg.assoc_window)
    h, w = cam.height, cam.width
    cap = data.shape[1]
    if data.shape[0] != sm.CHANNELS or data.stride(1) != 1 or cap < 1:
        raise ValueError("data must be [16, B] with unit column stride")
    if index_map.data_local.shape != (sm.CHANNELS, cap) or index_map.index.shape != (h, w):
        raise ValueError("index must be [H, W] and data_local [16, B]")
    dev = data.device
    if out is None:
        out = torch.empty((sm.CHANNELS, cap), dtype=torch.float32, device=dev)
    elif tuple(out.shape) != (sm.CHANNELS, cap) or out.stride(1) != 1:
        raise ValueError("out must be [16, B] with unit column stride")
    elif out.data_ptr() == data.data_ptr() and (compact or out.stride(0) != data.stride(0)):
        raise ValueError("out may be the input only on a flag frame")
    if compact:
        sm.check_columns(cap, "data")
    words, parity = sm.compaction_words(dev, sm.scan_tiles(cap)) if compact else (None, 0)
    count_out = torch.empty((), dtype=torch.int32, device=dev) if compact else smap.count
    factor = 0.5 + 0.5 * (1.0 - cfg.outlier_coeff / 10.0)
    conf_threshold, conf_p = scalar_arg(conf_threshold, "conf_threshold")
    f = K.fn("clean", "mmf_clean", _CLEAN_ARGS)
    K.call(
        "clean.compact" if compact else "clean", f, K.ptr(data), data.stride(0), cap,
        K.ptr(smap.count), K.ptr(index_map.index),
        K.ptr(index_map.data_local), K.ptr(depth_input), K.ptr(mask), int(mask_id), h, w,
        window, float(time), float(time_delta), conf_threshold,
        float(cfg.unstable_grace), float(cfg.clean_see_through_gate), float(cfg.outlier_coeff),
        factor, int(compact), K.ptr(verdict_scratch(dev, cap)),
        None if words is None else K.ptr(words), parity, K.ptr(out), out.stride(0),
        K.ptr(count_out), None if skip is None else K.ptr(skip), conf_p,
    )
    if compact:
        sm.compaction_launched(dev, sm.scan_tiles(cap))
    return sm.SurfelMap(data=out, count=count_out)


def clean(
    smap: sm.SurfelMap,
    index_map: IndexMap,  # the frame's (pre-fusion) index map
    depth_input: torch.Tensor,  # [H, W] filtered frame depth (m)
    mask: torch.Tensor,
    mask_id,
    cam: CameraModel,
    time,
    time_delta,
    conf_threshold,
    cfg: SurfelConfig,
    compact: bool = False,
    out: torch.Tensor | None = None,
    skip: torch.Tensor | None = None,
) -> sm.SurfelMap:
    """Outlier / redundancy / unstable-age culls, then either a compaction
    (``compact``) or a flag clear of the culled slots (copy_unstable.vert).

    The visual tests run in image space for each pixel's index-map winner and
    scatter their verdicts back to the winning surfel ids. The cleaned
    [16, B] map is written into ``out`` when given, unless the 0-dim bool
    ``skip`` (read on the device) is set: then ``out`` keeps what it held
    (the returned count is the cleaned one all the same). On a flag frame
    ``out`` may be ``smap.data`` itself, which the clean then updates in
    place (on the card only the values that change are written); a
    compaction frame's ``out`` must not alias it."""
    K.record("clean.compact" if compact else "clean", data=smap.data, count=smap.count,
             index=index_map.index, data_local=index_map.data_local, depth=depth_input,
             mask=mask, mask_id=mask_id, cam=cam, time=time, time_delta=time_delta,
             conf_threshold=conf_threshold, cfg=cfg, compact=compact)
    if smap.data.is_cuda:
        return clean_cuda(smap, index_map, depth_input, mask, mask_id, cam, time, time_delta,
                          conf_threshold, cfg, compact, out, skip)
    return clean_plain(smap, index_map, depth_input, mask, mask_id, cam, time, time_delta,
                       conf_threshold, cfg, compact, out, skip)


# ---------------------------------------------------------------- K14

def fuse_flat_plain(data, counts, layout: FlatLayout, frame_data, frame_valid, index, data_local,
                    mask, win_model, poses, maxd, active, cam: CameraModel, time,
                    cfg: SurfelConfig):
    """Plain PyTorch K14 (fuse): composite fusion of one frame into the flat
    store of all models. Returns (data [16, N] new array, counts [M] int32)."""
    h, w = cam.height, cam.width
    dev = data.device
    M = layout.n_models
    bases = layout.bases
    lx, ly = _pixel_rays(cam, dev)
    xl, yl = lx, ly
    lam = torch.sqrt(xl * xl + yl * yl + 1.0)
    fz = frame_data[sm.PZ].reshape(h, w)
    fnx = frame_data[sm.NX].reshape(h, w)
    fny = frame_data[sm.NY].reshape(h, w)
    fnz = frame_data[sm.NZ].reshape(h, w)

    par = int(time) % 2
    xi = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    yi = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    checker = ((xi % 2) == par) & ((yi % 2) == par)
    neigh_ok = (
        (_shift2d(fz, 0, -1, 0.0) > 0) & (_shift2d(fz, 0, 1, 0.0) > 0)
        & (_shift2d(fz, -1, 0, 0.0) > 0) & (_shift2d(fz, 1, 0, 0.0) > 0)
    )
    active_px = take_small(active.to(dev, torch.float32), mask, M) > 0.5
    maxd_px = take_small(maxd.to(dev), mask, M)
    participate = (
        checker & (mask < M) & active_px & neigh_ok & frame_valid.reshape(h, w)
        & (fz > 0) & (fz <= torch.clamp(maxd_px, max=cfg.depth_cutoff))
    )

    # owner-gated window search: a candidate must belong to the pixel's owner
    attrs = gather_attr_images(data_local, index)
    best_dist = torch.full((h, w), 1000.0, dtype=torch.float32, device=dev)
    best_tgt = torch.full((h, w), INVALID, dtype=torch.int32, device=dev)
    for dy, dx in _window_offsets(cfg.assoc_window):
        cand = _shift2d(index, dy, dx, INVALID)
        cdat = _shift2d(attrs, dy, dx, 0.0)
        cown = _shift2d(win_model, dy, dx, -1)
        cpx, cpy, cpz = cdat[sm.PX], cdat[sm.PY], cdat[sm.PZ]
        z_ok = torch.abs((cpz - fz) * lam) < cfg.assoc_depth_gate
        rx = yl * cpz - cpy
        ry = cpx - xl * cpz
        rz = xl * cpy - yl * cpx
        dist = torch.sqrt(rx * rx + ry * ry + rz * rz)
        cnx, cny, cnz = cdat[sm.NX], cdat[sm.NY], cdat[sm.NZ]
        cosang = torch.clamp(cnx * fnx + cny * fny + cnz * fnz, -1.0, 1.0)
        n_ok = (torch.abs(cnz) < 0.75) | (torch.abs(torch.arccos(cosang)) < 0.5)
        better = (cand >= 0) & (cown == mask) & z_ok & n_ok & (dist < best_dist)
        best_dist = torch.where(better, dist, best_dist)
        best_tgt = torch.where(better, cand, best_tgt)

    n_cb = (h // 2) * (w // 2)
    merging = (participate & (best_tgt >= 0))[par::2, par::2].reshape(n_cb)
    target = best_tgt[par::2, par::2].reshape(n_cb)
    part = participate[par::2, par::2].reshape(n_cb)
    own = mask[par::2, par::2].reshape(n_cb)
    fdat = frame_data.reshape(sm.CHANNELS, h, w)[:, par::2, par::2].reshape(sm.CHANNELS, n_cb)

    # merge in the owner's model frame
    own_c = torch.clamp(own, 0, M - 1)
    poses = poses.to(dev)
    new_global = transform_per_model(fdat, own_c, poses)
    old = transform_per_model(gather_attr_images(data_local, target), own_c, poses)
    c_k = old[sm.CONF]
    a = new_global[sm.CONF]
    csum = torch.clamp(c_k + a, min=1e-12)
    rad_ok = new_global[sm.RADIUS] < 1.5 * old[sm.RADIUS]

    def wavg(ch):
        return (c_k * old[ch] + a * new_global[ch]) / csum

    merged = old.clone()
    for ch in (sm.PX, sm.PY, sm.PZ, sm.CR, sm.CG, sm.CB):
        merged[ch] = torch.where(rad_ok, wavg(ch), old[ch])
    nmx, nmy, nmz = wavg(sm.NX), wavg(sm.NY), wavg(sm.NZ)
    nn = torch.sqrt(torch.clamp(nmx * nmx + nmy * nmy + nmz * nmz, min=1e-12))
    merged[sm.NX] = torch.where(rad_ok, nmx / nn, old[sm.NX])
    merged[sm.NY] = torch.where(rad_ok, nmy / nn, old[sm.NY])
    merged[sm.NZ] = torch.where(rad_ok, nmz / nn, old[sm.NZ])
    merged[sm.RADIUS] = torch.where(rad_ok, wavg(sm.RADIUS), old[sm.RADIUS])
    merged[sm.CONF] = c_k + a
    merged[sm.LAST_T] = float(time)

    # per-model appends: rank within the owner's model in source order
    total = layout.total
    counts = counts.to(dev)
    new_mask = part & ~merging
    rank = torch.zeros((n_cb,), dtype=torch.int32, device=dev)
    base = torch.zeros((n_cb,), dtype=torch.int32, device=dev)
    seg_end = torch.zeros((n_cb,), dtype=torch.int32, device=dev)
    n_new = []
    for m in range(M):
        selm = own == m
        cum = torch.cumsum((new_mask & selm).to(torch.int32), 0, dtype=torch.int32)
        rank = torch.where(selm, cum - 1, rank)
        base = torch.where(selm, bases[m] + counts[m], base)
        seg_end = torch.where(selm, torch.full_like(seg_end, bases[m + 1]), seg_end)
        room = torch.clamp(bases[m + 1] - bases[m] - counts[m], min=0)
        n_new.append(torch.minimum(cum[-1], room))
    append_dst = base + rank
    append_dst = torch.where(new_mask & (append_dst < seg_end), append_dst,
                             torch.full_like(append_dst, total))
    merge_dst = torch.where(merging, target, torch.full_like(target, total))
    dst = torch.cat([merge_dst, append_dst]).long()
    vals = torch.cat([merged, new_global], dim=1)
    n_src = 2 * n_cb
    src_ids = torch.arange(n_src, dtype=torch.int32, device=dev)
    inv = torch.full((total + 1,), n_src, dtype=torch.int32, device=dev)
    inv.scatter_reduce_(0, dst, src_ids, reduce="amin", include_self=True)
    inv = inv[:total]
    updated = inv < n_src
    upd = vals[:, torch.clamp(inv, max=n_src - 1).long()]
    out = torch.where(updated[None], upd, data)
    return out, (counts + torch.stack(n_new)).to(torch.int32)


_FUSE_FLAT_ARGS = (
    [K.P, K.I, K.I, K.I, K.I, K.P]  # data, row stride, bg, bo, slots, counts
    + [K.P, K.P, K.P, K.P, K.P, K.P]  # frame data, frame valid, mask, win model, index, data_local
    + [K.P, K.P, K.P]  # poses, max depths, active
    + [K.F] * 4 + [K.I, K.I]  # intrinsics, W, H
    + [K.F, K.I, K.F, K.F, K.I]  # time, parity, depth cutoff, depth gate, window
    + [K.P] * 7  # target, flags, own, prefix, inv, counts out, data out
)


def fuse_flat_cuda(data, counts, layout: FlatLayout, frame_data, frame_valid, index, data_local,
                   mask, win_model, poses, maxd, active, cam: CameraModel, time,
                   cfg: SurfelConfig, with_flags: bool = False):
    """K14 (fuse) on the card: ``csrc/fuse_flat.cu`` ``mmf_fuse_flat`` (same
    contract as ``fuse_flat_plain``; ``with_flags`` also returns the
    association's flags and owners, [n_cb] each)."""
    M = layout.n_models
    K.check(data, torch.float32, "data", contiguous=False)
    K.check(counts, torch.int32, "counts")
    K.check(frame_data, torch.float32, "frame_data")
    K.check(frame_valid, torch.bool, "frame_valid")
    K.check(mask, torch.int32, "mask")
    K.check(win_model, torch.int32, "win_model")
    K.check(index, torch.int32, "index")
    K.check(data_local, torch.float32, "data_local")
    K.check(poses, torch.float32, "poses")
    K.check(maxd, torch.float32, "maxd")
    K.check(active, torch.bool, "active")
    h, w = cam.height, cam.width
    total = layout.total
    if data.shape != (sm.CHANNELS, total) or data.stride(1) != 1 or data_local.shape != data.shape:
        raise ValueError("data must be [16, total] (unit column stride) and data_local [16, total]")
    if tuple(poses.shape) != (M, 4, 4) or counts.shape != (M,) or maxd.shape != (M,) \
            or active.shape != (M,):
        raise ValueError("poses must be [M, 4, 4], counts, maxd and active [M]")
    if h % 2 or w % 2 or M > 8:
        raise ValueError("fuse_flat needs an even image size and at most 8 models")
    n_cb = (h // 2) * (w // 2)
    dev = data.device
    ints = lambda n: torch.empty((n,), dtype=torch.int32, device=dev)  # noqa: E731
    target, flags, own, prefix = ints(n_cb), ints(n_cb), ints(n_cb), ints(n_cb)
    inv = ints(total + scan_scratch(n_cb, M))
    counts_out = ints(M)
    out = torch.empty((sm.CHANNELS, total), dtype=torch.float32, device=dev)
    f = K.fn("fuse_flat", "mmf_fuse_flat", _FUSE_FLAT_ARGS)
    K.call(
        "fuse_flat", f, K.ptr(data), data.stride(0), layout.bg, layout.bo, layout.slots,
        K.ptr(counts), K.ptr(frame_data), K.ptr(frame_valid), K.ptr(mask), K.ptr(win_model),
        K.ptr(index), K.ptr(data_local), K.ptr(poses), K.ptr(maxd), K.ptr(active),
        cam.fx, cam.fy, cam.cx, cam.cy, w, h, float(time), int(time) % 2,
        float(cfg.depth_cutoff), float(cfg.assoc_depth_gate), int(cfg.assoc_window),
        K.ptr(target), K.ptr(flags), K.ptr(own), K.ptr(prefix), K.ptr(inv), K.ptr(counts_out),
        K.ptr(out),
    )
    if with_flags:
        return out, counts_out, flags, own
    return out, counts_out


def fuse_flat(data, counts, layout: FlatLayout, frame: sm.FrameSurfels, index_map: IndexMap,
              mask, win_model, poses, maxd, active, cam: CameraModel, time, cfg: SurfelConfig):
    """Composite fusion: ONE association / merge / append pass for all models
    over the flat store. A pixel fuses only into its mask owner's model
    (the owner must be < M and active, its depth within the owner's max
    depth); window candidates must belong to that model (``win_model``); the
    merge runs in the owner's model frame (``poses`` [M, 4, 4] camera ->
    model); appends go after each segment's count in checkerboard source
    order and are dropped beyond the segment. Returns (data, counts)."""
    args = (data, counts, layout, frame.data, frame.valid, index_map.index, index_map.data_local,
            mask, win_model, poses, maxd, active, cam, time, cfg)
    K.record("fuse_flat", data=data, counts=counts, layout=layout, frame_data=frame.data,
             frame_valid=frame.valid, index=index_map.index, data_local=index_map.data_local,
             mask=mask, win_model=win_model, poses=poses, maxd=maxd, active=active, cam=cam,
             time=time, cfg=cfg)
    impl = fuse_flat_cuda if data.is_cuda else fuse_flat_plain
    return impl(*args)


def fuse_scan_cuda(flags: torch.Tensor, count: torch.Tensor, cap: int):
    """Test entry of K8's append scan (``mmf_fuse_scan_cases``): the scan
    that ``fuse_cuda``'s association kernel runs, on given flags (bit 1:
    new). Returns (prefix [n], the new count clipped to ``cap``)."""
    K.check(flags, torch.int32, "flags")
    K.check(count, torch.int32, "count")
    n = flags.numel()
    dev = flags.device
    scratch = torch.empty((scan_scratch(n, 1),), dtype=torch.int32, device=dev)
    prefix = torch.empty((n,), dtype=torch.int32, device=dev)
    count_out = torch.empty((), dtype=torch.int32, device=dev)
    f = K.fn("fuse", "mmf_fuse_scan_cases", [K.P, K.I, K.P, K.I, K.P, K.P, K.P])
    K.call("fuse.scan_cases", f, K.ptr(flags), n, K.ptr(count), int(cap), K.ptr(scratch),
           K.ptr(prefix), K.ptr(count_out))
    return prefix, count_out


def fuse_flat_scan_cuda(flags: torch.Tensor, own: torch.Tensor, counts: torch.Tensor,
                        layout: FlatLayout):
    """Test entry of K14's append scan (``mmf_fuse_flat_scan_cases``): the
    scan that ``fuse_flat_cuda``'s association kernel runs, on given flags
    (bit 1: new) and owners. Returns (prefix [n], written where the owner is
    a model; the new counts [M], clipped to each segment's room)."""
    M = layout.n_models
    K.check(flags, torch.int32, "flags")
    K.check(own, torch.int32, "own")
    K.check(counts, torch.int32, "counts")
    n = flags.numel()
    if own.numel() != n or counts.shape != (M,) or M > 8:
        raise ValueError("own must match flags, counts be [M], M at most 8")
    dev = flags.device
    scratch = torch.empty((scan_scratch(n, M),), dtype=torch.int32, device=dev)
    prefix = torch.full((n,), -1, dtype=torch.int32, device=dev)
    counts_out = torch.empty((M,), dtype=torch.int32, device=dev)
    f = K.fn("fuse_flat", "mmf_fuse_flat_scan_cases",
             [K.P, K.P, K.I, K.I, K.I, K.I, K.P, K.P, K.P, K.P])
    K.call("fuse_flat.scan_cases", f, K.ptr(flags), K.ptr(own), n, layout.bg, layout.bo,
           layout.slots, K.ptr(counts), K.ptr(scratch), K.ptr(prefix), K.ptr(counts_out))
    return prefix, counts_out


def clean_flat_verdicts(data, counts, layout: FlatLayout, index, data_local, win_model, depth,
                        conf_all, cam: CameraModel, time, time_delta, cfg: SurfelConfig):
    """Per flat slot, (the confidence penalty [total], 1 where none or culled;
    the visual cull vote [total] bool; keep [total] bool) of the composite clean."""
    h, w = cam.height, cam.width
    dev = data.device
    M = layout.n_models
    total = layout.total
    tf = float(time)
    last_t = data[sm.LAST_T]
    conf_all = conf_all.to(dev)
    attrs = gather_attr_images(data_local, index)
    conf_px = take_small(conf_all, win_model, M)
    qx, qy, qz = attrs[sm.PX], attrs[sm.PY], attrs[sm.PZ]
    q_init = attrs[sm.INIT_T]
    q_rad = attrs[sm.RADIUS]
    q_nz = torch.abs(attrs[sm.NZ])
    has_winner = index >= 0

    count = torch.zeros((h, w), dtype=torch.int32, device=dev)
    z_count = torch.zeros((h, w), dtype=torch.int32, device=dev)
    for dy, dx in _window_offsets(cfg.assoc_window):
        cand = _shift2d(index, dy, dx, INVALID)
        cdat = _shift2d(attrs, dy, dx, 0.0)
        cown = _shift2d(win_model, dy, dx, -1)
        cgate = _shift2d(conf_px, dy, dx, 0.0)
        cvalid = (cand >= 0) & (cand != index) & has_winner & (cown == win_model)
        czp, cconf = cdat[sm.PZ], cdat[sm.CONF]
        cinit, clast = cdat[sm.INIT_T], cdat[sm.LAST_T]
        xy_dist = torch.sqrt((cdat[sm.PX] - qx) ** 2 + (cdat[sm.PY] - qy) ** 2)
        red = (cvalid & (cinit < q_init) & (cconf > cgate) & (czp > qz) & (czp - qz < 0.01)
               & (xy_dist < q_rad * 1.4))
        count = count + red.to(torch.int32)
        zc = (cvalid & (clast == tf) & (cconf > cgate) & (czp > qz) & (czp - qz > 0.01)
              & (q_nz > 0.85))
        z_count = z_count + zc.to(torch.int32)

    violations = torch.zeros((h, w), dtype=torch.int32, device=dev)
    viol_sum = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            d = _shift2d(depth, dy, dx, 0.0)
            delta = d - qz
            hit = has_winner & (d > 0) & (delta > cfg.clean_see_through_gate)
            violations = violations + hit.to(torch.int32)
            viol_sum = viol_sum + torch.where(hit, delta, torch.zeros_like(delta))
    viol = violations > 0
    avg_v = viol_sum / torch.clamp(violations.to(torch.float32), min=1.0)
    one = torch.ones_like(avg_v)
    pen = torch.where(viol, 1.0 / (1.0 + cfg.outlier_coeff * avg_v), one)
    cull_vis = has_winner & ((count > 8) | (z_count > 4))

    ids = torch.where(has_winner, index, torch.full_like(index, total)).reshape(-1).long()
    verdict = torch.where(cull_vis, -one, pen).reshape(-1)
    per_surfel = torch.ones((total + 1,), dtype=torch.float32, device=dev)
    per_surfel.scatter_reduce_(0, ids, verdict, reduce="amin", include_self=True)
    per_surfel = per_surfel[:total]
    culled = per_surfel < 0.0
    pen_per_surfel = torch.where(culled, torch.ones_like(per_surfel), per_surfel)

    seg = layout.seg_model(dev).long()
    alive = (layout.pos_in_seg(dev) < counts.to(dev)[seg]) & (data[sm.ALIVE] > 0)
    keep = alive & ~culled
    unstable_dead = ((tf - last_t) > cfg.unstable_grace) & (data[sm.CONF] < conf_all[seg])
    keep = keep & ~unstable_dead
    keep = keep | (alive & (last_t > 0) & (tf - last_t > time_delta))
    return pen_per_surfel, culled, keep


def clean_flat_plain(data, counts, layout: FlatLayout, index, data_local, win_model, depth,
                     conf_all, cam: CameraModel, time, time_delta, cfg: SurfelConfig):
    """Plain PyTorch K14 (clean): the composite culls over the flat store;
    returns a new store with penalties applied and ALIVE cleared (no compaction)."""
    pen, _, keep = clean_flat_verdicts(data, counts, layout, index, data_local, win_model,
                                       depth, conf_all, cam, time, time_delta, cfg)
    out = data.clone()
    out[sm.CONF] = data[sm.CONF] * pen
    out[sm.ALIVE] = torch.where(keep, data[sm.ALIVE], torch.zeros_like(data[sm.ALIVE]))
    return out


_CLEAN_FLAT_ARGS = (
    [K.P, K.I, K.I, K.I, K.I, K.P]  # data, row stride, bg, bo, slots, counts
    + [K.P, K.P, K.P, K.P, K.P]  # index, data_local, win model, depth, conf_all
    + [K.I, K.I, K.I] + [K.F] * 5  # H, W, window, time, time delta, grace, gate, coeff
    + [K.P]  # verdicts
)


def clean_flat_cuda(data, counts, layout: FlatLayout, index, data_local, win_model, depth,
                    conf_all, cam: CameraModel, time, time_delta, cfg: SurfelConfig):
    """K14 (clean) on the card: ``csrc/fuse_flat.cu`` ``mmf_clean_flat``.

    IN PLACE: consumes ``data`` and returns it cleaned (CONF times each
    surfel's penalty where it is not 1, ALIVE cleared where a surfel is not
    kept; every other channel and row untouched), the values
    ``clean_flat_plain`` returns as a new tensor. ``cfg.assoc_window`` must be
    at most ``STAGE_MAX_WINDOW``."""
    M = layout.n_models
    window = check_stage_window(cfg.assoc_window)
    K.check(data, torch.float32, "data", contiguous=False)
    K.check(counts, torch.int32, "counts")
    K.check(index, torch.int32, "index")
    K.check(data_local, torch.float32, "data_local")
    K.check(win_model, torch.int32, "win_model")
    K.check(depth, torch.float32, "depth")
    K.check(conf_all, torch.float32, "conf_all")
    h, w = cam.height, cam.width
    total = layout.total
    if data.shape != (sm.CHANNELS, total) or data.stride(1) != 1 or data_local.shape != data.shape:
        raise ValueError("data must be [16, total] (unit column stride) and data_local [16, total]")
    if counts.shape != (M,) or conf_all.shape != (M,) or index.shape != (h, w):
        raise ValueError("counts and conf_all must be [M], index [H, W]")
    verdicts = torch.empty((total,), dtype=torch.int32, device=data.device)
    f = K.fn("fuse_flat", "mmf_clean_flat", _CLEAN_FLAT_ARGS)
    K.call(
        "clean_flat", f, K.ptr(data), data.stride(0), layout.bg, layout.bo, layout.slots,
        K.ptr(counts), K.ptr(index), K.ptr(data_local), K.ptr(win_model), K.ptr(depth),
        K.ptr(conf_all), h, w, window, float(time), float(time_delta),
        float(cfg.unstable_grace), float(cfg.clean_see_through_gate), float(cfg.outlier_coeff),
        K.ptr(verdicts),
    )
    return data


def clean_flat(data, counts, layout: FlatLayout, index_map: IndexMap, win_model, depth, conf_all,
               cam: CameraModel, time, time_delta, cfg: SurfelConfig):
    """Composite clean: window candidates of the SAME model as the pixel's
    winner, each gated by its model's confidence; see-through penalty;
    per-surfel verdicts; the unstable cull against the surfel's model gate.
    No compaction (the caller repacks each segment every compact_every frames).
    On the card ``data`` is consumed: cleaned in place and returned."""
    K.record("clean_flat", data=data, counts=counts, layout=layout, index=index_map.index,
             data_local=index_map.data_local, win_model=win_model, depth=depth,
             conf_all=conf_all, cam=cam, time=time, time_delta=time_delta, cfg=cfg)
    impl = clean_flat_cuda if data.is_cuda else clean_flat_plain
    return impl(data, counts, layout, index_map.index, index_map.data_local, win_model, depth,
                conf_all, cam, time, time_delta, cfg)
