"""Keypoint track table (kernel K20, ``csrc/tracks.cu``).

Port of the reference package's ``tracking/tracker.py``: a fixed-capacity
struct of arrays, rows = track slots (capacity T), columns = the last H frames
(a ring indexed by ``tick % H``). Matching is the cross-checked mutual nearest
neighbour in L2 with a distance gate.

Unlike the reference, which is functional, the port updates the table IN
PLACE: ``add_keypoints`` and ``update`` write into the tensors of the table
they are given and return it (or the pair it forms).

- ``mutual_match``: one tiled launch of the row and column minima over the
  [K, T] squared distances (never stored; per-block partials, no atomics)
  and one launch of the mutual test and the gate;
- ``update`` = ``add_keypoints`` -> ``prune`` -> ``last_pair`` as the engine
  runs them on every frame: the match (its tracks' ``in_history`` computed in
  the tile launch), then one launch over the tracks in pull form: a track
  takes the row of the query that matched it, or, if free, of the r-th
  unmatched valid keypoint where r is its rank among the free slots in index
  order; then it clears the next ring slot, prunes and forms the (p0, p1,
  valid) pair. Three device operations a frame; the tick is a host int
  passed by value.

Each wrapper launches the CUDA kernels for CUDA tensors and takes the plain
PyTorch version (``*_plain``) only for CPU tensors; the plain versions sum in
the kernels' order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel, KeypointConfig
from multimotionfusion_tpu_torch.ops import ransac
from multimotionfusion_tpu_torch.ops.image import div
from multimotionfusion_tpu_torch.tracking.superpoint import Keypoints

F32 = torch.float32
I32 = torch.int32
FPS = 30.0
FIELDS = ("xy", "p3d", "seen", "has_depth", "desc", "last_seen", "nvalid", "active", "model_id")


class TrackTable(NamedTuple):
    xy: torch.Tensor  # [T, H, 2] pixel coords per ring slot
    p3d: torch.Tensor  # [T, H, 3] camera-frame points (0 where invalid)
    seen: torch.Tensor  # [T, H] bool: keypoint present at that ring slot
    has_depth: torch.Tensor  # [T, H] bool: 3D coordinate is valid
    desc: torch.Tensor  # [T, D] descriptor of the most recent keypoint
    last_seen: torch.Tensor  # [T] int32 tick of the last keypoint (-1 = never)
    nvalid: torch.Tensor  # [T] int32 number of keypoints on the track
    active: torch.Tensor  # [T] bool slot allocated
    model_id: torch.Tensor  # [T] int32 owning model (0 = global / unassigned)

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    @property
    def history(self) -> int:
        return self.xy.shape[1]


def empty(capacity: int, history: int, desc_dim: int, device="cpu") -> TrackTable:
    z = dict(device=device)
    return TrackTable(
        xy=torch.zeros((capacity, history, 2), dtype=F32, **z),
        p3d=torch.zeros((capacity, history, 3), dtype=F32, **z),
        seen=torch.zeros((capacity, history), dtype=torch.bool, **z),
        has_depth=torch.zeros((capacity, history), dtype=torch.bool, **z),
        desc=torch.zeros((capacity, desc_dim), dtype=F32, **z),
        last_seen=torch.full((capacity,), -1, dtype=I32, **z),
        nvalid=torch.zeros((capacity,), dtype=I32, **z),
        active=torch.zeros((capacity,), dtype=torch.bool, **z),
        model_id=torch.zeros((capacity,), dtype=I32, **z),
    )


def backproject_keypoints(kps: Keypoints, depth: torch.Tensor, cam: CameraModel):
    """(p3d [K, 3], has_depth [K]): camera-frame points from the depth at the
    nearest pixel (``rint``, half to even), 0 where there is none."""
    h, w = depth.shape
    xi = torch.clamp(torch.round(kps.xy[:, 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(kps.xy[:, 1]).to(torch.int64), 0, h - 1)
    z = depth[yi, xi]
    has_depth = kps.valid & (z > 0)
    p = torch.stack([div(z * (kps.xy[:, 0] - cam.cx), cam.fx),
                     div(z * (kps.xy[:, 1] - cam.cy), cam.fy), z], dim=-1)
    return torch.where(has_depth[:, None], p, torch.zeros_like(p)), has_depth


# ---------------------------------------------------------------- mutual_match

def _gate2(max_dist: float) -> float:
    return float(np.float32(max_dist**2))


def sq_dists(q_desc: torch.Tensor, t_desc: torch.Tensor) -> torch.Tensor:
    """[K, T] = |q|^2 - 2 q.t + |t|^2, every sum over d = 0..D-1 in order (the
    kernel's order)."""
    qn = torch.zeros(q_desc.shape[0], dtype=F32, device=q_desc.device)
    tn = torch.zeros(t_desc.shape[0], dtype=F32, device=t_desc.device)
    dot = torch.zeros((q_desc.shape[0], t_desc.shape[0]), dtype=F32, device=q_desc.device)
    for d in range(q_desc.shape[1]):
        qd, td = q_desc[:, d], t_desc[:, d]
        qn = qn + qd * qd
        tn = tn + td * td
        dot = dot + qd[:, None] * td[None, :]
    return qn[:, None] - 2.0 * dot + tn[None, :]


def mutual_match_plain(q_desc, t_desc, q_valid, t_valid, max_dist: float):
    d2 = sq_dists(q_desc, t_desc)
    d2 = torch.where(q_valid[:, None] & t_valid[None, :], d2, torch.full_like(d2, 1e30))
    best_t = torch.argmin(d2, dim=1)  # first index on ties
    best_q = torch.argmin(d2, dim=0)
    k_ids = torch.arange(q_desc.shape[0], device=q_desc.device)
    mutual = best_q[best_t] == k_ids
    dist_ok = torch.gather(d2, 1, best_t[:, None])[:, 0] <= _gate2(max_dist)
    ok = mutual & dist_ok & q_valid
    match_idx = torch.where(ok, best_t, torch.full_like(best_t, -1)).to(I32)
    matched_t = torch.zeros(t_desc.shape[0], dtype=torch.bool, device=q_desc.device)
    matched_t[best_t[ok]] = True
    return match_idx, matched_t


MATCH_TILE = 128  # queries and tracks a block of csrc/tracks.cu's match_tile (TQ, TT)
_TICKETS = {}  # device -> the match's last-block ticket, 0 between launches


def _match_cuda(q_desc, t_desc, q_valid, t_valid, max_dist: float, table=None, time: int = 0,
                want_matched: bool = True):
    """``csrc/tracks.cu`` ``mmf_mutual_match``: (match_idx [K], tcol [T] int32:
    the query of each track's column minimum, matched_t [T] or None). The
    tracks' validity is ``t_valid``, or, with ``table``, ``in_history(table,
    time)`` computed in the kernel."""
    K.check(q_desc, F32, "q_desc")
    K.check(t_desc, F32, "t_desc")
    K.check(q_valid, torch.bool, "q_valid")
    if table is None:
        K.check(t_valid, torch.bool, "t_valid")
    else:
        K.check(table.active, torch.bool, "active")
        K.check(table.last_seen, I32, "last_seen")
    (k, d), t = q_desc.shape, t_desc.shape[0]
    if t_desc.shape[1] != d:
        raise ValueError("q_desc and t_desc must have the same descriptor width")
    if k == 0 or t == 0:
        raise ValueError("mutual_match needs at least one query and one track")
    dev = q_desc.device
    rowpart = torch.empty((-(-t // MATCH_TILE) * k,), dtype=torch.int64, device=dev)
    colpart = torch.empty((-(-k // MATCH_TILE) * t,), dtype=torch.int64, device=dev)
    match_idx = torch.empty((k,), dtype=I32, device=dev)
    tcol = torch.empty((t,), dtype=I32, device=dev)
    matched_t = torch.empty((t,), dtype=torch.bool, device=dev) if want_matched else None
    key = torch.device(dev)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((1,), dtype=I32, device=dev)
    f = K.fn("tracks", "mmf_mutual_match",
             [K.P] * 6 + [K.I] * 5 + [K.F] + [K.P] * 6)
    K.call("mutual_match", f, K.ptr(q_desc), K.ptr(t_desc), K.ptr(q_valid),
           None if table is not None else K.ptr(t_valid),
           None if table is None else K.ptr(table.active),
           None if table is None else K.ptr(table.last_seen), int(time),
           0 if table is None else table.history, k, t, d, _gate2(max_dist), K.ptr(rowpart),
           K.ptr(colpart), K.ptr(match_idx), K.ptr(tcol),
           None if matched_t is None else K.ptr(matched_t), K.ptr(_TICKETS[key]))
    return match_idx, tcol, matched_t


def mutual_match_cuda(q_desc, t_desc, q_valid, t_valid, max_dist: float):
    match_idx, _, matched_t = _match_cuda(q_desc, t_desc, q_valid, t_valid, max_dist)
    return match_idx, matched_t


def mutual_match(q_desc, t_desc, q_valid, t_valid, max_dist: float):
    """Cross-checked nearest-neighbour matching: (match_idx [K] int32 track
    per query or -1, matched_t [T] bool)."""
    K.record("mutual_match", q_desc=q_desc, t_desc=t_desc, q_valid=q_valid, t_valid=t_valid,
             max_dist=max_dist)
    impl = mutual_match_cuda if q_desc.is_cuda else mutual_match_plain
    return impl(q_desc, t_desc, q_valid, t_valid, max_dist)


def in_history(table: TrackTable, time: int) -> torch.Tensor:
    """Tracks that are candidates for matching: active, with a keypoint
    within the ring's span."""
    return table.active & ((time - table.last_seen) <= table.history)


# ---------------------------------------------------------------- table update

def add_keypoints_plain(table: TrackTable, kps: Keypoints, depth, time: int, cam: CameraModel,
                        cfg: KeypointConfig) -> TrackTable:
    hist = table.history
    slot = time % hist
    p3d, has_depth = backproject_keypoints(kps, depth, cam)
    match_idx, _ = mutual_match_plain(kps.desc, table.desc, kps.valid, in_history(table, time),
                                      cfg.match_dist_gate)
    matched = match_idx >= 0
    new_mask = kps.valid & ~matched
    free_slots = torch.nonzero(~table.active)[:, 0]  # ascending
    want_rank = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    has_slot = new_mask & (want_rank < free_slots.numel())
    new_tgt = free_slots[torch.clamp(want_rank, 0, max(free_slots.numel() - 1, 0))] \
        if free_slots.numel() else torch.zeros_like(want_rank)
    tgt = torch.where(matched, match_idx.to(torch.int64),
                      torch.where(has_slot, new_tgt, torch.full_like(new_tgt, -1)))
    sel = tgt >= 0
    rows = tgt[sel]
    table.xy[rows, slot] = kps.xy[sel]
    table.p3d[rows, slot] = p3d[sel]
    table.seen[rows, slot] = True
    table.has_depth[rows, slot] = has_depth[sel]
    table.desc[rows] = kps.desc[sel]
    table.last_seen[rows] = time
    table.nvalid[rows] = torch.where(matched[sel], table.nvalid[rows] + 1,
                                     torch.ones_like(table.nvalid[rows]))
    table.active[rows] = True
    nxt = (time + 1) % hist
    table.seen[:, nxt] = False
    table.has_depth[:, nxt] = False
    return table


def prune(table: TrackTable, time: int, cfg: KeypointConfig, fps: float = FPS) -> TrackTable:
    """Deactivate short, stale tracks (in place)."""
    stale = (time - table.last_seen) > int(np.int32(cfg.prune_max_age_s * fps))
    drop = table.active & (table.nvalid < cfg.prune_min_kps) & stale
    table.active.copy_(table.active & ~drop)
    return table


def last_pair(table: TrackTable, time: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(p0, p1, valid): each track's 3D points at ticks time-1 and time, valid
    where both have depth and the track was seen at ``time``."""
    hist = table.history
    s1, s0 = time % hist, (time - 1) % hist
    valid = (table.active & table.has_depth[:, s0] & table.has_depth[:, s1]
             & (table.last_seen == time))
    return table.p3d[:, s0].contiguous(), table.p3d[:, s1].contiguous(), valid


def _ring(table: TrackTable, ticks: torch.Tensor):
    """Each track's 3D points at ``ticks`` [K] (int32), [K, T, 3], and where
    they are usable, [K, T]: seen with depth at the tick, and the tick still
    within the ring of the track's last sighting. One gather of the ring."""
    hist = table.history
    slots = torch.remainder(ticks, hist)
    usable = (table.seen.T.index_select(0, slots) & table.has_depth.T.index_select(0, slots)
              & ((table.last_seen[None] - ticks[:, None]) < hist))
    return table.p3d.transpose(0, 1).index_select(0, slots), usable


def pair_between(table: TrackTable, t_a: int, t_b: int):
    """(p_a, p_b, valid): per-track 3D points at two ticks within the ring,
    valid where the track is active and usable at both."""
    pts, usable = _ring(table, torch.tensor([t_a, t_b], dtype=I32, device=table.p3d.device))
    return pts[0], pts[1], table.active & usable[0] & usable[1]


def update_plain(table: TrackTable, kps: Keypoints, depth, time: int, cam: CameraModel,
                 cfg: KeypointConfig, pair: bool = True):
    add_keypoints_plain(table, kps, depth, time, cam, cfg)
    if not pair:
        return None
    prune(table, time, cfg)
    return last_pair(table, time)


_SCAN = {}  # (device, tiles) -> [the update's two sets of scan words, the set to use next]


def _scan_words(device, cap: int):
    """The track update's scan words for this call and for the next: a status
    word per 256-track tile and the scan's ticket, in two sets that the calls
    alternate between (a launch sets the other set, which the call before it
    used, back to 0); both 0 at first."""
    tiles = -(-cap // 256)
    key = (torch.device(device), tiles)
    if key not in _SCAN:
        _SCAN[key] = [torch.zeros((2, tiles + 1), dtype=I32, device=device), 0]
    words, cur = _SCAN[key]
    _SCAN[key][1] = 1 - cur
    return words[cur], words[1 - cur]


def track_update_cuda(table: TrackTable, kps: Keypoints, match_idx, tcol, depth, time: int,
                      cam: CameraModel, cfg: KeypointConfig, pair: bool = True):
    """``csrc/tracks.cu`` ``mmf_track_update`` given the matches (``match_idx``
    per keypoint, ``tcol`` per track: ``_match_cuda``'s): one launch."""
    for name in FIELDS:
        K.check(getattr(table, name), {"xy": F32, "p3d": F32, "desc": F32, "last_seen": I32,
                                       "nvalid": I32, "model_id": I32}.get(name, torch.bool), name)
    K.check(kps.xy, F32, "kps.xy")
    K.check(kps.desc, F32, "kps.desc")
    K.check(kps.valid, torch.bool, "kps.valid")
    K.check(match_idx, I32, "match_idx")
    K.check(tcol, I32, "tcol")
    K.check(depth, F32, "depth")
    cap, hist, d = table.capacity, table.history, table.desc.shape[1]
    k = kps.xy.shape[0]
    if kps.desc.shape[1] != d:
        raise ValueError("keypoint and track descriptors differ in width")
    if tcol.shape[0] != cap or match_idx.shape[0] != k or k == 0:
        raise ValueError("match_idx must be [K] (K > 0) and tcol [capacity]")
    dev = depth.device
    p0 = torch.empty((cap, 3), dtype=F32, device=dev)
    p1 = torch.empty((cap, 3), dtype=F32, device=dev)
    valid = torch.empty((cap,), dtype=torch.bool, device=dev)
    h, w = depth.shape
    f = K.fn("tracks", "mmf_track_update",
             [K.P] * 14 + [K.I] * 6 + [K.F] * 4 + [K.I] * 4 + [K.P] * 5)
    K.call("track_update", f,
           K.ptr(table.xy), K.ptr(table.p3d), K.ptr(table.seen), K.ptr(table.has_depth),
           K.ptr(table.desc), K.ptr(table.last_seen), K.ptr(table.nvalid), K.ptr(table.active),
           K.ptr(kps.xy), K.ptr(kps.desc), K.ptr(kps.valid), K.ptr(match_idx), K.ptr(tcol),
           K.ptr(depth), cap, hist, d, k, h, w, cam.fx, cam.fy, cam.cx, cam.cy, int(time),
           int(pair), cfg.prune_min_kps, int(np.int32(cfg.prune_max_age_s * FPS)),
           *(K.ptr(w) for w in _scan_words(dev, cap)), K.ptr(p0), K.ptr(p1), K.ptr(valid))
    return (p0, p1, valid) if pair else None


def update_cuda(table: TrackTable, kps: Keypoints, depth, time: int, cam: CameraModel,
                cfg: KeypointConfig, pair: bool = True):
    """Three launches: the match tiles and the mutual test (the tracks'
    ``in_history`` computed in the first), then the update."""
    if K.capturing():
        K.record("mutual_match", q_desc=kps.desc, t_desc=table.desc, q_valid=kps.valid,
                 t_valid=in_history(table, time), max_dist=cfg.match_dist_gate)
    match_idx, tcol, _ = _match_cuda(kps.desc, table.desc, kps.valid, None,
                                     cfg.match_dist_gate, table, time, want_matched=False)
    return track_update_cuda(table, kps, match_idx, tcol, depth, time, cam, cfg, pair)


def update(table: TrackTable, kps: Keypoints, depth, time: int, cam: CameraModel,
           cfg: KeypointConfig, pair: bool = True):
    """``add_keypoints``, then (with ``pair``) ``prune`` and ``last_pair``,
    in place on ``table``; returns (p0, p1, valid) or None."""
    K.record("track_update", table=table, kps=kps, depth=depth, time=time, cam=cam, cfg=cfg,
             pair=pair)
    impl = update_cuda if depth.is_cuda else update_plain
    return impl(table, kps, depth, time, cam, cfg, pair)


def add_keypoints(table: TrackTable, kps: Keypoints, depth, time: int, cam: CameraModel,
                  cfg: KeypointConfig) -> TrackTable:
    """Match new keypoints to tracks; extend hits, open tracks for misses
    (in place)."""
    update(table, kps, depth, time, cam, cfg, pair=False)
    return table


def backdate_pairs(table: TrackTable, model_sel: torch.Tensor, time: int, length: int):
    """The back-dating fits' correspondences: for k < ``length`` the pair
    (tick time - k - 1, tick time - k) of ``pair_between`` with ``model_sel``
    applied, as (p_a [length, T, 3], p_b [length, T, 3], valid [length, T]).
    One gather of the ring (ticks time - length .. time, contiguous) holds
    every point; p_a and p_b are slices of it."""
    ticks = torch.arange(time, time - length - 1, -1, dtype=I32, device=table.p3d.device)
    pts, usable = _ring(table, ticks)  # tick time - j at j
    valid = usable[1:] & usable[:-1] & (table.active & model_sel)[None]
    return pts[1:], pts[:-1], valid


def refine_track_subset(table: TrackTable, model_sel: torch.Tensor, time: int, length: int,
                        gen: torch.Generator, ransac_cfg):
    """Back-date a new model's trajectory (Model::refineTrackSubset): per
    step k < ``length`` a RANSAC fit (kernel K21) of the model's tracks from
    tick time - k to time - k - 1, the ``length`` fits in one batch, each
    with its own draw from ``gen`` in step order; [length, 4, 4] transforms
    T_k with p(time - k - 1) ~ T_k p(time - k), identity where the fit
    fails."""
    K.record("refine_track_subset", table=table, model_sel=model_sel, time=time, length=length,
             ransac_cfg=ransac_cfg)
    pa, pb, valid = backdate_pairs(table, model_sel, time, length)
    u = ransac.draw_uniforms(gen, length, ransac_cfg.iterations, pa.device)
    res = ransac.ransac_fit_batch(u, pa, pb, valid, ransac_cfg)
    ok = (res.ok & torch.isfinite(res.transform).flatten(1).all(1)
          & (valid.to(I32).sum(1) >= 3))
    eye = torch.eye(4, dtype=F32, device=pa.device)
    return torch.where(ok[:, None, None], res.transform, eye)
