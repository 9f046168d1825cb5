"""Multi-model engine step: per-rigid-body tracking, lifecycle and fusion.

Port of the reference package's ``engine_multi.py`` for the composite step:
keypoints -> track table(s) -> per-model RANSAC seeds -> ONE composite
Gauss-Newton pass for every model (K11) -> segmentation -> spawn /
reactivate / deactivate / store -> ONE composite index map over the flat
store of all models (K12) -> ONE fuse and clean pass (K14) -> the composite
prediction (K10, composite mode, filled in only where the global model owns
the pixel).

The segmentation is the flow-CRF (``segmentation.mode`` "flow_crf", the
default, and every mode but "precomputed" and "crf", as in the reference):
every model's depth on the CRF grid from the pre-spawn stores at the new
poses (K13), the flow (K15), the unaries from it and from the track
velocities of the ``segm_lvl`` tracker (K18), the mean field (K16), the
label fusion (K18), the largest components (K17) and the segment finish
(K18); or, with ``mode="precomputed"``, the external masks of the frames.

Object models live in fixed slots on the device (``ObjectSlots``: slot k is
model k + 1 and owns mask id k + 1); the previous frame's mask (``prev_mask``)
partitions the pixels for tracking, and the winner model of last frame's
composite index map (``pred_own``) gates the prediction taps. Every
lifecycle decision is a device select (``torch.where``): the rare branches
of the reference's ``lax.cond`` (redetection, the new model's back-dating,
the spawn, the store snapshot) are computed on every frame and selected, so
a frame reads nothing back, spawn frames included.

The camera model's relocalisation (``reloc_mode``) and loop closure
(``close_loops``) run after the composite odometry and before the
segmentation, on the global model's system (``engine.global_consistency``);
while lost, the global segment keeps its pre-fusion data.

The legacy CoFusion CRF (``segmentation.mode="crf"``) takes a per-slot
step instead (``_multi_frame_step_legacy``): it needs every model's ICP
error image over the whole frame, which the composite passes do not make.
Each slot renders its own prediction at its previous pose (K6 + K10) and is
tracked on its own (K2-K5, masked to its id, with error images), then
renders its index map at the new pose (K6); the legacy CRF (K24a-c, K17)
segments; each slot fuses and cleans on its own (K8, K9); the global model
takes the static step's passes (K6, K8, K7/K9, K10 + fill-in).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from multimotionfusion_tpu_torch.config import REDETECT_RANSAC, CameraModel, EngineConfig
from multimotionfusion_tpu_torch.engine import (_compact_pred, _detect, _fern_frame, _seeded_table,
                                                global_consistency)
from multimotionfusion_tpu_torch.model import ferns, fusion, loop_closure, surfel_map as sm
from multimotionfusion_tpu_torch.model.fillin import FilledMaps, splat_fill
from multimotionfusion_tpu_torch.odometry import levels as lv
from multimotionfusion_tpu_torch.odometry import multi as modo
from multimotionfusion_tpu_torch.odometry import rgbd
from multimotionfusion_tpu_torch.ops import frame_maps, ransac, rasterize
from multimotionfusion_tpu_torch.ops.image import rgb_to_intensity
from multimotionfusion_tpu_torch.segmentation import flow_crf, legacy_crf
from multimotionfusion_tpu_torch.segmentation.precomputed import precomputed_segmentation
from multimotionfusion_tpu_torch.tracking import tracker
from multimotionfusion_tpu_torch.utils import se3

F32 = torch.float32
I32 = torch.int32
# strides of the global and the object segment in the CRF-scale depth render
# (reference engine_multi.py:62-78: stride 2 keeps >= 2 depth candidates per
# cell of a mature global map; objects stay dense)
_RMD_GLOBAL_STRIDE = 2
_RMD_OBJECT_STRIDE = 1
# named ranges of the multi step (torch.profiler; chip_smoke.py's stage phase)
_span = torch.profiler.record_function


class ObjectSlots(NamedTuple):
    """Batched object-model state (leading axis = slot; mask id = slot + 1)."""

    data: torch.Tensor  # [S, 16, cap_o]
    count: torch.Tensor  # [S] int32 high-water mark
    pose: torch.Tensor  # [S, 4, 4]
    active: torch.Tensor  # [S] bool
    unseen: torch.Tensor  # [S] int32 frames with zero segment pixels
    spawn_tick: torch.Tensor  # [S] int32
    conf_t: torch.Tensor  # [S] per-slot confidence gate (rises as the model matures)
    max_depth: torch.Tensor  # [S] per-slot max depth (segment mean + 1.2 std)
    stored: torch.Tensor  # [S] bool: the slot holds a deactivated model
    stored_desc: torch.Tensor  # [S, Ks, D] redetection snapshot
    stored_p3d: torch.Tensor  # [S, Ks, 3] model-frame points
    stored_valid: torch.Tensor  # [S, Ks] bool
    ext_id: torch.Tensor  # [S] int32 external mask id owned by the slot (0 = none)

    @property
    def num_slots(self) -> int:
        return self.data.shape[0]


FIELDS = ObjectSlots._fields


class SpawnAux(NamedTuple):
    """Per-frame lifecycle outputs the host reads lazily."""

    spawn: torch.Tensor  # [] bool: a new model claimed a slot this frame
    redetect: torch.Tensor  # [] bool: a stored model was re-attached
    slot: torch.Tensor  # [] int32 the claimed slot
    refine_T: torch.Tensor  # [L, 4, 4] per-step back-dating transforms


class MultiState(NamedTuple):
    """Device state of the multi-model step."""

    smap: sm.SurfelMap  # the global model (id 0)
    pose: torch.Tensor
    prev_pose: torch.Tensor
    filled: FilledMaps  # composite prediction (global pixels filled in)
    pred_own: torch.Tensor  # [H, W] int32 model of each prediction pixel's winner (M = none)
    last_intensity_coarse: torch.Tensor
    tracks: tracker.TrackTable  # the init_lvl tracker (pose seeds, redetection)
    # the segm_lvl tracker whose velocities feed the flow-CRF; a 1-slot stub
    # when segm_lvl == init_lvl (``tracks`` serves both)
    tracks_segm: tracker.TrackTable
    objects: ObjectSlots
    prev_mask: torch.Tensor  # [H, W] int32 segmentation of the previous frame
    prev_intensity: torch.Tensor  # [H, W]
    last_spawn: torch.Tensor  # [] int32 tick of the last spawn (cool-down)
    # the camera model's relocalisation and loop-closure state (as GlobalState)
    ferns: Optional[ferns.FernDB] = None
    bad_track_count: Optional[torch.Tensor] = None
    lost: Optional[torch.Tensor] = None
    pose_matches: Optional[loop_closure.MatchLog] = None


def empty_objects(cfg: EngineConfig, device) -> ObjectSlots:
    s = cfg.object_slots
    ks, d = cfg.keypoints.max_keypoints, cfg.keypoints.desc_dim
    z = dict(device=device)
    return ObjectSlots(
        data=torch.zeros((s, sm.CHANNELS, cfg.object_capacity), dtype=F32, **z),
        count=torch.zeros((s,), dtype=I32, **z),
        pose=torch.eye(4, dtype=F32, **z).repeat(s, 1, 1),
        active=torch.zeros((s,), dtype=torch.bool, **z),
        unseen=torch.zeros((s,), dtype=I32, **z),
        spawn_tick=torch.zeros((s,), dtype=I32, **z),
        conf_t=torch.full((s,), cfg.surfels.object_conf_threshold, dtype=F32, **z),
        max_depth=torch.full((s,), cfg.surfels.depth_cutoff, dtype=F32, **z),
        stored=torch.zeros((s,), dtype=torch.bool, **z),
        stored_desc=torch.zeros((s, ks, d), dtype=F32, **z),
        stored_p3d=torch.zeros((s, ks, 3), dtype=F32, **z),
        stored_valid=torch.zeros((s, ks), dtype=torch.bool, **z),
        ext_id=torch.zeros((s,), dtype=I32, **z),
    )


def stub_table(cfg: EngineConfig, device) -> tracker.TrackTable:
    """The 1-slot ``tracks_segm`` of a configuration with segm_lvl == init_lvl."""
    return tracker.empty(1, 2, cfg.keypoints.desc_dim, device)


def init_state(state, rgb_u8, depth_raw, time: int, cfg: EngineConfig, sp_net=None) -> MultiState:
    """The multi state after the first frame, from the static init step's;
    with segm_lvl != init_lvl the segm_lvl tracker is seeded from this frame."""
    cam = cfg.camera
    dev = state.pose.device
    zeros = torch.zeros((cam.height, cam.width), dtype=I32, device=dev)
    tracks_segm = stub_table(cfg, dev)
    if _use_segm_tracker(cfg):
        _, depth_filt = frame_maps.frame_depth(depth_raw)
        frame_lv = lv.frame_levels(depth_filt, rgb_u8, zeros, cam, cfg.odometry)
        tracks_segm = _seeded_table(frame_lv, depth_filt, time, cam, cfg, sp_net,
                                    cfg.odometry.segm_lvl)
    return MultiState(
        smap=state.smap, pose=state.pose, prev_pose=state.prev_pose, filled=state.filled,
        pred_own=zeros, last_intensity_coarse=state.last_intensity_coarse, tracks=state.tracks,
        tracks_segm=tracks_segm, objects=empty_objects(cfg, dev), prev_mask=zeros.clone(),
        prev_intensity=rgb_to_intensity(rgb_u8.to(F32)),
        last_spawn=torch.zeros((), dtype=I32, device=dev), ferns=state.ferns,
        bad_track_count=state.bad_track_count, lost=state.lost, pose_matches=state.pose_matches,
    )


def _eye(n: int, dev) -> torch.Tensor:
    return torch.eye(4, dtype=F32, device=dev).expand(n, 4, 4)


def _depth_stats(mask, new_label_mask, depth, m: int):
    """[m + 1] mean / std of the frame depth per label (index m = the new
    label): the per-model max-depth clamp mean + 1.2 std."""
    dev = depth.device
    ks = torch.arange(m, dtype=I32, device=dev)[:, None, None]
    sel = torch.cat([mask[None] == ks, new_label_mask[None]], dim=0) & (depth[None] > 0)
    n = torch.clamp(torch.sum(sel.to(F32), dim=(1, 2)), min=1.0)
    zero = torch.zeros_like(depth)[None]
    mu = torch.sum(torch.where(sel, depth[None], zero), dim=(1, 2)) / n
    var = torch.sum(torch.where(sel, (depth * depth)[None], zero), dim=(1, 2)) / n - mu * mu
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


def _fit_gate(res: ransac.RansacResult, min_inliers, max_step) -> torch.Tensor:
    """[B] seed gates of a batch of fits (thresholds per row: tensors or
    numbers); each row's translation norm on its own, as one fit's."""
    T = res.transform
    step = torch.stack([torch.linalg.norm(t[:3, 3]) for t in T])
    return (res.ok & (res.num_inliers >= min_inliers) & (res.error < 0.008)
            & torch.isfinite(T).flatten(1).all(1) & (step < max_step))


def _kp_seeds(tracks, pair, time: int, pose0, obj: ObjectSlots, cfg: EngineConfig, gen):
    """Per-model keypoint pose seeds (Model::getLastTrackTransform): RANSAC
    (K21) over each model's tracks of the last pair, the 1 + S fits in one
    batch, each with its own draw in model order; [M, 4, 4] seeds and [M]
    gates. Seeds compose as pose @ T_rel for every model."""
    p0, p1, valid = pair
    dev = p0.device
    m = 1 + obj.num_slots
    u = ransac.draw_uniforms(gen, m, cfg.ransac.iterations, dev)
    models = torch.arange(m, dtype=I32, device=dev)
    sel = valid[None] & (tracks.model_id[None] == models[:, None])
    res = ransac.ransac_fit_batch(u, p0, p1, sel, cfg.ransac)
    camera = models == 0  # the camera's gate: 24 inliers, 3 cm; the objects': 12, 5 cm
    good = _fit_gate(res, torch.where(camera, 24, 12), torch.where(camera, 0.03, 0.05))
    T_rel = torch.where(good[:, None, None], res.transform, torch.eye(4, dtype=F32, device=dev))
    poses = torch.cat([pose0[None], obj.pose], dim=0)
    return torch.stack([poses[k] @ T_rel[k] for k in range(m)]), good


def _redetect(obj: ObjectSlots, kps, kp_p3d, in_seg, cfg: EngineConfig, gen):
    """Re-attach STORED models to the new segment (Model::getBestMatch):
    descriptor match (K20) + RANSAC (K21) per slot, then a refit on the points
    within 1 cm. Returns (ok [S], err [S], T [S, 4, 4])."""
    dev = kp_p3d.device
    oks, errs, Ts = [], [], []
    for k in range(obj.num_slots):
        match_idx, _ = tracker.mutual_match(kps.desc, obj.stored_desc[k].contiguous(), in_seg,
                                            obj.stored_valid[k].contiguous(),
                                            cfg.keypoints.patch_gate)
        matched = match_idx >= 0
        pm = obj.stored_p3d[k][torch.clamp(match_idx, min=0).long()].contiguous()
        u = torch.rand((REDETECT_RANSAC.iterations, 3), generator=gen, device=dev)
        res = ransac.ransac_fit(u, pm, kp_p3d, matched, REDETECT_RANSAC)
        d = ransac.residual_norms(res.transform, pm, kp_p3d)
        tight = matched & (d < 0.01)
        T2 = ransac.kabsch_fit(pm, kp_p3d, tight)
        use2 = tight.to(I32).sum() >= 4
        T = torch.where(use2, T2, res.transform)
        dn = ransac.residual_norms(T, pm, kp_p3d)
        err = torch.sum(torch.where(tight, dn, torch.zeros_like(dn))) / torch.clamp(
            tight.to(F32).sum(), min=1.0)
        err = torch.where(use2, err, res.error)
        oks.append(res.ok & (res.num_inliers > 5) & (err < 0.01) & torch.isfinite(T).all())
        errs.append(err)
        Ts.append(T)
    return torch.stack(oks), torch.stack(errs), torch.stack(Ts)


def _snapshot_tracks(obj: ObjectSlots, tracks, poses):
    """Per-slot redetection snapshots from the track table (Model::store):
    the slot's tracks with depth at their last sighting, in model frame."""
    S = obj.num_slots
    ks = obj.stored_desc.shape[1]
    dev = poses.device
    cap = tracks.capacity
    s_last = torch.remainder(tracks.last_seen, tracks.history).long()
    rows = torch.arange(cap, device=dev)
    p_cam = tracks.p3d[rows, s_last]  # [T, 3]
    hasd = tracks.has_depth[rows, s_last]
    slot_ids = torch.arange(1, S + 1, dtype=I32, device=dev)[:, None]
    valid = tracks.active[None] & (tracks.model_id[None] == slot_ids) & hasd[None]  # [S, T]
    pm = torch.einsum("sij,tj->sti", poses[:, :3, :3], p_cam) + poses[:, None, :3, 3]
    rank = torch.cumsum(valid.to(I32), dim=1) - 1
    dest = torch.where(valid & (rank < ks), rank, torch.full_like(rank, ks)).long()
    d = tracks.desc.shape[1]
    d_out = torch.zeros((S, ks + 1, d), dtype=F32, device=dev)
    d_out.scatter_(1, dest[..., None].expand(S, cap, d), tracks.desc[None].expand(S, cap, d))
    p_out = torch.zeros((S, ks + 1, 3), dtype=F32, device=dev)
    p_out.scatter_(1, dest[..., None].expand(S, cap, 3), pm)
    v_out = torch.zeros((S, ks + 1), dtype=torch.bool, device=dev)
    v_out.scatter_(1, dest, valid)
    return d_out[:, :ks], p_out[:, :ks], v_out[:, :ks]


def _use_segm_tracker(cfg: EngineConfig) -> bool:
    return cfg.odometry.segm_lvl != cfg.odometry.init_lvl


def _flow_crf_mode(cfg: EngineConfig) -> bool:
    """Every mode but "precomputed" and "crf" (the legacy step) runs the flow-CRF."""
    return cfg.segmentation.mode not in ("precomputed", "crf")


def crf_camera(cam: CameraModel, scale: float) -> CameraModel:
    """The camera of the CRF grid."""
    return CameraModel(width=int(cam.width * scale), height=int(cam.height * scale),
                       fx=cam.fx * scale, fy=cam.fy * scale, cx=cam.cx * scale,
                       cy=cam.cy * scale)


def _track_velocities(pair, poses_prev, poses_new, cam: CameraModel, fps: float = tracker.FPS):
    """[M, T] px/s velocity error of each track of the last pair under each
    model's motion (the PIXEL_S metric of Segmentation.cpp:979-1007): the
    start point carried by the model's motion, projected, against the
    observed end pixel. Plain PyTorch on [M, T]."""
    p0, p1, _ = pair
    g = torch.einsum("mij,tj->mti", poses_prev[:, :3, :3], p0) + poses_prev[:, None, :3, 3]
    Tinv = se3.inverse_T(poses_new)
    pc = torch.einsum("mij,mtj->mti", Tinv[:, :3, :3], g) + Tinv[:, None, :3, 3]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = pc[..., 0] * cam.fx / z + cam.cx
    v = pc[..., 1] * cam.fy / z + cam.cy
    z1 = torch.clamp(p1[:, 2], min=1e-6)
    u1 = p1[:, 0] * cam.fx / z1 + cam.cx
    v1 = p1[:, 1] * cam.fy / z1 + cam.cy
    return torch.sqrt((u - u1) ** 2 + (v - v1) ** 2) * fps


def _associate_tracks(table, mask, time: int, h: int, w: int) -> None:
    """Each track seen THIS frame takes the mask label under its keypoint (in place)."""
    s1 = time % table.history
    txy = table.xy[:, s1]
    xi = torch.clamp(torch.round(txy[:, 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(txy[:, 1]).to(torch.int64), 0, h - 1)
    seen_now = table.last_seen == time
    table.model_id.copy_(torch.where(seen_now, mask[yi, xi], table.model_id))


SegResult = flow_crf.SegmentationResult


class LifecycleOut(NamedTuple):
    mask: torch.Tensor
    spawn: torch.Tensor
    any_red: torch.Tensor
    target_slot: torch.Tensor
    refine_T: torch.Tensor
    fs_w: sm.FrameSurfels
    objects: ObjectSlots  # data and counts with the spawn written, poses and flags updated
    last_spawn: torch.Tensor
    claim: torch.Tensor  # [] bool: a spawn or a redetection claimed ``target_slot``
    new_maxd: torch.Tensor  # [] the claimed slot's max depth


def _lifecycle_update(obj: ObjectSlots, seg: SegResult, tracks, kps, depth_m, depth_filt, rgb_u8,
                      new_pose0, prev_pose, obj_poses_new, time: int, last_spawn,
                      weight_multiplier, seg_conf_sum, seg_conf_cnt, reactivate, new_ext_id,
                      cam: CameraModel, cfg: EngineConfig, gen, tracks_segm=None) -> LifecycleOut:
    """Redetect / spawn / deactivate / store (reference MultiMotionFusion.cpp:
    468-613, Model::store gates :962-981), every branch on the device. The
    track labels of ``tracks`` (and of the segm_lvl table ``tracks_segm``,
    when given) are updated in place."""
    scfg = cfg.surfels
    S = obj.num_slots
    h, w = cam.height, cam.width
    dev = depth_filt.device
    allow_new = cfg.enable_model_spawning and cfg.object_slots > 0
    inf = torch.full((S,), float("inf"), dtype=F32, device=dev)
    slots = torch.arange(S, dtype=I32, device=dev)

    # ---- redetection (computed only where the configuration enables it: its
    # result is masked by the flag anyway)
    if cfg.enable_redetection and allow_new:
        kp_p3d, kp_hasd = tracker.backproject_keypoints(kps, depth_filt, cam)
        kxi = torch.clamp(torch.round(kps.xy[:, 0]).to(torch.int64), 0, w - 1)
        kyi = torch.clamp(torch.round(kps.xy[:, 1]).to(torch.int64), 0, h - 1)
        in_seg = seg.new_label_mask[kyi, kxi] & kps.valid & kp_hasd
        red_ok, red_err, red_T = _redetect(obj, kps, kp_p3d, in_seg, cfg, gen)
        red_ok = red_ok & obj.stored & ~obj.active & seg.has_new_label
    else:
        red_ok = torch.zeros((S,), dtype=torch.bool, device=dev)
        red_err, red_T = inf, _eye(S, dev)
    any_red = red_ok.any()
    red_slot = torch.argmin(torch.where(red_ok, red_err, inf))

    # ---- spawn decision
    slot_score = obj.active.to(I32) * 2 + (obj.stored & ~obj.active).to(I32)
    free_slot = torch.argmin(slot_score)
    any_free = ~obj.active.all()
    cooled = (last_spawn == 0) | (time - last_spawn >= cfg.model_spawn_offset)
    spawn = seg.has_new_label & any_free & cooled & ~any_red
    if not allow_new:
        spawn = spawn & False
    target_slot = torch.where(any_red, red_slot, free_slot).to(I32)
    claim = spawn | any_red
    new_id = target_slot + 1
    outlier_id = torch.full_like(seg.mask, S + 1)
    mask = torch.where(seg.new_label_mask, torch.where(claim, new_id.expand_as(seg.mask), outlier_id),
                       seg.mask)

    cutoff = torch.full((), scfg.depth_cutoff, dtype=F32, device=dev)
    seg_maxd = torch.minimum(seg.depth_mean + 1.2 * seg.depth_std, cutoff)
    slot_maxd = seg_maxd[1:1 + S]
    new_band = torch.clamp(1.2 * seg.depth_std[1 + S], min=0.05)
    new_maxd = torch.minimum(seg.depth_mean[1 + S] + new_band, cutoff)
    new_mind = torch.clamp(seg.depth_mean[1 + S] - new_band, min=0.0)

    # ---- track <-> segment association (in place)
    _associate_tracks(tracks, mask, time, h, w)
    if tracks_segm is not None:
        _associate_tracks(tracks_segm, mask, time, h, w)

    # ---- back-date the new object's trajectory (selected by `spawn`)
    refine_len = min(8, tracks.history - 2)
    refine_T = tracker.refine_track_subset(tracks, tracks.model_id == new_id, time, refine_len,
                                           gen, cfg.ransac)
    refine_T = torch.where(spawn, refine_T, _eye(refine_len, dev))

    # ---- spawn: the claimed slot's map from the new label's pixels
    diff = new_pose0 @ se3.inverse_T(prev_pose)
    motion = torch.maximum(torch.linalg.norm(diff[:3, 3]), torch.linalg.norm(se3.so3_log(diff[:3, :3])))
    weighting = torch.clamp(1.0 - torch.clamp(motion, max=0.01) / 0.01, min=0.5) * float(
        weight_multiplier)
    fs_w = frame_maps.frame_surfels(rgb_u8, depth_m, depth_filt, cam, time, scfg.depth_cutoff,
                                    weighting)
    spawn_conf_scale = 100.0 / torch.clamp(weighting, min=1e-6)
    pz = fs_w.data[sm.PZ]
    spawn_valid = (fs_w.valid & (mask == new_id).reshape(-1) & spawn & (pz <= new_maxd)
                   & (pz >= new_mind))
    sdat = torch.where(spawn_valid[None], fs_w.data, torch.zeros_like(fs_w.data))
    sdat = torch.cat([sdat[:sm.CONF], sdat[sm.CONF:sm.CONF + 1] * spawn_conf_scale,
                      sdat[sm.CONF + 1:]], dim=0)
    spawn_map = sm.init_from_frame(sm.FrameSurfels(sdat, spawn_valid), cfg.object_capacity)
    is_spawn_slot = (slots == target_slot) & spawn
    is_red_slot = (slots == target_slot) & any_red
    claimed = is_spawn_slot | is_red_slot
    obj_data = torch.where(is_spawn_slot[:, None, None], spawn_map.data[None], obj.data)
    obj_count = torch.where(is_spawn_slot, spawn_map.count, obj.count)
    obj_active = obj.active | claimed | reactivate
    obj_stored = obj.stored & ~claimed
    obj_ext_id = torch.where(claimed, new_ext_id, obj.ext_id)
    obj_pose = torch.where(is_spawn_slot[:, None, None], _eye(S, dev),
                           torch.where(is_red_slot[:, None, None],
                                       red_T.index_select(0, red_slot.reshape(1)),
                                       obj_poses_new))
    obj_spawn_tick = torch.where(claimed, torch.full_like(obj.spawn_tick, time), obj.spawn_tick)
    avg_conf = seg_conf_sum / torch.clamp(seg_conf_cnt, min=1.0)
    conf_t = torch.where(obj.active & (seg_conf_cnt > 0),
                         torch.clamp(torch.maximum(obj.conf_t, avg_conf), max=9.0), obj.conf_t)
    conf_t = torch.where(claimed, torch.full_like(conf_t, scfg.object_conf_threshold), conf_t)
    slot_px = seg.pixel_counts[1:1 + S]
    max_depth = torch.where(obj.active & (slot_px > 0),
                            torch.minimum(slot_maxd, obj.max_depth + 0.05), obj.max_depth)
    max_depth = torch.where(reactivate, slot_maxd, max_depth)
    max_depth = torch.where(claimed, new_maxd.expand_as(max_depth), max_depth)

    # ---- lost models (zero segment pixels)
    unseen = torch.where(obj_active & (slot_px == 0) & ~claimed, obj.unseen + 1,
                         torch.zeros_like(obj.unseen))
    was_active = obj_active
    obj_active = obj_active & (unseen < cfg.model_unseen_patience)
    dying = was_active & ~obj_active

    # ---- store dying models that pass the keep gates (>= 500 surfels, conf > 0.3)
    alive_d = obj_data[:, sm.ALIVE] > 0
    alive_cnt = alive_d.to(I32).sum(dim=1)
    mean_conf = torch.sum(torch.where(alive_d, obj_data[:, sm.CONF], torch.zeros_like(
        obj_data[:, sm.CONF])), dim=1) / torch.clamp(alive_cnt.to(F32), min=1.0)
    store_it = dying & (alive_cnt >= cfg.min_inactive_surfels) & (mean_conf > 0.3)
    snap_d, snap_p, snap_v = _snapshot_tracks(obj, tracks, obj_pose)
    objects = ObjectSlots(
        data=obj_data, count=obj_count, pose=obj_pose, active=obj_active, unseen=unseen,
        spawn_tick=obj_spawn_tick, conf_t=conf_t, max_depth=max_depth,
        stored=obj_stored | store_it,
        stored_desc=torch.where(store_it[:, None, None], snap_d, obj.stored_desc),
        stored_p3d=torch.where(store_it[:, None, None], snap_p, obj.stored_p3d),
        stored_valid=torch.where(store_it[:, None], snap_v, obj.stored_valid),
        ext_id=obj_ext_id,
    )
    last = torch.where(claim, torch.full_like(last_spawn, time), last_spawn)
    return LifecycleOut(mask, spawn, any_red, target_slot, refine_T, fs_w, objects, last, claim,
                        new_maxd)


def _flow_crf(state: MultiState, intensity, depth_filt, new_pose0, obj_poses_new, active_all,
              tseg, segm_pair, time: int, layout: rasterize.FlatLayout, cam: CameraModel,
              cfg: EngineConfig) -> SegResult:
    """The flow-CRF segmentation of the frame (reference engine_multi.py:
    933-987): every model's depth on the CRF grid from the PRE-spawn stores
    at the new poses and last frame's max depths (K13, no confidence gate),
    then ``flow_crf.flow_crf_segmentation`` against the previous frame's
    intensity, with the velocities of ``tseg``'s last pair ``segm_pair`` (the
    segm_lvl tracker's, or the init_lvl one's when the levels agree)."""
    scfg, seg_cfg = cfg.surfels, cfg.segmentation
    obj = state.objects
    dev = depth_filt.device
    one = torch.ones((1,), dtype=F32, device=dev)
    poses_new = torch.cat([new_pose0[None], obj_poses_new], dim=0)
    with _span("render_depths"):  # K13
        stores = rasterize.DepthStores(
            state.smap.data, obj.data, torch.cat([state.smap.count[None], obj.count]),
            layout.bg, layout.bo, _RMD_GLOBAL_STRIDE, _RMD_OBJECT_STRIDE)
        pred_c = rasterize.render_depths(
            stores, se3.inverse_T(poses_new).contiguous(),
            torch.cat([one * scfg.depth_cutoff, obj.max_depth]),
            torch.zeros((layout.n_models,), dtype=F32, device=dev),
            crf_camera(cam, seg_cfg.scale), time, scfg.time_delta)
    poses_prev = torch.cat([state.pose[None], obj.pose], dim=0)
    vel = _track_velocities(segm_pair, poses_prev, poses_new, cam).contiguous()
    txy = tseg.xy[:, time % tseg.history].contiguous()
    allow_new = cfg.enable_model_spawning and cfg.object_slots > 0
    return flow_crf.flow_crf_segmentation(
        state.prev_intensity, intensity, depth_filt, pred_c, active_all, txy, vel,
        segm_pair[2], seg_cfg, allow_new, span=_span)


def multi_frame_step(state: MultiState, rgb_u8, depth_raw, ext_mask, time: int,
                     weight_multiplier, cam: CameraModel, cfg: EngineConfig,
                     layout: rasterize.FlatLayout, sp_net=None, gen=None):
    """One multi-model frame (tick > 1). ``layout`` holds the global and the
    object work buckets. Returns (state, stats [9 + M] on the device, final
    mask, SpawnAux, odometry result). Writes the global map's bucket and the
    track table in place. The legacy CRF mode ("crf") takes the per-slot
    step (reference engine_multi.py:751-753)."""
    if cfg.segmentation.mode == "crf":
        return _multi_frame_step_legacy(state, rgb_u8, depth_raw, time, weight_multiplier, cam,
                                        cfg, layout.bg, sp_net, gen)
    scfg = cfg.surfels
    obj = state.objects
    S = obj.num_slots
    M = 1 + S
    h, w = cam.height, cam.width
    dev = depth_raw.device
    odo_cfg = dataclasses.replace(cfg.odometry, mask_icp=False)

    with _span("frame_inputs"):  # K1
        depth_m, depth_filt = frame_maps.frame_depth(depth_raw)
    with _span("levels"):  # K2 and K11's owner prep
        frame_lv = lv.frame_levels(depth_filt, rgb_u8, state.prev_mask, cam, odo_cfg)
        preds = lv.pred_levels(state.filled.vertex_conf, state.filled.normal_rad,
                               state.filled.color, cam, odo_cfg)
        mls = modo.owner_levels(state.prev_mask, state.pred_own, frame_lv,
                                lv.gn_levels(frame_lv, preds, cam, odo_cfg), odo_cfg, M)

    with _span("sparse"):  # K19, K20, K21
        tracks = state.tracks
        kps = _detect(frame_lv[cfg.odometry.init_lvl].img, cfg, sp_net)
        pair = tracker.update(tracks, kps, depth_filt, time, cam, cfg.keypoints)
        tracks_segm, segm_pair = state.tracks_segm, pair
        if _use_segm_tracker(cfg):  # only the segmentation's velocities read it
            lvl = cfg.odometry.segm_lvl
            segm_pair = tracker.update(tracks_segm, _detect(frame_lv[lvl].img, cfg, sp_net, lvl),
                                       depth_filt, time, cam, cfg.keypoints)
        T_init = seed_ok = None
        if cfg.odom_init == "kp":
            T_init, seed_ok = _kp_seeds(tracks, pair, time, state.pose, obj, cfg, gen)

    with _span("odometry"):  # K3, K11 and K5's M-wide steps
        T_prev = torch.cat([state.pose[None], obj.pose], dim=0)
        active_all = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), obj.active])
        odo = modo.multi_track(T_prev, mls, state.last_intensity_coarse, odo_cfg, cam, M,
                               T_init, seed_ok, active_all)
        new_pose0, obj_poses_new = odo.poses[0], odo.poses[1:]

    bad_count, lost = state.bad_track_count, state.lost
    if cfg.reloc_mode or cfg.close_loops:  # the global model's (engine_multi.py:834-873)
        with _span("ferns"):  # K22: the ÷factor frame
            frame_s = _fern_frame(rgb_u8, depth_filt, cfg)
        new_pose0, bad_count, lost = global_consistency(state, frame_s, odo.A[0],
                                                        odo.icp_count[0], new_pose0, time, cfg)

    with _span("segmentation"):
        reactivate = torch.zeros((S,), dtype=torch.bool, device=dev)
        new_ext_id = torch.zeros((), dtype=I32, device=dev)
        if _flow_crf_mode(cfg):
            seg = _flow_crf(state, frame_lv[0].img, depth_filt, new_pose0, obj_poses_new,
                            active_all, tracks_segm if _use_segm_tracker(cfg) else tracks,
                            segm_pair, time, layout, cam, cfg)
        else:
            pres = precomputed_segmentation(ext_mask, obj.ext_id, obj.active, depth_filt,
                                            cfg.segmentation.min_mask_size_px)
            mu, sd = _depth_stats(pres.mask, pres.new_label_mask, depth_filt, M)
            seg = SegResult(pres.mask, pres.new_label_mask, pres.has_new_label,
                            pres.pixel_counts, mu, sd)
            reactivate, new_ext_id = pres.reactivate, pres.new_ext_id

    with _span("lifecycle"):
        ks = torch.arange(1, S + 1, dtype=I32, device=dev)[:, None, None]
        sel = (seg.mask[None] == ks) & (state.prev_mask[None] == ks)
        conf_img = state.filled.vertex_conf[..., 3]
        seg_conf_sum = torch.sum(torch.where(sel, conf_img[None], torch.zeros_like(conf_img)[None]),
                                 dim=(1, 2))
        seg_conf_cnt = torch.sum(sel.to(F32), dim=(1, 2))
        lc = _lifecycle_update(obj, seg, tracks, kps, depth_m, depth_filt, rgb_u8, new_pose0,
                               state.prev_pose, obj_poses_new, time, state.last_spawn,
                               weight_multiplier, seg_conf_sum, seg_conf_cnt, reactivate,
                               new_ext_id, cam, cfg, gen,
                               tracks_segm if _use_segm_tracker(cfg) else None)
        objs = lc.objects

    Bg, Bo = layout.bg, layout.bo
    one = torch.ones((1,), dtype=F32, device=dev)
    poses_all = torch.cat([new_pose0[None], objs.pose], dim=0)
    maxd_all = torch.cat([one * scfg.depth_cutoff, objs.max_depth])
    conf_all = torch.cat([one * scfg.conf_threshold, objs.conf_t])
    active_all2 = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), objs.active])
    counts_all = torch.cat([state.smap.count[None], objs.count])
    with _span("zbuffer"):  # K12 over the flat store
        store = torch.cat([state.smap.data[:, :Bg],
                           objs.data[:, :, :Bo].permute(1, 0, 2).reshape(sm.CHANNELS, S * Bo)],
                          dim=1)
        index, data_local, win = rasterize.zbuffer_flat(
            store, counts_all, layout, se3.inverse_T(poses_all).contiguous(), maxd_all, cam,
            time, scfg.time_delta)
        im = rasterize.IndexMap(index, data_local)
    with _span("fuse"):  # K14
        fused, counts_new = fusion.fuse_flat(store, counts_all, layout, lc.fs_w, im, lc.mask, win,
                                             poses_all.contiguous(), maxd_all, active_all2, cam,
                                             time, scfg)
    with _span("clean"):  # K14, then K9 over every segment on compaction frames
        cleaned = fusion.clean_flat(fused, counts_new, layout, im, win, depth_filt, conf_all, cam,
                                    time, scfg.time_delta, scfg)
        gdata, odata = cleaned[:, :Bg], cleaned[:, Bg:].reshape(sm.CHANNELS, S, Bo)
        if cfg.reloc_mode:  # the global model's fusion is skipped while lost
            gdata = torch.where(lost, state.smap.data[:, :Bg], gdata)
            counts_new = torch.cat([torch.where(lost, state.smap.count, counts_new[0])[None],
                                    counts_new[1:]])
        # back into the stores, in place (objs.data is this frame's own tensor):
        # on compaction frames every segment repacked into them (one launch)
        if _compact_pred(time, scfg):
            counts_new = sm.compact_segments(gdata, odata, counts_new, state.smap.data[:, :Bg],
                                             objs.data[:, :, :Bo])
        else:
            state.smap.data[:, :Bg] = gdata
            objs.data[:, :, :Bo] = odata.permute(1, 0, 2)
        smap = sm.SurfelMap(data=state.smap.data, count=counts_new[0])
        objs = objs._replace(count=counts_new[1:].contiguous())

    with _span("splat_resolve"):  # K10 (composite) + fill-in of the global pixels
        fill = rasterize.FillFrame(rgb_u8, depth_filt, lc.fs_w.data, scfg.depth_cutoff,
                                   cfg.frame_to_frame_rgb, gate=lc.mask)
        filled = splat_fill(im, cam, 0.0, time, time, scfg.time_delta, scfg.splat_footprint,
                            fill, rasterize.Composite(conf_all, win))

    stats = torch.cat([
        torch.stack([odo.icp_error[0], odo.icp_count[0], odo.rgb_error[0], odo.rgb_count[0],
                     smap.alive_count().to(F32), smap.count.to(F32), lc.spawn.to(F32),
                     objs.active.to(F32).sum(), lost.to(F32)]),
        seg.pixel_counts.to(F32),
    ])
    new_state = MultiState(
        smap=smap, pose=new_pose0, prev_pose=state.pose, filled=filled, pred_own=win,
        last_intensity_coarse=frame_lv[cfg.odometry.num_pyr - 1].img, tracks=tracks,
        tracks_segm=tracks_segm, objects=objs, prev_mask=lc.mask, prev_intensity=frame_lv[0].img,
        last_spawn=lc.last_spawn, ferns=state.ferns, bad_track_count=bad_count, lost=lost,
        pose_matches=state.pose_matches,
    )
    aux = SpawnAux(lc.spawn, lc.any_red, lc.target_slot, lc.refine_T)
    return new_state, stats, lc.mask, aux, odo


def _multi_frame_step_legacy(state: MultiState, rgb_u8, depth_raw, time: int, weight_multiplier,
                             cam: CameraModel, cfg: EngineConfig, bucket_fuse: int, sp_net=None,
                             gen=None):
    """The per-slot multi-model step of the legacy CoFusion CRF (reference
    engine_multi.py:1195-1531): the CRF reads every model's ICP error image
    over the whole frame. Same returns as ``multi_frame_step``; the odometry
    result is the global model's. Each slot's prediction at its previous pose
    is rendered in the step (the state carries no per-slot images); every
    slot scalar (confidence gate, max depth, count) is read on the card."""
    scfg = cfg.surfels
    ocfg = cfg.odometry
    obj = state.objects
    S = obj.num_slots
    M = 1 + S
    dev = depth_raw.device
    ticks = time - 1  # the previous frame's render window

    with _span("frame_inputs"):  # K1
        depth_m, depth_filt = frame_maps.frame_depth(depth_raw)
    with _span("levels"):  # K2: the frame side of the global model (mask id 0)
        frame_lv = lv.frame_levels(depth_filt, rgb_u8, state.prev_mask, cam, ocfg)
        preds0 = lv.pred_levels(state.filled.vertex_conf, state.filled.normal_rad,
                                state.filled.color, cam, ocfg)

    with _span("sparse"):  # K19, K20, K21
        tracks = state.tracks
        kps = _detect(frame_lv[ocfg.init_lvl].img, cfg, sp_net)
        pair = tracker.update(tracks, kps, depth_filt, time, cam, cfg.keypoints)
        tracks_segm = state.tracks_segm
        if _use_segm_tracker(cfg):  # the legacy CRF reads no velocities; the table advances
            lvl = ocfg.segm_lvl
            tracker.update(tracks_segm, _detect(frame_lv[lvl].img, cfg, sp_net, lvl), depth_filt,
                           time, cam, cfg.keypoints)
        if cfg.odom_init == "kp":
            seeds, seed_ok = _kp_seeds(tracks, pair, time, state.pose, obj, cfg, gen)
        else:
            seeds = torch.cat([state.pose[None], obj.pose], dim=0)
            seed_ok = torch.zeros((M,), dtype=torch.bool, device=dev)

    with _span("slot_predictions"):  # K6 + K10 per slot at its previous pose
        opred = [rasterize.splat_predict(sm.SurfelMap(obj.data[k], obj.count[k]), obj.pose[k],
                                         cam, obj.conf_t[k], ticks, ticks, scfg.time_delta,
                                         obj.max_depth[k], scfg.splat_footprint)
                 for k in range(S)]

    with _span("odometry"):  # K3-K5: the global model, then each slot (mask id k + 1)
        odo0 = rgbd.track(state.pose, lv.gn_levels(frame_lv, preds0, cam, ocfg),
                          state.last_intensity_coarse, ocfg, cam,
                          T_init=seeds[0] if cfg.odom_init == "kp" else None,
                          seed_valid=seed_ok[0] if cfg.odom_init == "kp" else None)
        new_pose0 = odo0.pose
        obj_poses, icp_imgs = [], [odo0.icp_error_image]
        for k in range(S):
            flv = lv.frame_levels(depth_filt, rgb_u8, state.prev_mask, cam, ocfg, k + 1)
            pk = opred[k]
            preds = lv.pred_levels(pk.vertex_conf, pk.normal_rad, pk.color, cam, ocfg)
            odo = rgbd.track(obj.pose[k], lv.gn_levels(flv, preds, cam, ocfg),
                             state.last_intensity_coarse, ocfg, cam, T_init=seeds[k + 1],
                             seed_valid=seed_ok[k + 1])
            obj_poses.append(odo.pose)
            icp_imgs.append(odo.icp_error_image)
        obj_poses_new = torch.where(obj.active[:, None, None], torch.stack(obj_poses), obj.pose)

    bad_count, lost = state.bad_track_count, state.lost
    if cfg.reloc_mode:  # the legacy step relocalises; it does not close loops
        with _span("ferns"):  # K22: the ÷factor frame
            frame_s = _fern_frame(rgb_u8, depth_filt, cfg)
        new_pose0, bad_count, lost = global_consistency(
            state, frame_s, odo0.A, odo0.icp_count, new_pose0, time,
            dataclasses.replace(cfg, close_loops=False))

    with _span("slot_indices"):  # K6 per slot at its new pose
        oim = [rasterize.predict_indices(sm.SurfelMap(obj.data[k], obj.count[k]),
                                         obj_poses_new[k], cam, time, scfg.time_delta,
                                         obj.max_depth[k]) for k in range(S)]

    with _span("segmentation"):  # K24a-c, K17
        active_all = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), obj.active])
        conf_imgs = torch.stack([state.filled.vertex_conf[..., 3]]
                                + [p.vertex_conf[..., 3] for p in opred])
        allow_new = cfg.enable_model_spawning and cfg.object_slots > 0
        lres = legacy_crf.legacy_crf_segmentation(
            rgb_u8.to(F32), depth_filt, torch.stack(icp_imgs), conf_imgs, active_all,
            cfg.segmentation, allow_new=allow_new)
        mu, sd = _depth_stats(lres.mask, lres.new_label_mask, depth_filt, M)
        seg = SegResult(lres.mask, lres.new_label_mask, lres.has_new_label, lres.pixel_counts,
                        mu, sd)

    with _span("lifecycle"):
        # the confidence maturation reads each slot's own prediction
        ks = torch.arange(1, S + 1, dtype=I32, device=dev)[:, None, None]
        sel = seg.mask[None] == ks
        seg_conf_sum = torch.sum(torch.where(sel, conf_imgs[1:], torch.zeros_like(conf_imgs[1:])),
                                 dim=(1, 2))
        seg_conf_cnt = torch.sum(sel.to(F32), dim=(1, 2))
        lc = _lifecycle_update(obj, seg, tracks, kps, depth_m, depth_filt, rgb_u8, new_pose0,
                               state.prev_pose, obj_poses_new, time, state.last_spawn,
                               weight_multiplier, seg_conf_sum, seg_conf_cnt,
                               torch.zeros((S,), dtype=torch.bool, device=dev),
                               torch.zeros((), dtype=I32, device=dev), cam, cfg, gen,
                               tracks_segm if _use_segm_tracker(cfg) else None)
        objs = lc.objects
        # the claimed slot's index map again from its new map (the reference's
        # lax.cond, computed every frame and selected)
        t = lc.target_slot.reshape(1)
        re_im = rasterize.predict_indices(
            sm.SurfelMap(objs.data.index_select(0, t)[0], objs.count.index_select(0, t)[0]),
            objs.pose.index_select(0, t)[0], cam, time, scfg.time_delta, lc.new_maxd)
        slots = torch.arange(S, dtype=I32, device=dev)
        is_claim = (slots == lc.target_slot) & lc.claim
        oim = [rasterize.IndexMap(torch.where(is_claim[k], re_im.index, im.index),
                                  torch.where(is_claim[k], re_im.data_local, im.data_local))
               for k, im in enumerate(oim)]

    sub = state.smap.bucketed(bucket_fuse)
    with _span("zbuffer"):  # K6: the global model's index map at its new pose
        im0 = rasterize.predict_indices(sub, new_pose0, cam, time, scfg.time_delta,
                                        scfg.depth_cutoff)
    with _span("fuse"):  # K8: the global model (mask id 0)
        fused0 = fusion.fuse(sub, lc.fs_w, im0, lc.mask, 0, new_pose0, cam, time, scfg)
    with _span("clean"):  # K7, K9: written straight into the global map's bucket
        cleaned0 = fusion.clean(
            fused0, im0, depth_filt, lc.mask, 0, cam, time, scfg.time_delta, scfg.conf_threshold,
            scfg, compact=_compact_pred(time, scfg), out=state.smap.data[:, :bucket_fuse],
            skip=lost if cfg.reloc_mode else None)
        count0 = torch.where(lost, sub.count, cleaned0.count) if cfg.reloc_mode else \
            cleaned0.count
        smap = sm.SurfelMap(data=state.smap.data, count=count0)
    with _span("splat_resolve"):  # K10 + fill-in from the pre-fusion index map
        filled = splat_fill(im0, cam, scfg.conf_threshold, time, time, scfg.time_delta,
                            scfg.splat_footprint,
                            rasterize.FillFrame(rgb_u8, depth_filt, lc.fs_w.data,
                                                scfg.depth_cutoff, cfg.frame_to_frame_rgb))

    with _span("slot_fusion"):  # K8, K9 per slot, its confidence gate and depth band
        pz = lc.fs_w.data[sm.PZ]
        odata, ocount = [], []
        for k in range(S):
            omap = sm.SurfelMap(objs.data[k], objs.count[k])
            fs_k = sm.FrameSurfels(lc.fs_w.data, lc.fs_w.valid & (pz <= objs.max_depth[k]))
            fused = fusion.fuse(omap, fs_k, oim[k], lc.mask, k + 1, objs.pose[k], cam, time, scfg)
            compact = _compact_pred(time, scfg)  # a flag frame cleans K8's fresh map in place
            cleaned = fusion.clean(fused, oim[k], depth_filt, lc.mask, k + 1, cam, time,
                                   scfg.time_delta, objs.conf_t[k], scfg, compact=compact,
                                   out=None if compact else fused.data)
            odata.append(torch.where(objs.active[k], cleaned.data, omap.data))
            ocount.append(torch.where(objs.active[k], cleaned.count, omap.count))
        objs = objs._replace(data=torch.stack(odata), count=torch.stack(ocount))

    stats = torch.cat([
        torch.stack([odo0.icp_error, odo0.icp_count, odo0.rgb_error, odo0.rgb_count,
                     smap.alive_count().to(F32), smap.count.to(F32), lc.spawn.to(F32),
                     objs.active.to(F32).sum(), lost.to(F32)]),
        seg.pixel_counts.to(F32),
    ])
    new_state = MultiState(
        smap=smap, pose=new_pose0, prev_pose=state.pose, filled=filled,
        pred_own=torch.zeros_like(state.pred_own),  # unused by the legacy step
        last_intensity_coarse=frame_lv[ocfg.num_pyr - 1].img, tracks=tracks,
        tracks_segm=tracks_segm, objects=objs, prev_mask=lc.mask, prev_intensity=frame_lv[0].img,
        last_spawn=lc.last_spawn, ferns=state.ferns, bad_track_count=bad_count, lost=lost,
        pose_matches=state.pose_matches,
    )
    aux = SpawnAux(lc.spawn, lc.any_red, lc.target_slot, lc.refine_T)
    return new_state, stats, lc.mask, aux, odo0
