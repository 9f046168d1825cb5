"""Top-level engine: the static (ElasticFusion-style) per-frame SLAM step,
and the multi-model step.

Port of the reference package's ``engine.py`` for ``enable_multi_model=False``
with every pose initialisation (``odom_init``), and for
``enable_multi_model=True`` with the flow-CRF segmentation (the default
``segmentation.mode``) or external masks (``mode="precomputed"``)
(``engine_multi.multi_frame_step``; ``odom_init`` "kp" or ""): upload ->
depth filter ->
(first frame) initialise -> [keypoints -> track table -> RANSAC seed] ->
track -> fuse -> clean -> predict -> pose logging.

- ``odom_init="kp"`` (the default): each frame detects keypoints on the
  ``init_lvl`` intensity (K19), matches them into the track table and forms
  the last pair (K20), fits the frame-to-frame motion by RANSAC (K21) with
  uniforms from the engine's own ``torch.Generator`` (seeded from
  ``cfg.seed``; it gives other numbers than the reference's PRNG), gates the
  fit and hands it to the odometry as a seed (``rgbd.track``'s ``T_init``);
- ``odom_init="tf"``: the ground-truth pose given to ``process_frame``
  replaces the pose before the step; with ``icp_refine=False`` the odometry
  is skipped;
- ``odom_init=""``: the odometry starts from the previous pose.

After the odometry, and before fusion, the camera model's global
consistency (both engines): with ``reloc_mode`` the lost detection, the fern
relocalisation and keyframe insertion (K22 with K2-K5 at the fern scale;
fusion is skipped while lost), with ``close_loops`` the fern loop closure
with the embedded deformation of the map (K22, K23; ``global_consistency``).

All state lives on the compute device, the poses, the track table and the
fern store included. On the card the frame step launches only the
hand-written kernels of ``csrc/`` (K1-K23) plus PyTorch glue on poses, 0-dim
scalars and (multi-model) per-model vectors and masks (and the deformation
graph's dense solve); the odometry's loops run on the card with done flags,
so a steady-state frame reads nothing back except, at most every 64 frames,
the map's high-water mark (``_buckets``; in multi-model mode also the
largest object count) and, with ``close_loops``, one flag a frame (whether
the fern match passed). The
multi-model engine logs each frame's object poses, active flags and spawn
records on the device and reads them only when asked (``drain_events``,
``export_poses``).
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel, EngineConfig
from multimotionfusion_tpu_torch.io.frame import FrameData
from multimotionfusion_tpu_torch.model import ferns, fusion, loop_closure, surfel_map as sm
from multimotionfusion_tpu_torch.model.fillin import FilledMaps, splat_fill
from multimotionfusion_tpu_torch.odometry import levels as lv
from multimotionfusion_tpu_torch.odometry import rgbd
from multimotionfusion_tpu_torch.ops import frame_maps, ransac
from multimotionfusion_tpu_torch.ops import rasterize
from multimotionfusion_tpu_torch.tracking import superpoint, tracker
from multimotionfusion_tpu_torch.utils import se3

F32 = torch.float32
# named ranges of the frame step for torch.profiler (chip_smoke.py's stage phase);
# they cost a few microseconds each when no profiler is running
_span = torch.profiler.record_function


class GlobalState(NamedTuple):
    """Single-model engine state (the reference package's GlobalState but its
    PRNG key), all on the device."""

    smap: sm.SurfelMap
    pose: torch.Tensor  # [4,4]
    prev_pose: torch.Tensor  # [4,4], pose one frame earlier
    filled: FilledMaps  # prediction for the next frame's tracking
    last_intensity_coarse: torch.Tensor  # previous frame coarse intensity
    tracks: Optional[tracker.TrackTable] = None  # keypoint tracks (odom_init="kp")
    # the fern keyframe store (zero capacity without reloc_mode / close_loops)
    ferns: Optional[ferns.FernDB] = None
    bad_track_count: Optional[torch.Tensor] = None  # [] int32 consecutive bad frames
    lost: Optional[torch.Tensor] = None  # [] bool: relocalisation engaged
    pose_matches: Optional[loop_closure.MatchLog] = None  # loop-closure records


def global_extras(cfg: EngineConfig, device) -> dict:
    """The fern store (empty; zero capacity unless ``reloc_mode`` or
    ``close_loops``), ``bad_track_count``, ``lost`` and the match log of a
    new state."""
    uses = cfg.reloc_mode or cfg.close_loops
    return dict(
        ferns=ferns.create(cfg.ferns, cfg.camera, None if uses else 0, cfg.seed, device),
        bad_track_count=torch.zeros((), dtype=torch.int32, device=device),
        lost=torch.zeros((), dtype=torch.bool, device=device),
        pose_matches=loop_closure.empty_log(device=device),
    )


class FrameStats(NamedTuple):
    odo: Optional[rgbd.OdometryResult]  # (engine_multi: the multi odometry's result)
    smap: sm.SurfelMap  # the map after the frame (alive count read on demand)
    seed_ok: Optional[torch.Tensor] = None  # 0-dim bool: the keypoint seed passed its gate
    multi: Optional[torch.Tensor] = None  # multi-model stats vector [9 + M] on the device


def _bucket_for(n: int, capacity: int, floor: int = 1 << 15) -> int:
    """Smallest work bucket >= n: powers of two up to 2^18, then x1.5 rungs."""
    b = floor
    while b < n and b < (1 << 18):
        b <<= 1
    while b < n:
        b += b >> 1
    return min(b, capacity)


class _BucketEstimator:
    """Work bucket from a (possibly stale) high-water mark, extrapolated by
    the measured growth rate (x4 margin, at least ``min_margin``) plus a fixed
    headroom; ``read()`` reads the mark from the device only when the
    estimate outgrows the bucket or every 64 frames; shrinks by whole rungs
    with 2x hysteresis. Appends beyond the bucket are dropped for those
    frames."""

    def __init__(self, capacity: int, headroom: int, min_margin: int, growth: int, floor: int,
                 read):
        self.capacity, self.headroom, self.min_margin = capacity, headroom, min_margin
        self.growth, self.floor, self.read = growth, floor, read
        self.hwm = self.hwm_tick = self.bucket = 0

    def reset(self, hwm: int, tick: int, bucket: int) -> None:
        self.hwm, self.hwm_tick, self.bucket = hwm, tick, bucket

    def _fit(self, n: int) -> int:
        return _bucket_for(n, self.capacity, self.floor)

    def __call__(self, tick: int, k_ahead: int) -> int:
        margin = max(4 * self.growth, self.min_margin)
        est = self.hwm + (tick + k_ahead - self.hwm_tick) * margin
        if self.bucket == 0:
            self.bucket = self._fit(est + self.headroom)
        stale = tick - self.hwm_tick
        if est + self.headroom > self.bucket or stale >= 64:
            new_hwm = self.read()  # device read (rare)
            self.growth = max((new_hwm - self.hwm) // max(stale, 1), 64)
            self.hwm, self.hwm_tick = new_hwm, tick
            margin = max(4 * self.growth, self.min_margin)
            est = self.hwm + (k_ahead + 1) * margin
            ideal = self._fit(est + self.headroom)
            if ideal * 2 <= self.bucket:
                self.bucket = ideal
        if est + self.headroom > self.bucket:
            self.bucket = self._fit(est + self.headroom)
        return self.bucket


def _fusion_weight(pose, prev_pose, weight_multiplier: float) -> torch.Tensor:
    """Model::computeFusionWeight on the device (0-dim; glue on 4x4 poses)."""
    diff = pose @ se3.inverse_T(prev_pose)
    motion = torch.maximum(torch.linalg.norm(diff[:3, 3]), torch.linalg.norm(se3.so3_log(diff[:3, :3])))
    return torch.clamp(1.0 - torch.clamp(motion, max=0.01) / 0.01, min=0.5) * float(weight_multiplier)


def _fill_frame(rgb_u8, depth_filt, fs: sm.FrameSurfels, cfg: EngineConfig):
    return rasterize.FillFrame(rgb_u8, depth_filt, fs.data, cfg.surfels.depth_cutoff,
                               cfg.frame_to_frame_rgb)


def _detect(img, cfg: EngineConfig, sp_net, lvl: Optional[int] = None) -> superpoint.Keypoints:
    """Keypoints on ``img``, the intensity of pyramid level ``lvl`` (default
    ``init_lvl``), with xy at full resolution (u_full = (u_lvl + 0.5) 2^lvl - 0.5)."""
    kcfg = cfg.keypoints
    lvl = cfg.odometry.init_lvl if lvl is None else lvl
    if kcfg.detector == "superpoint":
        kps = superpoint.superpoint_detect(sp_net, img, kcfg.max_keypoints,
                                           kcfg.detect_threshold, kcfg.nms_radius)
    else:
        kps = superpoint.patch_detect(img, kcfg.max_keypoints, nms_radius=kcfg.nms_radius)
    if lvl > 0:
        kps = kps._replace(xy=(kps.xy + 0.5) * float(1 << lvl) - 0.5)
    return kps


def sparse_fit(img, tracks: tracker.TrackTable, depth_filt, time: int, u, cam: CameraModel,
               cfg: EngineConfig, sp_net=None) -> ransac.RansacResult:
    """The sparse block of a kp frame: detect on ``img``, update ``tracks``
    in place (add, prune, last pair), RANSAC over the pair with uniforms ``u``."""
    kps = _detect(img, cfg, sp_net)
    p0, p1, valid = tracker.update(tracks, kps, depth_filt, time, cam, cfg.keypoints)
    return ransac.ransac_fit(u, p0, p1, valid, cfg.ransac)


def _kp_seed(state: GlobalState, img, depth_filt, time: int, cam: CameraModel,
             cfg: EngineConfig, sp_net, gen: torch.Generator):
    """The keypoint seed of the pose (Model::getLastTrackTransform) and its
    gate: (seed pose, 0-dim bool), both on the device."""
    u = torch.rand((cfg.ransac.iterations, 3), generator=gen, device=depth_filt.device)
    K.record("sparse", img=img, tracks=state.tracks, depth_filt=depth_filt, time=time, u=u,
             cam=cam, cfg=cfg)
    res = sparse_fit(img, state.tracks, depth_filt, time, u, cam, cfg, sp_net)
    T = res.transform
    good = (res.ok & (res.num_inliers >= 24) & (res.error < 0.008) & torch.isfinite(T).all()
            & (torch.linalg.norm(T[:3, 3]) < 0.03))
    eye = torch.eye(4, dtype=F32, device=T.device)
    return state.pose @ torch.where(good, T, eye), good


def _init_step(rgb_u8, depth_raw, pose0, time, cam: CameraModel, cfg: EngineConfig, sp_net=None):
    """First frame: initialise the map, the first prediction and (kp) the
    track table."""
    scfg = cfg.surfels
    depth_m, depth_filt = frame_maps.frame_depth(depth_raw)  # K1
    one = torch.ones((), dtype=F32, device=depth_m.device)
    fs = frame_maps.frame_surfels(rgb_u8, depth_m, depth_filt, cam, time, scfg.depth_cutoff, one)
    smap = sm.init_from_frame(fs, scfg.max_surfels)  # K9
    im = rasterize.splat_indices(smap, pose0, cam, scfg.conf_threshold, time, time,  # K6
                                 scfg.time_delta, scfg.depth_cutoff)
    filled = splat_fill(im, cam, scfg.conf_threshold, time, time, scfg.time_delta,  # K10
                        scfg.splat_footprint, _fill_frame(rgb_u8, depth_filt, fs, cfg))
    frame_lv = lv.frame_levels(depth_filt, rgb_u8,
                               torch.zeros_like(depth_raw, dtype=torch.int32), cam, cfg.odometry)
    tracks = None
    if cfg.odom_init == "kp" or cfg.enable_multi_model:  # seed the track table (initGlobalTracks)
        tracks = _seeded_table(frame_lv, depth_filt, time, cam, cfg, sp_net,
                               cfg.odometry.init_lvl)
    extras = global_extras(cfg, depth_m.device)
    if cfg.reloc_mode or cfg.close_loops:  # the first keyframe (K22)
        frame_s = _fern_frame(rgb_u8, depth_filt, cfg)
        ferns.add_frame(extras["ferns"], frame_s, ferns.encode_hd(extras["ferns"], frame_s),
                        pose0, time, cfg.ferns.encoding_threshold)
    state = GlobalState(smap, pose0, pose0, filled, frame_lv[-1].img, tracks, **extras)
    return state, FrameStats(None, smap)


def _fern_frame(rgb_u8, depth_filt, cfg: EngineConfig) -> ferns.FernFrame:
    return ferns.fern_frame(rgb_u8, depth_filt, cfg.camera, cfg.surfels.depth_cutoff,
                            cfg.ferns.factor)


def _lost_update(A, icp_count, bad_count, lost):
    """Tracking-lost detection (MultiMotionFusion.cpp:629-695): the GN
    system's covariance inv(A + 1e-12 I) with a diagonal entry above 1e-4, or
    fewer than 100 ICP pairs, is a bad frame; more than 10 in a row is lost.
    (bad_count, lost), on the device."""
    eye = torch.eye(6, dtype=F32, device=A.device)
    cov, _ = torch.linalg.inv_ex(A + eye * 1e-12)
    bad = (torch.max(torch.diagonal(cov)) > 1e-4) | (icp_count < 100)
    bad_count = torch.where(bad, bad_count + 1, torch.zeros_like(bad_count))
    return bad_count, lost | (bad_count > 10)


def _ferns_update(db: ferns.FernDB, frame_s: ferns.FernFrame, pose, time: int, lost,
                  cfg: EngineConfig):
    """Relocalisation and keyframe insertion (reference engine
    ``_ferns_update``): retrieve and align against the closest keyframe every
    frame and adopt its pose where lost and every gate passed (the reference
    computes the retrieval only while lost; the result is the same), then
    insert the frame unless lost. (pose, relocalised); ``db`` in place."""
    hd = ferns.encode_hd(db, frame_s, fetch=True)
    r = ferns.find_frame(db, frame_s, hd, ferns.fern_camera(cfg.camera, cfg.ferns.factor),
                         photo_thresh=cfg.ferns.photo_thresh)
    relocalised = lost & r.ok
    pose = torch.where(relocalised, r.pose, pose)
    ferns.add_frame(db, frame_s, hd, pose, time, cfg.ferns.encoding_threshold, skip=lost)
    return pose, relocalised


def global_consistency(state, frame_s, odo_A, odo_icp_count, pose, time: int, cfg: EngineConfig):
    """Lost detection + relocalisation (``reloc_mode``) and loop closure
    (``close_loops``) of the camera model after its odometry, before fusion
    (reference order: closeLoops :679, fuse :791). The store, the log and (on
    an accepted loop closure) ``state.smap`` are updated in place. Returns
    (pose, bad_track_count, lost); the loop-closure path reads one value
    back (``loop_closure.attempt``)."""
    bad_count, lost = state.bad_track_count, state.lost
    db = state.ferns
    if cfg.reloc_mode and odo_A is not None:
        with _span("reloc"):  # K22 + K2-K5 at the fern scale
            bad_count, lost = _lost_update(odo_A, odo_icp_count, bad_count, lost)
            pose, relocalised = _ferns_update(db, frame_s, pose, time, lost, cfg)
            lost = lost & ~relocalised
            bad_count = torch.where(relocalised, torch.zeros_like(bad_count), bad_count)
    if cfg.close_loops:
        with _span("loop_closure"):  # K22, K2-K5 at the fern scale, K23 on a match
            hd = ferns.encode_hd(db, frame_s, fetch=True)
            pose, match = loop_closure.attempt(db, state.smap, pose, frame_s, hd, time,
                                               ferns.fern_camera(cfg.camera, cfg.ferns.factor),
                                               cfg)
            loop_closure.log_append(state.pose_matches, match)
            if not cfg.reloc_mode:  # reloc mode inserts keyframes above
                ferns.add_frame(db, frame_s, hd, pose, time, cfg.ferns.encoding_threshold)
    return pose, bad_count, lost


def _seeded_table(frame_lv, depth_filt, time, cam: CameraModel, cfg: EngineConfig, sp_net,
                  lvl: int) -> tracker.TrackTable:
    """A new track table holding the keypoints of pyramid level ``lvl``."""
    kcfg = cfg.keypoints
    tracks = tracker.empty(kcfg.max_tracks, kcfg.track_history, kcfg.desc_dim, depth_filt.device)
    tracker.add_keypoints(tracks, _detect(frame_lv[lvl].img, cfg, sp_net, lvl), depth_filt, time,
                          cam, kcfg)
    return tracks


def _compact_pred(time: int, scfg) -> bool:
    k = scfg.compact_every
    if k <= 0:
        return False
    return k == 1 or time % k == 0


def _frame_core(state: GlobalState, rgb_u8, depth_raw, mask, time: int, weight_multiplier,
                cam: CameraModel, cfg: EngineConfig, bucket_fuse: int, sp_net=None, gen=None):
    """[Keypoint seed ->] track -> fuse -> clean -> predict (tick > 1). Writes
    the cleaned bucket back into ``state.smap.data`` and the keypoints into
    ``state.tracks``, in place."""
    scfg = cfg.surfels
    with _span("frame_inputs"):  # K1: depth conversion and bilateral filter
        depth_m, depth_filt = frame_maps.frame_depth(depth_raw)
    with _span("levels"):  # K2: frame and prediction pyramids
        frame_lv = lv.frame_levels(depth_filt, rgb_u8, mask, cam, cfg.odometry)
        preds = lv.pred_levels(state.filled.vertex_conf, state.filled.normal_rad,
                               state.filled.color, cam, cfg.odometry)
    seed = seed_ok = None
    if cfg.odom_init == "kp":
        with _span("sparse"):  # K19, K20, K21
            seed, seed_ok = _kp_seed(state, frame_lv[cfg.odometry.init_lvl].img, depth_filt,
                                     time, cam, cfg, sp_net, gen)
    odo, pose = None, state.pose
    if cfg.icp_refine or cfg.odom_init != "tf":
        with _span("odometry"):  # K3, K4, K5
            odo = rgbd.track(state.pose, lv.gn_levels(frame_lv, preds, cam, cfg.odometry),
                             state.last_intensity_coarse, cfg.odometry, cam, T_init=seed,
                             seed_valid=seed_ok)
        pose = odo.pose
    bad_count, lost = state.bad_track_count, state.lost
    if cfg.reloc_mode or cfg.close_loops:
        with _span("ferns"):  # K22: the ÷factor frame
            frame_s = _fern_frame(rgb_u8, depth_filt, cfg)
        pose, bad_count, lost = global_consistency(
            state, frame_s, None if odo is None else odo.A, None if odo is None else odo.icp_count,
            pose, time, cfg)
    weighting = _fusion_weight(pose, state.prev_pose, weight_multiplier)

    sub = state.smap.bucketed(bucket_fuse)
    with _span("frame_surfels"):  # K1
        fs = frame_maps.frame_surfels(rgb_u8, depth_m, depth_filt, cam, time, scfg.depth_cutoff,
                                      weighting)
    # one index map per frame, shared by fuse, clean and the splat resolve
    with _span("zbuffer"):  # K6
        im = rasterize.predict_indices(sub, pose, cam, time, scfg.time_delta, scfg.depth_cutoff)
    with _span("fuse"):  # K8
        fused = fusion.fuse(sub, fs, im, mask, 0, pose, cam, time, scfg)
    with _span("clean"):  # K7, K9: written straight into the map's bucket
        # fusion is skipped while lost (MultiMotionFusion.cpp:791): K9 reads
        # the flag and writes nothing, so the bucket keeps the pre-fusion map
        cleaned = fusion.clean(
            fused, im, depth_filt, mask, 0, cam, time, scfg.time_delta, scfg.conf_threshold,
            scfg, compact=_compact_pred(time, scfg), out=state.smap.data[:, :bucket_fuse],
            skip=lost if cfg.reloc_mode else None,
        )
        count = cleaned.count
        if cfg.reloc_mode:
            count = torch.where(lost, sub.count, count)
        smap = sm.SurfelMap(data=state.smap.data, count=count)

    # the next prediction resolves from the PRE-fusion index map
    with _span("splat_resolve"):  # K10 + fill_in
        filled = splat_fill(im, cam, scfg.conf_threshold, time, time, scfg.time_delta,
                            scfg.splat_footprint, _fill_frame(rgb_u8, depth_filt, fs, cfg))
    coarse = frame_lv[cfg.odometry.num_pyr - 1].img
    new_state = GlobalState(smap, pose, state.pose, filled, coarse, state.tracks, state.ferns,
                            bad_count, lost, state.pose_matches)
    return new_state, FrameStats(odo, smap, seed_ok)


_UNSUPPORTED = (
    ("frame_to_frame_rgb", lambda c: c.frame_to_frame_rgb),
    ("upload_yuv420", lambda c: c.upload_yuv420),
    ("the legacy CRF segmentation (segmentation.mode='crf')",
     lambda c: c.enable_multi_model and c.segmentation.mode == "crf"),
    ("odom_init='tf' in multi-model mode", lambda c: c.enable_multi_model and c.odom_init == "tf"),
)


class MultiMotionFusionTorch:
    """Engine facade of the port: the static path, and the multi-model path
    (the flow-CRF finds the objects; with ``segmentation.mode="precomputed"``
    ``frame.mask`` carries their ids)."""

    def __init__(self, cfg: EngineConfig, device="cuda"):
        for name, test in _UNSUPPORTED:
            if test(cfg):
                raise NotImplementedError(
                    f"{name} is not ported yet; see ROADMAP.md (queue 1) for what comes next"
                )
        if cfg.odom_init not in ("", "kp", "tf"):
            raise ValueError(f"odom_init must be '', 'kp' or 'tf', got {cfg.odom_init!r}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.cam = cfg.camera
        self.device = device
        self.tick = 1
        self.state = None  # GlobalState, or engine_multi.MultiState in multi-model mode
        self.stats: Dict[str, float] = {}
        self._last_stats: Optional[FrameStats] = None
        self._pose_log: List[tuple] = []  # (timestamp, [4,4] device pose)
        # the global map's work bucket, and in multi-model mode the largest
        # object count's (floor 2^14)
        self._map_bucket = _BucketEstimator(cfg.surfels.max_surfels, 24576, 2048, 4096, 1 << 15,
                                            lambda: int(self.state.smap.count))
        self._obj_bucket = _BucketEstimator(cfg.object_capacity, 4096, 1024, 2048, 1 << 14,
                                            lambda: int(torch.max(self.state.objects.count)))
        # multi-model mode: the device logs
        self._obj_log: List[tuple] = []  # (timestamp, [S,4,4] poses, [S] active)
        self._spawn_log: List[tuple] = []  # (timestamp, spawn, slot, refine_T)
        self._event_cursor = 0
        self._active_last: Optional[np.ndarray] = None
        self._listeners: Dict[str, list] = {}
        self.last_mask: Optional[torch.Tensor] = None
        self._zero_mask = torch.zeros((self.cam.height, self.cam.width), dtype=torch.int32,
                                      device=device)
        # the RANSAC uniforms of odom_init="kp" (not carried by interop)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(cfg.seed)
        # frames whose keypoint seed passed its gate (a device counter)
        self.seed_accepted = torch.zeros((), dtype=torch.int32, device=device)
        self.sp_net = None
        kcfg = cfg.keypoints
        if cfg.odom_init == "kp" and kcfg.detector == "superpoint":
            if not kcfg.weights_path:
                raise ValueError("the superpoint detector needs keypoints.weights_path "
                                 "(a TorchScript SuperPointNet.pt)")
            self.sp_net = superpoint.load_torchscript(kcfg.weights_path).to(device)

    # -- state --------------------------------------------------------------

    def set_state(self, state, tick: int, bucket: int = 0, bucket_obj: int = 0) -> None:
        """Adopt an externally built state (see interop.state_from_numpy and
        interop.multi_state_from_numpy) as the state after frame ``tick - 1``;
        an empty track table stands in where a kp engine's state has none.
        ``bucket`` / ``bucket_obj`` are the work buckets to continue with (0:
        decide afresh)."""
        if self.cfg.odom_init == "kp" and state.tracks is None:
            kcfg = self.cfg.keypoints
            state = state._replace(tracks=tracker.empty(kcfg.max_tracks, kcfg.track_history,
                                                        kcfg.desc_dim, self.device))
        extras = global_extras(self.cfg, self.device)
        state = state._replace(**{k: v for k, v in extras.items() if getattr(state, k) is None})
        self.state = state
        self.tick = tick
        self._map_bucket.reset(int(state.smap.count), tick, bucket)
        if self.cfg.enable_multi_model:
            self._obj_bucket.reset(int(torch.max(state.objects.count)), tick, bucket_obj)

    def _buckets(self, k_ahead: int = 1):
        """(global map bucket, object bucket: 0 unless multi-model) for the
        next ``k_ahead`` frames (``_BucketEstimator``)."""
        obj = self._obj_bucket(self.tick, k_ahead) if self.cfg.enable_multi_model else 0
        return self._map_bucket(self.tick, k_ahead), obj

    # -- frames -------------------------------------------------------------

    def upload(self, frame: FrameData):
        """(rgb u8, depth, mask int32 or None) on the device. f32 depth travels
        as millimetres (uint16 bits in an int16 tensor) when
        ``upload_depth_mm``, exactly as the reference package quantises it."""
        depth = frame.depth
        if self.cfg.upload_depth_mm and depth.dtype == np.float32:
            depth = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
        if depth.dtype == np.uint16:
            depth = depth.view(np.int16)
        rgb = torch.from_numpy(np.ascontiguousarray(frame.rgb)).to(self.device)
        mask = None
        if frame.mask is not None:
            mask = torch.from_numpy(np.ascontiguousarray(frame.mask, np.int32)).to(self.device)
        return rgb, torch.from_numpy(np.ascontiguousarray(depth)).to(self.device), mask

    def _step(self, frame: FrameData, bucket: int, bucket_obj: int, weight_multiplier: float):
        rgb_u8, depth_raw, mask = self.upload(frame)
        if self.cfg.enable_multi_model:
            from multimotionfusion_tpu_torch import engine_multi as em

            layout = rasterize.FlatLayout(bucket, bucket_obj, self.cfg.object_slots)
            self.state, stats, seg_mask, aux, odo = em.multi_frame_step(
                self.state, rgb_u8, depth_raw, self._zero_mask if mask is None else mask,
                self.tick, weight_multiplier, self.cam, self.cfg, layout, self.sp_net,
                self.generator)
            self.last_mask = seg_mask
            self._obj_log.append((frame.timestamp, self.state.objects.pose,
                                  self.state.objects.active))
            self._spawn_log.append((frame.timestamp, aux.spawn, aux.slot, aux.refine_T))
            self._record(frame, FrameStats(odo, self.state.smap, None, stats))
            return
        self.state, stats = _frame_core(
            self.state, rgb_u8, depth_raw, self._zero_mask, self.tick, weight_multiplier,
            self.cam, self.cfg, bucket, self.sp_net, self.generator,
        )
        self._record(frame, stats)

    def _record(self, frame: FrameData, stats: FrameStats):
        self._last_stats = stats
        if stats.seed_ok is not None:
            self.seed_accepted += stats.seed_ok.to(torch.int32)
        self._pose_log.append((frame.timestamp, self.state.pose))
        self.tick += 1

    def process_frame(self, frame: FrameData, gt_pose: Optional[np.ndarray] = None,
                      weight_multiplier: float = 1.0) -> Dict[str, float]:
        if self.tick == 1:
            rgb_u8, depth_raw, _ = self.upload(frame)
            pose0 = torch.tensor(gt_pose if gt_pose is not None else np.eye(4), dtype=F32,
                                 device=self.device)
            self.state, stats = _init_step(rgb_u8, depth_raw, pose0, self.tick, self.cam, self.cfg,
                                           self.sp_net)
            if self.cfg.enable_multi_model:
                from multimotionfusion_tpu_torch import engine_multi as em

                self.state = em.init_state(self.state, rgb_u8, depth_raw, self.tick, self.cfg,
                                           self.sp_net)
                self._obj_log.append((frame.timestamp, self.state.objects.pose,
                                      self.state.objects.active))
                self._spawn_log.append((frame.timestamp, None, None, None))
            self._map_bucket.reset(int(self.state.smap.count), 1, self._map_bucket.bucket)
            self._record(frame, stats)
        else:
            if self.cfg.odom_init == "tf" and gt_pose is not None:
                self.state = self.state._replace(
                    pose=torch.as_tensor(np.asarray(gt_pose, np.float32)).to(self.device))
            self._step(frame, *self._buckets(), weight_multiplier)
        return dict(self.stats)

    def process_frames(self, frames, weight_multiplier: float = 1.0) -> Dict[str, float]:
        """Several frames with ONE bucket decision (k_ahead = len(frames)), as
        the reference package's batched step; per-frame otherwise."""
        frames = list(frames)
        if self.state is None or len(frames) == 1:
            for f in frames:
                self.process_frame(f, weight_multiplier=weight_multiplier)
            return dict(self.stats)
        buckets = self._buckets(k_ahead=len(frames))
        for f in frames:
            self._step(f, *buckets, weight_multiplier)
        return dict(self.stats)

    def current_stats(self, sync: bool = True) -> Dict[str, float]:
        if sync and self._last_stats is not None and self._last_stats.multi is not None:
            v = self._last_stats.multi.cpu().numpy()
            self.stats = {
                "icp_error": float(v[0]), "icp_count": float(v[1]), "rgb_error": float(v[2]),
                "rgb_count": float(v[3]), "surfels": float(v[4]), "hwm": float(v[5]),
                "spawned": float(v[6]), "active_objects": float(v[7]), "lost": float(v[8]),
                "segment_px": [float(x) for x in v[9:]],
            }
        elif sync and self._last_stats is not None:
            s = self._last_stats
            odo = s.odo
            self.stats = {
                "icp_error": float(odo.icp_error) if odo else 0.0,
                "icp_count": float(odo.icp_count) if odo else 0.0,
                "rgb_error": float(odo.rgb_error) if odo else 0.0,
                "rgb_count": float(odo.rgb_count) if odo else 0.0,
                "surfels": float(s.smap.alive_count()),
                "hwm": float(s.smap.count),
                "lost": float(self.state.lost),
            }
        return dict(self.stats)

    def pose_matches(self) -> List[Dict]:
        """Loop-closure PoseMatch records (reference Core/PoseMatch.h), oldest
        first; at most the log's capacity are kept (one copy to the host)."""
        if self.state is None:
            return []
        log = self.state.pose_matches
        n, cap = int(log.count), log.capacity
        times, poses = log.times.cpu().numpy(), log.poses.cpu().numpy()
        acc, err = log.accepted.cpu().numpy(), log.cons_err.cpu().numpy()
        out = []
        for i in range(max(0, n - cap), n):
            s = i % cap
            out.append({"source_time": int(times[s, 0]), "dest_time": int(times[s, 1]),
                        "source_pose": poses[s, 0], "dest_pose": poses[s, 1],
                        "accepted": bool(acc[s]), "mean_cons_err": float(err[s])})
        return out

    def finish(self) -> Dict[str, float]:
        """Wait for the device, then return the latest stats."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.current_stats(sync=True)

    @property
    def pose_log(self) -> List[tuple]:
        """[(timestamp, [4,4] numpy camera pose)] of every processed frame
        (one copy of all poses to the host)."""
        if not self._pose_log:
            return []
        poses = torch.stack([p for _, p in self._pose_log]).cpu().numpy()
        return [(ts, poses[i]) for i, (ts, _) in enumerate(self._pose_log)]

    @property
    def global_model(self):
        """The camera model's map, pose, high-water mark and pose log."""
        from types import SimpleNamespace

        st = self.state
        return SimpleNamespace(
            id=0,
            smap=st.smap if st is not None else None,
            pose=st.pose if st is not None else None,
            hwm=int(st.smap.count) if st is not None else 0,
            pose_log=self.pose_log,
        )

    # -- multi-model lifecycle (reference Core/Callbacks.h) -----------------

    def add_model_listener(self, event: str, fn) -> None:
        """Register a callback for "new_model" / "inactive_model" events; it
        receives {event, timestamp, id, redetected?}."""
        if event not in ("new_model", "inactive_model"):
            raise ValueError(f"unknown event {event!r}")
        self._listeners.setdefault(event, []).append(fn)

    def _lifecycle_logs(self):
        """The object-pose and spawn logs with their device tensors read (one
        copy each of the poses, flags and spawn records since the start)."""
        def host(x):
            return None if x is None else x.cpu().numpy()

        if self._obj_log and isinstance(self._obj_log[-1][2], torch.Tensor):
            poses = torch.stack([p for _, p, _ in self._obj_log]).cpu().numpy()
            act = torch.stack([a for _, _, a in self._obj_log]).cpu().numpy()
            self._obj_log = [(ts, poses[i], act[i]) for i, (ts, _, _) in enumerate(self._obj_log)]
            self._spawn_log = [(ts, host(sp), host(sl), host(rT)) for ts, sp, sl, rT in self._spawn_log]
        return self._obj_log, self._spawn_log

    def drain_events(self) -> List[Dict]:
        """Lifecycle events since the last drain (a model became active: spawn
        or redetection; a model went inactive), listeners fired."""
        obj_log, spawn_log = self._lifecycle_logs()
        events: List[Dict] = []
        while self._event_cursor < len(obj_log):
            i = self._event_cursor
            ts, _, act = obj_log[i]
            sp, sl = spawn_log[i][1], spawn_log[i][2]
            spawned = int(sl) if sp is not None and bool(sp) else -1
            prev = self._active_last
            if prev is not None:
                for k in np.nonzero(act & ~prev)[0]:
                    events.append({"event": "new_model", "timestamp": ts, "id": int(k) + 1,
                                   "redetected": int(k) != spawned})
                for k in np.nonzero(prev & ~act)[0]:
                    events.append({"event": "inactive_model", "timestamp": ts, "id": int(k) + 1})
            self._active_last = act
            self._event_cursor += 1
        for ev in events:
            for fn in self._listeners.get(ev["event"], []):
                fn(ev)
        return events

    def export_poses(self, export_dir: str) -> List[str]:
        """Write each model's trajectory in TUM format to ``poses-<id>.txt``:
        the camera's (id 0), and in multi-model mode each object slot's over
        the frames it was active, as P_0 P_m^-1 (the object's motion in the
        world), a spawned object back-dated by its refine transforms."""
        self.finish()
        pose_log = self.pose_log
        models = [(0, pose_log)]
        if self.cfg.enable_multi_model:
            obj_log, spawn_log = self._lifecycle_logs()
            obj_logs = {k: [] for k in range(self.cfg.object_slots)}
            for ts, poses, active in obj_log:
                for k in range(self.cfg.object_slots):
                    if active[k]:
                        obj_logs[k].append((ts, poses[k]))
            ts_order = [ts for ts, _ in pose_log]
            ts_index = {ts: i for i, ts in enumerate(ts_order)}
            for ts, sp, sl, rT in spawn_log:
                if sp is None or not bool(sp) or ts not in ts_index:
                    continue
                i, P, back = ts_index[ts], np.eye(4, dtype=np.float64), []
                for k in range(rT.shape[0]):
                    j = i - k - 1
                    if j < 0 or not np.all(np.isfinite(rT[k])):
                        break
                    P = P @ np.linalg.inv(rT[k])
                    back.append((ts_order[j], P.astype(np.float32)))
                obj_logs[int(sl)] = back[::-1] + obj_logs[int(sl)]
            models += [(k + 1, log) for k, log in obj_logs.items() if log]
        gposes = dict(pose_log)
        paths = []
        for model_id, log in models:
            path = os.path.join(export_dir, f"poses-{model_id}.txt")
            with open(path, "w") as f:
                for ts, pose in log:
                    if model_id == 0:
                        T = pose
                    elif ts in gposes:
                        T = gposes[ts] @ np.linalg.inv(np.asarray(pose))
                    else:
                        continue
                    q = se3.to_quaternion_xyzw(torch.as_tensor(T[:3, :3])).numpy()
                    t = T[:3, 3]
                    f.write(f"{ts * 1e-9:.9f} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")
            paths.append(path)
        return paths
