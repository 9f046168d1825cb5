"""Top-level engine: the static (ElasticFusion-style) per-frame SLAM step.

Port of the reference package's ``engine.py`` for ``enable_multi_model=False``
with every pose initialisation (``odom_init``): upload -> depth filter ->
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

All state lives on the compute device, the poses and the track table
included. On the card the frame step launches only the hand-written kernels
of ``csrc/`` (K1-K10, K19-K21) plus PyTorch glue on 4x4 poses and 0-dim
scalars; the odometry's loops run on the card with done flags, so a
steady-state frame reads nothing back except, at most every 64 frames, the
map's high-water mark (``_buckets``).
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel, EngineConfig
from multimotionfusion_tpu_torch.io.frame import FrameData
from multimotionfusion_tpu_torch.model import fusion, surfel_map as sm
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
    """Single-model engine state (the static path's fields of the reference
    package's GlobalState), all on the device."""

    smap: sm.SurfelMap
    pose: torch.Tensor  # [4,4]
    prev_pose: torch.Tensor  # [4,4], pose one frame earlier
    filled: FilledMaps  # prediction for the next frame's tracking
    last_intensity_coarse: torch.Tensor  # previous frame coarse intensity
    tracks: Optional[tracker.TrackTable] = None  # keypoint tracks (odom_init="kp")


class FrameStats(NamedTuple):
    odo: Optional[rgbd.OdometryResult]
    smap: sm.SurfelMap  # the map after the frame (alive count read on demand)
    seed_ok: Optional[torch.Tensor] = None  # 0-dim bool: the keypoint seed passed its gate


def _bucket_for(n: int, capacity: int, floor: int = 1 << 15) -> int:
    """Smallest work bucket >= n: powers of two up to 2^18, then x1.5 rungs."""
    b = floor
    while b < n and b < (1 << 18):
        b <<= 1
    while b < n:
        b += b >> 1
    return min(b, capacity)


def _fusion_weight(pose, prev_pose, weight_multiplier: float) -> torch.Tensor:
    """Model::computeFusionWeight on the device (0-dim; glue on 4x4 poses)."""
    diff = pose @ se3.inverse_T(prev_pose)
    motion = torch.maximum(torch.linalg.norm(diff[:3, 3]), torch.linalg.norm(se3.so3_log(diff[:3, :3])))
    return torch.clamp(1.0 - torch.clamp(motion, max=0.01) / 0.01, min=0.5) * float(weight_multiplier)


def _fill_frame(rgb_u8, depth_filt, fs: sm.FrameSurfels, cfg: EngineConfig):
    return rasterize.FillFrame(rgb_u8, depth_filt, fs.data, cfg.surfels.depth_cutoff,
                               cfg.frame_to_frame_rgb)


def _detect(img, cfg: EngineConfig, sp_net) -> superpoint.Keypoints:
    """Keypoints on ``img``, the ``init_lvl`` intensity, with xy at full
    resolution (u_full = (u_lvl + 0.5) 2^lvl - 0.5)."""
    kcfg, lvl = cfg.keypoints, cfg.odometry.init_lvl
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
    if cfg.odom_init == "kp":  # seed the track table (initGlobalTracks)
        kcfg = cfg.keypoints
        tracks = tracker.empty(kcfg.max_tracks, kcfg.track_history, kcfg.desc_dim,
                               depth_filt.device)
        img = frame_lv[cfg.odometry.init_lvl].img
        tracker.add_keypoints(tracks, _detect(img, cfg, sp_net), depth_filt, time, cam, kcfg)
    state = GlobalState(smap, pose0, pose0, filled, frame_lv[-1].img, tracks)
    return state, FrameStats(None, smap)


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
        cleaned = fusion.clean(
            fused, im, depth_filt, mask, 0, cam, time, scfg.time_delta, scfg.conf_threshold,
            scfg, compact=_compact_pred(time, scfg), out=state.smap.data[:, :bucket_fuse],
        )
        smap = sm.SurfelMap(data=state.smap.data, count=cleaned.count)

    # the next prediction resolves from the PRE-fusion index map
    with _span("splat_resolve"):  # K10 + fill_in
        filled = splat_fill(im, cam, scfg.conf_threshold, time, time, scfg.time_delta,
                            scfg.splat_footprint, _fill_frame(rgb_u8, depth_filt, fs, cfg))
    coarse = frame_lv[cfg.odometry.num_pyr - 1].img
    new_state = GlobalState(smap, pose, state.pose, filled, coarse, state.tracks)
    return new_state, FrameStats(odo, smap, seed_ok)


_UNSUPPORTED = (
    ("enable_multi_model", lambda c: c.enable_multi_model),
    ("reloc_mode", lambda c: c.reloc_mode),
    ("close_loops", lambda c: c.close_loops),
    ("frame_to_frame_rgb", lambda c: c.frame_to_frame_rgb),
    ("upload_yuv420", lambda c: c.upload_yuv420),
)


class MultiMotionFusionTorch:
    """Engine facade of the port (static path only)."""

    def __init__(self, cfg: EngineConfig, device="cuda"):
        for name, test in _UNSUPPORTED:
            if test(cfg):
                raise NotImplementedError(
                    f"{name} is not ported yet; see ROADMAP.md (queue 1) for the static path's successors"
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
        self.state: Optional[GlobalState] = None
        self.stats: Dict[str, float] = {}
        self._last_stats: Optional[FrameStats] = None
        self._pose_log: List[tuple] = []  # (timestamp, [4,4] device pose)
        self._hwm = 0
        self._hwm_tick = 0
        self._growth_rate = 4096
        self._bucket = 0
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

    def set_state(self, state: GlobalState, tick: int, bucket: int = 0) -> None:
        """Adopt an externally built state (see interop.state_from_numpy) as
        the state after frame ``tick - 1``; an empty track table stands in
        where a kp engine's state has none."""
        if self.cfg.odom_init == "kp" and state.tracks is None:
            kcfg = self.cfg.keypoints
            state = state._replace(tracks=tracker.empty(kcfg.max_tracks, kcfg.track_history,
                                                        kcfg.desc_dim, self.device))
        self.state = state
        self.tick = tick
        self._hwm = int(state.smap.count)
        self._hwm_tick = tick
        self._bucket = bucket

    def _buckets(self, k_ahead: int = 1) -> int:
        """Work bucket from a (possibly stale) high-water mark, extrapolated by
        the measured growth rate (x4 margin) plus a fixed headroom; re-read
        from the device only when the estimate outgrows the bucket or every
        64 frames; shrinks by whole rungs with 2x hysteresis. Appends beyond
        the bucket are dropped for those frames."""
        cap = self.cfg.surfels.max_surfels
        headroom = 24576
        margin = max(4 * self._growth_rate, 2048)
        est = self._hwm + (self.tick + k_ahead - self._hwm_tick) * margin
        if self._bucket == 0:
            self._bucket = _bucket_for(est + headroom, cap)
        stale = self.tick - self._hwm_tick
        if (est + headroom > self._bucket or stale >= 64) and self.state is not None:
            new_hwm = int(self.state.smap.count)  # device read (rare)
            dt = max(stale, 1)
            self._growth_rate = max((new_hwm - self._hwm) // dt, 64)
            self._hwm = new_hwm
            self._hwm_tick = self.tick
            margin = max(4 * self._growth_rate, 2048)
            est = self._hwm + (k_ahead + 1) * margin
            ideal = _bucket_for(est + headroom, cap)
            if ideal * 2 <= self._bucket:
                self._bucket = ideal
        if est + headroom > self._bucket:
            self._bucket = _bucket_for(est + headroom, cap)
        return self._bucket

    # -- frames -------------------------------------------------------------

    def upload(self, frame: FrameData):
        """(rgb u8, depth) on the device. f32 depth travels as millimetres
        (uint16 bits in an int16 tensor) when ``upload_depth_mm``, exactly as
        the reference package quantises it."""
        depth = frame.depth
        if self.cfg.upload_depth_mm and depth.dtype == np.float32:
            depth = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
        if depth.dtype == np.uint16:
            depth = depth.view(np.int16)
        rgb = torch.from_numpy(np.ascontiguousarray(frame.rgb)).to(self.device)
        return rgb, torch.from_numpy(np.ascontiguousarray(depth)).to(self.device)

    def _step(self, frame: FrameData, bucket: int, weight_multiplier: float):
        rgb_u8, depth_raw = self.upload(frame)
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
            rgb_u8, depth_raw = self.upload(frame)
            pose0 = torch.tensor(gt_pose if gt_pose is not None else np.eye(4), dtype=F32,
                                 device=self.device)
            self.state, stats = _init_step(rgb_u8, depth_raw, pose0, self.tick, self.cam, self.cfg,
                                           self.sp_net)
            self._hwm = int(self.state.smap.count)
            self._hwm_tick = 1
            self._record(frame, stats)
        else:
            if self.cfg.odom_init == "tf" and gt_pose is not None:
                self.state = self.state._replace(
                    pose=torch.as_tensor(np.asarray(gt_pose, np.float32)).to(self.device))
            self._step(frame, self._buckets(), weight_multiplier)
        return dict(self.stats)

    def process_frames(self, frames, weight_multiplier: float = 1.0) -> Dict[str, float]:
        """Several frames with ONE bucket decision (k_ahead = len(frames)), as
        the reference package's batched step; per-frame otherwise."""
        frames = list(frames)
        if self.state is None or len(frames) == 1:
            for f in frames:
                self.process_frame(f, weight_multiplier=weight_multiplier)
            return dict(self.stats)
        bucket = self._buckets(k_ahead=len(frames))
        for f in frames:
            self._step(f, bucket, weight_multiplier)
        return dict(self.stats)

    def current_stats(self, sync: bool = True) -> Dict[str, float]:
        if sync and self._last_stats is not None:
            s = self._last_stats
            odo = s.odo
            self.stats = {
                "icp_error": float(odo.icp_error) if odo else 0.0,
                "icp_count": float(odo.icp_count) if odo else 0.0,
                "rgb_error": float(odo.rgb_error) if odo else 0.0,
                "rgb_count": float(odo.rgb_count) if odo else 0.0,
                "surfels": float(s.smap.alive_count()),
                "hwm": float(s.smap.count),
            }
        return dict(self.stats)

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

    def export_poses(self, export_dir: str) -> List[str]:
        """Write the camera trajectory in TUM format to ``poses-0.txt``."""
        self.finish()
        path = os.path.join(export_dir, "poses-0.txt")
        with open(path, "w") as f:
            for ts, T in self.pose_log:
                q = se3.to_quaternion_xyzw(torch.as_tensor(T[:3, :3])).numpy()
                t = T[:3, 3]
                f.write(f"{ts * 1e-9:.9f} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")
        return [path]
