"""Global loop closure: fern retrieval -> surface constraints -> embedded
deformation -> gated map and pose correction.

Port of the reference package's ``model/loop_closure.py`` (the closeLoops
path of MultiMotionFusion.cpp:679-789 and Deformation.cpp:76-180): each
frame retrieves the most similar fern keyframe and aligns the live frame
against it (K22 with K2-K5 at the fern scale); on a confident match with an
old enough keyframe, point constraints ("this surface point at its current,
drifted, global position must move to where the relocalised pose puts it")
drive the deformation graph (K23); the map is deformed and the relocalised
pose adopted only when the optimised graph meets the constraints. A
``PoseMatch`` is logged for every match.

The reference skips the deformation with a ``lax.cond`` on frames without a
match; here ``attempt`` reads ``matched`` on the host once per frame (the
reference system branches on the host here too) and runs or skips the
sampling, optimisation and application. Acceptance is never read: the map
kernel and the pose select read it on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimotionfusion_tpu_torch.config import CameraModel, EngineConfig
from multimotionfusion_tpu_torch.model import deformation as dg
from multimotionfusion_tpu_torch.model import ferns as ferns_mod
from multimotionfusion_tpu_torch.model import surfel_map as sm
from multimotionfusion_tpu_torch.utils import se3

F32 = torch.float32
# the constraint grid: the fern-scale vertex map at this stride (the
# reference's 20x20 consBuff density)
CONS_STRIDE = 4


class PoseMatch(NamedTuple):
    """Loop-closure pose pair record (reference Core/PoseMatch.h)."""

    source_time: torch.Tensor  # [] int32 keyframe time
    dest_time: torch.Tensor  # [] int32 live time
    source_pose: torch.Tensor  # [4,4] drifted pose at match time
    dest_pose: torch.Tensor  # [4,4] relocalised pose
    accepted: torch.Tensor  # [] bool: deformation applied
    matched: torch.Tensor  # [] bool: fern gates passed
    mean_cons_err: torch.Tensor  # [] float32 post-optimisation constraint error


class MatchLog(NamedTuple):
    """Ring buffer of PoseMatch records on the device."""

    times: torch.Tensor  # [M, 2] int32 (source keyframe time, dest live time)
    poses: torch.Tensor  # [M, 2, 4, 4] (drifted pose, relocalised pose)
    accepted: torch.Tensor  # [M] bool
    cons_err: torch.Tensor  # [M] float32
    count: torch.Tensor  # [] int32 total matches ever recorded

    @property
    def capacity(self) -> int:
        return self.times.shape[0]


FIELDS = MatchLog._fields
DTYPES = {"times": torch.int32, "accepted": torch.bool, "count": torch.int32}


def empty_log(capacity: int = 16, device="cpu") -> MatchLog:
    z = dict(device=device)
    return MatchLog(
        times=torch.zeros((capacity, 2), dtype=torch.int32, **z),
        poses=torch.zeros((capacity, 2, 4, 4), dtype=F32, **z),
        accepted=torch.zeros((capacity,), dtype=torch.bool, **z),
        cons_err=torch.zeros((capacity,), dtype=F32, **z),
        count=torch.zeros((), dtype=torch.int32, **z),
    )


def log_append(log: MatchLog, match: PoseMatch) -> None:
    """Record ``match`` in place (nothing unless ``match.matched``; the
    oldest record is overwritten once the ring is full)."""
    slot = torch.arange(log.capacity, device=log.count.device) == torch.remainder(
        log.count, log.capacity)
    put = slot & match.matched
    log.times.copy_(torch.where(put[:, None], torch.stack([match.source_time, match.dest_time]
                                                          ).to(torch.int32)[None], log.times))
    log.poses.copy_(torch.where(put[:, None, None, None],
                                torch.stack([match.source_pose, match.dest_pose])[None], log.poses))
    log.accepted.copy_(torch.where(put, match.accepted, log.accepted))
    log.cons_err.copy_(torch.where(put, match.mean_cons_err, log.cons_err))
    log.count.add_(match.matched.to(torch.int32))


def attempt(db: ferns_mod.FernDB, smap: sm.SurfelMap, pose, frame: ferns_mod.FernFrame,
            hd: ferns_mod.Retrieval, time: int, cam_s: CameraModel, cfg: EngineConfig):
    """One loop-closure attempt against ``db`` with this frame's retrieval
    ``hd`` (fetched). Deforms ``smap`` in place when a match is accepted.
    Returns (pose, PoseMatch); one host read (``matched``)."""
    r = ferns_mod.find_frame(db, frame, hd, cam_s, photo_thresh=cfg.ferns.photo_thresh)
    src_time = db.src_time.index_select(0, r.best.reshape(1).long())[0]
    # a self-match against a keyframe just inserted from this very pose is
    # not a loop: the keyframe must be older than time_delta
    matched = r.ok & ((time - src_time) > cfg.surfels.time_delta)
    dev = pose.device
    accepted = torch.zeros((), dtype=torch.bool, device=dev)
    cons_err = torch.full((), float("inf"), dtype=F32, device=dev)
    new_pose = pose
    if bool(matched):  # the loop-closure path's one host read a frame
        pts = frame.vmap[::CONS_STRIDE, ::CONS_STRIDE].reshape(-1, 3)
        valid = pts[:, 2] > 0
        src = se3.transform_points(pose, pts).contiguous()
        dst = se3.transform_points(r.pose, pts)
        # constrained points carry the CURRENT time: they anchor to the most
        # recent nodes, while old nodes hold the loop's far side in place
        times = torch.full((src.shape[0],), float(time), dtype=F32, device=dev)
        dcfg = cfg.deformation
        graph = dg.sample_nodes(smap, dcfg.max_nodes)
        opt = dg.optimise(graph, src, dst, valid, times, dcfg)
        moved, _ = dg.deform_points(src, times, opt, dcfg)
        n_valid = torch.clamp(valid.to(F32).sum(), min=1.0)
        dist = torch.linalg.norm(moved - dst, dim=-1)
        cons_err = torch.where(valid, dist, torch.zeros_like(dist)).sum() / n_valid
        accepted = (cons_err < cfg.loop_accept_cons_err) & torch.isfinite(opt.t).all()
        dg.apply_to_map(smap, opt, dcfg, gate=accepted)
        new_pose = torch.where(accepted, r.pose, pose)
    match = PoseMatch(source_time=src_time, dest_time=torch.full((), time, dtype=torch.int32,
                                                                 device=dev),
                      source_pose=pose, dest_pose=r.pose, accepted=accepted, matched=matched,
                      mean_cons_err=cons_err)
    return new_pose, match
