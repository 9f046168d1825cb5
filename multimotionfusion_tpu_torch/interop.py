"""Engine state <-> a plain dict of numpy arrays.

The system has no learned weights; what carries across from the reference
package is its map and pose state. The dict holds the fields of the reference
package's GlobalState that the static path reads, under these keys:
``smap.data`` [16, capacity] f32, ``smap.count`` [] int32, ``pose`` and
``prev_pose`` [4, 4] f32, ``filled.color`` [H, W, 3], ``filled.vertex_conf``
[H, W, 4], ``filled.normal_rad`` [H, W, 4] and ``last_intensity_coarse``
[H/4, W/4] (all f32), and the keypoint track table under the reference's
names ``tracks.xy`` [T, H, 2], ``tracks.p3d`` [T, H, 3], ``tracks.seen`` and
``tracks.has_depth`` [T, H] bool, ``tracks.desc`` [T, D], ``tracks.last_seen``,
``tracks.nvalid`` and ``tracks.model_id`` [T] int32 and ``tracks.active`` [T]
bool. A test builds it from a reference GlobalState with ``np.asarray`` on
each field.

``multi_state_to_numpy`` / ``multi_state_from_numpy`` carry the multi-model
state (``engine_multi.MultiState``): the same keys plus ``pred_own``,
``prev_mask``, ``prev_intensity``, ``last_spawn``, ``objects.<field>`` for
every field of the reference's ObjectSlots and the segm_lvl track table
under ``tracks_segm.<field>`` (the reference's 1-slot stub when segm_lvl ==
init_lvl; a dict without those keys gets that stub).

When the ``tracks.*`` keys are absent (a snapshot without a track table) the
state's ``tracks`` is None, and ``MultiMotionFusionTorch.set_state`` stands in
an empty table of its configuration. The engine's random generator (the
RANSAC uniforms) is not part of the state and is not carried.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from multimotionfusion_tpu_torch.engine import GlobalState
from multimotionfusion_tpu_torch.model.fillin import FilledMaps
from multimotionfusion_tpu_torch.model.surfel_map import SurfelMap
from multimotionfusion_tpu_torch.tracking import tracker

_FILLED = ("color", "vertex_conf", "normal_rad")
_TRACK_DTYPES = {"seen": torch.bool, "has_depth": torch.bool, "active": torch.bool,
                 "last_seen": torch.int32, "nvalid": torch.int32, "model_id": torch.int32}


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    out = {
        "smap.data": state.smap.data.cpu().numpy(),
        "smap.count": np.asarray(state.smap.count.cpu().numpy(), np.int32),
        "pose": state.pose.cpu().numpy(),
        "prev_pose": state.prev_pose.cpu().numpy(),
        "last_intensity_coarse": state.last_intensity_coarse.cpu().numpy(),
    }
    for k in _FILLED:
        out[f"filled.{k}"] = getattr(state.filled, k).cpu().numpy()
    if state.tracks is not None:
        for k in tracker.FIELDS:
            out[f"tracks.{k}"] = getattr(state.tracks, k).cpu().numpy()
    return out


def state_from_numpy(d: Dict[str, np.ndarray], device="cuda") -> GlobalState:
    def dev(key, dtype=torch.float32):
        return torch.as_tensor(np.array(d[key]), dtype=dtype).to(device).contiguous()

    tracks = None
    if "tracks.xy" in d:
        tracks = tracker.TrackTable(*(dev(f"tracks.{k}", _TRACK_DTYPES.get(k, torch.float32))
                                      for k in tracker.FIELDS))

    return GlobalState(
        smap=SurfelMap(data=dev("smap.data"), count=dev("smap.count", torch.int32).reshape(())),
        pose=dev("pose"),
        prev_pose=dev("prev_pose"),
        filled=FilledMaps(*(dev(f"filled.{k}") for k in _FILLED)),
        last_intensity_coarse=dev("last_intensity_coarse"),
        tracks=tracks,
    )


# ---------------------------------------------------------------- multi-model

_OBJ_DTYPES = {"count": torch.int32, "active": torch.bool, "unseen": torch.int32,
               "spawn_tick": torch.int32, "stored": torch.bool, "stored_valid": torch.bool,
               "ext_id": torch.int32}
_MULTI_INT = ("pred_own", "prev_mask", "last_spawn")


def multi_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """An ``engine_multi.MultiState`` as a dict: the static keys (without
    ``prev_pose``'s absence: all of them), the track table, ``pred_own``,
    ``prev_mask`` [H, W] int32, ``prev_intensity`` [H, W], ``last_spawn`` []
    int32 and the object slots under ``objects.<field>`` (the reference's
    ObjectSlots names)."""
    from multimotionfusion_tpu_torch.engine_multi import FIELDS

    out = state_to_numpy(state)
    for k in _MULTI_INT + ("prev_intensity",):
        out[k] = getattr(state, k).cpu().numpy()
    for k in FIELDS:
        out[f"objects.{k}"] = getattr(state.objects, k).cpu().numpy()
    for k in tracker.FIELDS:
        out[f"tracks_segm.{k}"] = getattr(state.tracks_segm, k).cpu().numpy()
    return out


def multi_state_from_numpy(d: Dict[str, np.ndarray], device="cuda"):
    """An ``engine_multi.MultiState`` from such a dict (e.g. the reference
    engine's ``mstate``, each field through ``np.asarray``); without
    ``tracks_segm.*`` keys the segm_lvl table is a 1-slot stub with the
    track table's descriptor width."""
    from multimotionfusion_tpu_torch.engine_multi import FIELDS, MultiState, ObjectSlots

    def dev(key, dtype=torch.float32):
        return torch.as_tensor(np.array(d[key]), dtype=dtype).to(device).contiguous()

    g = state_from_numpy(d, device)
    objects = ObjectSlots(*(dev(f"objects.{k}", _OBJ_DTYPES.get(k, torch.float32))
                            for k in FIELDS))
    if "tracks_segm.xy" in d:
        tracks_segm = tracker.TrackTable(*(dev(f"tracks_segm.{k}",
                                               _TRACK_DTYPES.get(k, torch.float32))
                                           for k in tracker.FIELDS))
    else:
        tracks_segm = tracker.empty(1, 2, np.shape(d["tracks.desc"])[1], device)
    return MultiState(
        smap=g.smap, pose=g.pose, prev_pose=g.prev_pose, filled=g.filled,
        pred_own=dev("pred_own", torch.int32), last_intensity_coarse=g.last_intensity_coarse,
        tracks=g.tracks, tracks_segm=tracks_segm, objects=objects,
        prev_mask=dev("prev_mask", torch.int32),
        prev_intensity=dev("prev_intensity"),
        last_spawn=dev("last_spawn", torch.int32).reshape(()),
    )
