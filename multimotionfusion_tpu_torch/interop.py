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

Both state kinds also carry the relocalisation and loop-closure state under
the reference's names: ``ferns.<field>`` for every field of the fern store
(``model/ferns.FernDB``), ``bad_track_count`` [] int32, ``lost`` [] bool and
``pose_matches.<field>`` for every field of the match log
(``model/loop_closure.MatchLog``).

When the ``tracks.*`` keys are absent (a snapshot without a track table) the
state's ``tracks`` is None, and ``MultiMotionFusionTorch.set_state`` stands in
an empty table of its configuration; so it does for the fern store, the lost
flags and the match log when their keys are absent. The engine's random
generator (the RANSAC uniforms) is not part of the state and is not carried.

Every array of a returned dict is a copy: it shares no memory with the
engine's tensors, which the next step updates in place.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from multimotionfusion_tpu_torch.engine import GlobalState
from multimotionfusion_tpu_torch.model import ferns, loop_closure
from multimotionfusion_tpu_torch.model.fillin import FilledMaps
from multimotionfusion_tpu_torch.model.surfel_map import SurfelMap
from multimotionfusion_tpu_torch.tracking import tracker

_FILLED = ("color", "vertex_conf", "normal_rad")
_TRACK_DTYPES = {"seen": torch.bool, "has_depth": torch.bool, "active": torch.bool,
                 "last_seen": torch.int32, "nvalid": torch.int32, "model_id": torch.int32}


def _np(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a CPU tensor)."""
    return t.detach().cpu().numpy().copy()


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    out = {
        "smap.data": _np(state.smap.data),
        "smap.count": np.asarray(_np(state.smap.count), np.int32),
        "pose": _np(state.pose),
        "prev_pose": _np(state.prev_pose),
        "last_intensity_coarse": _np(state.last_intensity_coarse),
    }
    for k in _FILLED:
        out[f"filled.{k}"] = _np(getattr(state.filled, k))
    for prefix, nt, fields in (("tracks", state.tracks, tracker.FIELDS),
                               ("ferns", state.ferns, ferns.FIELDS),
                               ("pose_matches", state.pose_matches, loop_closure.FIELDS)):
        if nt is not None:
            for k in fields:
                out[f"{prefix}.{k}"] = _np(getattr(nt, k))
    for k in ("bad_track_count", "lost"):
        if getattr(state, k) is not None:
            out[k] = _np(getattr(state, k))
    return out


def _group(d, prefix, cls, fields, dtypes, dev):
    if f"{prefix}.{fields[0]}" not in d:
        return None
    return cls(*(dev(f"{prefix}.{k}", dtypes.get(k, torch.float32)) for k in fields))


def state_from_numpy(d: Dict[str, np.ndarray], device="cuda") -> GlobalState:
    def dev(key, dtype=torch.float32):
        return torch.as_tensor(np.array(d[key]), dtype=dtype).to(device).contiguous()

    fdb = _group(d, "ferns", ferns.FernDB, ferns.FIELDS, ferns.DTYPES, dev)
    log = _group(d, "pose_matches", loop_closure.MatchLog, loop_closure.FIELDS,
                 loop_closure.DTYPES, dev)
    return GlobalState(
        smap=SurfelMap(data=dev("smap.data"), count=dev("smap.count", torch.int32).reshape(())),
        pose=dev("pose"),
        prev_pose=dev("prev_pose"),
        filled=FilledMaps(*(dev(f"filled.{k}") for k in _FILLED)),
        last_intensity_coarse=dev("last_intensity_coarse"),
        tracks=_group(d, "tracks", tracker.TrackTable, tracker.FIELDS, _TRACK_DTYPES, dev),
        ferns=None if fdb is None else fdb._replace(count=fdb.count.reshape(())),
        bad_track_count=(dev("bad_track_count", torch.int32).reshape(())
                         if "bad_track_count" in d else None),
        lost=dev("lost", torch.bool).reshape(()) if "lost" in d else None,
        pose_matches=None if log is None else log._replace(count=log.count.reshape(())),
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
        out[k] = _np(getattr(state, k))
    for k in FIELDS:
        out[f"objects.{k}"] = _np(getattr(state.objects, k))
    for k in tracker.FIELDS:
        out[f"tracks_segm.{k}"] = _np(getattr(state.tracks_segm, k))
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
    tracks_segm = _group(d, "tracks_segm", tracker.TrackTable, tracker.FIELDS, _TRACK_DTYPES, dev)
    if tracks_segm is None:
        tracks_segm = tracker.empty(1, 2, np.shape(d["tracks.desc"])[1], device)
    return MultiState(
        smap=g.smap, pose=g.pose, prev_pose=g.prev_pose, filled=g.filled,
        pred_own=dev("pred_own", torch.int32), last_intensity_coarse=g.last_intensity_coarse,
        tracks=g.tracks, tracks_segm=tracks_segm, objects=objects,
        prev_mask=dev("prev_mask", torch.int32),
        prev_intensity=dev("prev_intensity"),
        last_spawn=dev("last_spawn", torch.int32).reshape(()),
        ferns=g.ferns, bad_track_count=g.bad_track_count, lost=g.lost,
        pose_matches=g.pose_matches,
    )
