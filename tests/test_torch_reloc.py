"""The port's relocalisation (``reloc_mode``: lost detection, fern
retrieval and alignment, keyframe insertion, fusion skipped while lost)
against the reference package's, on the CPU, at 160x120
(tests/test_reloc.py's scene and configuration).

Both engines run tests/test_reloc.py's journey: four healthy frames, 13
blackout frames, a frame near pose 1. Each step that matters is held both
ways, from frozen states: the port stepped from the reference's state
before the frame against the reference's step, and the reference stepped
from the port's own state against the port's step.

- the blackout step that sets ``lost`` (the 11th bad frame in a row):
  ``bad_track_count`` and ``lost`` equal, the map's count unchanged;
- the reappearance step: ``lost`` cleared, the pose within 1e-4 m (and
  1e-4 in rotation);
- the port's free run: ``bad_track_count`` and ``lost`` equal to the
  reference's on every frame, the recovered pose within tests/test_reloc.py's
  0.06 m of the truth;
- one multi-model step (external masks) with ``lost`` set, from a reference
  MultiState carried across by ``interop``: a blackout frame leaves the
  global model's map as it was, ``lost`` stays set and the count of bad
  frames goes on;
- ``interop``'s dicts of both state kinds share no memory with the engine's
  tensors on the CPU (which the next step updates in place).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu import config as J
from multimotionfusion_tpu import engine_multi as jem
from multimotionfusion_tpu.engine import MultiMotionFusionTPU
from multimotionfusion_tpu.io.frame import FrameData
from multimotionfusion_tpu.tracking import tracker as jtracker
from multimotionfusion_tpu_torch import config as T
from multimotionfusion_tpu_torch import interop
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
from tests import synthetic
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMK = dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
H, W = CAMK["height"], CAMK["width"]
BUCKET = 1 << 16  # both packages' work bucket at this capacity
LOST_AT, REAPPEAR = 14, 17  # the frame that sets lost, the reappearance


def cfg_of(C, **kw):
    """tests/test_reloc.py's configuration."""
    return C.EngineConfig(
        camera=C.CameraModel(**CAMK), enable_multi_model=False, odom_init="", reloc_mode=True,
        surfels=C.SurfelConfig(max_surfels=65536, depth_cutoff=5.0),
        ferns=C.FernConfig(num_ferns=300, factor=4, max_depth=5.0), **kw)


def frames():
    out = []
    for i in range(4):
        d, rgb = synthetic.render(synthetic.pose((0, 0.04 * i, 0), (0.06 * i, 0, 0)),
                                  J.CameraModel(**CAMK))
        out.append(FrameData(rgb=rgb.astype(np.uint8), depth=d, timestamp=i))
    black = FrameData(rgb=np.zeros((H, W, 3), np.uint8), depth=np.zeros((H, W), np.float32),
                      timestamp=99)
    out += [black] * 13
    d, rgb = synthetic.render(TRUE_POSE, J.CameraModel(**CAMK))
    out.append(FrameData(rgb=rgb.astype(np.uint8), depth=d, timestamp=100))
    return out


TRUE_POSE = synthetic.pose((0, 0.04 + 0.01, 0), (0.06 + 0.01, 0, 0))


def jstate(st):
    """A reference GlobalState as interop's dict."""
    d = {"smap.data": st.smap.data, "smap.count": st.smap.count, "pose": st.pose,
         "prev_pose": st.prev_pose, "last_intensity_coarse": st.last_intensity_coarse,
         "bad_track_count": st.bad_track_count, "lost": st.lost}
    d.update({f"filled.{k}": getattr(st.filled, k) for k in ("color", "vertex_conf",
                                                             "normal_rad")})
    for prefix in ("ferns", "pose_matches"):
        nt = getattr(st, prefix)
        d.update({f"{prefix}.{k}": getattr(nt, k) for k in nt._fields})
    return {k: np.asarray(v) for k, v in d.items()}


def to_reference(template, d):
    """The reference GlobalState holding interop dict ``d`` (track table and
    PRNG key from ``template``)."""
    def arr(key, like):
        like = np.asarray(like)
        return jnp.asarray(np.asarray(d[key]).astype(like.dtype).reshape(like.shape))

    def sub(prefix, nt):
        return nt._replace(**{k: arr(f"{prefix}.{k}", getattr(nt, k)) for k in nt._fields})

    return template._replace(
        smap=sub("smap", template.smap), filled=sub("filled", template.filled),
        ferns=sub("ferns", template.ferns), pose_matches=sub("pose_matches",
                                                            template.pose_matches),
        **{k: arr(k, getattr(template, k)) for k in ("pose", "prev_pose", "last_intensity_coarse",
                                                     "bad_track_count", "lost")})


def summary(state):
    return dict(pose=np.asarray(state.pose), lost=bool(state.lost),
                bad=int(state.bad_track_count), count=int(state.smap.count))


def reference_step(st, tick, frame):
    eng = MultiMotionFusionTPU(cfg_of(J))
    eng.state, eng.tick = st, tick
    eng._buckets = lambda k_ahead=1: (BUCKET, BUCKET)
    eng.process_frame(frame)
    eng.finish()
    return summary(eng.state)


def port_step(d, tick, frame):
    eng = MultiMotionFusionTorch(cfg_of(T), device="cpu")
    eng.set_state(interop.state_from_numpy(d, "cpu"), tick, BUCKET)
    eng.process_frame(frame)
    return summary(eng.state)


@pytest.fixture(scope="module")
def journey():
    fr = frames()
    ref = MultiMotionFusionTPU(cfg_of(J))
    ref._buckets = lambda k_ahead=1: (BUCKET, BUCKET)
    port = MultiMotionFusionTorch(cfg_of(T), device="cpu")
    port._map_bucket.reset(0, 1, BUCKET)
    ref_before, port_before, ref_out, port_out = {}, {}, [], []
    for i, f in enumerate(fr):
        if i in (LOST_AT, REAPPEAR):
            ref_before[i] = (ref.state, ref.tick)
            port_before[i] = (interop.state_to_numpy(port.state), port.tick)
        ref.process_frame(f)
        ref.finish()
        ref_out.append(summary(ref.state))
        port.process_frame(f)
        port_out.append(summary(port.state))
    step, cross = {}, {}
    for i in (LOST_AT, REAPPEAR):
        st, tick = ref_before[i]
        step[i] = port_step(jstate(st), tick, fr[i])
        d, ptick = port_before[i]
        cross[i] = reference_step(to_reference(st, d), ptick, fr[i])
    return dict(ref=ref_out, port=port_out, step=step, cross=cross, ref_state=ref.state,
                port_engine=port)


def test_free_run_lost_flags_and_recovery(journey):
    ref, port = journey["ref"], journey["port"]
    print("bad counts: reference", [r["bad"] for r in ref], "port", [p["bad"] for p in port])
    assert [p["bad"] for p in port] == [r["bad"] for r in ref]
    assert [p["lost"] for p in port] == [r["lost"] for r in ref]
    assert ref[LOST_AT]["lost"] and not ref[LOST_AT - 1]["lost"] and not ref[REAPPEAR]["lost"]
    assert len({p["count"] for p in port[LOST_AT:REAPPEAR]}) == 1  # fusion skipped while lost
    delta = np.linalg.inv(TRUE_POSE) @ port[REAPPEAR]["pose"]
    assert np.linalg.norm(delta[:3, 3]) < 0.06  # tests/test_reloc.py's bound


@pytest.mark.parametrize("kind", ["step", "cross"])
def test_blackout_step_both_ways(journey, kind):
    target = journey["ref" if kind == "step" else "port"][LOST_AT]
    got = journey[kind][LOST_AT]
    assert got["lost"] == target["lost"] is True
    assert got["bad"] == target["bad"] == 11
    assert got["count"] == target["count"]


@pytest.mark.parametrize("kind", ["step", "cross"])
def test_reappearance_step_both_ways(journey, kind):
    target = journey["ref" if kind == "step" else "port"][REAPPEAR]
    got = journey[kind][REAPPEAR]
    print(kind, "pose gap", np.abs(got["pose"] - target["pose"]).max())
    assert not got["lost"] and not target["lost"]
    assert np.abs(got["pose"][:3, 3] - target["pose"][:3, 3]).max() < 1e-4
    assert np.abs(got["pose"][:3, :3] - target["pose"][:3, :3]).max() < 1e-4


def test_multi_model_step_while_lost(journey):
    """A reference MultiState as the reference's facade builds it from its
    global state (here the one after the journey), marked lost, carried
    across; one blackout frame with external masks."""
    st = journey["ref_state"]
    jcfg = dataclasses.replace(cfg_of(J), enable_multi_model=True, object_slots=2,
                               object_capacity=2048,
                               segmentation=J.SegmentationConfig(mode="precomputed"))
    kc = jcfg.keypoints
    zeros = jnp.zeros((H, W), jnp.int32)
    ms = jem.MultiState(
        smap=st.smap, pose=st.pose, prev_pose=st.prev_pose, filled=st.filled, pred_own=zeros,
        last_intensity_coarse=st.last_intensity_coarse,
        tracks=jtracker.empty(kc.max_tracks, kc.track_history, kc.desc_dim),
        tracks_segm=jtracker.empty(1, 2, kc.desc_dim), rng=st.rng,
        objects=jem.empty_objects(jcfg, jcfg.camera), prev_mask=zeros,
        prev_intensity=jnp.zeros((H, W), jnp.float32), last_spawn=jnp.zeros((), jnp.int32),
        ferns=st.ferns, bad_track_count=jnp.int32(11), lost=jnp.asarray(True),
        pose_matches=st.pose_matches)
    d = jstate(ms)
    d.update({f"{p}.{k}": np.asarray(getattr(getattr(ms, p), k))
              for p in ("tracks", "tracks_segm", "objects")
              for k in getattr(ms, p)._fields})
    d.update({k: np.asarray(getattr(ms, k)) for k in ("pred_own", "prev_mask", "prev_intensity",
                                                     "last_spawn")})
    tcfg = dataclasses.replace(cfg_of(T), enable_multi_model=True, object_slots=2,
                               object_capacity=2048,
                               segmentation=T.SegmentationConfig(mode="precomputed"))
    eng = MultiMotionFusionTorch(tcfg, device="cpu")
    eng.set_state(interop.multi_state_from_numpy(d, "cpu"), 20, BUCKET, 2048)
    black = frames()[4]
    black.mask = np.zeros((H, W), np.uint8)
    eng.process_frame(black)
    stats = eng.finish()
    out = eng.state
    n = int(d["smap.count"])
    assert stats["lost"] == 1.0 and bool(out.lost) and int(out.bad_track_count) == 12
    assert int(out.smap.count) == n
    assert np.array_equal(out.smap.data[:, :BUCKET].numpy(), d["smap.data"][:, :BUCKET])
    assert int(out.ferns.count) == int(d["ferns.count"])  # no keyframe while lost
    _no_shared_memory(interop.multi_state_to_numpy(out), out)


def _tensors(state):
    for v in state:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, tuple):
            yield from _tensors(v)


def _no_shared_memory(d, state):
    views = [t.numpy() for t in _tensors(state)]
    shared = [k for k, a in d.items() if any(np.shares_memory(a, v) for v in views)]
    assert len(d) > 20 and shared == []


def test_interop_copies_share_no_memory(journey):
    st = journey["port_engine"].state
    d = interop.state_to_numpy(st)
    assert {"ferns.codes", "ferns.count", "bad_track_count", "lost",
            "pose_matches.times"} <= set(d)
    _no_shared_memory(d, st)
