"""The port's external-mask segmentation and multi-model lifecycle against
the reference package, on the CPU, at 80x60, on frozen inputs.

- ``precomputed_segmentation``: slot mask, candidate, its pixels, areas and
  reactivation flags exact; the depth means within 1e-6 relative (float sums
  in another order);
- ``_lifecycle_update`` on the same frozen inputs: a spawn (with a
  reactivation beside it), a deactivation that stores its model (the
  track snapshot), and (with ``enable_redetection``) a stored model
  re-attached to a new segment whose keypoints carry its stored
  descriptors: the final mask, every object slot field, the track labels
  and the cool-down tick equal, the spawned map within 1e-4 (the frame
  surfels' normals differ by ~2e-5 between the two packages), the
  redetected pose within 1e-5 of the reference's and of the true one (the
  RANSAC uniforms differ, but every candidate of clean correspondences
  finds the same inliers, and the pose is the refit on them).
"""

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu import config as J
from multimotionfusion_tpu import engine_multi as jem
from multimotionfusion_tpu.io import synthetic
from multimotionfusion_tpu.ops import image as jimg
from multimotionfusion_tpu.ops import maps as jmaps
from multimotionfusion_tpu.segmentation import flow_crf as jseg
from multimotionfusion_tpu.segmentation import precomputed as jpc
from multimotionfusion_tpu.tracking import superpoint as jsp
from multimotionfusion_tpu.tracking import tracker as jtr
from multimotionfusion_tpu_torch import config as T
from multimotionfusion_tpu_torch import engine_multi as tem
from multimotionfusion_tpu_torch.segmentation import precomputed as tpc
from multimotionfusion_tpu_torch.tracking import superpoint as tsp
from multimotionfusion_tpu_torch.tracking import tracker as ttr
from tests.test_torch_multi_engine import CAMK, H, W, _cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


# ---------------------------------------------------------------- segmentation

def _seg_case(seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((H, W), np.int32)
    m[5:20, 5:25] = 7
    m[30:55, 40:75] = 9
    m[22:28, 0:80] = 3
    m[50:58, 2:10] = 200  # below the size gate
    m[rng.random((H, W)) < 0.02] = 255
    return m


@pytest.mark.parametrize("ext_ids,active", [
    ([7, 0, 3], [True, False, False]),   # slot 2's id reappears: reactivation
    ([0, 0, 0], [False, False, False]),  # nothing mapped: the largest id spawns
    ([7, 9, 3], [True, True, True]),     # every large id mapped: no candidate
])
def test_precomputed_segmentation_exact(ext_ids, active):
    m = _seg_case(0)
    depth = np.random.default_rng(1).uniform(0.5, 3.0, (H, W)).astype(np.float32)
    depth[::7, ::5] = 0.0
    ref = jpc.precomputed_segmentation(jnp.asarray(m), jnp.asarray(ext_ids, jnp.int32),
                                       jnp.asarray(active), jnp.asarray(depth), 100)
    out = tpc.precomputed_segmentation(torch.from_numpy(m), torch.tensor(ext_ids, dtype=torch.int32),
                                       torch.tensor(active), torch.from_numpy(depth), 100)
    for k in ("mask", "new_label_mask", "has_new_label", "new_ext_id", "pixel_counts",
              "reactivate"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)
    np.testing.assert_allclose(out.depth_mean.numpy(), np.asarray(ref.depth_mean), rtol=1e-6)


# ---------------------------------------------------------------- lifecycle

def _frame_inputs(time):
    cam = J.CameraModel(**CAMK)
    depth, rgb = synthetic.render(synthetic.pose((0.0, 0.002, 0.0), (0.003, 0.0, 0.0)), cam)
    rgb_u8 = rgb.astype(np.uint8)
    depth_filt = np.asarray(jimg.bilateral_depth_filter(jnp.asarray(depth)))
    return depth.astype(np.float32), depth_filt, rgb_u8


def _slots(cfg, rng):
    """Three slots: 0 active (ext 7) with a mature map, 1 inactive (ext 3,
    its map kept), 2 free."""
    S, cap = cfg.object_slots, cfg.object_capacity
    ks, d = cfg.keypoints.max_keypoints, cfg.keypoints.desc_dim
    data = np.zeros((S, 16, cap), np.float32)
    for s, n in ((0, 700), (1, 300)):
        data[s, :3, :n] = rng.normal(size=(3, n)) * 0.1 + np.array([[0.0], [0.0], [1.5]])
        data[s, 3, :n] = rng.uniform(0.2, 2.0, n)
        data[s, 13, :n] = 1.0
    return dict(data=data, count=np.array([700, 300, 0], np.int32),
                pose=np.stack([synthetic.pose((0.01, 0, 0), (0.02, 0, 0)), np.eye(4),
                               np.eye(4)]).astype(np.float32),
                active=np.array([True, False, False]), unseen=np.array([1, 0, 0], np.int32),
                spawn_tick=np.array([2, 3, 0], np.int32),
                conf_t=np.array([1.5, 0.01, 0.01], np.float32),
                max_depth=np.array([1.8, 5.0, 5.0], np.float32),
                stored=np.array([False, True, False]),
                stored_desc=np.zeros((S, ks, d), np.float32),
                stored_p3d=np.zeros((S, ks, 3), np.float32),
                stored_valid=np.zeros((S, ks), bool), ext_id=np.array([7, 3, 0], np.int32))


def _tracks(cfg, time, rng):
    kc = cfg.keypoints
    T_, Hh, D = kc.max_tracks, kc.track_history, kc.desc_dim
    act = rng.random(T_) < 0.5
    return dict(xy=rng.uniform([0, 0], [W - 1, H - 1], (T_, Hh, 2)).astype(np.float32),
                p3d=rng.normal(size=(T_, Hh, 3)).astype(np.float32),
                seen=rng.random((T_, Hh)) < 0.8, has_depth=rng.random((T_, Hh)) < 0.8,
                desc=rng.normal(size=(T_, D)).astype(np.float32),
                last_seen=np.where(rng.random(T_) < 0.6, time, time - 1).astype(np.int32),
                nvalid=rng.integers(1, 9, T_).astype(np.int32), active=act,
                model_id=rng.integers(0, 3, T_).astype(np.int32))


@pytest.mark.parametrize("scenario", ["spawn_and_reactivate", "deactivate_and_store",
                                      "redetect"])
def test_lifecycle_update_matches_reference(scenario):
    cfg_j, cfg_t = _cfg(J), _cfg(T)
    if scenario == "redetect":
        cfg_j = dataclasses.replace(cfg_j, enable_redetection=True)
        cfg_t = dataclasses.replace(cfg_t, enable_redetection=True)
    rng = np.random.default_rng(3)
    time = 6
    depth, depth_filt, rgb_u8 = _frame_inputs(time)
    slots = _slots(cfg_j, rng)
    tracks = _tracks(cfg_j, time, rng)
    mask = np.zeros((H, W), np.int32)
    new_label = np.zeros((H, W), bool)
    if scenario == "spawn_and_reactivate":
        mask[10:25, 10:30] = 1
        mask[35:50, 50:70] = 2
        new_label[30:50, 5:30] = True
        counts = np.array([H * W - 600, 300, 300, 0], np.int32)
        reactivate = np.array([False, True, False])
        has_new = True
    elif scenario == "redetect":
        mask[10:25, 10:30] = 1
        new_label[30:50, 5:30] = True
        counts = np.array([H * W - 800, 300, 0, 0], np.int32)
        reactivate = np.zeros(3, bool)
        has_new = True
    else:
        counts = np.array([H * W, 0, 0, 0], np.int32)
        reactivate = np.zeros(3, bool)
        has_new = False
    # the new label's depth band around its pixels' mean depth
    dm = np.array([2.0, 1.4, 1.6, 2.2, depth_filt[new_label | ~new_label.any()].mean()],
                  np.float32)
    ds = np.array([0.3, 0.05, 0.0, 0.2, 0.01], np.float32)
    K = cfg_j.keypoints.max_keypoints
    kxy = rng.uniform([0, 0], [W - 1, H - 1], (K, 2)).astype(np.float32)
    kdesc = rng.normal(size=(K, cfg_j.keypoints.desc_dim)).astype(np.float32)
    kvalid = rng.random(K) < 0.7
    T_true = synthetic.pose((0.02, -0.05, 0.01), (0.03, -0.02, 0.05))
    if scenario == "redetect":
        # 40 keypoints in the new segment carry slot 1's stored descriptors;
        # its stored points are their camera points in its model frame
        kxy[:40] = rng.uniform([6, 31], [28, 48], (40, 2)).astype(np.float32)
        kvalid[:40] = True
        kdesc /= np.linalg.norm(kdesc, axis=1, keepdims=True)
        xi, yi = np.rint(kxy[:40, 0]).astype(int), np.rint(kxy[:40, 1]).astype(int)
        z = depth_filt[yi, xi].astype(np.float64)
        assert (z > 0).all()
        p = np.stack([z * (kxy[:40, 0] - CAMK["cx"]) / CAMK["fx"],
                      z * (kxy[:40, 1] - CAMK["cy"]) / CAMK["fy"], z], -1)
        slots["stored_desc"][1, :40] = kdesc[:40]
        slots["stored_p3d"][1, :40] = p @ T_true[:3, :3].T + T_true[:3, 3]
        slots["stored_valid"][1, :40] = True
    new_pose0 = synthetic.pose((0.0, 0.003, 0.0), (0.004, 0.0, 0.0))
    prev_pose = synthetic.pose((0.0, 0.002, 0.0), (0.002, 0.0, 0.0))
    obj_new = np.stack([synthetic.pose((0.011, 0, 0), (0.021, 0, 0)), np.eye(4),
                        np.eye(4)]).astype(np.float32)
    conf_sum = np.array([300.0, 0.0, 0.0], np.float32)
    conf_cnt = np.array([100.0, 0.0, 0.0], np.float32)

    cam = J.CameraModel(**CAMK)
    vmap_raw = jmaps.create_vmap(jnp.asarray(depth), cam, cfg_j.surfels.depth_cutoff)
    vmap_f = jmaps.create_vmap(jnp.asarray(depth_filt), cam, cfg_j.surfels.depth_cutoff)
    jtracks = jtr.TrackTable(**{k: jnp.asarray(v) for k, v in tracks.items()})
    ref = jem._lifecycle_update(
        jem.ObjectSlots(**{k: jnp.asarray(v) for k, v in slots.items()}),
        jseg.SegmentationResult(jnp.asarray(mask), jnp.asarray(new_label), jnp.asarray(has_new),
                                jnp.asarray(counts), jnp.asarray(dm), jnp.asarray(ds),
                                jnp.zeros((H // 4, W // 4, 2))),
        jtracks, jtracks, False,
        jsp.Keypoints(jnp.asarray(kxy), jnp.zeros(K), jnp.asarray(kdesc), jnp.asarray(kvalid)),
        jnp.asarray(depth_filt), jnp.asarray(rgb_u8, jnp.float32), vmap_raw, vmap_f,
        jmaps.create_nmap(vmap_f), jnp.asarray(new_pose0), jnp.asarray(prev_pose),
        jnp.asarray(obj_new), time, jnp.asarray(3, jnp.int32), 1.0, jnp.asarray(conf_sum),
        jnp.asarray(conf_cnt), jnp.asarray(reactivate), jnp.asarray(9, jnp.int32),
        jax.random.PRNGKey(0), cam, cfg_j)

    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    ttracks = ttr.TrackTable(**{k: t(v) for k, v in tracks.items()})
    out = tem._lifecycle_update(
        tem.ObjectSlots(**{k: t(v) for k, v in slots.items()}),
        tem.SegResult(t(mask), t(new_label), t(has_new), t(counts), t(dm), t(ds)), ttracks,
        tsp.Keypoints(t(kxy), torch.zeros(K), t(kdesc), t(kvalid)), t(depth), t(depth_filt),
        t(rgb_u8), t(new_pose0), t(prev_pose), t(obj_new), time, torch.tensor(3, dtype=torch.int32),
        1.0, t(conf_sum), t(conf_cnt), t(reactivate), torch.tensor(9, dtype=torch.int32),
        T.CameraModel(**CAMK), cfg_t, torch.Generator().manual_seed(0))

    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert bool(out.spawn) == bool(ref.spawn) == (scenario == "spawn_and_reactivate")
    assert bool(out.any_red) == bool(ref.any_red) == (scenario == "redetect")
    assert int(out.target_slot) == int(ref.target_slot)
    assert int(out.last_spawn) == int(ref.last_spawn)
    np.testing.assert_array_equal(ttracks.model_id.numpy(), np.asarray(ref.tracks.model_id))
    o = out.objects
    for k, v in (("count", ref.obj_count), ("active", ref.obj_active), ("stored", ref.obj_stored),
                 ("spawn_tick", ref.obj_spawn_tick), ("ext_id", ref.obj_ext_id),
                 ("unseen", ref.unseen), ("stored_valid", ref.stored_valid)):
        np.testing.assert_array_equal(getattr(o, k).numpy(), np.asarray(v), err_msg=k)
    for k, v in (("pose", ref.obj_pose), ("conf_t", ref.conf_t), ("max_depth", ref.max_depth),
                 ("stored_desc", ref.stored_desc), ("stored_p3d", ref.stored_p3d)):
        tol = 1e-5 if k == "pose" and scenario == "redetect" else 1e-6
        np.testing.assert_allclose(getattr(o, k).numpy(), np.asarray(v), atol=tol, err_msg=k)
    np.testing.assert_allclose(o.data.numpy(), np.asarray(ref.obj_data), atol=1e-4)
    if scenario == "spawn_and_reactivate":
        assert o.active.tolist() == [True, True, True] and int(o.count[2]) > 100
    elif scenario == "redetect":
        assert int(out.target_slot) == 1 and o.active.tolist() == [True, True, False]
        assert not bool(o.stored[1]) and int(o.ext_id[1]) == 9
        np.testing.assert_allclose(o.pose[1].numpy(), T_true, atol=1e-5)
    else:
        assert o.active.tolist() == [False, False, False] and bool(o.stored[0])
        assert bool(o.stored_valid[0].any())
        # no spawn: the back-dating transforms are the identity
        np.testing.assert_array_equal(out.refine_T.numpy(), np.asarray(ref.refine_T))
