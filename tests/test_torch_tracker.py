"""The port's keypoint track table (K20 plain versions, on the CPU) against the
reference package, on the same numpy inputs at 160x120.

- ``mutual_match`` on the cross-check case of tests/test_tracking.py and on
  random descriptors with invalid rows and columns: the matches equal the
  reference's, except where the reference's two best distances of a row or
  column lie within 1e-6 of each other (the two pipelines sum the dot
  products in other orders, so such a near-tie may break the other way);
  those are excused and counted;
- ``add_keypoints`` over three frames of the synthetic scene, both tables fed
  the same keypoints (the reference's, converted): integer and boolean fields
  equal, float fields within 1e-6;
- ``prune``, ``last_pair`` and ``pair_between``: equal, and ``update`` (the
  engine's fused add/prune/pair) equals the three in sequence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel, KeypointConfig
from multimotionfusion_tpu.ops.image import rgb_to_intensity
from multimotionfusion_tpu.tracking import superpoint as jsp
from multimotionfusion_tpu.tracking import tracker as jtr
from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
from multimotionfusion_tpu_torch.config import KeypointConfig as TKeypointConfig
from multimotionfusion_tpu_torch.tracking import superpoint as tsp
from multimotionfusion_tpu_torch.tracking import tracker as ttr
from tests import synthetic
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMK = dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
CAM, TCAM = CameraModel(**CAMK), TCameraModel(**CAMK)
KK = dict(max_keypoints=256, max_tracks=1024, track_history=8, detector="patch",
          match_dist_gate=1.0)
KCFG, TKCFG = KeypointConfig(**KK), TKeypointConfig(**KK)


def _t(a):
    return torch.from_numpy(np.array(a))


def _near_ties(d2, axis):
    """Rows (axis=1) or columns (axis=0) whose two smallest distances are
    within 1e-6."""
    part = np.sort(d2, axis=axis)
    first, second = np.take(part, 0, axis=axis), np.take(part, 1, axis=axis)
    return (second - first) <= 1e-6


def _compare_match(q, t, qv, tv, gate):
    mj, tj = (np.asarray(a) for a in jtr.mutual_match(jnp.asarray(q), jnp.asarray(t),
                                                      jnp.asarray(qv), jnp.asarray(tv), gate))
    mt, tt = (a.numpy() for a in ttr.mutual_match(_t(q), _t(t), _t(qv), _t(tv), gate))
    d2 = ((q[:, None, :] - t[None, :, :]) ** 2).sum(-1)
    d2 = np.where(qv[:, None] & tv[None, :], d2, 1e30)
    tied_rows = _near_ties(d2, 1)
    tied_cols = _near_ties(d2, 0)
    # a near-tie in a row, or in the column of either side's best match
    excused = qv & (tied_rows | tied_cols[np.argmin(d2, 1)])
    differ = mt != mj
    assert not (differ & ~excused).any(), np.nonzero(differ & ~excused)
    print(f"mutual_match: {int(differ.sum())} differing of {len(mj)}, "
          f"{int(excused.sum())} near-ties excused")
    return mj, mt, tj, tt, excused


def test_mutual_match_cross_check():
    rng = np.random.default_rng(0)
    t_desc = rng.normal(size=(32, 16)).astype(np.float32)
    t_desc /= np.linalg.norm(t_desc, axis=1, keepdims=True)
    perm = rng.permutation(32)
    q_desc = (t_desc[perm] + 0.01 * rng.normal(size=(32, 16))).astype(np.float32)
    ones = np.ones(32, bool)
    mj, mt, tj, tt, _ = _compare_match(q_desc, t_desc, ones, ones, 0.5)
    np.testing.assert_array_equal(mt, perm)
    np.testing.assert_array_equal(tt, tj)
    q_far = (rng.normal(size=(32, 16)) * 10).astype(np.float32)
    mj, mt, _, _, _ = _compare_match(q_far, t_desc, ones, ones, 0.5)
    assert (mt < 0).all() and (mj < 0).all()


def test_mutual_match_random_descriptors():
    rng = np.random.default_rng(1)
    t_desc = rng.normal(size=(1024, 64)).astype(np.float32)
    t_desc /= np.linalg.norm(t_desc, axis=1, keepdims=True)
    src = rng.integers(0, 1024, 256)
    q_desc = (t_desc[src] + 0.05 * rng.normal(size=(256, 64))).astype(np.float32)
    q_desc /= np.linalg.norm(q_desc, axis=1, keepdims=True)
    qv, tv = rng.random(256) < 0.9, rng.random(1024) < 0.8
    mj, mt, _, _, _ = _compare_match(q_desc, t_desc, qv, tv, 1.0)
    assert (mj >= 0).sum() > 100


def _frames():
    out = []
    for i in range(1, 4):
        depth, rgb = synthetic.render(synthetic.pose((0.0, 0.004 * i, 0.0), (0.01 * i, 0.0, 0.0)),
                                      CAM)
        kps = jsp.patch_detect(rgb_to_intensity(jnp.asarray(rgb)), KCFG.max_keypoints)
        out.append((i, depth, kps))
    return out


def _assert_tables(tj, tt, atol=1e-6):
    for f in ttr.FIELDS:
        a, b = np.asarray(getattr(tj, f)), getattr(tt, f).numpy()
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.fixture(scope="module")
def tables():
    tj = jtr.empty(KCFG.max_tracks, KCFG.track_history, KCFG.desc_dim)
    tt = ttr.empty(KCFG.max_tracks, KCFG.track_history, KCFG.desc_dim)
    steps = []
    for time, depth, kps in _frames():
        tj = jtr.add_keypoints(tj, kps, jnp.asarray(depth), time, CAM, KCFG)
        ttr.add_keypoints(tt, tsp.Keypoints(*(_t(a) for a in kps)), _t(depth), time, TCAM, TKCFG)
        steps.append((tj, ttr.TrackTable(*(a.clone() for a in tt))))
    return steps


def test_add_keypoints_three_frames(tables):
    for tj, tt in tables:
        _assert_tables(tj, tt)
    tj, tt = tables[-1]
    assert int(tt.active.sum()) > 60 and int((tt.nvalid > 1).sum()) > 30


def test_prune_and_last_pair(tables):
    tj, tt = tables[-1]
    for time in (3, 3 + 31, 3 + 40):
        pj = jtr.prune(tj, time, KCFG)
        pt = ttr.prune(ttr.TrackTable(*(a.clone() for a in tt)), time, TKCFG)
        np.testing.assert_array_equal(pt.active.numpy(), np.asarray(pj.active))
    assert int(pt.active.sum()) == 0
    for a, b in zip(jtr.last_pair(tj, 3), ttr.last_pair(tt, 3)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jtr.pair_between(tj, 1, 3), ttr.pair_between(tt, 1, 3)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(ttr.last_pair(tt, 3)[2].sum()) > 25


def test_update_is_add_prune_pair():
    (_, d1, k1), (_, d2, k2) = _frames()[:2]
    tj = jtr.empty(KCFG.max_tracks, KCFG.track_history, KCFG.desc_dim)
    tj = jtr.add_keypoints(tj, k1, jnp.asarray(d1), 1, CAM, KCFG)
    tj = jtr.prune(jtr.add_keypoints(tj, k2, jnp.asarray(d2), 2, CAM, KCFG), 2, KCFG)
    tt = ttr.empty(KCFG.max_tracks, KCFG.track_history, KCFG.desc_dim)
    ttr.add_keypoints(tt, tsp.Keypoints(*(_t(a) for a in k1)), _t(d1), 1, TCAM, TKCFG)
    pair = ttr.update(tt, tsp.Keypoints(*(_t(a) for a in k2)), _t(d2), 2, TCAM, TKCFG)
    _assert_tables(tj, tt)
    for a, b in zip(jtr.last_pair(tj, 2), pair):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
