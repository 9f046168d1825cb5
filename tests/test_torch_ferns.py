"""The port's fern keyframe database (K22 plain versions, ``model/ferns.py``)
against the reference package's, on the CPU, at 160x120 with ferns at ÷4
(tests/test_ferns.py's scene and configuration).

The reference's conservatory (``fern_pos``, ``fern_thresh``: threefry draws)
is carried across, so both packages encode with the same ferns. Both get the
same ÷4 frames: the reference's ``downsample_frame`` of its vertex and normal
maps, the port's ``fern_frame`` of the same depth and colour.

- the ÷4 frame: colour and vertices equal, normals within 1e-6;
- ``encode``, ``block_hd`` and ``add_frame``'s decisions exactly equal over
  the insertion sequence of tests/test_ferns.py (four distinct views insert,
  a repeated view does not), and the first argmax on a constructed
  similarity tie (a keyframe's codes copied into a later slot);
- ``find_frame`` near keyframe 1: ``best``, ``ok`` and the similarity equal,
  the pose within 1e-4 m, the ICP and photometric errors within 1e-4
  relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel as JCam
from multimotionfusion_tpu.config import FernConfig as JFern
from multimotionfusion_tpu.config import OdometryConfig as JOdo
from multimotionfusion_tpu.model import ferns as jf
from multimotionfusion_tpu.ops import maps as jmaps
from multimotionfusion_tpu_torch.config import CameraModel, FernConfig
from multimotionfusion_tpu_torch.model import ferns as tf
from tests import synthetic

CAMK = dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
CAM = CameraModel(**CAMK)
JCAM = JCam(**CAMK)
FCFG = dict(num_ferns=300, factor=4, max_depth=5.0)
CAM_S = tf.fern_camera(CAM, 4)
JCAM_S = JCam(width=40, height=30, fx=33.0, fy=33.0, cx=20.0, cy=15.0)
JOCFG = JOdo(num_pyr=2, iterations=(10, 5), so3_prealign=False, mask_icp=False, mask_rgb=False,
             min_grad_magnitudes=(5.0, 3.0))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs (six pytest workers share the
    CPU; see tests/test_torch_segmentation.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _poses(n):
    return [synthetic.pose((0, 0.08 * i, 0), (0.15 * i, 0, 0)) for i in range(n)]


def frames_of(T):
    """(reference ÷4 frame (rgb, vmap, nmap, depth), the port's) of one view."""
    depth, rgb = synthetic.render(T, JCAM)
    rgb_u8 = rgb.astype(np.uint8)
    vmap = jmaps.create_vmap(jnp.asarray(depth), JCAM, 5.0)
    rgb_s, vmap_s, nmap_s = jf.downsample_frame(jnp.asarray(rgb_u8, jnp.float32), vmap,
                                                jmaps.create_nmap(vmap), 4)
    port = tf.fern_frame(torch.from_numpy(rgb_u8), torch.from_numpy(depth), CAM, 5.0, 4)
    return (rgb_s, vmap_s, nmap_s, vmap_s[..., 2]), port


def to_port(jdb) -> tf.FernDB:
    return tf.FernDB(*(torch.from_numpy(np.array(getattr(jdb, k))).to(tf.DTYPES.get(k, tf.F32))
                       for k in tf.FIELDS))


@pytest.fixture(scope="module")
def store():
    """Both stores after tests/test_ferns.py's four insertions, each
    insertion's decisions, and the query frames."""
    jdb = jf.create(JFern(**FCFG), JCAM, capacity=16, seed=0)
    tdb = to_port(jdb)
    steps = []
    for i, T in enumerate(_poses(4) + [_poses(2)[1]]):
        (rgb_s, vmap_s, nmap_s, _), fr = frames_of(T)
        jcodes = jf.encode(jdb, rgb_s, vmap_s)
        jsim = jf.block_hd(jdb, jcodes)
        jdb, jins = jf.add_frame(jdb, rgb_s, vmap_s, nmap_s, jnp.asarray(T), i, 0.2)
        hd = tf.encode_hd(tdb, fr, fetch=True)
        tins = tf.add_frame(tdb, fr, hd, torch.from_numpy(T.astype(np.float32)), i, 0.2)
        steps.append((np.asarray(jcodes), np.asarray(jsim), bool(jins), hd, bool(tins)))
    return jdb, tdb, steps


def test_create_draws_the_conservatory_from_the_seed():
    """The port's own draws (a torch.Generator, not threefry): the
    reference's ranges and shapes, the same store for the same seed, an
    empty store of the given capacity (0 without reloc or loop closure)."""
    cfg = FernConfig(**FCFG)
    a, b = tf.create(cfg, CAM, 16, seed=3), tf.create(cfg, CAM, 16, seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.fern_thresh, tf.create(cfg, CAM, 16, seed=4).fern_thresh)
    pos, th = a.fern_pos, a.fern_thresh
    assert pos.shape == (300, 2) and pos.dtype == torch.int32
    assert int(pos[:, 0].min()) >= 0 and int(pos[:, 0].max()) < 40
    assert int(pos[:, 1].min()) >= 0 and int(pos[:, 1].max()) < 30
    assert float(th[:, :3].min()) >= 0.0 and float(th[:, :3].max()) < 255.0
    assert float(th[:, 3].min()) >= 400.0 and float(th[:, 3].max()) < 5000.0
    assert a.codes.shape == (16, 300) and bool((a.codes == 255).all()) and int(a.count) == 0
    assert tf.create(cfg, CAM, 0).rgb.shape == (0, 30, 40, 3)


def test_fern_frame_matches_downsample():
    (rgb_s, vmap_s, nmap_s, depth_s), fr = frames_of(_poses(3)[2])
    assert np.array_equal(fr.rgb.numpy(), np.asarray(rgb_s).astype(np.uint8))
    assert np.array_equal(fr.vmap.numpy(), np.asarray(vmap_s))
    assert np.array_equal(fr.depth.numpy(), np.asarray(depth_s))
    np.testing.assert_allclose(fr.nmap.numpy(), np.asarray(nmap_s), atol=1e-6)
    assert (fr.depth > 0).float().mean() > 0.9


def test_encode_block_hd_and_insert_decisions(store):
    jdb, tdb, steps = store
    for i, (jcodes, jsim, jins, hd, tins) in enumerate(steps):
        assert np.array_equal(hd.codes.numpy(), jcodes), i
        assert np.array_equal(hd.sim.numpy(), jsim), i  # integer counts, one division
        assert int(hd.best) == int(np.argmax(jsim)), i
        assert tins == jins, i
    assert [s[2] for s in steps] == [True] * 4 + [False]  # the repeated view is refused
    for k in tf.FIELDS:
        a, b = getattr(tdb, k).numpy(), np.asarray(getattr(jdb, k))
        if k == "nmap":  # normals: the cross product's norm rounds otherwise
            assert np.abs(a - b).max() <= 1e-6
        else:
            assert np.array_equal(a, b), k


def test_similarity_tie_takes_the_lower_index(store):
    jdb, tdb, _ = store
    jdb = jdb._replace(codes=jdb.codes.at[3].set(jdb.codes[1]))
    tdb = tdb._replace(codes=tdb.codes.clone())
    tdb.codes[3] = tdb.codes[1]
    T_q = synthetic.pose((0, 0.08 + 0.01, 0), (0.15 + 0.01, 0, 0))
    (rgb_q, vmap_q, _, _), fr = frames_of(T_q)
    jsim = np.asarray(jf.block_hd(jdb, jf.encode(jdb, rgb_q, vmap_q)))
    hd = tf.encode_hd(tdb, fr, fetch=True)
    assert jsim[1] == jsim[3] == jsim.max()
    assert np.array_equal(hd.sim.numpy(), jsim)
    assert int(hd.best) == int(jnp.argmax(jnp.asarray(jsim))) == 1
    assert np.array_equal(hd.kf_pose.numpy(), np.asarray(jdb.poses[1]))


def test_find_frame_matches_reference(store):
    jdb, tdb, _ = store
    T_true = synthetic.pose((0, 0.08 + 0.015, 0), (0.15 + 0.02, 0, 0.01))
    (rgb_q, vmap_q, nmap_q, depth_q), fr = frames_of(T_true)
    jr = jf.find_frame(jdb, rgb_q, vmap_q, nmap_q, depth_q, JCAM_S, JOCFG,
                       max_icp_error=5e-4, min_icp_count_frac=0.05)
    hd = tf.encode_hd(tdb, fr, fetch=True)
    tr = tf.find_frame(tdb, fr, hd, CAM_S, max_icp_error=5e-4, min_icp_count_frac=0.05)
    print("reference: best", int(jr.best), "ok", bool(jr.ok), "icp", float(jr.icp_error),
          "photo", float(jr.photo_error), "| port:", int(tr.best), bool(tr.ok),
          float(tr.icp_error), float(tr.photo_error))
    assert int(tr.best) == int(jr.best) == 1
    assert bool(tr.ok) == bool(jr.ok) and bool(tr.ok)
    assert float(tr.similarity) == float(jr.similarity)
    assert np.abs(tr.pose.numpy()[:3, 3] - np.asarray(jr.pose)[:3, 3]).max() < 1e-4
    assert np.abs(tr.pose.numpy()[:3, :3] - np.asarray(jr.pose)[:3, :3]).max() < 1e-4
    assert abs(float(tr.icp_error) - float(jr.icp_error)) <= 1e-4 * float(jr.icp_error)
    assert abs(float(tr.photo_error) - float(jr.photo_error)) <= 1e-4 * float(jr.photo_error)
    delta = np.linalg.inv(T_true) @ tr.pose.numpy()
    assert np.linalg.norm(delta[:3, 3]) < 0.05  # tests/test_ferns.py's bound
