"""The port's keypoint detectors (K19 plain versions, on the CPU) against the
reference package, on the same numpy inputs at 160x120.

- ``nms_topk`` against the reference's ``_nms_topk`` (whose ``approx_max_k``
  is the exact top-k on the CPU): xy, score and valid equal in all K slots,
  on random scores, on a plateau holding more peaks than K, and on fewer
  peaks than K (the empty slots hold score 0 at the lowest flat indices);
- ``patch_score``: the Shi-Tomasi score within 1e-5 of the score range (the
  reference's compiler contracts the blur to FMAs and rounds apart by an ulp
  here and there), the blurred intensity likewise;
- ``patch_detect`` on frames of the synthetic scene: at least 98 % of the
  reference's valid keypoints at equal xy (an ulp in a score can move a
  plateau peak or the last top-k slot; the measured share is printed), and
  their descriptors within 1e-5;
- SuperPoint with the reference's ``superpoint_init(PRNGKey(0))`` carried
  across by ``params_from_numpy``: heat map and coarse descriptors within
  1e-5, ``superpoint_detect`` equal on the valid keypoints; and a TorchScript
  module loads through ``load_torchscript`` to the same network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel
from multimotionfusion_tpu.ops import image as jimg
from multimotionfusion_tpu.tracking import superpoint as jsp
from multimotionfusion_tpu_torch.ops import image as timg
from multimotionfusion_tpu_torch.tracking import superpoint as tsp
from tests import synthetic

CAM = CameraModel(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
K = 256


def _t(a):
    return torch.from_numpy(np.array(a))


def _intensity(T_wc):
    _, rgb = synthetic.render(T_wc, CAM)
    return np.asarray(jimg.rgb_to_intensity(jnp.asarray(rgb)))


def _heat(kind):
    rng = np.random.default_rng(7)
    if kind == "random":
        return rng.random((CAM.height, CAM.width)).astype(np.float32), 0.5
    heat = np.zeros((CAM.height, CAM.width), np.float32)
    if kind == "plateau":  # 60 x 80 pixels, every one a peak
        heat[30:90, 40:120] = 3.0
    else:  # fewer peaks than K
        ys, xs = rng.integers(10, 110, 40), rng.integers(10, 150, 40)
        heat[ys, xs] = rng.uniform(1.5, 5.0, 40).astype(np.float32)
    return heat, 1.0


@pytest.mark.parametrize("kind", ["random", "plateau", "few"])
def test_nms_topk_matches_reference(kind):
    heat, thr = _heat(kind)
    xj, sj, vj = (np.asarray(a) for a in jsp._nms_topk(jnp.asarray(heat), K, thr, 4))
    xt, st, vt = (a.numpy() for a in tsp.nms_topk(_t(heat), K, thr, 4))
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(vt, vj)
    if kind == "plateau":
        assert vt.all()
    if kind == "few":
        assert 0 < vt.sum() < K and (st[~vt] == 0).all()


def test_patch_score_and_blur_match_reference():
    inten = _intensity(synthetic.pose((0.0, 0.0, 0.0), (0.01, 0.0, 0.0)))
    score_t, blur_t = (a.numpy() for a in tsp.patch_score(_t(inten)))
    gx, gy = jimg.sobel_gradients(jnp.asarray(inten))
    ixx = jimg.gaussian_blur(gx * gx, 1.5, 2)
    iyy = jimg.gaussian_blur(gy * gy, 1.5, 2)
    ixy = jimg.gaussian_blur(gx * gy, 1.5, 2)
    tr, det = ixx + iyy, ixx * iyy - ixy * ixy
    min_eig = np.asarray(tr / 2.0 - jnp.sqrt(jnp.maximum(tr * tr / 4.0 - det, 0.0)))
    inside = np.zeros_like(min_eig, bool)
    inside[8:-8, 8:-8] = True
    score_j = np.where(inside, min_eig, 0.0)
    np.testing.assert_allclose(score_t, score_j, rtol=0, atol=1e-5 * np.abs(score_j).max())
    blur_j = np.asarray(jimg.gaussian_blur(jnp.asarray(inten), 1.0, 2))
    np.testing.assert_allclose(blur_t, blur_j, rtol=0, atol=1e-5 * np.abs(blur_j).max())
    assert (score_t[~inside] == 0).all() and (score_t > 1.0).sum() > 100


def test_patch_detect_matches_reference():
    shares = []
    for i in range(3):
        inten = _intensity(synthetic.pose((0.0, 0.01 * i, 0.0), (0.01 * i, 0.0, 0.0)))
        kj = jsp.patch_detect(jnp.asarray(inten), K)
        kt = tsp.patch_detect(_t(inten), K)
        vj, vt = np.asarray(kj.valid), kt.valid.numpy()
        xy_j = {tuple(p): n for n, p in enumerate(np.asarray(kj.xy)) if vj[n]}
        xy_t = {tuple(p): n for n, p in enumerate(kt.xy.numpy()) if vt[n]}
        shared = set(xy_j) & set(xy_t)
        shares.append(len(shared) / max(len(xy_j), 1))
        dj, dt = np.asarray(kj.desc), kt.desc.numpy()
        for p in shared:
            np.testing.assert_allclose(dt[xy_t[p]], dj[xy_j[p]], rtol=0, atol=1e-5)
        assert len(xy_j) > 40
    print(f"patch_detect: shares of the reference's keypoints at equal xy {shares}")
    assert min(shares) >= 0.98, shares


@pytest.fixture(scope="module")
def superpoint_pair():
    params = jsp.superpoint_init(jax.random.PRNGKey(0))
    net = tsp.params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    inten = _intensity(np.eye(4, dtype=np.float32))
    return params, net, inten


def test_superpoint_forward_matches_reference(superpoint_pair):
    params, net, inten = superpoint_pair
    hj, dj = (np.asarray(a) for a in jsp.superpoint_apply(params, jnp.asarray(inten) / 255.0))
    ht, dt = (a.numpy() for a in tsp.superpoint_apply(net, _t(inten) / 255.0))
    assert ht.shape == (CAM.height, CAM.width) and dt.shape == (15, 20, 256)
    np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)


def test_superpoint_detect_matches_reference(superpoint_pair):
    params, net, inten = superpoint_pair
    kj = jsp.superpoint_detect(params, jnp.asarray(inten), 128, conf_thresh=0.0)
    kt = tsp.superpoint_detect(net, _t(inten), 128, conf_thresh=0.0)
    vj = np.asarray(kj.valid)
    np.testing.assert_array_equal(kt.valid.numpy(), vj)
    np.testing.assert_array_equal(kt.xy.numpy()[vj], np.asarray(kj.xy)[vj])
    np.testing.assert_allclose(kt.desc.numpy()[vj], np.asarray(kj.desc)[vj], rtol=0, atol=1e-5)
    assert vj.sum() > 10


def test_load_torchscript_matches_params(superpoint_pair, tmp_path):
    _, net, inten = superpoint_pair
    path = str(tmp_path / "SuperPointNet.pt")
    torch.jit.trace(net, torch.zeros((1, 1, 16, 16))).save(path)
    loaded = tsp.load_torchscript(path)
    for (n1, p1), (n2, p2) in zip(net.state_dict().items(), loaded.state_dict().items()):
        assert n1 == n2 and torch.equal(p1, p2)
    h1, _ = tsp.superpoint_apply(net, _t(inten) / 255.0)
    h2, _ = tsp.superpoint_apply(loaded, _t(inten) / 255.0)
    assert torch.equal(h1, h2)


def test_gaussian_blur_and_bilinear_sample_match_reference():
    rng = np.random.default_rng(3)
    img = rng.random((24, 32)).astype(np.float32) * 255
    for sigma, r in ((1.0, 2), (1.5, 2), (2.0, 3)):
        np.testing.assert_allclose(timg.gaussian_blur(_t(img), sigma, r).numpy(),
                                   np.asarray(jimg.gaussian_blur(jnp.asarray(img), sigma, r)),
                                   rtol=0, atol=1e-4)
    x = rng.uniform(-2, 34, 50).astype(np.float32)
    y = rng.uniform(-2, 26, 50).astype(np.float32)
    img3 = rng.random((24, 32, 5)).astype(np.float32)
    for im in (img, img3):
        np.testing.assert_allclose(
            timg.bilinear_sample(_t(im), _t(x), _t(y)).numpy(),
            np.asarray(jimg.bilinear_sample(jnp.asarray(im), jnp.asarray(x), jnp.asarray(y))),
            rtol=1e-6, atol=1e-5)


def test_engine_with_superpoint_detector_steps(superpoint_pair, tmp_path):
    """detector="superpoint" loads the TorchScript weights and seeds the track
    table with 256-wide descriptors (80x60, three frames on the CPU)."""
    from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
    from multimotionfusion_tpu_torch.config import EngineConfig, KeypointConfig
    from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
    from multimotionfusion_tpu_torch.io.readers import SyntheticLogReader

    _, net, _ = superpoint_pair
    path = str(tmp_path / "SuperPointNet.pt")
    torch.jit.trace(net, torch.zeros((1, 1, 16, 16))).save(path)
    cam = TCameraModel(width=80, height=64, fx=66.0, fy=66.0, cx=40.0, cy=32.0)
    kcfg = KeypointConfig(detector="superpoint", weights_path=path, max_keypoints=128,
                          max_tracks=512, detect_threshold=0.0)
    eng = MultiMotionFusionTorch(EngineConfig(camera=cam, enable_multi_model=False,
                                              keypoints=kcfg), device="cpu")
    for f in SyntheticLogReader(cam, num_frames=3):
        eng.process_frame(f)
    eng.finish()
    assert eng.state.tracks.desc.shape == (512, 256) and eng.state.tracks.active.any()
