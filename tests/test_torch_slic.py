"""The port's SLIC superpixels (K24a, K24b plain versions on the CPU) against
the reference package's ``segmentation/slic.py``, at 160x120 on a rendered
sphere scene with seeded noise.

- ``slic``: the labels equal on >= 99.9 % of the pixels (all are expected:
  the sums run in the reference's order, pixel by pixel), the centres (mean
  colour and position) and counts within 1e-5 relative;
- given the reference's labels, ``superpixel_means`` (the depth and a stack
  of seeded images) within 1e-6 relative of ``downsample_to_superpixels``;
- the labels back on the pixels: ``upsample_onehot`` equals the reference's
  ``upsample_from_superpixels`` compared with each label.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel
from multimotionfusion_tpu.segmentation import slic as jslic
from multimotionfusion_tpu_torch.segmentation import slic as tslic
from tests import synthetic
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAM = CameraModel(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)


@pytest.fixture(scope="module", params=[0, 1])
def scene(request):
    """(image, depth, reference SLIC) of the sphere scene with noise seed ``param``."""
    rng = np.random.default_rng(request.param)
    depth, rgb = synthetic.render(np.eye(4, dtype=np.float32), CAM,
                                  sphere_center=(0.15, 0.0, 1.3), sphere_radius=0.3)
    img = np.clip(rgb.astype(np.float32) + rng.normal(0.0, 8.0, rgb.shape), 0, 255)
    img = img.astype(np.float32)
    return img, depth, jslic.slic(jnp.asarray(img)), rng


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_slic_matches_reference(scene):
    img, _, ref, _ = scene
    res = tslic.slic(torch.from_numpy(img))
    assert res.grid_hw == tuple(ref.grid_hw)
    labels = res.labels.numpy()
    assert (labels == np.asarray(ref.labels)).mean() >= 0.999
    for got, want in ((res.mean_color, ref.mean_color), (res.mean_xy, ref.mean_xy),
                      (res.count, ref.count)):
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-5
    # the labels moved off the regular grid (the assignment ran)
    grid = tslic.grid_labels(CAM.height, CAM.width, tslic.SP_SIZE, "cpu").numpy()
    assert (labels != grid).mean() > 0.01


def test_superpixel_means_match_reference(scene):
    img, depth, ref, rng = scene
    images = np.concatenate([depth[None], rng.uniform(0, 0.3, (4,) + depth.shape)]).astype(
        np.float32)
    res = tslic.SlicResult(torch.from_numpy(np.asarray(ref.labels)), None, None,
                           torch.from_numpy(np.asarray(ref.count)), tuple(ref.grid_hw))
    got = tslic.superpixel_means(torch.from_numpy(images), res).numpy()
    for k in range(images.shape[0]):
        want = np.asarray(jslic.downsample_to_superpixels(jnp.asarray(images[k]), ref))
        assert _rel(got[k], want) <= 1e-6, k


def test_upsample_matches_reference(scene):
    _, _, ref, rng = scene
    s = int(np.asarray(ref.count).shape[0])
    lbl_sp = rng.integers(0, 4, s).astype(np.int32)
    want = np.asarray(jslic.upsample_from_superpixels(jnp.asarray(lbl_sp), ref))
    got = tslic.upsample_onehot(torch.from_numpy(lbl_sp), torch.from_numpy(
        np.asarray(ref.labels)), 4).numpy()
    for lbl in range(4):
        np.testing.assert_array_equal(got[lbl], want == lbl)
