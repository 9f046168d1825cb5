"""The port's legacy CoFusion CRF segmentation (K24c and the whole
``legacy_crf_segmentation``, plain versions on the CPU) against the reference
package's ``segmentation/legacy_crf.py``, at 160x120.

- ``_superpixel_crf`` given the same unaries and features (built from the
  reference's SLIC of tests/test_legacy_crf.py's scene, one model with a
  high-error region and three models with seeded errors, confidences and an
  inactive model): Q within 1e-5 absolute; the argmax equal except where the
  reference's top-two margin is below 1e-5 (matrix products summed in
  another order).
- ``legacy_crf_segmentation`` end to end on tests/test_legacy_crf.py's
  scenarios (the high-error region, with and without new labels allowed;
  uniform low error) and on the three-model case: ``has_new_label``, the
  mask, the new-label mask and ``pixel_counts`` equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel, SegmentationConfig
from multimotionfusion_tpu.segmentation import legacy_crf as jl
from multimotionfusion_tpu.segmentation import slic as jslic
from multimotionfusion_tpu_torch.config import SegmentationConfig as TSegmentationConfig
from multimotionfusion_tpu_torch.segmentation import legacy_crf as tl
from tests import synthetic
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAM = CameraModel(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
H, W = CAM.height, CAM.width
SEGK = dict(min_rel_size_new=0.02, max_rel_size_new=0.5)  # tests/test_legacy_crf.py
TIE_EPS = 1e-5


def _scene():
    depth, rgb = synthetic.render(np.eye(4, dtype=np.float32), CAM)
    return depth, rgb.astype(np.float32)


def _inputs(case):
    """(icp errors [M, H, W], confidences [M, H, W], active [M]) of a case."""
    ys, xs = np.mgrid[0:H, 0:W]
    blob = (ys - 60) ** 2 + (xs - 100) ** 2 < 30**2
    if case == "uniform":
        return (np.full((1, H, W), 0.001, np.float32), np.ones((1, H, W), np.float32),
                np.array([True]))
    err0 = np.full((H, W), 0.001, np.float32)
    err0[blob] = 0.3
    if case == "high_error":
        return err0[None], np.ones((1, H, W), np.float32), np.array([True])
    rng = np.random.default_rng(3)  # "three_models": model 1 explains the blob
    err1 = rng.uniform(0.1, 0.4, (H, W)).astype(np.float32)
    err1[blob] = 0.002
    err2 = rng.uniform(0.0, 0.05, (H, W)).astype(np.float32)
    conf = rng.uniform(0.2, 1.0, (3, H, W)).astype(np.float32)
    return np.stack([err0, err1, err2]), conf, np.array([True, True, False])


CASES = [("high_error", True), ("high_error", False), ("uniform", True), ("three_models", True)]


@pytest.mark.parametrize("case,allow_new", CASES)
def test_segmentation_matches_reference(case, allow_new):
    depth, rgb = _scene()
    err, conf, active = _inputs(case)
    ref = jl.legacy_crf_segmentation(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(err),
                                     jnp.asarray(conf), jnp.asarray(active),
                                     SegmentationConfig(**SEGK), allow_new=allow_new)
    got = tl.legacy_crf_segmentation(torch.from_numpy(rgb), torch.from_numpy(depth),
                                     torch.from_numpy(err), torch.from_numpy(conf),
                                     torch.from_numpy(active), TSegmentationConfig(**SEGK),
                                     allow_new=allow_new)
    assert bool(got.has_new_label) == bool(ref.has_new_label)
    assert bool(ref.has_new_label) == (case == "high_error" and allow_new)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.new_label_mask.numpy(), np.asarray(ref.new_label_mask))
    np.testing.assert_array_equal(got.pixel_counts.numpy(), np.asarray(ref.pixel_counts))
    np.testing.assert_array_equal(got.slic_labels.numpy(), np.asarray(ref.slic_labels))


@pytest.mark.parametrize("case", ["high_error", "three_models"])
def test_superpixel_crf_matches_reference(case):
    depth, rgb = _scene()
    err, conf, active = _inputs(case)
    sp = jslic.slic(jnp.asarray(rgb))
    lows = np.stack([np.asarray(jslic.downsample_to_superpixels(jnp.asarray(x), sp))
                     for x in [depth, *err, *conf]])
    unary, feat = tl.crf_inputs_plain(torch.from_numpy(lows), torch.from_numpy(
        np.array(sp.mean_color)), torch.from_numpy(np.array(sp.mean_xy)),
        torch.from_numpy(active), True)
    q_ref = np.asarray(jl._superpixel_crf(jnp.asarray(unary.numpy()), jnp.asarray(feat.numpy()),
                                          10))
    q = tl.superpixel_crf_plain(unary, feat, 10).numpy()
    assert q.shape == q_ref.shape == (lows.shape[1], active.shape[0] + 1)
    np.testing.assert_allclose(q, q_ref, rtol=0, atol=1e-5)
    top2 = np.sort(q_ref, axis=-1)[:, -2:]
    flipped = q.argmax(-1) != q_ref.argmax(-1)
    assert not (flipped & (top2[:, 1] - top2[:, 0] >= TIE_EPS)).any()
    # the port's iteration API gives the same Q and the first-index argmax
    plan = tl.crf_plan_plain(torch.from_numpy(lows), torch.from_numpy(np.array(
        sp.mean_color)), torch.from_numpy(np.array(sp.mean_xy)), torch.from_numpy(active), True)
    lbl = tl.mean_field(plan, 10).numpy()
    np.testing.assert_array_equal(lbl, q.argmax(-1))
