"""The port's SLIC superpixels (K24a, K24b plain versions on the CPU) against
the reference package's ``segmentation/slic.py``, at 160x120 on a rendered
sphere scene with seeded noise.

- ``slic``: the labels equal on >= 99.9 % of the pixels (all are expected:
  the sums run in the reference's order, pixel by pixel), the centres (mean
  colour and position) and counts within 1e-5 relative;
- given the reference's labels, ``superpixel_means`` (the depth and a stack
  of seeded images) within 1e-6 relative of ``downsample_to_superpixels``;
- the labels back on the pixels: ``upsample_onehot`` equals the reference's
  ``upsample_from_superpixels`` compared with each label;
- ``label_bounds_plain`` (the twin of the kernels' bounding boxes) on the
  reference's labels: each box is its superpixel's extent and lies within
  the five cells a label can move in five assignments; summing each box row
  by row, in the order the kernels sum, reproduces the reference's
  ``downsample_to_superpixels`` bit for bit;
- the same box sums on the hand-made label images of the kernels' card
  check (``checks.slic_label_cases``: a superpixel over many list chunks,
  empty ones, labels five cells away, the edge cells), which are what they
  claim, equal the plain centres and means bit for bit (N = 1, 13, 40).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel
from multimotionfusion_tpu.segmentation import slic as jslic
from multimotionfusion_tpu_torch.kernels import checks
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


def _box_sums(values, labels, bounds):
    """([N, S] sums, [S] counts) of ``values`` [N, H, W] over each label's
    box, row by row: each label's pixels in row-major order, added one by one
    in float32 from 0, as the kernels' lanes add them."""
    n, s = values.shape[0], bounds.shape[0]
    sums, cnt = np.zeros((n, s), np.float32), np.zeros(s, np.float32)
    for lbl in range(s):
        y0, x0, y1, x1 = (int(v) for v in bounds[lbl])
        if y1 < 0:
            continue
        vals = values[:, y0:y1 + 1, x0:x1 + 1][:, labels[y0:y1 + 1, x0:x1 + 1] == lbl]
        cnt[lbl] = vals.shape[1]
        sums[:, lbl] = np.cumsum(vals, axis=1, dtype=np.float32)[:, -1]
    return sums, cnt


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def test_label_bounds_on_reference_labels(scene):
    img, depth, ref, rng = scene
    labels = np.array(ref.labels)
    gy, gx = ref.grid_hw
    s = gy * gx
    bounds = tslic.label_bounds_plain(torch.from_numpy(labels), s).numpy()
    sp = tslic.SP_SIZE
    h, w = labels.shape
    for lbl in range(s):
        ys, xs = np.nonzero(labels == lbl)
        if ys.size == 0:
            assert (bounds[lbl] == -1).all()
            continue
        np.testing.assert_array_equal(bounds[lbl], (ys.min(), xs.min(), ys.max(), xs.max()))
        # a label moves at most one cell per assignment: five cells of its own
        cy, cx = divmod(lbl, gx)
        r = tslic.ITERATIONS
        assert bounds[lbl, 0] >= max(cy - r, 0) * sp and bounds[lbl, 1] >= max(cx - r, 0) * sp
        assert bounds[lbl, 2] < (h if cy + r >= gy - 1 else (cy + r + 1) * sp)
        assert bounds[lbl, 3] < (w if cx + r >= gx - 1 else (cx + r + 1) * sp)
    images = np.concatenate([depth[None], rng.uniform(0, 0.3, (4,) + depth.shape)]).astype(
        np.float32)
    sums, cnt = _box_sums(images, labels, bounds)
    np.testing.assert_array_equal(cnt, np.asarray(ref.count))
    got = sums / np.maximum(cnt, np.float32(1.0))
    for k in range(images.shape[0]):
        want = np.asarray(jslic.downsample_to_superpixels(jnp.asarray(images[k]), ref))
        np.testing.assert_array_equal(_bits(got[k]), _bits(want))


@pytest.fixture(scope="module")
def hand_made():
    return checks.slic_label_cases("cpu")[1]


def test_hand_made_labels_are_what_they_claim(hand_made):
    _, image, labels = hand_made
    grid_hw = tslic.grid_shape(*labels.shape)
    facts = checks.slic_case_facts(labels, grid_hw)
    assert facts["largest"] >= 20000
    assert facts["empty"] >= 1
    assert facts["max_reach_cells"] == 5
    assert facts["edge_rows"] > 0 and facts["edge_cols"] > 0
    assert labels.shape[0] % tslic.SP_SIZE and labels.shape[1] % tslic.SP_SIZE
    assert not (labels == checks.SLIC_EMPTY).any()


def test_box_centres_match_plain_on_hand_made_labels(hand_made):
    _, image, labels = hand_made
    s = tslic.grid_shape(*labels.shape)
    s = s[0] * s[1]
    lab = labels.numpy()
    bounds = tslic.label_bounds_plain(labels, s).numpy()
    h, w, _ = image.shape
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    values = np.concatenate([np.moveaxis(image.numpy(), -1, 0), xs[None], ys[None]])
    sums, cnt = _box_sums(values, lab, bounds)
    want = tslic.slic_centres_plain(image, labels, s).numpy()
    np.testing.assert_array_equal(cnt, want[:, 5])
    got = (sums / np.maximum(cnt, np.float32(1.0))).T
    np.testing.assert_array_equal(_bits(got), _bits(want[:, :5]))


@pytest.mark.parametrize("n", [1, 13, 40])
def test_box_means_match_plain_on_hand_made_labels(hand_made, n):
    _, _, labels = hand_made
    s = tslic.grid_shape(*labels.shape)
    s = s[0] * s[1]
    images = np.random.default_rng(n).uniform(0, 5, (n,) + tuple(labels.shape)).astype(np.float32)
    bounds = tslic.label_bounds_plain(labels, s).numpy()
    sums, cnt = _box_sums(images, labels.numpy(), bounds)
    want = tslic.superpixel_means_plain(torch.from_numpy(images), labels, torch.from_numpy(cnt))
    np.testing.assert_array_equal(_bits(sums / np.maximum(cnt, np.float32(1.0))),
                                  _bits(want.numpy()))
