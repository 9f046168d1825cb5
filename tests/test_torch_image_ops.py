"""Parity of the PyTorch port's image and map ops with the reference package.

Same numpy inputs (a rendered synthetic frame plus seeded depth holes) go
through the JAX function on the CPU and through the port's plain PyTorch
version on the CPU. Tolerances:
- intensity, Sobel gradients and the nearest pyramid are exact: floor / int16
  truncation of identically ordered sums, and pure indexing;
- the bilateral filter, Gaussian pyramid and vertex/normal maps within 1e-5
  absolute: float32 sums of up to 169 taps whose order or FMA contraction may
  differ between XLA:CPU and PyTorch (a few ulps of metres or of 0..255).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import CameraModel
from multimotionfusion_tpu.io import synthetic
from multimotionfusion_tpu.ops import image as jimg
from multimotionfusion_tpu.ops import maps as jmaps
from multimotionfusion_tpu_torch.config import CameraModel as TCameraModel
from multimotionfusion_tpu_torch.ops import image as timg
from multimotionfusion_tpu_torch.ops import maps as tmaps
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAMS = {
    "80x60": dict(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0),
    "160x120": dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0),
}


def _frame(name):
    cam = CameraModel(**CAMS[name])
    rng = np.random.default_rng(3)
    depth, rgb = synthetic.render(synthetic.pose((0.01, -0.02, 0.0), (0.02, 0.0, 0.01)), cam)
    depth = depth + rng.normal(0, 0.002, depth.shape).astype(np.float32) * (depth > 0)
    depth[rng.random(depth.shape) < 0.03] = 0.0  # sensor holes
    return cam, TCameraModel(**CAMS[name]), depth.astype(np.float32), rgb.astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(CAMS))
def test_intensity_sobel_nearest_exact(name):
    _, _, depth, rgb = _frame(name)
    rgbf = rgb.astype(np.float32)
    ij = np.asarray(jimg.rgb_to_intensity(jnp.asarray(rgbf)))
    it = timg.rgb_to_intensity(_t(rgbf)).numpy()
    np.testing.assert_array_equal(it, ij)
    for a, b in zip(jimg.sobel_gradients(jnp.asarray(ij)), timg.sobel_gradients(_t(ij))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    labels = (np.arange(depth.size).reshape(depth.shape) % 7).astype(np.int32)
    for a, b in zip(jimg.build_pyramid_nearest(jnp.asarray(labels), 3),
                    timg.build_pyramid_nearest(_t(labels), 3)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("name", sorted(CAMS))
def test_bilateral_and_gauss_pyramid(name):
    _, _, depth, rgb = _frame(name)
    bj = np.asarray(jimg.bilateral_depth_filter(jnp.asarray(depth)))
    bt = timg.bilateral_depth_filter(_t(depth)).numpy()
    np.testing.assert_allclose(bt, bj, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(bt > 0, bj > 0)
    intensity = np.asarray(jimg.rgb_to_intensity(jnp.asarray(rgb.astype(np.float32))))
    for img in (depth, intensity):
        for a, b in zip(jimg.build_pyramid(jnp.asarray(img), 3), timg.build_pyramid(_t(img), 3)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CAMS))
def test_vmap_nmap(name):
    jcam, tcam, depth, _ = _frame(name)
    vj = jmaps.create_vmap(jnp.asarray(depth), jcam, 2.5)
    vt = tmaps.create_vmap(_t(depth), tcam, 2.5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-5)
    nj = np.asarray(jmaps.create_nmap(vj))
    nt = tmaps.create_nmap(vt).numpy()
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tmaps.vertices_to_depth(vt, 2.0).numpy(),
        np.asarray(jmaps.vertices_to_depth(vj, 2.0)), rtol=0, atol=1e-5,
    )
