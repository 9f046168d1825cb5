"""One SO(3) iteration in one call (``rgbd.so3_iteration``, K3 and K5's SO(3)
step; plain version on the CPU) against the two halves it joins.

``so3_iteration(last, next, cam_l, state, verbatim)`` must return the sums of
``so3_reduce`` and leave the state ``so3_step`` leaves, ``torch.equal``, on
every iteration of a whole 10-iteration loop: one that converges after a
few iterations (the done flag set mid-way, after which the sums are zeros
and the state only has its pose rewritten), one that diverges, and both
under the multi-model path's convergence test (``verbatim``: the same
motion then runs all ten iterations). The images are the
port's synthetic scene at 160x120, reduced to the coarsest level (40x30)
as the odometry's pyramid does.
"""

import numpy as np
import pytest
import torch

from multimotionfusion_tpu_torch.config import CameraModel
from multimotionfusion_tpu_torch.io import synthetic
from multimotionfusion_tpu_torch.odometry import rgbd
from multimotionfusion_tpu_torch.ops import image
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CAM = CameraModel(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
ITERATIONS = 10


def _coarse_intensity(T, flip=False):
    _, rgb = synthetic.render(T, CAM)
    img = image.rgb_to_intensity(torch.from_numpy(np.array(rgb, dtype=np.float32)))
    img = image.build_pyramid(img, 3)[-1].contiguous()
    return torch.flip(img, dims=(0,)).contiguous() if flip else img


@pytest.mark.parametrize("case,verbatim", [("converges", False), ("diverges", False),
                                           ("converges", True), ("diverges", True)])
def test_iteration_equals_reduce_then_step(case, verbatim):
    last = _coarse_intensity(np.eye(4, dtype=np.float32), flip=case == "diverges")
    nxt = _coarse_intensity(synthetic.pose((0.0, 0.02, 0.0), (0.01, 0.0, 0.0)))
    cam_l = CAM.level(2)
    st_a, st_b = rgbd.odo_init("cpu"), rgbd.odo_init("cpu")
    done_at = None
    for j in range(ITERATIONS):
        sums_a = rgbd.so3_iteration(last, nxt, cam_l, st_a, verbatim)
        sums_b = rgbd.so3_reduce(last, nxt, cam_l, st_b)
        rgbd.so3_step(st_b, sums_b, verbatim)
        assert torch.equal(sums_a, sums_b), j
        assert torch.equal(st_a, st_b), j
        if done_at is None and bool(st_a[rgbd.S_SO3_DONE] != 0):
            done_at = j
        elif done_at is not None:  # a done loop: zero sums, the rotation kept
            assert not sums_a.any()
    if case == "converges" and verbatim:
        assert done_at is None and int(st_a[rgbd.S_SO3_ITERS]) == ITERATIONS
    else:  # the loop stopped early, and the remaining iterations ran done
        assert done_at is not None and done_at < ITERATIONS - 1
        assert int(st_a[rgbd.S_SO3_ITERS]) == done_at + 1
