"""The port's multi-model step with external masks and ``odom_init="kp"``
against the reference package, on the CPU: the two-id journey of
tests/test_precomputed.py (80x60) with keypoint seeds. The RANSAC uniforms
come from each engine's own generator (ROADMAP queue 3 #6), and at this
scale no seed passes its gate, so the bounds are those of the ``""``
journeys in ``test_torch_multi_engine.py`` (lifecycle equal per frame, each
step held from the other package's state, both ways), plus the kp journey
bound of tests/test_torch_kp_engine.py: the free-running camera within 1 %
of the path and 0.3 deg of the reference's, on the frames before a mask id
vanishes (up to frame 4). From frame 5 on, the reference's own camera is
1-4 cm from the ground truth on a 1 cm path (printed by the lifecycle
check), so that bound cannot hold there for either package. A file of its
own so that its reference compile and the ``""`` one land on two workers.
"""

import numpy as np
import pytest

from tests.test_torch_multi_engine import (CAMERA_TOGETHER, _rot_deg, check_lifecycle,
                                           check_one_step, gt_pose, run_journey)
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def journey():
    return run_journey("two_ids", "kp")


def test_kp_journey_lifecycle_matches_reference(journey):
    check_lifecycle(journey)


def test_kp_journey_one_step_from_reference_state(journey):
    check_one_step(journey)


def test_kp_journey_within_path_of_reference(journey):
    n = len(journey["ref"])
    gt = np.stack([gt_pose(i) for i in range(n)])
    path = np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1))
    for i in range(CAMERA_TOGETHER + 1):
        r, p = journey["ref"][i]["pose"], journey["port"][i]["pose"]
        assert np.linalg.norm(r[:3, 3] - p[:3, 3]) < 0.01 * path, (i, path)
        assert _rot_deg(r, p) < 0.3, i
