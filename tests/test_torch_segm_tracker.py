"""The port's segm_lvl tracker (``MultiState.tracks_segm``, a second track
table at another pyramid level whose last pair feeds the flow-CRF's
velocities) against the reference engine's, on the CPU, at 80x60.

The scene and configuration of test_torch_flow_crf_engine.py with
``OdometryConfig(segm_lvl=1)`` (keypoints of the half-resolution intensity,
coordinates at full resolution). Held: the table the first frame seeds, and
after one step of each frame from the reference's state the table the port
updates (its keypoints matched in, pruned, and associated with the final
mask): activity, ages, hit counts and model labels equal; coordinates within
1e-4 px, points within 1e-5 m and descriptors within 1e-5 (the keypoint
scores and descriptors of two libraries); the step's mask equal and its
camera within 1e-4.
"""

import numpy as np
import pytest

from multimotionfusion_tpu import config as J
from multimotionfusion_tpu.engine import MultiMotionFusionTPU
from multimotionfusion_tpu_torch import config as T
from multimotionfusion_tpu_torch import interop
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch
from tests.test_torch_flow_crf_engine import cfg_of, frames, jstate
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 5
EXACT = ("active", "last_seen", "nvalid", "model_id")


def _table(d, prefix="tracks_segm"):
    return {k.split(".", 1)[1]: np.asarray(v) for k, v in d.items() if k.startswith(prefix + ".")}


def _check_table(port, ref):
    act = ref["active"]
    assert act.shape[0] > 1 and act.any()
    for k in EXACT:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    seen = ref["seen"] & act[:, None]
    np.testing.assert_array_equal(port["seen"] & act[:, None], seen)
    np.testing.assert_allclose(port["xy"][seen], ref["xy"][seen], atol=1e-4)
    has = seen & ref["has_depth"]
    np.testing.assert_array_equal(port["has_depth"] & seen, has)
    np.testing.assert_allclose(port["p3d"][has], ref["p3d"][has], atol=1e-5)
    np.testing.assert_allclose(port["desc"][act], ref["desc"][act], atol=1e-5)


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = cfg_of(J, segm_lvl=1), cfg_of(T, segm_lvl=1)
    fr = frames()[:N]
    eng = MultiMotionFusionTPU(jcfg)
    states = []
    for f in fr:
        states.append((eng.mstate, eng.tick, (eng._bucket, eng._bucket_obj)))
        eng.process_frame(f)
        eng.finish()
    states.append((eng.mstate, eng.tick, None))
    port = MultiMotionFusionTorch(tcfg, device="cpu")
    port.process_frame(fr[0])
    steps = []
    for i in range(1, N):
        ms, tick, buckets = states[i]
        p = MultiMotionFusionTorch(tcfg, device="cpu")
        p.set_state(interop.multi_state_from_numpy(jstate(ms), "cpu"), tick, *buckets)
        p.process_frame(fr[i])
        p.finish()
        steps.append(interop.multi_state_to_numpy(p.state))
    return dict(states=states, init=interop.multi_state_to_numpy(port.state), steps=steps)


def test_segm_tracker_seeded_like_reference(runs):
    ref = _table(jstate(runs["states"][1][0]))
    assert ref["xy"].shape[0] == 256  # a table of its own, not the 1-slot stub
    _check_table(_table(runs["init"]), ref)


def test_segm_tracker_step_matches_reference(runs):
    for i, d in enumerate(runs["steps"], start=1):
        ms = runs["states"][i + 1][0]
        ref = jstate(ms)
        _check_table(_table(d), _table(ref))
        np.testing.assert_array_equal(d["prev_mask"], ref["prev_mask"], err_msg=str(i))
        assert np.abs(d["pose"] - ref["pose"]).max() < 1e-4, i
    # the objects the flow-CRF spawned label the segm_lvl tracks too
    assert (_table(runs["steps"][-1])["model_id"] > 0).any()
