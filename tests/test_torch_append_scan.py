"""The references that the card's exact checks of K8/K14's append scan and of
K4's last-block sums are held to, checked here on the CPU.

On the card, ``checks.check_scan_cases`` holds the scan that K8's and K14's
association kernels run (``csrc/surfel.cuh`` ``append_scan``) to
``checks.scan_expected`` (``torch.cumsum``) on ``checks.scan_cases``, and
``checks.check_gn`` holds every ``gn_reduce`` evaluation's sums bit-equal to
``checks.gn_sums_from_partials`` (the float32 sum of its partials in block
order). Here those references are held to independent loops: the scan to a
running count per model over the pixels in source order, the block-order
sum to a numpy float32 loop. The cases must also have the properties they
are named for (no new flag, every owner present, each room relation).
"""

import numpy as np
import pytest
import torch

from multimotionfusion_tpu_torch.kernels import checks
from multimotionfusion_tpu_torch.odometry import rgbd
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CASES = {c[0]: c for c in checks.scan_cases()}


def _loop_scan(flags, own, M, counts, lens):
    """Source-order running counts: (prefix, -1 where the owner is no model;
    the new counts)."""
    run = [0] * M
    prefix = []
    for f, o in zip(flags.tolist(), own.tolist()):
        if 0 <= o < M:
            prefix.append(run[o])
            run[o] += (f >> 1) & 1
        else:
            prefix.append(-1)
    out = [int(c) + min(r, max(int(s) - int(c), 0)) for c, r, s in zip(counts.tolist(), run, lens)]
    return np.array(prefix, np.int32), np.array(out, np.int32), run


@pytest.mark.parametrize("name", list(CASES))
def test_scan_expected_matches_loop(name):
    _, flags, own, M, counts, count8, cap8 = CASES[name]
    lens = [checks.SCAN_LAYOUT["bg"]] + [checks.SCAN_LAYOUT["bo"]] * (M - 1)
    prefix, out = checks.scan_expected(flags, own, M, counts, lens)
    lp, lo, totals = _loop_scan(flags, own, M, counts, lens)
    np.testing.assert_array_equal(prefix.numpy(), lp)
    np.testing.assert_array_equal(out.numpy(), lo)
    # K8: one model, every pixel its own
    p8, c8 = checks.scan_expected(flags, torch.zeros_like(own), 1,
                                  torch.tensor([count8], dtype=torch.int32), [cap8])
    lp8, lo8, (total8,) = _loop_scan(flags, np.zeros(flags.numel(), np.int64), 1,
                                     torch.tensor([count8]), [cap8])
    np.testing.assert_array_equal(p8.numpy(), lp8)
    np.testing.assert_array_equal(c8.numpy(), lo8)

    # what the case is named for
    new = ((flags >> 1) & 1).numpy()
    room = [max(s - int(c), 0) for c, s in zip(counts.tolist(), lens)]
    if name == "no_new":
        assert total8 == 0
    if name == "all_new":
        assert total8 == flags.numel()
    if name == "one_model":
        assert (own == 0).all() and totals[0] == total8 > 0
    if name == "eight_models":
        assert M == 8 and set(own.tolist()) == set(range(8))
    if name == "no_owner":
        unowned = ((own < 0) | (own >= M)).numpy()
        assert new[unowned].sum() > 0 and (own < 0).any() and (own == M).any()
    if name == "rooms":
        rel = [("full" if r == 0 else "clipped" if r < t else "at" if r == t
                else "one_below" if r == t + 1 else "far_below") for r, t in zip(room, totals)]
        assert rel == list(checks.SCAN_ROOMS)
    if name in ("ragged", "small", "one_tile"):
        assert flags.numel() % 256 != 0
    assert any(r < t for r, t in zip(room, totals)) or name in ("no_new", "all_new", "one_model",
                                                                 "eight_models", "no_owner")


def _np_block_order(p):
    s = np.zeros(p.shape[1], np.float32)
    for row in p:
        s = (s + row).astype(np.float32)
    return s


@pytest.mark.parametrize("blocks,n", [(300, 31), (300, 28), (75, 31), (1, 28)])
def test_block_order_sum_matches_numpy_loop(blocks, n):
    rng = np.random.default_rng(blocks * n)
    # partials of mixed sign and magnitude, as a GN system's are, so that the
    # order of the additions shows in the low bits
    p = (rng.standard_normal((blocks, n)) * 10.0 ** rng.integers(-3, 5, (blocks, n)))
    p = p.astype(np.float32)
    got = checks.block_order_sum(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), _np_block_order(p).view(np.int32))
    if blocks > 1:
        backwards = _np_block_order(p[::-1])
        assert (backwards.view(np.int32) != got.view(np.int32)).any()


def test_gn_sums_from_partials_slots():
    rng = np.random.default_rng(3)
    p1 = torch.from_numpy(rng.standard_normal((75, 31)).astype(np.float32))
    p2 = torch.from_numpy(rng.standard_normal((75, 28)).astype(np.float32))
    s = checks.gn_sums_from_partials(p1, p2)
    assert s.shape == (rgbd.N_SUMS,)
    s1, s2 = _np_block_order(p1.numpy()), _np_block_order(p2.numpy())
    np.testing.assert_array_equal(s[:28].numpy(), s1[:28])  # S_icp
    np.testing.assert_array_equal(s[28:56].numpy(), s2)  # S_rgb
    np.testing.assert_array_equal(s[56:].numpy(), s1[28:])  # counts, sum diff^2
    no_rgb = checks.gn_sums_from_partials(p1)
    assert (no_rgb[28:56] == 0).all() and torch.equal(no_rgb[:28], s[:28])


def test_gn_partials_layout_aligned():
    for blocks in range(1, 1025):
        (o1, n1), (o2, n2) = rgbd.gn_partials_layout(blocks)
        assert o1 == 0 and n1 == 31 * blocks and n2 == 28 * blocks
        assert o2 % 4 == 0 and n1 <= o2 < n1 + 4  # pass 2 from the next 16-byte boundary
