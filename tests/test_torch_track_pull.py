"""The index logic of K20's update and K15's box sums, checked on the CPU.

On the card, ``csrc/tracks.cu`` updates the track table in pull form: each
track takes its row from the query of its column minimum when that query's
match is this track, or, if the track was free, from the r-th unmatched
valid keypoint, r being its rank among the free slots. The plain version
(``tracker.update_plain``) pushes each keypoint to its track instead.
``checks.update_pull_emulated`` repeats the pull form with tensor ops; here
it is held bit-equal to ``update_plain`` on ``checks.track_cases`` at
capacities 64 and 256 (a full table, more new keypoints than free slots, all
matched, none valid, the ring's wrap either way, no depth, no pair), every
field of the table and the pair.

``csrc/flow.cu`` sums each 9x9 box from column sums computed once per row
and column (vertical taps from zero in order, skipping rows outside the
image, then the horizontal taps of those, skipping columns outside); the
plain version's ``flow._box`` pads with zeros instead. A numpy float32
emulation of the kernel's order is held bit-equal to ``_box`` on random
planes (negative values, zeros and -0.0 included) whose borders the box
crosses, and ``flow.flow_band`` to the kernel's split of every level's rows
over the cluster.
"""

import numpy as np
import pytest
import torch

from multimotionfusion_tpu_torch.kernels import checks
from multimotionfusion_tpu_torch.segmentation import flow as FL
from multimotionfusion_tpu_torch.tracking import tracker as TR
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

# small tables: capacity, ring, keypoints, descriptor width, image
SHAPES = {64: dict(cap=64, hist=8, k=48, d=16, h=60, w=80),
          256: dict(cap=256, hist=16, k=96, d=32, h=90, w=120)}


@pytest.fixture(scope="module")
def cases():
    return {cap: {c[0]: c for c in checks.track_cases(**kw, seed=cap)}
            for cap, kw in SHAPES.items()}


@pytest.mark.parametrize("cap", sorted(SHAPES))
@pytest.mark.parametrize("name", checks.TRACK_CASES)
def test_pull_update_equals_plain(cases, cap, name):
    _, table, kps, depth, time, cam, cfg, pair = cases[cap][name]
    tp, te = checks._table_copy(table), checks._table_copy(table)
    pp = TR.update_plain(tp, kps, depth, time, cam, cfg, pair)
    pe = checks.update_pull_emulated(te, kps, depth, time, cam, cfg, pair)
    differ = checks._table_differ(tp, te)
    assert sum(differ.values()) == 0, differ
    assert (pp is None) == (not pair)
    if pair:
        for a, b in zip(pp, pe):
            assert torch.equal(a, b)
    # the case is what its name says
    match, _ = TR.mutual_match_plain(kps.desc, table.desc, kps.valid,
                                     TR.in_history(table, time), cfg.match_dist_gate)
    new = int((kps.valid & (match < 0)).sum())
    free = int((~table.active).sum())
    taken = int((tp.active & ~table.active).sum())
    if name == "full":
        assert free == 0 and new > 0 and taken == 0
    elif name == "more_new_than_free":
        assert 0 < free < new and taken == free
    elif name == "all_matched":
        assert bool((match >= 0).all())
    elif name == "no_valid":
        assert int((match >= 0).sum()) == 0 and taken == 0
    elif name == "ring_wrap":
        assert (time + 1) % table.history == 0
    elif name == "ring_wrap_back":
        assert time % table.history == 0
    elif name == "no_depth":
        written = (tp.last_seen == time) & (table.last_seen != time)
        assert bool(written.any())
        assert not bool(tp.has_depth[written, time % table.history].any())
    else:
        assert name == "add_only" and not pair
    if name not in ("full", "no_valid", "all_matched"):
        assert taken > 0


def _box_columns_once(x: np.ndarray, r: int = FL.RADIUS) -> np.ndarray:
    """The kernel's box sum in numpy float32: each column sum once, from zero
    in tap order, skipping rows outside; then each pixel's horizontal taps of
    the column sums, from zero in order, skipping columns outside."""
    h, w = x.shape
    col = np.zeros((h, w), np.float32)
    for y in range(h):
        v = np.zeros(w, np.float32)
        for dy in range(-r, r + 1):
            if 0 <= y + dy < h:
                v = (v + x[y + dy]).astype(np.float32)
        col[y] = v
    out = np.zeros((h, w), np.float32)
    for xx in range(w):
        acc = np.zeros(h, np.float32)
        for dx in range(-r, r + 1):
            if 0 <= xx + dx < w:
                acc = (acc + col[:, xx + dx]).astype(np.float32)
        out[:, xx] = acc
    return out


@pytest.mark.parametrize("hw", [(5, 7), (8, 40), (30, 40), (13, 160)])
def test_box_equals_column_sums_once(hw):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    x = (rng.standard_normal(hw) * 10.0 ** rng.integers(-3, 4, hw)).astype(np.float32)
    x[rng.random(hw) < 0.2] = 0.0
    x[rng.random(hw) < 0.1] = -0.0
    x[:, 0] = -0.0  # a border column of negative zeros
    want = _box_columns_once(x)
    got = FL._box(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("hc,wc", [(120, 160), (121, 162), (240, 320), (60, 80), (30, 40),
                                   (17, 23), (9, 11), (7, 5)])
def test_flow_band_splits_every_level(hc, wc):
    cluster = FL.CLUSTER
    sizes = [(hc, wc)]
    for _ in range(FL.LEVELS - 1):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    band = halo = stage = near = 0
    for lvl, (h, w) in enumerate(sizes):
        bounds = [h * r // cluster for r in range(cluster + 1)]
        assert bounds[0] == 0 and bounds[-1] == h
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))
        for a, b in zip(bounds, bounds[1:]):
            band = max(band, (b - a) * w)
            rows = set(range(a - FL.RADIUS, b + FL.RADIUS)) & set(range(h))
            halo = max(halo, len(rows) * w)
            rows = set(range(a - FL.NEAR, b + FL.NEAR + 1)) & set(range(h))
            near = max(near, len(rows) * w)
            # the rows the vertical blur (level 0) or the downsample (of the
            # finer level) reads: y + d for d in -3..3, or 2 y + d for d in -2..2
            if lvl == 0:
                read = {y + d for y in range(a, b) for d in range(-3, 4)} & set(range(h))
                stage = max(stage, 2 * len(read) * w)
            elif b > a:
                hf, wf = sizes[lvl - 1]
                read = {2 * y + d for y in range(a, b) for d in range(-2, 3)} & set(range(hf))
                stage = max(stage, 2 * len(read) * wf)
    got = FL.flow_band(hc, wc)
    assert got[:2] == (band, halo) and got[3] == near
    assert got[2] >= stage  # a block stages at least the rows it reads
    assert FL.flow_scratch_floats(hc, wc) == 2 * hc * wc + 6 * sum(h * w for h, w in sizes)
