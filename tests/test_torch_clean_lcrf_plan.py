"""The partitions of K7/K9 (``csrc/clean.cu``) and K24c
(``csrc/legacy_crf.cu``), mirrored on the CPU.

- The multi-model repack (``surfel_map.compact_segments``): its plain twin,
  every segment's keep formed from its count and ALIVE, against the
  reference's ``surfel_map.compact`` segment by segment, bit for bit, on
  stores from a seed with stale ALIVE past the counts, +0 and -0 ALIVE, an
  empty segment and a full one.
- The compaction's one-launch partition: tiles of 1,024 columns (four
  sub-tiles of 256 for a block of 256 threads), each scattering its kept
  columns to its exclusive prefix and zeroing the slots
  ``n - E_incl .. n - E_before`` (``E`` the columns dropped up to the tile),
  and zero blocks of 2,048 slots for ``[n, cap)``: every destination slot
  written once, and the result ``compact_plain``'s.
- The clean's surfel pass in place (``out`` the input map): CONF written
  only where the penalty is not 1 (or CONF is a NaN), ALIVE (+0) only where
  a slot is not kept and its ALIVE is not +0, the rest as it was:
  ``clean_plain``'s map bit for bit (penalties and keeps from
  ``fusion.clean_verdicts``); ``clean`` given its input as ``out`` leaves
  the map a copy would hold, and with ``skip`` set leaves it as it was.
- The verdicts' persistent scratch: each launch scatter-mins its votes into
  it and resets every word it reads, so a second clean on the same scratch
  sees what a fresh fill gives it, and words past a smaller map stay.
- K24c in float32 without fused multiply-adds, op by op: the two-launch plan
  (row sums over 256 lanes from 0 in j order and a fixed tree, the entries
  recomputed and scaled as ``k * d_i * d_j``) and the one-launch mean field
  (ceil(S / SMs) rows a block, passes of rows by grid stride, a row's
  labels four to a warp, Q staged at an odd stride, each
  step into its own slice of the history; lane j's terms j, j + 32, ... and
  the shuffle tree) bit-equal to the parent's partition (the
  matrices stored, then normalised; one launch a step reading Q from the
  previous step's array), and within the existing tolerance of the
  reference's ``_superpixel_crf`` (each step from the reference's chain
  within 1e-5; free-running, the labels equal but at the reference's ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.model import surfel_map as jsm
from multimotionfusion_tpu.segmentation import legacy_crf as jl
from multimotionfusion_tpu_torch.kernels import checks
from multimotionfusion_tpu_torch.model import fusion as FU
from multimotionfusion_tpu_torch.model import surfel_map as sm
from multimotionfusion_tpu_torch.ops import rasterize as R
from multimotionfusion_tpu_torch.segmentation import legacy_crf as LC
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

F = np.float32
TILE = 256  # the plan's block
TIE_EPS = 1e-5  # tests/test_torch_legacy_crf.py's
_jcompact = jax.jit(jsm.compact, static_argnums=2)


def _bytes(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


# ---------------------------------------------------------------- K9

@pytest.mark.parametrize("case", checks.SEGMENT_CASES, ids=[c[0] for c in checks.SEGMENT_CASES])
def test_segment_repack_matches_reference(case):
    _, bg, bo, slots = case
    gsrc, osrc, counts, gdst, odst = checks.segment_case_inputs(bg, bo, slots, "cpu")
    counts_out = sm.compact_segments_plain(gsrc, osrc, counts, gdst, odst)
    segs = [(gsrc, gdst)] + [(osrc[:, k], odst[k]) for k in range(slots)]
    for m, (src, dst) in enumerate(segs):
        size = src.shape[1]
        keep = (np.arange(size) < int(counts[m])) & (src[sm.ALIVE].numpy() > 0)
        jd, jc = _jcompact(jnp.asarray(src.numpy()), jnp.asarray(keep), size)
        assert np.array_equal(_bytes(dst.numpy()), _bytes(jd)), m
        assert int(counts_out[m]) == int(jc)
    if slots > 1:  # an empty and a full segment
        assert int(counts_out[1]) == 0 and int(counts_out[2]) == bo


CT, CSUB = 256, 4  # clean.cu's compaction block: 256 threads, 4 sub-tiles of 256 columns
CTILE = CT * CSUB
ZCOLS = 8 * CT  # the slots a zero block zeroes


def compaction_emulated(data: np.ndarray, keep: np.ndarray, cap: int) -> tuple:
    """``mmf_compact``'s tiles in numpy: (packed [16, cap], count, writes a
    slot). A tile's rank of a column: the tile's base, then the kept columns
    of the (sub-tile, warp) pairs before its own in column order, then its
    rank among its warp's lanes."""
    n = data.shape[1]
    out = np.full((data.shape[0], cap), np.nan, F)
    writes = np.zeros(cap, np.int64)
    tiles = (n + CTILE - 1) // CTILE
    base = 0
    for tile in range(tiles):
        start, end = tile * CTILE, min(tile * CTILE + CTILE, n)
        k = np.zeros(CTILE, bool)
        k[:end - start] = keep[start:end]
        warps = k.reshape(CSUB * CT // 32, 32)  # (sub-tile, warp) pairs in column order
        first = base + np.concatenate([[0], np.cumsum(warps.sum(1))[:-1]])
        lanes = np.cumsum(warps, axis=1) - warps  # popc(ballot & lanes below)
        dst = (first[:, None] + lanes).reshape(-1)
        total = base + int(k.sum())
        for i in np.nonzero(k)[0]:
            if dst[i] < cap:
                out[:, dst[i]] = data[:, start + i]
                writes[dst[i]] += 1
        e_before, e_incl = start - base, end - total
        for z in range(n - e_incl, n - e_before):
            if z < cap:
                out[:, z] = 0.0
                writes[z] += 1
        base = total
    for c0 in range(n, cap, ZCOLS):  # the zero blocks, ahead of the tiles
        out[:, c0:c0 + ZCOLS] = 0.0
        writes[c0:min(c0 + ZCOLS, cap)] += 1
    return out, min(base, cap), writes


@pytest.mark.parametrize("case", checks.COMPACT_CASES, ids=[c[0] for c in checks.COMPACT_CASES])
def test_compaction_tiles_write_every_slot_once(case):
    _, n, cap, kind = case
    data, keep, cap = checks.compact_case_inputs(n, cap, kind, "cpu")
    out, count, writes = compaction_emulated(data.numpy(), keep.numpy(), cap)
    ref, ref_count = sm.compact_plain(data, keep, cap)
    assert (writes == 1).all()
    assert np.array_equal(_bytes(out), _bytes(ref.numpy()))
    assert count == int(ref_count)


def _clean_args(case):
    name, h, w, B, window, gate, skip, kind = case
    a = checks.clean_inputs(h, w, B, window, gate, kind, "cpu")
    data, count, index, dl, depth, mask, mask_id, cam, time, td, conf, cfg = a
    return (sm.SurfelMap(data, count), R.IndexMap(index, dl), depth, mask, mask_id, cam, time,
            td, conf, cfg)


SMALL_CLEAN = [c for c in checks.CLEAN_CASES if c[1] * c[2] < 10_000]


@pytest.mark.parametrize("case", SMALL_CLEAN, ids=[c[0] for c in SMALL_CLEAN])
def test_in_place_rule_gives_the_plain_map(case):
    args = _clean_args(case)
    smap = args[0]
    keep, pen = FU.clean_verdicts(*args)
    data = smap.data.clone()
    data[sm.CONF, 5] = float("nan")  # a NaN confidence: the rule writes it too
    smap = sm.SurfelMap(data, smap.count)
    ref = FU.clean_plain(smap, *args[1:]).data
    got = data.clone()
    conf, alive = got[sm.CONF], got[sm.ALIVE]
    write_conf = (pen != 1.0) | torch.isnan(conf)
    got[sm.CONF] = torch.where(write_conf, conf * pen, conf)
    got[sm.ALIVE] = torch.where(~keep & (alive.view(torch.int32) != 0), torch.zeros_like(alive),
                                alive)
    assert np.array_equal(_bytes(got.numpy()), _bytes(ref.numpy()))


@pytest.mark.parametrize("skip", [False, True], ids=["written", "skipped"])
def test_clean_into_its_own_map(skip):
    """A flag frame's ``clean`` given its input map as ``out`` (the legacy
    slots' call) returns that map holding what a copy gets; with ``skip``
    set the map stays as it was."""
    args = _clean_args(SMALL_CLEAN[0])
    smap = args[0]
    before = smap.data.clone()
    ref = before if skip else FU.clean_plain(sm.SurfelMap(before.clone(), smap.count),
                                             *args[1:]).data
    got = FU.clean(smap, *args[1:], out=smap.data, skip=torch.tensor(skip))
    assert got.data.data_ptr() == smap.data.data_ptr()
    assert np.array_equal(_bytes(got.data.numpy()), _bytes(ref.numpy()))
    assert skip or not np.array_equal(_bytes(ref.numpy()), _bytes(before.numpy()))


def test_compaction_words_change_hands_only_after_a_launch():
    """A compaction's scan words: the set a call is given stays the next
    call's until ``compaction_launched`` (so a refused call takes none),
    then the sets alternate."""
    tiles = 7
    _, first = sm.compaction_words("cpu", tiles)
    assert sm.compaction_words("cpu", tiles)[1] == first
    sm.compaction_launched("cpu", tiles)
    assert sm.compaction_words("cpu", tiles)[1] == 1 - first
    sm.compaction_launched("cpu", tiles)
    assert sm.compaction_words("cpu", tiles)[1] == first
    for n in (0, 0x3FFFFFFF):
        with pytest.raises(ValueError):
            sm.check_columns(n, "data")


NONE = FU.VERDICT_NONE


def _ford(v: torch.Tensor) -> torch.Tensor:
    i = v.view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def _fval(i: torch.Tensor) -> torch.Tensor:
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF).view(torch.float32)


def _votes(rng, B: int, n: int):
    """n pixel votes: slot ids below B, verdicts -1 (a cull), a penalty in
    (0, 1) or exactly 1."""
    ids = torch.from_numpy(rng.integers(0, B, n))
    kind = rng.integers(0, 3, n)
    v = np.where(kind == 0, -1.0, np.where(kind == 1, rng.uniform(0.05, 1.0, n), 1.0))
    return ids, torch.from_numpy(v.astype(F))


def test_verdict_scratch_twice_equals_fresh_fills():
    rng = np.random.default_rng(0)
    scratch = torch.full((7_000,), NONE, dtype=torch.int32)  # one per card, grown once
    for B, n in ((6_000, 9_000), (3_001, 4_000), (6_000, 20)):
        ids, v = _votes(rng, B, n)
        fresh = torch.full((B,), NONE, dtype=torch.int32)
        fresh.scatter_reduce_(0, ids, _ford(v), reduce="amin", include_self=True)
        scratch.scatter_reduce_(0, ids, _ford(v), reduce="amin", include_self=True)
        read = scratch[:B].clone()  # the surfel pass reads its slots' words ...
        scratch[:B] = torch.where(read != NONE, torch.full_like(read, NONE), read)  # ... resets
        assert torch.equal(read, fresh)
        votes_min = torch.zeros(B).scatter_reduce_(0, ids, v, reduce="amin", include_self=False)
        assert torch.equal(_fval(read)[ids], votes_min[ids])
        assert bool((scratch == NONE).all())


# ---------------------------------------------------------------- K24c

def _softmax(x: np.ndarray) -> np.ndarray:
    """The kernels' softmax over the last axis, op by op in float32."""
    mx = x[..., 0].copy()
    for l in range(1, x.shape[-1]):
        mx = np.maximum(mx, x[..., l])
    e = np.exp(x - mx[..., None]).astype(F)
    s = np.zeros(x.shape[:-1], F)
    for l in range(x.shape[-1]):
        s = s + e[..., l]
    return (e / s[..., None]).astype(F)


def _clamp_unary(x: np.ndarray) -> np.ndarray:
    x = np.where(np.isnan(x), F(0), x)
    x = np.where(x == np.inf, F(1e5), np.where(x == -np.inf, F(-3.4028234663852886e38), x))
    return np.maximum(np.minimum(x, F(1e5)), F(1e-5)).astype(F)


def _features(lows, color, xy) -> np.ndarray:
    f = np.empty((lows.shape[1], 6), F)
    f[:, 0], f[:, 1] = xy[:, 0] * F(0.125), xy[:, 1] * F(0.125)
    f[:, 2:5] = color * F(1.0 / 30.0)
    f[:, 5] = np.minimum(lows[0] * F(2.5), F(100.0))
    return f


def _entries(f: np.ndarray) -> tuple:
    """Both kernels minus the identity, every entry as ``entries`` forms it."""
    xi = f[:, 0] * F(1.0) / F(2.0)
    yi = f[:, 1] * F(1.0) / F(2.0)
    dx, dy = xi[:, None] - xi[None], yi[:, None] - yi[None]
    dxy = dx * dx + dy * dy
    df = None
    for k in range(6):
        e = f[:, None, k] - f[None, :, k]
        df = e * e if df is None else df + e * e
    eye = np.eye(f.shape[0], dtype=F)
    return (np.exp(F(-0.5) * dxy).astype(F) - eye, np.exp(F(-0.5) * df).astype(F) - eye)


def _row_sums(v: np.ndarray) -> np.ndarray:
    """A 256-thread block's row sum: thread t's terms t, t + 256, ... from 0,
    then the tree r[t] += r[t + off]."""
    S = v.shape[0]
    chunks = (S + TILE - 1) // TILE
    pad = np.zeros((S, chunks * TILE), F)
    pad[:, :S] = v
    r = np.zeros((S, TILE), F)
    for c in range(chunks):
        r = r + pad[:, c * TILE:(c + 1) * TILE]
    off = TILE // 2
    while off:
        r[:, :off] = r[:, :off] + r[:, off:2 * off]
        off //= 2
    return r[:, 0]


def _inputs(lows, active, allow_new) -> tuple:
    """(unary [S, L], Q0): the plan's unary blocks."""
    M = active.shape[0]
    depth_range = np.maximum(lows[0].max() - lows[0].min(), F(1e-3))
    gate = depth_range * F(0.01)
    x = np.empty((lows.shape[1], M + 1), F)
    lowest = np.full(lows.shape[1], np.inf, F)
    for m in range(M):
        icp, conf = lows[1 + m], lows[1 + M + m]
        icp = np.where(conf < F(0.3) if m == 0 else conf <= F(0.4), gate, icp)
        err = icp / depth_range if active[m] else np.full_like(icp, np.inf)
        lowest = np.where(err < lowest, err, lowest)
        x[:, m] = _clamp_unary(F(40.0) * err)
    un_new = np.maximum(F(5.0) - F(40.0) * lowest, F(0.01))
    x[:, M] = _clamp_unary(un_new if allow_new else np.full_like(un_new, np.inf))
    return x, _softmax(-x)


def plan_two_launches(lows, color, xy, active, allow_new) -> tuple:
    """The plan as its two launches compute it: the row factors from entries
    not stored, then every entry recomputed and scaled."""
    f = _features(lows, color, xy)
    d = [F(1.0) / np.sqrt(np.maximum(_row_sums(v), F(1e-12))) for v in _entries(f)]
    ks, ka = (v * dd[:, None] * dd[None, :] for v, dd in zip(_entries(f), d))
    return (*_inputs(lows, active, allow_new), f, ks, ka)


def plan_three_launches(lows, color, xy, active, allow_new) -> tuple:
    """The parent's: the matrices stored with their factors, then scaled."""
    f = _features(lows, color, xy)
    ks, ka = _entries(f)
    d1, d2 = (F(1.0) / np.sqrt(np.maximum(_row_sums(v), F(1e-12))) for v in (ks, ka))
    ks, ka = ks * d1[:, None], ka * d2[:, None]
    return (*_inputs(lows, active, allow_new), f, ks * d1[None, :], ka * d2[None, :])


def _row_msgs(rows: np.ndarray, q: np.ndarray, ks, ka, labels: slice) -> np.ndarray:
    """Each row's messages 40 Ks_i q + 40 Ka_i q of ``labels`` as a warp sums
    them: lane j's terms j, j + 32, ... from 0 in that order, then the
    shuffle tree (lane l += lane l + off)."""
    S = q.shape[0]
    ql = q[:, labels]
    lanes = np.zeros((2, rows.size, 32, ql.shape[1]), F)
    kr, ar = ks[rows], ka[rows]
    for j0 in range(0, S, 32):
        n = min(32, S - j0)
        lanes[0, :, :n] = lanes[0, :, :n] + kr[:, j0:j0 + n, None] * ql[j0:j0 + n]
        lanes[1, :, :n] = lanes[1, :, :n] + ar[:, j0:j0 + n, None] * ql[j0:j0 + n]
    off = 16
    while off:
        lanes[:, :, :32 - off] = lanes[:, :, :32 - off] + lanes[:, :, off:].copy()
        off //= 2
    return F(40.0) * lanes[0, :, 0] + F(40.0) * lanes[1, :, 0]


def _finish(rows: np.ndarray, msg: np.ndarray, unary) -> np.ndarray:
    """``row_finish``: the Potts term from the messages summed in label
    order, then the softmax."""
    tot = np.zeros(rows.size, F)
    for l in range(msg.shape[1]):
        tot = tot + msg[:, l]
    return _softmax(-unary[rows] - (tot[:, None] - msg))


def _step_rows(rows: np.ndarray, q: np.ndarray, unary, ks, ka) -> np.ndarray:
    """Each row's step as the one-step kernel takes it (one warp a row)."""
    return _finish(rows, _row_msgs(rows, q, ks, ka, slice(None)), unary)


def mean_field_one_launch(q0, unary, ks, ka, steps: int, sms: int, grid_cap: int) -> tuple:
    """``mmf_lcrf_mean_field``'s partition: ceil(S / sms) rows a block, at
    most ``grid_cap`` blocks (passes of rows by grid stride: each row once a
    step), a row's labels in groups of 4, one warp each, their messages met
    before the row's finish; each step's Q staged at an odd row stride from
    the previous step's slice of the history, written into its own."""
    S, L = q0.shape
    ldq, rb = L | 1, -(-S // sms)
    grid = min(-(-S // rb), grid_cap)
    owner = np.zeros(S, np.int64)
    for b in range(grid):
        for i0 in range(b * rb, S, grid * rb):
            owner[i0:min(i0 + rb, S)] += 1
    assert (owner == 1).all()
    hist = np.full((steps, S, L), np.nan, F)
    rows = np.arange(S)
    for t in range(steps):
        q = (q0 if t == 0 else hist[t - 1]).reshape(-1)
        staged = np.zeros(S * ldq, F)
        e = np.arange(S * L)
        staged[(e // L) * ldq + e % L] = q  # each block's copy
        qs = staged.reshape(S, ldq)[:, :L]
        msg = np.concatenate([_row_msgs(rows, qs, ks, ka, slice(l0, min(l0 + 4, L)))
                              for l0 in range(0, L, 4)], axis=1)
        hist[t] = _finish(rows, msg, unary)
    return hist, np.argmax(hist[-1], axis=-1)


def mean_field_steps(q0, unary, ks, ka, steps: int) -> tuple:
    """The parent's: one launch a step, Q read from the previous array."""
    q, hist = q0, []
    for _ in range(steps):
        q = _step_rows(np.arange(q.shape[0]), q, unary, ks, ka)
        hist.append(q)
    return np.stack(hist), np.argmax(q, axis=-1)


LCRF = [c for c in checks.LCRF_CASES if c[0] in ("one_superpixel", "two_labels",
                                                  "inactive_model", "nan_inf", "ties")]


@pytest.mark.parametrize("case", LCRF, ids=[c[0] for c in LCRF])
def test_lcrf_one_launch_partition(case):
    name, S, M, allow_new, kind = case
    S = min(S, 300)
    a = checks.lcrf_inputs(S, M, allow_new, kind, "cpu")
    lows, color, xy, active = (x.numpy() for x in a[:4])
    new = plan_two_launches(lows, color, xy, active, allow_new)
    old = plan_three_launches(lows, color, xy, active, allow_new)
    for x, y in zip(new, old):
        assert np.array_equal(_bytes(x), _bytes(y))
    unary, q0, feat, ks, ka = new
    # 132 SMs (an H100) and a grid capped below the blocks the rows need, so
    # the passes of rows by grid stride run too
    hist, lbl = mean_field_one_launch(q0, unary, ks, ka, 10, 132, 7)
    hist_old, lbl_old = mean_field_steps(q0, unary, ks, ka, 10)
    assert np.array_equal(_bytes(hist), _bytes(hist_old)) and np.array_equal(lbl, lbl_old)
    # the plain plan and the reference within the existing tolerances
    plan = LC.crf_plan_plain(*a)
    assert np.array_equal(_bytes(unary), _bytes(plan.unary.numpy()))
    assert np.array_equal(_bytes(feat), _bytes(plan.feat.numpy()))
    np.testing.assert_allclose(ks, plan.k_smooth.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ka, plan.k_app.numpy(), rtol=0, atol=1e-6)
    # each step from the reference's chain within 1e-5; free-running, a
    # label differs only where the reference's top-two margin fell below
    # TIE_EPS (checks.check_lcrf_iterate's rule)
    u, fe = jnp.asarray(plan.unary.numpy()), jnp.asarray(plan.feat.numpy())
    q_ref = [np.asarray(jl._superpixel_crf(u, fe, t)) for t in range(11)]
    margin = np.full(S, np.inf, F)
    for t in range(10):
        forced = _step_rows(np.arange(S), q_ref[t], unary, ks, ka)
        np.testing.assert_allclose(forced, q_ref[t + 1], rtol=0, atol=1e-5)
        top2 = np.sort(q_ref[t + 1], axis=-1)[:, -2:]
        margin = np.minimum(margin, top2[:, 1] - top2[:, 0])
    flipped = lbl != q_ref[10].argmax(-1)
    assert not (flipped & (margin >= TIE_EPS)).any()
