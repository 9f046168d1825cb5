"""The partitions of K13's one-launch render (``csrc/zbuffer.cu``
``render_depths_kernel``) and of K19's patch score (``csrc/keypoints.cu``
``patch_score_kernel``), and their hand-made cases against the reference.

K13: every block of the scatter lists each model's live columns from the
counts (the global bucket at stride ``gs``; the slot-major object range at
stride ``os`` from 0, a slot's positions below its count), and the grid
walks the live columns by grid stride, one a thread (column ``base +
thread`` of a block's trip): column ``t`` belongs to the last model whose
first live column is at or below ``t``. In each warp, a run of lanes
whose keys land on one cell takes its minimum and one atomicMin goes out a
run; the second launch decodes every cell once (four a thread, the cells
past the last four one a thread) and sets each key it read back to
KEY_INVALID. Mirrored here in numpy for grids of several sizes: every live
column (and no other) visited exactly once, the runs' keys equal to the
per-column atomics' (the plain version's scatter-min), every cell decoded
once, the scratch left all KEY_INVALID and the depth equal to
``render_depths_plain``'s.

K19: a block of ``PS_T`` threads owns a ``PS_TX`` x ``PS_TY`` output
tile. A thread computes ``PS_PSEG`` Sobel products along a row from its
3 x (``PS_PSEG`` + 2) staged intensities, then ``PS_HSEG`` horizontal sums
along a row, then ``PS_TY / PS_ROWS`` vertical sums down a column. Here
every phase's thread mapping must cover its positions once and read only
staged (written) values, and the block, emulated in numpy float32 (the
staged intensities with their halo, the truncated Sobel products, the
horizontal and the vertical sums in the kernel's order, the eigenvalue and
the border), must write every pixel once, score and blurred intensity
bit-equal to ``patch_score_plain``, on ``checks.SCORE_CASES``.

Each hand-made case's plain version is also held to the reference package:
``render_model_depths`` fed as its engine feeds it (coverage exact, depth
within one log-depth bin) and the patch detector's score and blur (within
1e-5 of their range: the reference's compiler may contract to FMAs). No
reference engine step is compiled here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu import config as J
from multimotionfusion_tpu.model import surfel_map as jsm
from multimotionfusion_tpu.ops import image as jimg
from multimotionfusion_tpu.ops import rasterize as jr
from multimotionfusion_tpu_torch.kernels import checks
from multimotionfusion_tpu_torch.ops import image as imops
from multimotionfusion_tpu_torch.ops import rasterize as R
from multimotionfusion_tpu_torch.tracking import superpoint as SP
from tests.test_torch_owner_unaries_plan import cu_constants
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ZB = cu_constants("zbuffer")
KP = cu_constants("keypoints")
INVALID = 2**31 - 1
DEPTH_IDS = [c[0] for c in checks.DEPTH_CASES]
SCORE_IDS = [c[0] for c in checks.SCORE_CASES]
# grids the launch may take: 8 blocks an SM on 132 SMs, fewer, one block
GRIDS = (1056, 264, 7, 1)


def _depth_args(name):
    spec = next(c[1:] for c in checks.DEPTH_CASES if c[0] == name)
    return checks.depth_inputs(*spec, "cpu")


def test_constants_read_from_the_sources():
    assert ZB["RD_T"] % 32 == 0 and ZB["RD_MAX_M"] == R.RENDER_DEPTHS_MAX_MODELS == 32
    assert (KP["PS_TX"], KP["PS_TY"], KP["PS_ROWS"], KP["PS_T"]) == (32, 20, 5, 256)
    assert KP["PS_TY"] % KP["PS_ROWS"] == 0 and KP["HALO"] == KP["BR"] + 1


# ---------------------------------------------------------------- K13

def live_columns(st):
    """(start [M + 1], first [M]) of the kernel's ``live_columns``."""
    counts = st.counts.numpy().astype(np.int64)
    M = 1 + st.odata.shape[0]
    live, first = np.zeros(M, np.int64), np.zeros(M, np.int64)
    live[0] = (min(max(counts[0], 0), st.bg) + st.gs - 1) // st.gs
    for m in range(1, M):
        base, c = (m - 1) * st.bo, min(max(counts[m], 0), st.bo)
        first[m] = (base + st.os - 1) // st.os
        live[m] = (base + c + st.os - 1) // st.os - first[m]
    return np.concatenate([[0], np.cumsum(live)]), first


def column_of(st, start, first, t):
    """(model, position) of grid columns ``t``: the kernel's search for the
    last model whose first live column is <= t, then its position."""
    M = len(first)
    lo, hi = np.zeros_like(t), np.full_like(t, M - 1)
    while (lo < hi).any():  # the kernel's binary search, lane by lane
        mid = (lo + hi + 1) >> 1
        up = start[mid] <= t
        lo, hi = np.where(lo < hi, np.where(up, mid, lo), lo), np.where(
            lo < hi, np.where(up, hi, mid - 1), hi)
    m = lo
    j = t - start[m]
    pos = np.where(m == 0, j * st.gs, (first[m] + j) * st.os - (m - 1) * st.bo)
    return m, pos


def strided_index(st, m, pos):
    """The column's index in ``rasterize.depth_keys``' order (the global
    bucket's strided columns, then the flat object range's)."""
    ng = (st.bg + st.gs - 1) // st.gs
    return np.where(m == 0, pos // st.gs, ng + ((m - 1) * st.bo + pos) // st.os)


def grid_blocks(st, resident):
    """The scatter's grid: what fits the card, no more than the capacities'
    columns need."""
    T = ZB["RD_T"]
    S = st.odata.shape[0]
    cols = (st.bg + st.gs - 1) // st.gs + (S * st.bo + st.os - 1) // st.os
    return max(1, min(resident, (cols + T - 1) // T))


@pytest.mark.parametrize("name", DEPTH_IDS)
def test_live_columns_are_visited_once(name):
    a = _depth_args(name)
    st = a[0]
    start, first = live_columns(st)
    total = int(start[-1])
    t = np.arange(total, dtype=np.int64)
    m, pos = column_of(st, start, first, t)
    counts = st.counts.numpy()
    cap = np.where(m == 0, st.bg, st.bo)
    assert (pos >= 0).all() and (pos < np.minimum(counts[m], cap)).all()
    stride = np.where(m == 0, st.gs, st.os)
    flat = np.where(m == 0, pos, (m - 1) * st.bo + pos)
    assert (flat % stride == 0).all()
    # the live columns of the plain version's strided store, each once
    pix, key = R.depth_keys(*a)
    idx = strided_index(st, m, pos)
    assert len(np.unique(idx)) == total
    M = 1 + st.odata.shape[0]
    gi = np.arange(0, st.bg, st.gs)
    oi = np.arange(0, (M - 1) * st.bo, st.os)
    model = np.concatenate([np.zeros(len(gi), np.int64), oi // max(st.bo, 1) + 1])
    at = np.concatenate([gi, oi % max(st.bo, 1)])
    live = at < counts[model]
    assert sorted(idx.tolist()) == np.flatnonzero(live).tolist()
    # a column the grid skips never holds a key
    assert (key.numpy()[~live] == INVALID).all()
    # every grid column is one thread's of one block's trip, and a warp's 32
    # lanes hold 32 consecutive columns (a warp trip: t // 32)
    T = ZB["RD_T"]
    for grid in GRIDS:
        g = grid_blocks(st, grid)
        trip, rest = np.divmod(t, g * T)
        block, thread = np.divmod(rest, T)
        assert ((trip * g + block) * T + thread == t).all() and (block < g).all()
        assert (((trip * g + block) * T + thread // 32 * 32) == t // 32 * 32).all()


@pytest.mark.parametrize("name", DEPTH_IDS)
def test_warp_runs_keys_and_decode_reset(name):
    a = _depth_args(name)
    st, cam_c = a[0], a[4]
    M = 1 + st.odata.shape[0]
    n = M * cam_c.height * cam_c.width
    start, first = live_columns(st)
    t = np.arange(int(start[-1]), dtype=np.int64)
    m, pos = column_of(st, start, first, t)
    pix, key = R.depth_keys(*a)
    idx = strided_index(st, m, pos)
    cell, k = pix.numpy()[idx], key.numpy()[idx]
    ok = k != INVALID
    assert (cell[ok] < n).all() and (cell[~ok] == n).all()
    # runs of consecutive lanes of a warp trip (t // 32) on one cell: the
    # run's minimum, one atomicMin a run
    lane = t % 32
    assert (cell[ok] >= 0).all()
    ident = np.where(ok, cell, -1 - lane)  # a lane without a key: a run of its own
    head = (lane == 0) | (ident != np.roll(ident, 1))
    run = np.cumsum(head) - 1
    runs = int(run[-1]) + 1 if len(run) else 0
    run_min = np.full(runs, INVALID, np.int64)
    np.minimum.at(run_min, run[ok], k[ok])
    run_cell = np.full(runs, n, np.int64)
    run_cell[run[ok]] = cell[ok]
    landed = run_cell < n
    scratch = np.full(n, INVALID, np.int64)
    np.minimum.at(scratch, run_cell[landed], run_min[landed])
    every = np.full(n, INVALID, np.int64)  # one atomicMin a column
    np.minimum.at(every, cell[ok], k[ok])
    np.testing.assert_array_equal(scratch, every)
    # the plain version's scatter-min
    kmin = torch.full((n + 1,), INVALID, dtype=torch.int32)
    kmin.scatter_reduce_(0, pix, key, reduce="amin", include_self=True)
    np.testing.assert_array_equal(scratch, kmin[:n].numpy())
    print(f"{name}: {ok.sum()} keys, {int(landed.sum())} atomics")
    # the decode: thread q < n // 4 the cells 4q..4q+3, the next n % 4 threads
    # one cell each past them
    n4 = n >> 2
    q = np.arange(n4 + n % 4)
    cells = np.concatenate([(4 * q[:n4, None] + np.arange(4)).ravel(), 4 * n4 + (q[n4:] - n4)])
    assert (np.bincount(cells, minlength=n) == 1).all() and len(cells) == n
    decoded = torch.from_numpy(scratch.astype(np.int32))
    zw = torch.exp2((decoded & ((1 << 20) - 1)).to(torch.float32) * (8.0 / (1 << 20)) - 4.0)
    depth = torch.where(decoded != INVALID, zw, torch.zeros_like(zw))
    assert torch.equal(depth.reshape(M, cam_c.height, cam_c.width), R.render_depths_plain(*a))
    scratch[:] = INVALID  # each key read set back
    assert (scratch == INVALID).all()


def test_edge_surfels_gated_as_the_reference():
    a = _depth_args("edges")
    _, key = R.depth_keys(*a)
    lands = (key.numpy()[:14] != INVALID).tolist()
    # z at the max depth, an ulp past it, 0, behind; u at -0.5, W - 0.5,
    # 10.5, 11.5; v at -0.5, H - 0.5, 12.5, 13.5; last_t at the window, past
    assert lands == [True, False, False, False, True, False, True, True, True, False, True,
                     True, True, False]


def test_miss_bit_set_where_a_gate_is_missed():
    a = _depth_args("conf_miss")
    _, key = R.depth_keys(*a)
    k = key.numpy()
    landed = k != INVALID
    assert (landed & (k >> 21 == 1)).any() and (landed & (k >> 21 == 0)).any()


def _camera_frame(data, T):
    """The position rows of the reference's ``surfel_map.transform_surfels``
    in numpy float32: the same expressions, each operation rounded once (as
    its eager ``jnp`` operations are); the other rows as they are."""
    out = data.astype(np.float32).copy()
    R, t = T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32)
    p = [out[jsm.PX].copy(), out[jsm.PY].copy(), out[jsm.PZ].copy()]
    for i, row in enumerate((jsm.PX, jsm.PY, jsm.PZ)):
        out[row] = R[i, 0] * p[0] + R[i, 1] * p[1] + R[i, 2] * p[2] + t[i]
    return out


_render_model_depths = jax.jit(jr.render_model_depths, static_argnames=("n_models", "cam_c"))


def _reference_depths(a):
    """``render_model_depths`` (jitted: no product in it is followed by an
    addition, so no contraction changes a rounding) fed as the reference's
    engine feeds it (engine_multi.py:945-981): the stores in each model's
    camera frame (``_camera_frame``), strided as ``_stride_cols`` strides,
    slot ids from the original index."""
    st, T_inv, maxd, conf, cam_c, time, td = a
    S, bo = st.odata.shape[0], st.bo
    counts = st.counts.numpy()
    Ti = T_inv.numpy()
    gd = st.gdata.numpy()[:, :st.bg]
    parts = [_camera_frame(gd, Ti[0])[:, ::st.gs]]
    alive = [((np.arange(st.bg) < counts[0]) & (gd[13] > 0))[::st.gs]]
    seg = [np.zeros(((st.bg + st.gs - 1) // st.gs,), np.int32)]
    if S:
        od = st.odata.numpy()[:, :, :bo]
        o_local = np.stack([_camera_frame(od[k], Ti[k + 1]) for k in range(S)])
        oalive = np.stack([(np.arange(bo) < counts[k + 1]) & (od[k, 13] > 0) for k in range(S)])
        parts.append(np.moveaxis(o_local, 0, 1).reshape(16, -1)[:, ::st.os])
        alive.append(oalive.reshape(-1)[::st.os])
        n_obj = (S * bo + st.os - 1) // st.os
        seg.append((np.arange(n_obj, dtype=np.int32) * st.os) // bo + 1)
    cam = J.CameraModel(width=cam_c.width, height=cam_c.height, fx=cam_c.fx, fy=cam_c.fy,
                        cx=cam_c.cx, cy=cam_c.cy)
    return np.asarray(_render_model_depths(
        jnp.asarray(np.concatenate(parts, axis=1)), jnp.asarray(np.concatenate(alive)),
        jnp.asarray(np.concatenate(seg)), jnp.asarray(conf.numpy()),
        jnp.asarray(maxd.numpy()), n_models=1 + S, cam_c=cam, time=time, time_delta=td))


@pytest.mark.parametrize("name", DEPTH_IDS)
def test_depth_case_plain_matches_reference(name):
    a = _depth_args(name)
    ref = _reference_depths(a)
    out = R.render_depths_plain(*a).numpy()
    np.testing.assert_array_equal(out > 0, ref > 0)
    # one log-depth bin is 2^(8 / 2^20) - 1 = 5.3e-6 relative
    np.testing.assert_allclose(out, ref, rtol=6e-6, atol=0)
    if name == "zero_counts":
        assert not (out > 0).any()
    elif name == "one_cell":
        assert ((out > 0).sum(axis=(1, 2)) == 1).all()
    else:
        assert (out > 0).sum() > 0


# ---------------------------------------------------------------- K19

def test_patch_score_phases_cover_their_positions_once():
    TX, TY, ROWS, T = KP["PS_TX"], KP["PS_TY"], KP["PS_ROWS"], KP["PS_T"]
    IW, IH, IWP = KP["PS_IW"], KP["PS_IH"], KP["PS_IWP"]
    PW, PH, PSEG, HSEG = KP["PS_PW"], KP["PS_PH"], KP["PS_PSEG"], KP["PS_HSEG"]
    assert (IW, IH, PW, PH) == (TX + 6, TY + 6, TX + 4, TY + 4)
    # 2. products: thread tid < PH * (PW / PSEG) at row ly, columns lx0..,
    # from staged rows ly..ly+2 and columns lx0..lx0+PSEG+1 (float2 pairs)
    seen = np.zeros((PH, PW), np.int64)
    for tid in range(PH * (PW // PSEG)):
        assert tid < T
        ly, lx0 = tid // (PW // PSEG), tid % (PW // PSEG) * PSEG
        seen[ly, lx0:lx0 + PSEG] += 1
        assert lx0 % 2 == 0 and ly + 2 < IH and lx0 + PSEG + 1 < IW
    assert (seen == 1).all()
    # 3. horizontal sums: thread tid < PH * (TX / HSEG) at row ly, columns
    # c0..c0+3: products c0..c0+7 (two float4), intensities c0+1..c0+8 of
    # staged row ly+1 (three float4 from c0: the last four past the used)
    seen = np.zeros((PH, TX), np.int64)
    for tid in range(PH * (TX // HSEG)):
        assert tid < T
        ly, c0 = tid // (TX // HSEG), tid % (TX // HSEG) * HSEG
        seen[ly, c0:c0 + HSEG] += 1
        assert c0 % 4 == 0 and c0 + 7 < PW and c0 + 8 < IW and c0 + 11 < IWP and ly + 1 < IH
    assert (seen == 1).all()
    # 4. vertical sums: thread tid < ROWS * TX, column tid % TX, rows
    # (tid // TX) * TY / ROWS.., from horizontal-sum rows r0..r0+TY/ROWS+3
    seen = np.zeros((TY, TX), np.int64)
    rpt = TY // ROWS
    for tid in range(ROWS * TX):
        tx, ty = tid % TX, tid // TX
        seen[ty * rpt:(ty + 1) * rpt, tx] += 1
        assert (ty + 1) * rpt + 3 < PH
    assert (seen == 1).all() and ROWS * TX <= T


def emulate_patch_score(img: np.ndarray):
    """``patch_score_kernel`` block by block in numpy float32 (the square
    root torch's): (score, blurred, the number of times each pixel was
    written)."""
    h, w = img.shape
    TX, TY, ROWS = KP["PS_TX"], KP["PS_TY"], KP["PS_ROWS"]
    BR, HALO = KP["BR"], KP["HALO"]
    RPT = TY // ROWS
    f = np.float32
    k15 = imops.gaussian_weights(1.5, 2)
    k10 = imops.gaussian_weights(1.0, 2)
    k1, k2 = f(0.52201), f(0.79451)
    score = np.zeros((h, w), f)
    blurred = np.zeros((h, w), f)
    written = np.zeros((h, w), np.int64)
    padded = np.zeros((h + 2 * TY + 2 * HALO, w + 2 * TX + 2 * HALO), f)
    padded[HALO:HALO + h, HALO:HALO + w] = img
    for by in range(-(-h // TY)):
        for bx in range(-(-w // TX)):
            y0, x0 = by * TY, bx * TX
            s_i = padded[y0:y0 + TY + 2 * HALO, x0:x0 + TX + 2 * HALO]  # rows y0-3 ..
            ph, pw = TY + 2 * BR, TX + 2 * BR
            s = lambda dy, dx: s_i[1 + dy:1 + dy + ph, 1 + dx:1 + dx + pw]  # noqa: E731
            gx = (-k1) * s(-1, -1)
            gx = gx + k1 * s(-1, 1)
            gx = gx + (-k2) * s(0, -1)
            gx = gx + k2 * s(0, 1)
            gx = gx + (-k1) * s(1, -1)
            gx = gx + k1 * s(1, 1)
            gy = (-k1) * s(-1, -1)
            gy = gy + (-k2) * s(-1, 0)
            gy = gy + (-k1) * s(-1, 1)
            gy = gy + k1 * s(1, -1)
            gy = gy + k2 * s(1, 0)
            gy = gy + k1 * s(1, 1)
            gx, gy = np.trunc(gx), np.trunc(gy)
            ys = (y0 - BR + np.arange(ph))[:, None]
            xs = (x0 - BR + np.arange(pw))[None, :]
            inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
            prods = [np.where(inside, p, f(0)) for p in (gx * gx, gy * gy, gx * gy)]
            s_h = []
            for c in range(4):
                acc = np.zeros((ph, TX), f)
                for i in range(2 * BR + 1):
                    src = prods[c][:, i:i + TX] if c < 3 else s_i[1:1 + ph, 1 + i:1 + i + TX]
                    acc = acc + (k15 if c < 3 else k10)[i] * src
                s_h.append(acc)
            out = []
            for c in range(4):
                acc = np.zeros((TY, TX), f)
                for i in range(2 * BR + 1):
                    acc = acc + (k15 if c < 3 else k10)[i] * s_h[c][i:i + TY]
                out.append(acc)
            ixx, iyy, ixy = out[:3]
            tr = ixx + iyy
            det = ixx * iyy - ixy * ixy
            # torch's square root, as the plain version's: on the CPU it is not
            # always correctly rounded (sqrtf on the card, and torch.sqrt there, are)
            disc = torch.sqrt(torch.from_numpy(np.maximum(tr * tr / f(4) - det, f(0)))).numpy()
            min_eig = tr / f(2) - disc
            for ty in range(ROWS):  # each thread's rows, as the kernel writes them
                for r in range(RPT):
                    ly = ty * RPT + r
                    y = y0 + ly
                    if y >= h:
                        break
                    x = x0 + np.arange(TX)
                    keep = x < w
                    border = (y >= 8) & (y < h - 8) & (x >= 8) & (x < w - 8)
                    score[y, x[keep]] = np.where(border, min_eig[ly], f(0))[keep]
                    blurred[y, x[keep]] = out[3][ly][keep]
                    written[y, x[keep]] += 1
    return score, blurred, written


@pytest.mark.parametrize("name", SCORE_IDS)
def test_patch_score_emulation_bit_equal_to_plain(name):
    _, h, w, kind = next(c for c in checks.SCORE_CASES if c[0] == name)
    (img,) = checks.score_inputs(h, w, kind, "cpu")
    score, blurred, written = emulate_patch_score(img.numpy())
    assert (written == 1).all()
    sp, bp = (x.numpy() for x in SP.patch_score_plain(img))
    assert score.tobytes() == sp.tobytes() and blurred.tobytes() == bp.tobytes()


@pytest.mark.parametrize("name", SCORE_IDS)
def test_score_case_plain_matches_reference(name):
    _, h, w, kind = next(c for c in checks.SCORE_CASES if c[0] == name)
    (img,) = checks.score_inputs(h, w, kind, "cpu")
    score_t, blur_t = (x.numpy() for x in SP.patch_score_plain(img))
    inten = jnp.asarray(img.numpy())
    gx, gy = jimg.sobel_gradients(inten)
    ixx = jimg.gaussian_blur(gx * gx, 1.5, 2)
    iyy = jimg.gaussian_blur(gy * gy, 1.5, 2)
    ixy = jimg.gaussian_blur(gx * gy, 1.5, 2)
    tr, det = ixx + iyy, ixx * iyy - ixy * ixy
    min_eig = np.asarray(tr / 2.0 - jnp.sqrt(jnp.maximum(tr * tr / 4.0 - det, 0.0)))
    ys, xs = np.mgrid[0:h, 0:w]
    inside = (ys >= 8) & (ys < h - 8) & (xs >= 8) & (xs < w - 8)
    score_j = np.where(inside, min_eig, 0.0)
    np.testing.assert_allclose(score_t, score_j, rtol=0, atol=1e-5 * np.abs(score_j).max())
    blur_j = np.asarray(jimg.gaussian_blur(inten, 1.0, 2))
    np.testing.assert_allclose(blur_t, blur_j, rtol=0, atol=1e-5 * np.abs(blur_j).max())
    assert (score_t[~inside] == 0).all()
    if kind == "constant" or not inside.any():
        assert (score_t == 0).all()
    else:
        assert (score_t > 0).sum() > 0
