"""The staged reads of K11's owner prep (``csrc/gn_multi.cu``) and the pull
form of K18's unaries (``csrc/segment.cu``).

Owner prep: one launch builds every level. A block of ``OT`` threads owns
an ``OTW`` x ``OTH`` tile of level ``l``, one thread a pixel, and stages its
level's mask samples and their keys on the tile widened by ``WB`` before and
``WA`` after; a level-0 block also stages the prediction owners its
diamonds read, the tile widened by ``DIAMOND``, rows and columns taken
modulo the image. A pixel reads diamond tap (dy, dx) at staged position
``(ry + DIAMOND + dy) * PRED_W + tx + DIAMOND + dx`` and window tap (oy, ox)
at ``(ry + WB + oy) * WIN_W + tx + WB + ox`` (``(tx, ry)`` the pixel in
its tile). Level-0 pixel (y, x) with y and x multiples of 2^l also writes level
l's owner and eroded owner at (y >> l, x >> l): the reference erodes at full
resolution and samples. Here that arithmetic, mirrored in numpy, must give
every tap of every pixel the image position the reference names
(``jnp.roll``'s wrap for the diamond), inside the staged region and the
kernel's shared arrays, for every level and sizes off the tile; every
coarse pixel must be written by one level-0 pixel; the kernel computed from
its staged arrays (the key rule included) must give ``owner_levels_plain``'s
maps bit for bit on ``checks.OWNER_CASES``; the grid's level ranges must
cover every tile once; and the constants must be read from the source.

Unaries: block b owns the cells [b UN_C, (b + 1) UN_C) and mins the error
of each valid track whose cell is one of its own into its rows. That
binning, emulated block by block, must give ``sparse_unary``'s error rows
and ``unaries_plain``'s unary bit for bit on ``checks.UNARY_CASES``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multimotionfusion_tpu_torch.kernels import checks
from multimotionfusion_tpu_torch.odometry import levels as LV
from multimotionfusion_tpu_torch.odometry import multi as MO
from multimotionfusion_tpu_torch.segmentation import flow_crf as FC
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CSRC = Path(MO.__file__).resolve().parent.parent / "csrc"
SIZES = ((9, 11), (17, 23), (37, 61), (61, 37), (33, 129), (120, 160), (487, 651), (480, 640))


def cu_constants(name: str) -> dict:
    """The ``constexpr int`` constants of ``csrc/<name>.cu`` that evaluate
    from the file's own earlier ones."""
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", (CSRC / f"{name}.cu").read_text()):
        for part in decl.split(","):
            key, expr = (x.strip() for x in part.split("=", 1))
            try:
                out[key] = eval(re.sub(r"//.*", "", expr), {}, dict(out))
            except (NameError, SyntaxError):  # a header's constant, a kernel's local one
                pass
    return out


OWN = cu_constants("gn_multi")
UN = cu_constants("segment")


def pred_region():
    """(width, height) of a level-0 tile's staged prediction owners."""
    d = OWN["DIAMOND"]
    return OWN["OTW"] + 2 * d, OWN["OTH"] + 2 * d


def test_owner_constants():
    assert OWN["OWN_LEVELS"] == MO.OWN_LEVELS == 3
    assert OWN["OT"] == OWN["OTW"] * OWN["OTH"] == 256
    assert OWN["DIAMOND"] == 2 and (OWN["WB"], OWN["WA"]) == (2, 1)
    assert (OWN["PRED_W"], OWN["PRED_H"]) == pred_region()
    assert OWN["PRED_STAGED"] == OWN["PRED_W"] * OWN["PRED_H"]
    assert OWN["WIN_STAGED"] == (OWN["OTW"] + 3) * (OWN["OTH"] + 3)
    # the static shared memory of a block: both staged arrays, under 48 KB
    assert 4 * (OWN["PRED_STAGED"] + 2 * OWN["WIN_STAGED"]) <= 48 * 1024


def diamond():
    d = OWN["DIAMOND"]
    return [(dy, dx) for dy in range(-d, d + 1) for dx in range(-d, d + 1)
            if abs(dy) + abs(dx) <= d]


def owner_reads(lvl: int, H0: int, W0: int):
    """Per pixel of level ``lvl``: for every diamond tap (level 0 only: the
    staged position, the image position the staging wrote there, the
    position the reference's rolled erosion reads) and for every window tap
    (the staged position, the level position staged there, the level
    position the reference's shifted window reads), as arrays. The staging
    wraps with a modulo (the kernel's ``wrap``)."""
    tw, th, d, wb = OWN["OTW"], OWN["OTH"], OWN["DIAMOND"], OWN["WB"]
    pw = pred_region()[0]
    h, w = ((H0 - 1) >> lvl) + 1, ((W0 - 1) >> lvl) + 1
    y, x = np.mgrid[0:h, 0:w]
    x0, y0, tx, ry = x - x % tw, y - y % th, x % tw, y % th  # ry: the row in the tile
    Y0, X0 = y0 - d, x0 - d
    dia = []
    for dy, dx in diamond() if lvl == 0 else ():
        r, c = ry + d + dy, tx + d + dx
        got = ((Y0 + r) % H0, (X0 + c) % W0)
        want = ((y + dy) % H0, (x + dx) % W0)
        dia.append((r, c, r * pw + c, got, want))
    win_w = tw + wb + OWN["WA"]
    win = []
    for oy in range(-wb, OWN["WA"] + 1):
        for ox in range(-wb, OWN["WA"] + 1):
            r, c = ry + wb + oy, tx + wb + ox
            win.append((r, c, r * win_w + c, (y0 - wb + r, x0 - wb + c), (y + oy, x + ox)))
    return (h, w), dia, win


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_every_owner_tap_is_staged(hw):
    H0, W0 = hw
    pw, ph = pred_region()
    for lvl in range(OWN["OWN_LEVELS"]):
        _, dia, win = owner_reads(lvl, H0, W0)
        assert len(dia) == (13 if lvl == 0 else 0)
        for r, c, s, got, want in dia:
            assert r.min() >= 0 and r.max() < ph and c.min() >= 0 and c.max() < pw
            assert s.max() < OWN["PRED_STAGED"]
            assert (got[0] == want[0]).all() and (got[1] == want[1]).all(), lvl
        for r, c, s, got, want in win:
            assert r.min() >= 0 and r.max() < OWN["OTH"] + 3
            assert c.min() >= 0 and c.max() < OWN["OTW"] + 3
            assert s.max() < OWN["WIN_STAGED"]
            assert (got[0] == want[0]).all() and (got[1] == want[1]).all(), lvl


@pytest.mark.parametrize("lvl", range(3))
def test_owner_region_is_the_tiles_taps(lvl):
    """The staged prediction rectangle (level 0) is the bounding box of a
    whole tile's diamond taps (no larger than they need), and a tile's
    windows read every staged window position."""
    tw, th = OWN["OTW"], OWN["OTH"]
    pw, ph = pred_region()
    H0, W0 = (th << lvl) * 4, (tw << lvl) * 4  # a tile away from every border
    _, dia, win = owner_reads(lvl, H0, W0)
    sl = np.s_[th: 2 * th, tw: 2 * tw]  # the second tile of each axis
    if lvl == 0:
        rows = np.concatenate([r[sl].ravel() for r, *_ in dia])
        cols = np.concatenate([c[sl].ravel() for _, c, *_ in dia])
        assert (rows.min(), rows.max(), cols.min(), cols.max()) == (0, ph - 1, 0, pw - 1)
    assert sorted(set(np.concatenate([s[sl].ravel() for *_, s, _, _ in win]).tolist())) == \
        list(range((tw + 3) * (th + 3)))


def grid(H0: int, W0: int, levels: int):
    """mmf_owner_prep's grid: per level (first block, end), coarsest first."""
    tw = OWN["OTW"]
    out, blocks = {}, 0
    for lvl in reversed(range(levels)):
        h, w = ((H0 - 1) >> lvl) + 1, ((W0 - 1) >> lvl) + 1
        n = -(-w // tw) * -(-h // OWN["OTH"])
        out[lvl] = (blocks, blocks + n)
        blocks += n
    return out, blocks


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_owner_grid_covers_every_level_once(hw):
    H0, W0 = hw
    for levels in (1, 2, 3):
        ranges, blocks = grid(H0, W0, levels)
        seen = np.zeros(blocks, int)
        for lvl, (b0, b1) in ranges.items():
            seen[b0:b1] += 1
            h, w = LV.level_sizes(H0, W0, levels)[lvl]
            tiles = np.zeros((h, w), int)
            tw, th = OWN["OTW"], OWN["OTH"]
            tx = -(-w // tw)
            for tile in range(b1 - b0):
                x0, y0 = tile % tx * tw, tile // tx * th
                tiles[y0: y0 + th, x0: x0 + tw] += 1
            assert (tiles == 1).all()
        assert (seen == 1).all()


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_coarse_owners_come_from_level_0_once(hw):
    """The level-0 pixels whose coordinates are multiples of 2^l (the
    kernel's ``(y | x) & (2^l - 1)`` test) write level l's owners at
    ``(y >> l) * w_l + (x >> l)``: every pixel of level l exactly once."""
    H0, W0 = hw
    y, x = np.mgrid[0:H0, 0:W0]
    for lvl in (1, 2):
        h, w = LV.level_sizes(H0, W0, 3)[lvl]
        sel = ((y | x) & ((1 << lvl) - 1)) == 0
        q = (y[sel] >> lvl) * w + (x[sel] >> lvl)
        assert sorted(q.tolist()) == list(range(h * w))


def owner_emulated(mask, pred, frame, M: int, scales):
    """The owner prep as the kernel computes it from its staged arrays
    (reading each tap where ``owner_reads`` says the staging wrote it): the
    coarser levels' owners and eroded owners are level 0's at (y << l, x << l)."""
    mask, pred = mask.numpy(), pred.numpy()
    H0, W0 = mask.shape
    out = []
    for lvl, (fl, ms) in enumerate(zip(frame, scales)):
        (h, w), dia, win = owner_reads(lvl, H0, W0)
        y, x = np.mgrid[0:h, 0:w]
        img = fl.img.numpy()
        if lvl == 0:
            o0 = pred.copy()
            differs = np.zeros((h, w), bool)
            for *_, got, _ in dia:
                differs |= pred[got] != o0
            bank0 = np.where((o0 == 0) & differs, M, o0)
        bank = bank0[(y << lvl), (x << lvl)]
        own = mask[(y << lvl), (x << lvl)]
        all_ok = np.ones((h, w), bool)
        for *_, got, _ in win:
            yy, xx = got
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yc, xc = np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)
            t_own = mask[yc << lvl, xc << lvl]
            key = np.where((img[yc, xc] > 0) & (t_own < M), t_own, M)
            all_ok &= ~inside | (key == own)
        gx, gy = fl.didx.numpy(), fl.didy.numpy()
        valid = (own < M) & all_ok & (x < w - 5) & (y < h - 1)
        valid &= (gx * gx + gy * gy >= np.float32(ms)) & (fl.depth.numpy() > 0)
        out.append((own, bank, valid))
    return out


@pytest.mark.parametrize("case", checks.OWNER_CASES, ids=[c[0] for c in checks.OWNER_CASES])
def test_owner_kernel_emulated_is_the_plain_version(case):
    _, h, w, levels, M = case
    a = checks.owner_inputs(h, w, levels, M, "cpu")
    plain = MO.owner_levels_plain(*a)
    emulated = owner_emulated(*a)
    assert len(plain) == len(emulated) == levels
    for lvl, ((po, pb, ps), (eo, eb, es)) in enumerate(zip(plain, emulated)):
        np.testing.assert_array_equal(po.numpy(), eo, err_msg=f"own L{lvl}")
        np.testing.assert_array_equal(pb.numpy(), eb, err_msg=f"bank L{lvl}")
        np.testing.assert_array_equal(ps.numpy(), es, err_msg=f"valid L{lvl}")
    assert int((plain[0][1] == M).sum()) > 0


# ---------------------------------------------------------------- unaries

def test_unaries_constants():
    assert UN["UN_T"] % 32 == 0 and UN["UN_TRACKS"] >= 1 and UN["UN_C"] <= UN["UN_T"]
    # the rows of the most models and a round's track list fit in the 48 KB a
    # block takes without asking
    assert ((UN["MAX_M"] + 1) * UN["UN_C"] + UN["UN_T"] * UN["UN_TRACKS"]) * 4 <= 48 * 1024


def unary_errors_pulled(a, hc: int, wc: int):
    """The sparse-error rows as the pull form builds them: block by block,
    each block's rows from the tracks whose cell is one of its own; and how
    many blocks took each valid track."""
    _, _, active, xy, vel, valid, cfg, allow_new = a
    n, nt = hc * wc, UN["UN_C"]
    M, T = vel.shape
    xy, vel, valid, active = xy.numpy(), vel.numpy(), valid.numpy(), active.numpy()
    sx = np.float32(xy[:, 0] * np.float32(cfg.scale))
    sy = np.float32(xy[:, 1] * np.float32(cfg.scale))
    cell = (np.clip(np.rint(sy), 0, hc - 1) * wc + np.clip(np.rint(sx), 0, wc - 1)).astype(int)
    with np.errstate(invalid="ignore"):
        e = np.where(vel > cfg.velocity_threshold, 1.0, 0.0).astype(np.float32)
        fits = ((vel < cfg.velocity_threshold) & active[:, None]).any(0)
    known = (~active[:, None] | np.isfinite(vel)).all(0)
    err = np.full((M + 1, n), np.inf, np.float32)
    taken = np.zeros(T, int)
    for b in range(-(-n // nt)):
        rows = np.full((M + 1, nt), np.inf, np.float32)
        for t in np.flatnonzero(valid):
            local = cell[t] - b * nt
            if not 0 <= local < nt:
                continue
            taken[t] += 1
            for m in np.flatnonzero(active):
                rows[m, local] = min(rows[m, local], e[m, t])
            if allow_new and known[t]:
                rows[M, local] = min(rows[M, local], np.float32(fits[t]))
        end = min(n, (b + 1) * nt)
        err[:, b * nt: end] = rows[:, : end - b * nt]
    return err.reshape(M + 1, hc, wc), taken[valid]


@pytest.mark.parametrize("case", checks.UNARY_CASES, ids=[c[0] for c in checks.UNARY_CASES])
def test_pull_form_is_the_plain_version(case):
    name, hc, wc, k, M, T, allow_new = case
    a = checks.unaries_inputs(hc, wc, k, M, T, allow_new, name == "one_cell", "cpu")
    err, taken = unary_errors_pulled(a, hc, wc)
    _, _, active, xy, vel, valid, cfg, _ = a
    plain_err = FC.sparse_unary(xy, vel, valid, active, hc, wc, cfg.scale,
                                cfg.velocity_threshold, allow_new)
    assert (taken == 1).all()  # every valid track lands in exactly one block
    assert torch.equal(torch.from_numpy(err), plain_err)
    unary = FC.neg_log_softmax_errors(torch.from_numpy(err))
    assert torch.equal(unary, FC.unaries_plain(*a).unary)
    if T and name != "no_new":
        assert bool(torch.isfinite(plain_err[M]).any())  # the outlier row is reached
