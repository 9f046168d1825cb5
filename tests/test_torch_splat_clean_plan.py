"""The staged windows of K10 (``csrc/splat_resolve.cu``) and of K14's and
K9's clean pixel passes (``csrc/fuse_flat.cu``, ``csrc/clean.cu``), and the
clean's in-place rule.

A block of one thread a pixel owns a ``TILE`` = (32, 8) pixel tile and
stages it widened by ``halo(window)``; each pixel then reads its window's taps
from the staged position ``(ty + j) * sw + tx + i`` (tap ``(j, i)`` of the
window, ``sw`` the staged width), and the staging writes position ``s`` from
the image at ``(y0 - before + s // sw, x0 - before + s % sw)``. Here that
arithmetic, mirrored in numpy, must give every tap of every pixel the image
position the reference's offsets name, inside the staged region and the
kernels' shared arrays, for windows 1-7 and image sizes off the tile; the
region must be no larger than a block's taps; the tiles must cover the image
once; and the kernels' constants must be the plan's. A window the staging
does not hold raises.

The clean on the card writes CONF only where a surfel's penalty is not 1
and ALIVE (+0) only where a surfel is not kept and its ALIVE is not +0,
leaving every other channel and row as it is: that rule, applied to a copy
of the store, must give ``clean_flat_plain``'s new store bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multimotionfusion_tpu_torch.config import SurfelConfig
from multimotionfusion_tpu_torch.kernels import checks
from multimotionfusion_tpu_torch.model import fusion as FU
from multimotionfusion_tpu_torch.model import surfel_map as sm
from multimotionfusion_tpu_torch.ops import rasterize as R

CSRC = Path(R.__file__).resolve().parent.parent / "csrc"
TILE = (32, 8)  # (width, height) of a block's pixel tile
WINDOWS = tuple(range(1, R.STAGE_MAX_WINDOW + 1))
SIZES = ((9, 11), (17, 23), (37, 61), (61, 37), (120, 160), (487, 651))
# (source, tile width, tile height, largest window, shared array length) names
KERNELS = (("splat_resolve", "TW", "TH", "MAX_WINDOW", "STAGED"),
           ("fuse_flat", "CTW", "CTH", "CLEAN_MAX_WINDOW", "CLEAN_STAGED"),
           ("clean", "CTW", "CTH", "CLEAN_MAX_WINDOW", "CLEAN_STAGED"))


def cu_constants(name: str) -> dict:
    """The ``constexpr int`` constants of ``csrc/<name>.cu`` that evaluate
    from the file's own earlier ones."""
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", (CSRC / f"{name}.cu").read_text()):
        for part in decl.split(","):
            key, expr = (x.strip() for x in part.split("=", 1))
            try:
                out[key] = eval(re.sub(r"//.*", "", expr), {}, dict(out))
            except NameError:  # a constant of an included header
                pass
    return out


@pytest.mark.parametrize("kernel", KERNELS, ids=[k[0] for k in KERNELS])
def test_constants_are_the_plan(kernel):
    name, tw, th, mw, staged = kernel
    k = cu_constants(name)
    assert (k[tw], k[th]) == TILE and k[mw] == R.STAGE_MAX_WINDOW
    assert k[staged] == (k[tw] + k[mw] - 1) * (k[th] + k[mw] - 1)


def halo(window: int) -> tuple:
    """(before, after): the taps' offsets run from -(window // 2) to
    window - window // 2 - 1, the reference's order."""
    return window // 2, window - window // 2 - 1


def staged_reads(h: int, w: int, window: int):
    """Per pixel and tap: (the staged position the kernel reads, the image
    position that the staging wrote there, the image position the
    reference's offsets name), as [taps, h, w] arrays."""
    tw, th = TILE
    before, _ = halo(window)
    sw = tw + window - 1
    y, x = np.mgrid[0:h, 0:w]
    x0, y0, tx, ty = x - x % tw, y - y % th, x % tw, y % th
    s, got, want = [], [], []
    for j in range(window):  # dy outer, dx inner, as the reference
        for i in range(window):
            pos = (ty + j) * sw + tx + i
            s.append(pos)
            got.append((y0 - before + pos // sw, x0 - before + pos % sw))
            want.append((y + j - before, x + i - before))
    return np.stack(s), np.array(got), np.array(want)


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_every_tap_is_staged(hw):
    """Every tap of every pixel reads, from inside the staged region and
    the shared arrays, what the staging stored from the tap's image
    position; a tap off the image reads a position the staging left empty
    (off the image too)."""
    h, w = hw
    tw, th = TILE
    capacity = (tw + R.STAGE_MAX_WINDOW - 1) * (th + R.STAGE_MAX_WINDOW - 1)
    for window in WINDOWS:
        s, got, want = staged_reads(h, w, window)
        sh = th + window - 1
        assert s.min() >= 0 and s.max() < (tw + window - 1) * sh <= capacity
        assert (got == want).all(), window
        offsets = [o - halo(window)[0] for o in range(window)]
        assert offsets == list(range(-(window // 2), window - window // 2))


@pytest.mark.parametrize("window", WINDOWS)
def test_staged_region_is_the_blocks_taps(window):
    """A block's taps read every staged position, each at least once: the
    halo is no wider than the window needs."""
    tw, th = TILE
    s, _, _ = staged_reads(th, tw, window)  # one whole block
    assert sorted(set(s.reshape(-1).tolist())) == list(
        range((tw + window - 1) * (th + window - 1)))


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_tiles_cover_the_image_once(hw):
    h, w = hw
    tw, th = TILE
    gx, gy = -(-w // tw), -(-h // th)
    seen = np.zeros((h, w), np.int64)
    for by in range(gy):
        for bx in range(gx):
            seen[by * th:(by + 1) * th, bx * tw:(bx + 1) * tw] += 1
    assert (seen == 1).all()


def test_a_window_the_staging_does_not_hold_raises():
    cam = checks._case_camera(9, 11)
    index = torch.zeros((9, 11), dtype=torch.int32)
    data_local = torch.zeros((sm.CHANNELS, 4))
    with pytest.raises(ValueError, match="window"):
        R.splat_resolve_cuda(index, data_local, cam, 0.0, 1, 1, 1, R.STAGE_MAX_WINDOW + 1)
    a = checks.clean_flat_inputs(9, 11, "cpu")
    cfg = SurfelConfig(assoc_window=R.STAGE_MAX_WINDOW + 1)
    with pytest.raises(ValueError, match="window"):
        FU.clean_flat_cuda(*a[:-1], cfg)


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("case", checks.CLEAN_FLAT_CASES, ids=[c[0] for c in checks.CLEAN_FLAT_CASES])
def test_in_place_rule_gives_the_plain_store(case, seed):
    _, h, w, window = case
    a = checks.clean_flat_inputs(h, w, "cpu", seed, window)
    data = a[0]
    plain = FU.clean_flat_plain(*a)
    pen, _, keep = FU.clean_flat_verdicts(*a)
    mirror = data.clone()
    penalised = pen != 1.0
    mirror[sm.CONF, penalised] = data[sm.CONF, penalised] * pen[penalised]
    alive_bits = data[sm.ALIVE].contiguous().view(torch.int32)
    cleared = ~keep & (alive_bits != 0)
    mirror[sm.ALIVE, cleared] = 0.0
    assert (_bytes(mirror) == _bytes(plain)).all()
    others = [c for c in range(sm.CHANNELS) if c not in (sm.CONF, sm.ALIVE)]
    assert (_bytes(plain[others]) == _bytes(data[others])).all()
    # the rule's branches all run: rows penalised, rows cleared (past the
    # counts too), rows kept with a penalty of exactly 1, ALIVE already +0
    assert penalised.any() and cleared.any() and (keep & ~penalised).any()
    assert ((alive_bits == 0) & ~keep).any()
