"""The tiling of K2's one launch a side (``csrc/pyramid.cu``) and of K1's
filter (``csrc/frame_maps.cu``), held to brute-force enumerations at the
hand-made cases' sizes.

A K2 block owns a tile of each level and stages each level's base fields on
the tile widened by a halo (``levels.regions``). Here every read the
block's threads make is enumerated one level-0 axis at a time (the
stencils are separable): each output of a tile reads its level's base
fields around it (the frame side's Sobel, normals and static-validity
window; the prediction's normals), and each base cell of a coarser level
that lies in its image reads the finer level's 5x5 Gaussian centred on
2x. Every read must lie in the staged region, and the region must be no
wider than the reads of a block away from the image's edges. The level
sizes must be the plain version's, the tiles must cover each level once,
and the kernels' constants must be the plan's.
"""

import re
from pathlib import Path

import pytest
import torch

from multimotionfusion_tpu_torch.kernels import checks
from multimotionfusion_tpu_torch.odometry import levels as LV
from multimotionfusion_tpu_torch.ops import image as imops

CSRC = Path(LV.__file__).resolve().parent.parent / "csrc"
# (height, width) of the hand-made cases and of the engine's cameras
SIZES = sorted({(h, w) for _, h, w, *_ in checks.PYRAMID_CASES + checks.FILTER_CASES}
               | {(480, 640), (120, 160)})
SIDES = ("frame", "pred")


def cu_constants(name: str) -> dict:
    """Every ``constexpr int`` of ``csrc/<name>.cu`` that is not a template's,
    evaluated in order."""
    out = {}
    text = (CSRC / f"{name}.cu").read_text()
    text = re.sub(r"template <[^>]*>\s*constexpr int [^;]+;", "", text)
    for decl in re.findall(r"constexpr int ([^;]+);", text):
        for part in decl.split(","):
            key, expr = (x.strip() for x in part.split("=", 1))
            out[key] = eval(re.sub(r"//.*", "", expr), {}, dict(out))
    return out


def reads(side: str, n0: int, b: int):
    """{level: set of base-field cells block ``b`` reads} along one axis of
    length ``n0`` at level 0, by enumerating the kernel's reads."""
    sizes = [s for s, _ in LV.level_sizes(n0, n0, LV.MAX_LEVELS)]
    need = {lvl: set() for lvl in range(LV.MAX_LEVELS)}
    for lvl in range(LV.MAX_LEVELS):
        lo, hi = LV.tile(lvl, b)
        before, after = LV.OUT_HALO[side][lvl]
        for x in range(lo, hi):  # every thread of the tile computes, in the image or not
            need[lvl].update(range(x - before, x + after + 1))
    for lvl in reversed(range(1, LV.MAX_LEVELS)):  # coarse cells in the image read the finer
        for c in need[lvl]:
            if 0 <= c < sizes[lvl]:
                need[lvl - 1].update(range(2 * c - LV.GAUSS_REACH, 2 * c + LV.GAUSS_REACH + 1))
    return need, sizes


@pytest.mark.parametrize("side", SIDES)
def test_regions_match_the_kernel(side):
    k = cu_constants("pyramid")
    assert k["T2"] == LV.TILE and k["LEVELS"] == LV.MAX_LEVELS
    prefix = {"frame": "F", "pred": "P"}[side]
    got = tuple((k[f"{prefix}B{lvl}"], k[f"{prefix}A{lvl}"]) for lvl in range(LV.MAX_LEVELS))
    assert got == LV.regions(side)
    # the frame side's model-id test covers its outputs' halo
    assert (k["MB"], k["MA"]) == LV.OUT_HALO["frame"][0]
    for lvl in range(LV.MAX_LEVELS):
        b, a = LV.regions(side)[lvl]
        tile = LV.TILE << (LV.MAX_LEVELS - 1 - lvl)
        assert k[f"{prefix}N{lvl}"] == tile + b + a


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_reads_lie_in_the_regions(side, hw):
    """Every block of the launch, along both axes."""
    grid = LV.grid(*hw)
    for n0, blocks in ((hw[1], grid[0]), (hw[0], grid[1])):
        for b in range(blocks):
            need, sizes = reads(side, n0, b)
            for lvl, (before, after) in enumerate(LV.regions(side)):
                lo, hi = LV.tile(lvl, b)
                assert min(need[lvl]) >= lo - before and max(need[lvl]) < hi + after, (lvl, b)
                inside = lo - before >= 0 and hi + after <= sizes[lvl]
                if inside and all(LV.tile(c, b)[1] + LV.regions(side)[c][1] <= sizes[c]
                                  for c in range(lvl, LV.MAX_LEVELS)):
                    # no wider than needed: both ends are read
                    assert min(need[lvl]) == lo - before and max(need[lvl]) == hi + after - 1


def test_some_block_is_away_from_the_edges():
    """The tightness check above runs: 640 wide has blocks whose regions lie
    in every level's image."""
    n0, hits = 640, 0
    for b in range(LV.grid(480, n0)[0]):
        sizes = [s for s, _ in LV.level_sizes(n0, n0, LV.MAX_LEVELS)]
        hits += all(LV.tile(c, b)[0] - LV.regions("frame")[c][0] >= 0
                    and LV.tile(c, b)[1] + LV.regions("frame")[c][1] <= sizes[c]
                    for c in range(LV.MAX_LEVELS))
    assert hits > 0


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_level_sizes_are_the_plain_versions(hw):
    pyr = imops.build_pyramid(torch.zeros(hw), LV.MAX_LEVELS)
    assert [tuple(p.shape) for p in pyr] == LV.level_sizes(*hw, LV.MAX_LEVELS)


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_tiles_cover_every_level_once(hw):
    gx, gy = LV.grid(*hw)
    for lvl, (h, w) in enumerate(LV.level_sizes(*hw, LV.MAX_LEVELS)):
        for n, blocks in ((w, gx), (h, gy)):
            covered = [x for b in range(blocks) for x in range(*LV.tile(lvl, b)) if x < n]
            assert covered == list(range(n)), (lvl, n)
            assert LV.tile(lvl, blocks - 1)[0] < n  # no block without a pixel at level 0
    # the kernel's grid: level 2's size over the tile, rounded up
    h2, w2 = LV.level_sizes(*hw, LV.MAX_LEVELS)[-1]
    assert (gx, gy) == (-(-w2 // LV.TILE), -(-h2 // LV.TILE))


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_filter_tile_reads(hw):
    """K1's filter: a block stages its FW x FH tile widened by the radius;
    every tap of every output lies in it, and a thread's row of FX + 2R
    staged values is whole float4 words."""
    k = cu_constants("frame_maps")
    r, fw, fh = k["R"], k["FW"], k["FH"]
    assert (k["SW"], k["SH"]) == (fw + 2 * r, fh + 2 * r)
    assert fw == k["FX"] * k["FTX"] and (k["FX"] + 2 * r) % 4 == 0 and k["SW"] % 4 == 0
    for n, t in ((hw[1], fw), (hw[0], fh)):
        for b in range(-(-n // t)):
            taps = {x + o for x in range(b * t, (b + 1) * t) for o in range(-r, r + 1)}
            assert min(taps) == b * t - r and max(taps) == (b + 1) * t + r - 1
