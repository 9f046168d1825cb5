"""K17's tiled sweeps (``csrc/components.cu``) held to the reference package
on the CPU.

The kernel cannot run here, so ``tiled_keep_largest`` below repeats its
scheme in plain PyTorch: every tile of the stack loads its region (the tile
plus a halo of ``halo`` cells, cropped to the image: cells outside it count
as not in the mask, as do cells beyond the region), runs up to ``halo``
Jacobi sweeps on that region alone (a region whose sweep changes nothing
stops, as a block exits early) and writes its tile back; ``ceil(64 / halo)``
passes. Then the kernel's histogram and packed first argmax: the largest
count, ties to the lower id, as ``(count << 32) | (n - 1 - id)`` under a
maximum. Kept masks and sizes must be bit-equal to
``multimotionfusion_tpu.segmentation.components.keep_largest_components_batched``
for every (tile, halo) on random blobs, ``checks.components_inputs``' spiral
(longer than the 64 sweeps), two equal-size components, an all-True mask and
sides that the tiles do not divide. ``tiling`` (the wrapper's choice) must
give at least two blocks an SM at 640x480 with seven labels.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.segmentation import components as jcc
from multimotionfusion_tpu_torch.kernels import checks
from multimotionfusion_tpu_torch.segmentation import components as tcc
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ITERS = 64
TILINGS = ((8, 1), (8, 8), (16, 16), (5, 64))


def _sweep(reg: torch.Tensor, big: int) -> torch.Tensor:
    """One Jacobi sweep of [R, h, w] regions, cells beyond a region big."""
    r, h, w = reg.shape
    rowf = torch.full((r, 1, w), big, dtype=reg.dtype)
    colf = torch.full((r, h, 1), big, dtype=reg.dtype)
    m = reg
    m = torch.minimum(m, torch.cat([rowf, reg[:, :-1]], dim=1))
    m = torch.minimum(m, torch.cat([reg[:, 1:], rowf], dim=1))
    m = torch.minimum(m, torch.cat([colf, reg[:, :, :-1]], dim=2))
    m = torch.minimum(m, torch.cat([reg[:, :, 1:], colf], dim=2))
    return torch.where(reg != big, m, reg)


def _windows(n: int, tile: int, halo: int):
    """Per tile along one axis: (region start, region end, tile start, tile
    end), the region cropped to [0, n)."""
    return [(max(0, t - halo), min(n, t + tile + halo), t, min(n, t + tile))
            for t in range(0, n, tile)]


def tiled_sweeps(masks: torch.Tensor, tile: int, halo: int, iters: int = ITERS) -> torch.Tensor:
    """Labels [L, H, W] after the kernel's passes (h*w outside the masks)."""
    l, h, w = masks.shape
    big = h * w
    idx = torch.arange(h * w, dtype=torch.int32).reshape(1, h, w)
    lab = torch.where(masks, idx, torch.full_like(idx, big))
    tiles = [(ry, rx) for ry in _windows(h, tile, halo) for rx in _windows(w, tile, halo)]
    groups = {}  # regions of one shape sweep together
    for ry, rx in tiles:
        groups.setdefault((ry[1] - ry[0], rx[1] - rx[0]), []).append((ry, rx))
    for k in range(max(1, math.ceil(iters / halo))):
        sweeps = max(0, min(halo, iters - k * halo))
        out = lab.clone()
        for group in groups.values():
            reg = torch.cat([lab[:, ry[0]:ry[1], rx[0]:rx[1]] for ry, rx in group])
            live = torch.ones(reg.shape[0], dtype=torch.bool)
            for _ in range(sweeps):
                new = _sweep(reg, big)
                changed = (new != reg).flatten(1).any(1)
                reg = torch.where(live[:, None, None], new, reg)
                live &= changed
                if not live.any():
                    break
            for i, (ry, rx) in enumerate(group):
                part = reg[i * l:(i + 1) * l]
                out[:, ry[2]:ry[3], rx[2]:rx[3]] = part[:, ry[2] - ry[0]:ry[3] - ry[0],
                                                        rx[2] - rx[0]:rx[3] - rx[0]]
        lab = out
    return lab


def packed_argmax(hist: np.ndarray):
    """The kernel's pick: per row of an [L, n + 1] histogram, the maximum of
    (count << 32) | (n - 1 - id) over ids 0..n-1 with a count; (id, count),
    (0, 0) for a row without counts."""
    n = hist.shape[1] - 1
    ids = np.arange(n, dtype=np.uint64)
    words = (hist[:, :n].astype(np.uint64) << np.uint64(32)) | (np.uint64(n - 1) - ids)
    words = np.where(hist[:, :n] > 0, words, np.uint64(0)).max(axis=1)
    best = np.where(words > 0, (n - 1) - (words & np.uint64(0xFFFFFFFF)).astype(np.int64), 0)
    return best, (words >> np.uint64(32)).astype(np.int64)


def tiled_keep_largest(masks: torch.Tensor, tile: int, halo: int, iters: int = ITERS):
    """(kept [L, H, W], sizes [L]) as ``csrc/components.cu`` computes them."""
    l, h, w = masks.shape
    n = h * w
    lab = tiled_sweeps(masks, tile, halo, iters).reshape(l, n).numpy()
    hist = np.zeros((l, n + 1), np.int64)
    for i in range(l):
        hist[i] = np.bincount(lab[i], minlength=n + 1)
    best, sizes = packed_argmax(hist)
    keep = lab == best[:, None]
    return keep.reshape(l, h, w), sizes


def _blobs(h, w, labels, seed, threshold=None):
    rng = np.random.default_rng(seed)
    field = torch.from_numpy(rng.random((labels, 1, h, w), np.float32))
    for _ in range(2):
        field = torch.nn.functional.avg_pool2d(field, 7, stride=1, padding=3)
    cut = field.mean() if threshold is None else threshold
    return (field[:, 0] > cut).numpy()


def _case(name: str) -> np.ndarray:
    if name == "blobs":
        return _blobs(48, 64, 3, 0)
    if name == "spiral":  # label 0: the square spiral, geodesic length > 64
        return checks.components_inputs(64, 80, "cpu", labels=2)[0].numpy()
    if name == "equal_sizes":  # two 6x6 squares far apart: the lower id wins
        m = np.zeros((2, 40, 48), bool)
        m[0, 3:9, 30:36] = True
        m[0, 27:33, 5:11] = True
        m[1, 39, 47] = True  # a one-cell component in the last row and column
        return m
    if name == "all_true":  # one ball wider than 64 sweeps: it splits
        return np.concatenate([np.ones((1, 40, 56), bool), np.zeros((1, 40, 56), bool)])
    if name == "ragged":  # sides no tile divides
        return _blobs(45, 61, 2, 1)
    raise KeyError(name)


CASES = ("blobs", "spiral", "equal_sizes", "all_true", "ragged")
_reference = {}


def _ref(name: str):
    if name not in _reference:
        masks = _case(name)
        keep = np.asarray(jcc.keep_largest_components_batched(jnp.asarray(masks)))
        _reference[name] = masks, keep, keep.reshape(keep.shape[0], -1).sum(1)
    return _reference[name]


@pytest.mark.parametrize("tile,halo", TILINGS)
@pytest.mark.parametrize("case", CASES)
def test_tiled_sweeps_bit_equal_to_reference(case, tile, halo):
    masks, ref_keep, ref_sizes = _ref(case)
    keep, sizes = tiled_keep_largest(torch.from_numpy(masks), tile, halo)
    np.testing.assert_array_equal(keep, ref_keep)
    np.testing.assert_array_equal(sizes, ref_sizes)
    if case == "equal_sizes":
        assert ref_keep[0, 3:9, 30:36].all() and not ref_keep[0, 27:33, 5:11].any()
        assert ref_keep[1, 39, 47] and sizes[1] == 1
    if case in ("spiral", "all_true"):  # the 64 sweeps split the component
        assert 0 < ref_sizes[0] < masks[0].sum()
    if case == "all_true":
        assert sizes[1] == 0 and not keep[1].any()


def test_packed_argmax_matches_jnp_argmax_on_ties():
    rng = np.random.default_rng(3)
    n = 300
    hist = rng.integers(0, 4, (64, n + 1))  # many ties at the largest count
    hist[1] = 0  # no counts: id 0, count 0
    hist[2, :n] = 5  # every id ties
    hist[3, [7, 250]] = 9  # two ties far apart
    best, count = packed_argmax(hist)
    ref = np.asarray(jnp.argmax(jnp.asarray(hist[:, :n]), axis=1))
    np.testing.assert_array_equal(best, ref)
    np.testing.assert_array_equal(count, hist[np.arange(hist.shape[0]), ref])
    assert best[3] == 7 and best[1] == 0 and count[1] == 0


def test_wrapper_tiling_fills_the_card_and_is_exact():
    tile, halo = tcc.tiling(7, 480, 640)
    assert 7 * math.ceil(480 / tile) * math.ceil(640 / tile) >= 2 * tcc.SMS
    assert halo == tcc.HALO
    masks = _blobs(50, 70, 2, 2)
    tile, halo = tcc.tiling(*masks.shape)
    keep, sizes = tiled_keep_largest(torch.from_numpy(masks), tile, halo)
    ref, ref_sizes = tcc.keep_largest_components_plain(torch.from_numpy(masks))
    np.testing.assert_array_equal(keep, ref.numpy())
    np.testing.assert_array_equal(sizes, ref_sizes.numpy())
