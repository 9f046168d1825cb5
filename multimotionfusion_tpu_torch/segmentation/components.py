"""Connected components and largest-blob selection (kernel K17).

Port of the reference package's ``segmentation/components.py``: connected
components are min-label propagation over the 4-neighbourhood, exactly
``iters`` (64) Jacobi sweeps (each sweep reads the previous sweep's labels
only), so a component whose in-component geodesic diameter exceeds the sweep
count stays split, as in the reference. Component ids are the smallest flat
index a label reached; the largest component of each label is the first
argmax of the size histogram over those ids.

``keep_largest_components_batched`` launches ``csrc/components.cu`` for
CUDA tensors and takes its plain PyTorch version (``*_plain``) only for CPU
tensors; ``connected_components``, ``keep_largest_component`` and
``component_sizes_at_pixels`` are plain functions of the same propagation.

The kernel sweeps tiles: each block loads a tile plus a halo of ``HALO``
cells, runs up to ``HALO`` sweeps in shared memory and writes the tile back,
``ceil(iters / HALO)`` passes in all. A path of at most ``HALO`` cells from
the tile stays inside the loaded region, so the tile's labels equal the
whole-image sweeps' exactly (``tiling`` picks the tile side).
"""

from __future__ import annotations

from typing import Tuple

import torch

from multimotionfusion_tpu_torch import kernels as K

I32 = torch.int32
ITERS = 64
HALO = 16  # the sweeps a tile's pass runs, and its halo
SMS = 132  # an H100's streaming multiprocessors


def tiling(l: int, h: int, w: int) -> Tuple[int, int]:
    """(tile side, halo) of ``csrc/components.cu`` for an [l, h, w] stack:
    64-cell tiles (96 x 96 regions, 73.7 KB of shared memory a block) where
    they give two blocks an SM, else 32-cell tiles (64 x 64 regions)."""
    blocks64 = l * -(-h // 64) * -(-w // 64)
    return (64 if blocks64 >= 2 * SMS else 32), HALO


def _sweeps(masks: torch.Tensor, iters: int) -> torch.Tensor:
    """[L, H, W] labels after ``iters`` Jacobi sweeps of 4-neighbour min
    propagation (h*w outside ``masks``)."""
    l, h, w = masks.shape
    big = h * w
    idx = torch.arange(h * w, dtype=I32, device=masks.device).reshape(1, h, w)
    fill = torch.full_like(idx.expand(l, h, w), big)
    lab = torch.where(masks, idx.expand(l, h, w), fill)
    rowf = torch.full((l, 1, w), big, dtype=I32, device=masks.device)
    colf = torch.full((l, h, 1), big, dtype=I32, device=masks.device)
    for _ in range(iters):
        m = lab
        m = torch.minimum(m, torch.cat([rowf, lab[:, :-1, :]], dim=1))
        m = torch.minimum(m, torch.cat([lab[:, 1:, :], rowf], dim=1))
        m = torch.minimum(m, torch.cat([colf, lab[:, :, :-1]], dim=2))
        m = torch.minimum(m, torch.cat([lab[:, :, 1:], colf], dim=2))
        lab = torch.where(masks, m, fill)
    return lab


def connected_components(mask: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """Component ids [H, W] of the True pixels of ``mask``; -1 elsewhere."""
    lab = _sweeps(mask[None], iters)[0]
    return torch.where(mask, lab, torch.full_like(lab, -1))


def _sizes(flat: torch.Tensor, n: int) -> torch.Tensor:
    """Histogram of ``flat`` (int, values in [0, n]) over n + 1 bins."""
    sizes = torch.zeros((n + 1,), dtype=I32, device=flat.device)
    return sizes.index_add_(0, flat.long(), torch.ones_like(flat, dtype=I32))


def keep_largest_component(mask: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """True only on the largest connected component of ``mask``."""
    h, w = mask.shape
    lab = connected_components(mask, iters)
    flat = torch.where(lab >= 0, lab, torch.full_like(lab, h * w)).reshape(-1)
    sizes = _sizes(flat, h * w)
    return lab == torch.argmax(sizes[: h * w])


def component_sizes_at_pixels(mask: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """[H, W] size of the component each True pixel belongs to (0 outside)."""
    h, w = mask.shape
    lab = connected_components(mask, iters)
    flat = torch.where(lab >= 0, lab, torch.full_like(lab, h * w)).reshape(-1)
    sizes = _sizes(flat, h * w)
    sizes[h * w] = 0
    return sizes[flat.long()].reshape(h, w)


def keep_largest_components_plain(masks: torch.Tensor, iters: int = ITERS
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K17: (the largest component of each label [L, H, W]
    bool, its size [L] int32)."""
    l, h, w = masks.shape
    lab = _sweeps(masks, iters).reshape(l, h * w)
    offs = (torch.arange(l, dtype=I32, device=masks.device) * (h * w + 1))[:, None]
    binned = torch.where(masks.reshape(l, -1), lab + offs, torch.full_like(lab, l * (h * w + 1)))
    sizes = _sizes(binned.reshape(-1), l * (h * w + 1))[: l * (h * w + 1)].reshape(l, h * w + 1)
    best = torch.argmax(sizes[:, :-1], dim=1)  # first maximum, as jnp.argmax
    keep = masks & (lab == best[:, None].to(I32)).reshape(l, h, w)
    return keep, torch.gather(sizes, 1, best[:, None])[:, 0]


def keep_largest_components_cuda(masks: torch.Tensor, iters: int = ITERS
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K17 on the card: ``csrc/components.cu``, tiled passes with a halo,
    then the histogram's argmax and the kept masks."""
    K.check(masks, torch.bool, "masks")
    if masks.dim() != 3:
        raise ValueError("masks must be [L, H, W]")
    l, h, w = masks.shape
    n = h * w
    dev = masks.device
    tile, halo = tiling(l, h, w)
    keep = torch.empty_like(masks)
    sizes = torch.empty((l,), dtype=I32, device=dev)
    planes = torch.empty((2, l, n), dtype=I32, device=dev)
    # the L 64-bit argmax words, then the [L, n + 1] histogram (zeroed in the kernel)
    counts = torch.empty((2 * l + l * (n + 1),), dtype=I32, device=dev)
    f = K.fn("components", "mmf_components", [K.P, K.I, K.I, K.I, K.I, K.I, K.I]
             + [K.P] * 4)
    K.call("components", f, K.ptr(masks), l, h, w, int(iters), tile, halo, K.ptr(planes),
           K.ptr(counts), K.ptr(keep), K.ptr(sizes))
    return keep, sizes


def keep_largest_components_batched(masks: torch.Tensor, iters: int = ITERS
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``keep_largest_component`` of every label of an [L, H, W] stack in one
    pass: (kept [L, H, W] bool, each kept component's size [L] int32)."""
    K.record("components", masks=masks, iters=iters)
    impl = keep_largest_components_cuda if masks.is_cuda else keep_largest_components_plain
    return impl(masks, iters)
