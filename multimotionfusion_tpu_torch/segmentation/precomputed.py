"""External-mask ("precomputed") segmentation.

Port of the reference package's ``segmentation/precomputed.py`` (reference
Segmentation.cpp:89-147): per-frame mask images from an instance segmenter
map each distinct external id to a model; ids seen before keep their slot, the
largest id not yet owned (above the size gate) is the spawn candidate, id 0 is
the background (the global model).

Plain PyTorch on the card, with no host read: the 256-bin id histogram is an
``index_add_`` into zeros (not ``torch.bincount``, which reads its maximum
back), and every selection is a compare and a ``torch.where`` (no
boolean-mask indexing).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_IDS = 256  # uint8 external ids


class PrecomputedResult(NamedTuple):
    mask: torch.Tensor  # [H, W] int32 slot ids (0 = global)
    new_label_mask: torch.Tensor  # [H, W] bool: pixels of the spawn candidate
    has_new_label: torch.Tensor  # [] bool
    new_ext_id: torch.Tensor  # [] int32 external id of the candidate
    pixel_counts: torch.Tensor  # [1 + S] int32 per-model areas
    reactivate: torch.Tensor  # [S] bool: inactive slot whose id reappeared
    depth_mean: torch.Tensor  # [1 + S] float32


def precomputed_segmentation(ext_mask: torch.Tensor, ext_ids: torch.Tensor, active: torch.Tensor,
                             depth: torch.Tensor, min_px: int) -> PrecomputedResult:
    """``ext_mask`` [H, W] int32 raw ids, ``ext_ids`` [S] int32 each slot's
    external id (0 = unassigned), ``active`` [S] bool, ``depth`` [H, W]."""
    dev = ext_mask.device
    n_slots = ext_ids.shape[0]
    flat = torch.clamp(ext_mask.reshape(-1), 0, MAX_IDS - 1).long()
    area = torch.zeros((MAX_IDS,), dtype=torch.int32, device=dev)
    area.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))

    # relabel external ids -> slot ids (slot k owns mask id k + 1)
    per_slot = (ext_ids[:, None, None] > 0) & (ext_mask[None] == ext_ids[:, None, None])
    mask = torch.sum(per_slot.to(torch.int32)
                     * torch.arange(1, n_slots + 1, dtype=torch.int32, device=dev)[:, None, None],
                     dim=0, dtype=torch.int32)

    ids_c = torch.clamp(ext_ids, 0, MAX_IDS - 1).long()
    slot_px = torch.where(ext_ids > 0, area[ids_c], torch.zeros_like(ext_ids))
    reactivate = ~active & (ext_ids > 0) & (slot_px > 0)

    # spawn candidate: the largest unowned nonzero id above the size gate
    bins = torch.arange(MAX_IDS, dtype=torch.int32, device=dev)
    in_use = ((bins[:, None] == ext_ids[None, :]) & (ext_ids[None, :] > 0)).any(dim=1)
    cand = (area >= min_px) & ~in_use & (bins != 0)
    new_ext = torch.argmax(torch.where(cand, area, torch.full_like(area, -1))).to(torch.int32)
    has_new = cand.any()
    new_label_mask = has_new & (ext_mask == new_ext)

    pixel_counts = torch.cat([area[:1], slot_px])
    # candidate pixels belong to no model yet
    lbl = torch.where(new_label_mask, torch.full_like(mask, -1), mask)
    sel = (lbl[None] == torch.arange(1 + n_slots, dtype=torch.int32, device=dev)[:, None, None]) \
        & (depth[None] > 0)
    dsum = torch.sum(torch.where(sel, depth[None], torch.zeros_like(depth[None])), dim=(1, 2))
    depth_mean = dsum / torch.clamp(torch.sum(sel.to(torch.int32), dim=(1, 2)), min=1)
    return PrecomputedResult(mask, new_label_mask, has_new, new_ext, pixel_counts, reactivate,
                             depth_mean)
