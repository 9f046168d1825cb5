"""Frame container (== reference Core/FrameData.h:25-43).

rgb: [H, W, 3] uint8 (RGB order — the reference carries BGR cv::Mats and flips
for GL; we standardise on RGB at the reader boundary). depth: [H, W] float32
metres, 0 = invalid. mask: optional [H, W] uint8 precomputed segmentation.
timestamp: nanoseconds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class FrameData:
    rgb: np.ndarray
    depth: np.ndarray
    timestamp: int = 0
    mask: Optional[np.ndarray] = None
    name: str = ""
    # optional ground-truth camera pose (4x4, world frame) travelling WITH the
    # frame — the live-transport equivalent of the reference's tf lookup per
    # frame (RosNodeReader.cpp:142-165); consumed by '-init tf'
    gt_pose: Optional[np.ndarray] = None
