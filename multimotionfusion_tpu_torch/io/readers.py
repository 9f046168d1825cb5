"""Frame sources: the log-reader interface and the synthetic sequence.

Counterpart of the reference package's ``io/readers.py`` restricted to what the
static frame step needs: the ``LogReader`` interface and ``SyntheticLogReader``
(a procedurally rendered sequence with a known camera trajectory).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from multimotionfusion_tpu_torch.config import CameraModel
from multimotionfusion_tpu_torch.io.frame import FrameData


class LogReader:
    """Iterator over FrameData."""

    def __iter__(self) -> Iterator[FrameData]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def intrinsics(self) -> Optional[CameraModel]:
        """Calibration carried by the log, if any."""
        return None


class SyntheticLogReader(LogReader):
    """Procedural RGB-D sequence with known camera (and object) trajectory."""

    def __init__(
        self,
        cam: CameraModel,
        num_frames: int = 30,
        cam_step=(0.004, 0.0, 0.0),
        cam_rot_step=(0.0, 0.002, 0.0),
        object_step=(0.0, 0.0, 0.0),
        fps: float = 30.0,
    ):
        from multimotionfusion_tpu_torch.io import synthetic

        self._render = synthetic.render_moving_sphere
        self.cam = cam
        self.num_frames = num_frames
        self.cam_step = np.asarray(cam_step, np.float64)
        self.cam_rot_step = np.asarray(cam_rot_step, np.float64)
        self.object_step = np.asarray(object_step, np.float64)
        self.fps = fps
        self.gt_poses: list[np.ndarray] = []

    def __len__(self) -> int:
        return self.num_frames

    def __iter__(self) -> Iterator[FrameData]:
        from multimotionfusion_tpu_torch.io.synthetic import pose as mk_pose

        for i in range(self.num_frames):
            T_wc = mk_pose(rotvec=self.cam_rot_step * i, trans=self.cam_step * i)
            self.gt_poses.append(T_wc)
            depth, rgb = self._render(T_wc, self.cam, self.object_step * i)
            yield FrameData(
                rgb=rgb.astype(np.uint8),
                depth=depth,
                timestamp=int(i / self.fps * 1e9),
                name=f"synthetic-{i}",
            )
