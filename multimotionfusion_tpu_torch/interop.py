"""Engine state <-> a plain dict of numpy arrays.

The system has no learned weights; what carries across from the reference
package is its map and pose state. The dict holds the fields of the reference
package's GlobalState that the static path reads, under these keys:
``smap.data`` [16, capacity] f32, ``smap.count`` [] int32, ``pose`` and
``prev_pose`` [4, 4] f32, ``filled.color`` [H, W, 3], ``filled.vertex_conf``
[H, W, 4], ``filled.normal_rad`` [H, W, 4] and ``last_intensity_coarse``
[H/4, W/4] (all f32). A test builds it from a reference GlobalState with
``np.asarray`` on each field.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from multimotionfusion_tpu_torch.engine import GlobalState
from multimotionfusion_tpu_torch.model.fillin import FilledMaps
from multimotionfusion_tpu_torch.model.surfel_map import SurfelMap

_FILLED = ("color", "vertex_conf", "normal_rad")


def state_to_numpy(state: GlobalState) -> Dict[str, np.ndarray]:
    out = {
        "smap.data": state.smap.data.cpu().numpy(),
        "smap.count": np.asarray(state.smap.count.cpu().numpy(), np.int32),
        "pose": state.pose.cpu().numpy(),
        "prev_pose": state.prev_pose.cpu().numpy(),
        "last_intensity_coarse": state.last_intensity_coarse.cpu().numpy(),
    }
    for k in _FILLED:
        out[f"filled.{k}"] = getattr(state.filled, k).cpu().numpy()
    return out


def state_from_numpy(d: Dict[str, np.ndarray], device="cuda") -> GlobalState:
    def dev(key, dtype=torch.float32):
        return torch.as_tensor(np.asarray(d[key]), dtype=dtype).to(device).contiguous()

    return GlobalState(
        smap=SurfelMap(data=dev("smap.data"), count=dev("smap.count", torch.int32).reshape(())),
        pose=dev("pose"),
        prev_pose=dev("prev_pose"),
        filled=FilledMaps(*(dev(f"filled.{k}") for k in _FILLED)),
        last_intensity_coarse=dev("last_intensity_coarse"),
    )
