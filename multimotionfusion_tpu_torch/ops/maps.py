"""Vertex/normal maps from depth (port of the reference package's ``ops/maps.py``).

Maps are [H, W, 3] float32, channel-last; invalid entries are all-zero.
"""

from __future__ import annotations

import torch

from multimotionfusion_tpu_torch.config import CameraModel


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None):
    """(x, y) integer pixel coordinate grids of shape [H, W]."""
    ys = torch.arange(h, dtype=dtype, device=device)[:, None]
    xs = torch.arange(w, dtype=dtype, device=device)[None, :]
    return xs.expand(h, w), ys.expand(h, w)


def backproject(depth: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    """Depth [H,W] -> camera-frame points [H,W,3] (zeros stay zeros)."""
    h, w = depth.shape
    x, y = pixel_grid(h, w, depth.dtype, depth.device)
    px = depth * (x - cam.cx) * (1.0 / cam.fx)
    py = depth * (y - cam.cy) * (1.0 / cam.fy)
    return torch.stack([px, py, depth], dim=-1)


def create_vmap(
    depth: torch.Tensor,
    cam: CameraModel,
    depth_cutoff: float,
    mask: torch.Tensor | None = None,
    mask_id: int = 0,
) -> torch.Tensor:
    """Vertex map from depth (createVMap), optionally gated by ``mask == mask_id``."""
    valid = (depth > 0) & (depth < depth_cutoff)
    if mask is not None:
        valid = valid & (mask == mask_id)
    v = backproject(torch.where(valid, depth, torch.zeros_like(depth)), cam)
    return torch.where(valid[..., None], v, torch.zeros_like(v))


def create_nmap(vmap: torch.Tensor) -> torch.Tensor:
    """Normals n = normalize((v01 - v00) x (v10 - v00)) (createNMap); invalid on
    the last row/column or where any participant is invalid."""
    v00 = vmap
    v01 = torch.zeros_like(vmap)
    v01[:, :-1] = vmap[:, 1:]
    v10 = torch.zeros_like(vmap)
    v10[:-1] = vmap[1:]
    valid = (v00[..., 2] > 0) & (v01[..., 2] > 0) & (v10[..., 2] > 0)
    n = torch.linalg.cross(v01 - v00, v10 - v00, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = torch.where(norm > 1e-12, n / torch.clamp(norm, min=1e-12), torch.zeros_like(n))
    return torch.where(valid[..., None], n, torch.zeros_like(n))


def vertices_to_depth(vmap: torch.Tensor, cutoff: float) -> torch.Tensor:
    """z channel of a vertex map, gated to (0, cutoff] (verticesToDepthKernel)."""
    z = vmap[..., 2]
    return torch.where((z > 0) & (z <= cutoff), z, torch.zeros_like(z))
