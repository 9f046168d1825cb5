"""SE(3)/SO(3) utilities on torch tensors (float32), branch-free.

Port of the reference package's ``utils/se3.py``:
- ``so3_exp`` is Rodrigues' formula (OdometryProvider::rodrigues);
- ``so3_log`` is its inverse, with the theta ~ pi branch (Model::rodrigues2);
- ``gn_update_pose`` premultiplies the running increment by ``[R(x[3:6]), x[0:3]]``
  (OdometryProvider::computeUpdateSE3).
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector."""
    zero = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zero, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector -> rotation matrix (I + hat(w) to first order near 0)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-8
    one = torch.ones_like(theta)
    safe_theta = torch.where(small, one, theta)
    a = torch.where(small, one, torch.sin(theta) / safe_theta)
    b = torch.where(
        small, torch.full_like(theta, 0.5),
        (1.0 - torch.cos(theta)) / torch.where(small, one, theta2),
    )
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector (inverse Rodrigues)."""
    rx = R[..., 2, 1] - R[..., 1, 2]
    ry = R[..., 0, 2] - R[..., 2, 0]
    rz = R[..., 1, 0] - R[..., 0, 1]
    r = torch.stack([rx, ry, rz], dim=-1)
    s = torch.sqrt(torch.clamp(torch.sum(r * r, dim=-1), min=0.0) * 0.25)
    c = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(c)

    sin_ok = s > 1e-5
    one = torch.ones_like(s)
    vth = torch.where(sin_ok, 1.0 / torch.where(sin_ok, 2.0 * s, one), torch.zeros_like(s)) * theta

    near_pi = (~sin_ok) & (c < 0)
    t = torch.stack(
        [(R[..., 0, 0] + 1.0) * 0.5, (R[..., 1, 1] + 1.0) * 0.5, (R[..., 2, 2] + 1.0) * 0.5],
        dim=-1,
    )
    axis = torch.sqrt(torch.clamp(t, min=0.0))
    sign_y = torch.where(R[..., 0, 1] < 0, -one, one)
    sign_z = torch.where(R[..., 0, 2] < 0, -one, one)
    x_small = torch.abs(axis[..., 0:1]) < 1e-6
    one1 = torch.ones_like(axis[..., 0:1])
    sign_z2 = torch.where(
        (torch.abs(axis[..., 1:2]) < 1e-6) & (R[..., 1:2, 2] < 0), -one1, one1
    )
    axis_fixed = torch.cat(
        [
            axis[..., 0:1],
            axis[..., 1:2] * torch.where(x_small, one1, sign_y[..., None]),
            axis[..., 2:3] * torch.where(x_small, sign_z2, sign_z[..., None]),
        ],
        dim=-1,
    )
    pi_branch = axis_fixed * theta[..., None]
    generic = r * vth[..., None]
    out = torch.where(near_pi[..., None], pi_branch, generic)
    tiny = (~sin_ok) & (c > 0)
    return torch.where(tiny[..., None], torch.zeros_like(out), out)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble a 4x4 homogeneous transform (no element assignment: on the
    card writing a Python scalar into a tensor is a synchronising copy)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [t(3), w(3)] -> 4x4 with R=exp(w) and the translation used directly
    (the reference's "infinitesimal transformation" convention)."""
    return make_T(so3_exp(xi[..., 3:6]), xi[..., 0:3])


def inverse_T(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return make_T(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to points [..., 3]."""
    return torch.einsum("ij,...j->...i", T[:3, :3], p) + T[:3, 3]


def gn_update_pose(result_Rt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """computeUpdateSE3: resultRt <- [R(x[3:6]), x[0:3]] @ resultRt."""
    return se3_exp(x) @ result_Rt


def to_quaternion_xyzw(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (x, y, z, w), for TUM pose export."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 0.5
    qx = (R[2, 1] - R[1, 2]) / (4.0 * qw)
    qy = (R[0, 2] - R[2, 0]) / (4.0 * qw)
    qz = (R[1, 0] - R[0, 1]) / (4.0 * qw)
    q = torch.stack([qx, qy, qz, qw])
    return q / torch.linalg.norm(q)
