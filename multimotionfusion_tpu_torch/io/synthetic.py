"""Analytic synthetic RGB-D scene renderer (host-side).

Renders depth + RGB of a fixed textured scene (back wall + floor + sphere) from
an arbitrary camera pose by per-pixel ray casting in numpy. Ground truth for odometry / fusion / end-to-end tests and the default input
of the synthetic log reader — the replacement for the reference's
manual-replay testing on recorded bags (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np

from multimotionfusion_tpu_torch.config import CameraModel


def _texture(p: np.ndarray) -> np.ndarray:
    """Procedural 3D texture -> RGB in 0..255, high frequency for photometric terms."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 127.5 + 70.0 * np.sin(9.0 * x) * np.cos(7.0 * y)
    g = 127.5 + 70.0 * np.sin(5.0 * y + 1.0) * np.cos(11.0 * z)
    b = 127.5 + 70.0 * np.sin(6.0 * z + 2.0) * np.cos(8.0 * x)
    # mid-frequency detail so photometric gradient gates see real texture at
    # test resolutions (the low-frequency bands alone fall under the
    # reference's minimum-gradient thresholds when downsampled)
    d = 45.0 * np.sin(31.0 * x + 13.0 * y) * np.cos(27.0 * z - 11.0 * x)
    return np.stack([r + d, g + d, b + d], axis=-1).clip(0, 255)


def render(
    T_wc: np.ndarray,
    cam: CameraModel,
    sphere_center=(0.15, 0.0, 1.6),
    sphere_radius=0.35,
    wall_z=2.5,
    floor_y=0.8,
    spheres=None,
):
    """Render (depth [H,W] float32 metres, rgb [H,W,3] float32 0..255).

    T_wc: camera-to-world pose. Scene (world frame): back wall z=wall_z,
    floor y=floor_y, one sphere — or several via ``spheres=[(center, radius),
    ...]`` (multi-object journeys; overrides the single-sphere args)."""
    h, w = cam.height, cam.width
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    dirs_cam = np.stack(
        [(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy, np.ones_like(xs)], axis=-1
    )
    R = T_wc[:3, :3].astype(np.float64)
    t = T_wc[:3, 3].astype(np.float64)
    dirs = dirs_cam @ R.T
    origin = t

    t_hit = np.full((h, w), np.inf)

    # back wall z = wall_z (normal -z)
    dz = dirs[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_wall = (wall_z - origin[2]) / dz
    t_wall = np.where((dz > 1e-9) & (t_wall > 0.05), t_wall, np.inf)
    t_hit = np.minimum(t_hit, t_wall)

    # floor y = floor_y (normal -y), only in front of the camera
    dy = dirs[..., 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_floor = (floor_y - origin[1]) / dy
    t_floor = np.where((dy > 1e-9) & (t_floor > 0.05), t_floor, np.inf)
    t_hit = np.minimum(t_hit, t_floor)

    # spheres (front-most wins per pixel)
    if spheres is None:
        spheres = [(sphere_center, sphere_radius)]
    nrm2 = np.einsum("hwi,hwi->hw", dirs, dirs)
    t_spheres = []
    for centre, radius in spheres:
        c = np.asarray(centre, np.float64)
        oc = origin - c
        b = np.einsum("hwi,i->hw", dirs, oc)
        cc = oc @ oc - radius**2
        disc = b * b - nrm2 * cc
        with np.errstate(invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
            t_sph = (-b - sq) / nrm2
        t_sph = np.where((disc > 0) & (t_sph > 0.05), t_sph, np.inf)
        t_spheres.append(t_sph)
        t_hit = np.minimum(t_hit, t_sph)

    hit = np.isfinite(t_hit)
    points_w = origin + dirs * t_hit[..., None]
    # depth = z in CAMERA frame
    p_cam = (points_w - t) @ R
    depth = np.where(hit, p_cam[..., 2], 0.0).astype(np.float32)
    # each sphere's texture is anchored to the OBJECT (local coordinates), so
    # a moving object keeps its appearance — required for descriptor tracking
    # and redetection to be physically meaningful. Each object gets a distinct
    # texture-space offset so two objects are not photometric clones.
    tex_p = points_w.copy()
    for k, ((centre, _), t_sph) in enumerate(zip(spheres, t_spheres)):
        c = np.asarray(centre, np.float64)
        sphere_hit = hit & np.isclose(t_hit, t_sph)
        tex_p = np.where(
            sphere_hit[..., None], points_w - c + 0.8 + 0.37 * k, tex_p
        )
    rgb = np.where(hit[..., None], _texture(tex_p), 0.0).astype(np.float32)
    return depth, rgb


def render_moving_sphere(T_wc, cam, sphere_pose_t, **kw):
    """Scene with the sphere translated by sphere_pose_t (for multi-model tests)."""
    c = np.asarray([0.15, 0.0, 1.6]) + np.asarray(sphere_pose_t)
    return render(T_wc, cam, sphere_center=tuple(c), **kw)


def pose(rotvec=(0, 0, 0), trans=(0, 0, 0)) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec(rotvec).as_matrix()
    T[:3, 3] = trans
    return T
