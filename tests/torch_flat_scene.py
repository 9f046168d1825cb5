"""A small multi-model scene for the port's composite-map and flat-fusion tests.

80x60 camera, four models (the global map and three object slots) in one
flat store (``FlatLayout(bg=4800, bo=1200, slots=3)``), built from one
synthetic frame (the reference package's renderer and frame surfels) with a
numpy generator:
- the global segment holds every valid pixel's surfel (jittered 2 mm) but a
  block (``HOLES``: those pixels append), so the
  objects' surfels meet their stale copies in the global map at equal depth
  (the 2 cm object priority of the composite z-buffer decides those);
- slot 1 (model 1) holds region A's surfels but a block, with a max depth
  below part of them; slot 2 (model 2) region B's, filled to the segment's capacity; slot 3
  (model 3) region C's and is inactive;
- ages vary: some surfels are stale (beyond the time window), confidences
  are random around the gates;
- the mask owns regions A, B, C by models 1..3, region D by the sentinel
  id M = 4 (no model), the rest by the global model;
- every model's surfels are stored in its model frame (pose: camera ->
  model), so the z-buffer transforms them back.
"""

import numpy as np

from multimotionfusion_tpu.config import CameraModel, SurfelConfig
from multimotionfusion_tpu.io import synthetic

CAMK = dict(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0)
CAM = CameraModel(**CAMK)
CFG = SurfelConfig(max_surfels=8192, depth_cutoff=5.0)
BG, BO, SLOTS = 4800, 1200, 3
M = 1 + SLOTS
TIME = 40
REGIONS = {1: (slice(8, 28), slice(10, 34)), 2: (slice(30, 52), slice(40, 70)),
           3: (slice(34, 56), slice(4, 24))}
SENTINEL = (slice(2, 10), slice(50, 78))
# blocks left out of the store, so their pixels append new surfels
HOLES = {0: (slice(40, 56), slice(26, 38)), 1: (slice(12, 22), slice(16, 28))}

# unit layout indices (the reference's CHANNELS order)
PX, PY, PZ, CONF, INIT_T, LAST_T, NX, NY, NZ, RADIUS, ALIVE = 0, 1, 2, 3, 7, 8, 9, 10, 11, 12, 13


def _rigid(rng, rot=0.05, trans=0.05):
    w = rng.normal(size=3) * rot
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3) * trans
    return T.astype(np.float32)


def _to_model(data, T):
    out = data.copy()
    R, t = T[:3, :3].astype(np.float64), T[:3, 3].astype(np.float64)
    p = data[[PX, PY, PZ]].astype(np.float64)
    n = data[[NX, NY, NZ]].astype(np.float64)
    out[[PX, PY, PZ]] = (R @ p + t[:, None]).astype(np.float32)
    out[[NX, NY, NZ]] = (R @ n).astype(np.float32)
    return out


def frame_surfels(time=TIME, weighting=1.0):
    """(JAX FrameSurfels of the frame at ``time``, its depth [H, W], rgb)."""
    import jax.numpy as jnp

    from multimotionfusion_tpu.model import surfel_map as jsm
    from multimotionfusion_tpu.ops import maps as jmaps

    depth, rgb = synthetic.render(synthetic.pose((0.0, 0.002, 0.0), (0.003, 0.0, 0.0)), CAM)
    vmap = jmaps.create_vmap(jnp.asarray(depth), CAM, CFG.depth_cutoff)
    nmap = jmaps.create_nmap(vmap)
    fs = jsm.compute_frame_surfels(jnp.asarray(rgb), vmap, vmap, nmap, CAM, time,
                                   CFG.depth_cutoff, weighting)
    return fs, depth.astype(np.float32), rgb


def build(seed: int = 0):
    """dict: data [16, N] (model frames), counts [M] int32, poses [M, 4, 4]
    (camera -> model), maxd [M], active [M], conf_all [M], mask [H, W] int32,
    frame (JAX FrameSurfels), depth [H, W], rgb."""
    rng = np.random.default_rng(seed)
    h, w = CAM.height, CAM.width
    fs, depth, rgb = frame_surfels()
    fdata = np.array(fs.data)
    fvalid = np.array(fs.valid)
    region = np.zeros((h, w), np.int32)
    for m, (ys, xs) in REGIONS.items():
        region[ys, xs] = m
    mask = region.copy()
    mask[SENTINEL] = M

    def jittered(cols):
        d = fdata[:, cols].copy()
        d[[PX, PY, PZ]] += rng.normal(scale=0.002, size=(3, len(cols))).astype(np.float32)
        d[CONF] = rng.uniform(0.0, 20.0, size=len(cols)).astype(np.float32)
        d[INIT_T] = rng.integers(1, TIME, size=len(cols)).astype(np.float32)
        d[LAST_T] = np.where(rng.random(len(cols)) < 0.1, TIME - 250,
                             rng.integers(TIME - 30, TIME, size=len(cols))).astype(np.float32)
        d[INIT_T] = np.minimum(d[INIT_T], d[LAST_T])
        d[ALIVE] = (rng.random(len(cols)) > 0.05).astype(np.float32)
        return d

    hole = np.full((h, w), -1, np.int32)
    for m, (ys, xs) in HOLES.items():
        hole[ys, xs] = m
    hole = hole.reshape(-1)
    poses = np.stack([_rigid(rng) for _ in range(M)])
    data = np.zeros((16, BG + SLOTS * BO), np.float32)
    counts = np.zeros((M,), np.int32)
    cols = np.flatnonzero(fvalid & (hole != 0))
    g = jittered(cols)
    data[:, :len(cols)] = _to_model(g, poses[0])
    counts[0] = len(cols)
    for m in range(1, M):
        rc = np.flatnonzero(fvalid & (region.reshape(-1) == m) & (hole != m))
        if m == 2:  # fill the segment to capacity
            rc = np.resize(rc, BO)
        d = jittered(rc[:BO])
        base = BG + (m - 1) * BO
        data[:, base:base + d.shape[1]] = _to_model(d, poses[m])
        counts[m] = d.shape[1]
    zs = fdata[PZ][fvalid & (region.reshape(-1) == 1)]
    maxd = np.array([CFG.depth_cutoff, float(np.median(zs)), CFG.depth_cutoff,
                     CFG.depth_cutoff], np.float32)
    return dict(
        data=data, counts=counts, poses=poses, maxd=maxd,
        active=np.array([True, True, True, False]),
        conf_all=np.array([CFG.conf_threshold, 2.0, 5.0, 0.01], np.float32),
        mask=mask, frame=fs, depth=depth, rgb=rgb,
    )


def seg_model():
    return np.concatenate([np.zeros(BG, np.int32), np.arange(SLOTS * BO, dtype=np.int32) // BO + 1])


def pos_in_seg():
    return np.concatenate([np.arange(BG, dtype=np.int32), np.tile(np.arange(BO, dtype=np.int32),
                                                                  SLOTS)])


def bases():
    return tuple([0, BG] + [BG + (k + 1) * BO for k in range(SLOTS)])
