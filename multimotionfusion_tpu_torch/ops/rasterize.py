"""Point rasterisation of surfel maps: the index map and the splat resolve.

Port of the reference package's ``ops/rasterize.py``:

- ``predict_indices`` (kernel K6, ``csrc/zbuffer.cu``): transform, gate and
  project every surfel, then one int32 min of the packed key
  ``(log-depth << id_bits) | id`` per pixel; the front-most surfel wins and
  depth ties resolve to the lowest id.
- ``splat_resolve`` (kernel K10, ``csrc/splat_resolve.cu``): a 5x5 ray-disk
  resolve over the index map that carries the nearest hit's attributes into
  the predicted colour / vertex / normal / time images; its fill-in epilogue
  (``model/fillin.py``) writes the filled maps directly. In composite mode
  (the multi-model step) a tap must belong to the pixel's winner model and
  passes that model's confidence gate. A block resolves its pixel tile from
  a window staged in shared memory, so windows up to ``STAGE_MAX_WINDOW``
  wide; K14's clean stages its window the same way;
- ``zbuffer_flat`` (kernel K12, ``csrc/zbuffer.cu``): the composite index map
  over ALL models' surfels in one flat store (``FlatLayout``): each surfel is
  transformed by its model's inverse pose, gated by its model's max depth,
  and object surfels win depth ties within 2 cm against the global map (a
  priority offset and an is-global tie bit in the packed key); it also writes
  the winner-model image (``win_model_image``).

Transforms are [4, 4] float32 tensors that the kernels read by pointer.

Each kernel's wrapper launches the CUDA kernel for CUDA tensors and takes the
plain PyTorch version (``*_plain``, same module) only for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel
from multimotionfusion_tpu_torch.model import surfel_map as sm
from multimotionfusion_tpu_torch.ops.image import _shift2d, div
from multimotionfusion_tpu_torch.utils import se3

INVALID = -1
_BIG = 3.4e38
_ID_BITS = 20
_KEY_INVALID = 2**31 - 1
# composite z-buffer: object depths move this much nearer before quantisation
_Z_PRIORITY = 0.02
# The staged windows of K10 (csrc/splat_resolve.cu) and of K14's clean pixel
# pass (csrc/fuse_flat.cu): a block stages its pixel tile widened by the
# window's halo; the shared memory holds windows up to STAGE_MAX_WINDOW
# (tests/test_torch_splat_clean_plan.py mirrors the geometry).
STAGE_MAX_WINDOW = 7


def check_stage_window(window: int) -> int:
    """``window`` if the staging holds it, else ValueError (no fallback)."""
    if not 1 <= int(window) <= STAGE_MAX_WINDOW:
        raise ValueError(f"window {window}: the staged kernels take windows 1 to "
                         f"{STAGE_MAX_WINDOW}")
    return int(window)


class IndexMap(NamedTuple):
    index: torch.Tensor  # [H, W] int32 surfel id, -1 = none
    data_local: torch.Tensor  # [CHANNELS, bucket] camera-frame surfel attributes


class PredictedMaps(NamedTuple):
    color: torch.Tensor  # [H, W, 3] 0..255, zeros where empty
    vertex_conf: torch.Tensor  # [H, W, 4] camera-frame vertex + confidence
    normal_rad: torch.Tensor  # [H, W, 4] camera-frame normal + radius
    time: torch.Tensor  # [H, W] int32 init time of covering surfel
    valid: torch.Tensor  # [H, W] bool


def gather_attr_images(data_local: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """[CHANNELS, H, W] winner-surfel attributes per pixel (zeros where none)."""
    img = data_local[:, torch.clamp(index, min=0).long()]
    return torch.where((index >= 0)[None], img, torch.zeros_like(img))


def _id_bits_for(n: int) -> int:
    bits = _ID_BITS
    while (1 << bits) < n:
        bits += 1
    if bits > 24:
        raise ValueError("surfel bucket exceeds packed id range")
    return bits


def _pack_depth_id(z, ids, valid, id_bits: int = _ID_BITS):
    levels = 1 << (31 - id_bits)
    zq = (torch.log2(torch.clamp(z, min=1e-6)) + 4.0) * (levels / 8.0)
    zq = torch.clamp(zq.to(torch.int32), 0, levels - 2)
    key = (zq << id_bits) | ids
    return torch.where(valid, key, torch.full_like(key, _KEY_INVALID))


def _unpack_zmin(kmin, id_bits: int = _ID_BITS):
    levels = 1 << (31 - id_bits)
    won = kmin != _KEY_INVALID
    idx = torch.where(won, kmin & ((1 << id_bits) - 1), torch.full_like(kmin, INVALID))
    zmin = torch.where(
        won,
        torch.exp2((kmin >> id_bits).to(torch.float32) * (8.0 / levels) - 4.0),
        torch.full(kmin.shape, _BIG, dtype=torch.float32, device=kmin.device),
    )
    return idx, zmin


def take_small(table: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """table[idx] for a small table of ``n`` entries; 0 where idx is out of range."""
    ok = (idx >= 0) & (idx < n)
    val = table[torch.clamp(idx, 0, n - 1).long()]
    return torch.where(ok, val, torch.zeros_like(val))


class FlatLayout(NamedTuple):
    """The multi-model flat store: the global map's bucket (``bg`` slots, model
    0), then ``slots`` object buckets of ``bo`` slots each (model k + 1)."""

    bg: int
    bo: int
    slots: int

    @property
    def n_models(self) -> int:
        return 1 + self.slots

    @property
    def total(self) -> int:
        return self.bg + self.slots * self.bo

    @property
    def bases(self):
        """Segment boundaries, length n_models + 1."""
        return tuple([0, self.bg] + [self.bg + (k + 1) * self.bo for k in range(self.slots)])

    def seg_model(self, device) -> torch.Tensor:
        """[total] int32 model of each flat slot."""
        i = torch.arange(self.total, dtype=torch.int32, device=device)
        return torch.where(i < self.bg, torch.zeros_like(i), 1 + torch.div(
            i - self.bg, self.bo, rounding_mode="floor")).to(torch.int32)

    def pos_in_seg(self, device) -> torch.Tensor:
        i = torch.arange(self.total, dtype=torch.int32, device=device)
        return torch.where(i < self.bg, i, torch.remainder(i - self.bg, self.bo)).to(torch.int32)


def transform_per_model(data: torch.Tensor, model: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """``surfel_map.transform_surfels`` with the pose ``T[model[i]]`` per column
    ([16, N] data, [N] model ids in range, [M, 4, 4] poses)."""
    Tm = T.to(data.dtype)[model.long()]  # [N, 4, 4]
    px, py, pz = data[sm.PX], data[sm.PY], data[sm.PZ]
    nx, ny, nz = data[sm.NX], data[sm.NY], data[sm.NZ]
    out = data.clone()
    for i, (row_p, row_n) in enumerate(((sm.PX, sm.NX), (sm.PY, sm.NY), (sm.PZ, sm.NZ))):
        R0, R1, R2 = Tm[:, i, 0], Tm[:, i, 1], Tm[:, i, 2]
        out[row_p] = R0 * px + R1 * py + R2 * pz + Tm[:, i, 3]
        out[row_n] = R0 * nx + R1 * ny + R2 * nz
    return out


def check_pose(T: torch.Tensor, name: str = "pose") -> None:
    """Validate a [4, 4] transform that a kernel reads by pointer on the card."""
    K.check(T, torch.float32, name)
    if tuple(T.shape) != (4, 4):
        raise ValueError(f"{name} must be [4, 4]")


def _gates(data_local, alive, time, time_delta, max_depth):
    z = data_local[sm.PZ]
    return alive & (z > 0) & (z <= max_depth) & (float(time) - data_local[sm.LAST_T] <= time_delta)


def _project(data_local, cam: CameraModel):
    """Integer pixel (u, v) of each camera-frame surfel centre, rounded half
    to even like jnp.rint (clamped before the int cast: no overflow UB)."""
    x, y, z = data_local[sm.PX], data_local[sm.PY], data_local[sm.PZ]
    safe_z = torch.where(z > 0, z, torch.ones_like(z))
    u = torch.round(torch.clamp(x * cam.fx / safe_z + cam.cx, -2.0**30, 2.0**30)).to(torch.int32)
    v = torch.round(torch.clamp(y * cam.fy / safe_z + cam.cy, -2.0**30, 2.0**30)).to(torch.int32)
    return u, v


def packed_keys(data, count, T_inv, cam: CameraModel, time, time_delta, max_depth,
                splat_gates=None):
    """(pixel [B] int64 with H*W for rejected surfels, packed key [B] int32,
    data_local [16, B]) of the z-buffer; ``T_inv`` is world -> camera.
    ``splat_gates`` = (conf_threshold, max_time) adds the splat.vert gates."""
    h, w = cam.height, cam.width
    n = data.shape[1]
    data_local = sm.transform_surfels(data, T_inv.to(data.device))
    alive = (torch.arange(n, dtype=torch.int32, device=data.device) < count) & (data[sm.ALIVE] > 0)
    if splat_gates is not None:
        conf_threshold, max_time = splat_gates
        alive = alive & (data[sm.CONF] >= conf_threshold) & (data[sm.LAST_T] <= max_time)
    ok = _gates(data_local, alive, time, time_delta, max_depth)
    u, v = _project(data_local, cam)
    valid = ok & (u >= 0) & (v >= 0) & (u < w) & (v < h)
    ids = torch.arange(n, dtype=torch.int32, device=data.device)
    key = _pack_depth_id(data_local[sm.PZ], ids, valid, _id_bits_for(n))
    pix = torch.where(valid, v * w + u, torch.full_like(u, h * w)).long()
    return pix, key, data_local


def zbuffer_plain(data, count, T_inv, cam: CameraModel, time, time_delta, max_depth,
                  splat_gates=None):
    """Plain PyTorch K6: (index [H, W] int32, data_local [16, B])."""
    h, w = cam.height, cam.width
    pix, key, data_local = packed_keys(data, count, T_inv, cam, time, time_delta, max_depth,
                                       splat_gates)
    kmin = torch.full((h * w + 1,), _KEY_INVALID, dtype=torch.int32, device=data.device)
    kmin.scatter_reduce_(0, pix, key, reduce="amin", include_self=True)
    idx, _ = _unpack_zmin(kmin[: h * w], _id_bits_for(data.shape[1]))
    return idx.reshape(h, w), data_local


_ZB_ARGS = ([K.P, K.I, K.I, K.P, K.P] + [K.F] * 4 + [K.I, K.I] + [K.F] * 3 + [K.I, K.F, K.F]
            + [K.I, K.P, K.P, K.P, K.P, K.P])


def scalar_arg(x, name: str):
    """(float, pointer) of a kernel scalar that is either a Python number or a
    0-dim float32 tensor on the card (read there by pointer, no host read)."""
    if isinstance(x, torch.Tensor):
        K.check(x, torch.float32, name)
        if x.dim() != 0:
            raise ValueError(f"{name} must be 0-dim")
        return 0.0, K.ptr(x)
    return float(x), None


def zbuffer_cuda(data, count, T_inv, cam: CameraModel, time, time_delta, max_depth,
                 splat_gates=None):
    """K6 on the card: ``csrc/zbuffer.cu`` (same contract as ``zbuffer_plain``;
    ``T_inv``, and ``max_depth`` and the confidence gate where they are
    0-dim tensors, are read by pointer)."""
    K.check(data, torch.float32, "data", contiguous=False)
    K.check(count, torch.int32, "count")
    check_pose(T_inv, "T_inv")
    gated = splat_gates is not None
    conf_threshold, max_time = splat_gates if gated else (0.0, 0.0)
    if data.shape[0] != sm.CHANNELS or data.stride(1) != 1:
        raise ValueError("data must be [16, B] with unit column stride")
    h, w = cam.height, cam.width
    n = data.shape[1]
    dev = data.device
    keys = torch.empty((h * w,), dtype=torch.int32, device=dev)
    data_local = torch.empty((sm.CHANNELS, n), dtype=torch.float32, device=dev)
    index = torch.empty((h, w), dtype=torch.int32, device=dev)
    f = K.fn("zbuffer", "mmf_zbuffer", _ZB_ARGS)
    max_depth, max_depth_p = scalar_arg(max_depth, "max_depth")
    conf_threshold, conf_p = scalar_arg(conf_threshold, "conf_threshold")
    K.call(
        "zbuffer", f, K.ptr(data), data.stride(0), n, K.ptr(count), K.ptr(T_inv),
        cam.fx, cam.fy, cam.cx, cam.cy, w, h, float(time), float(time_delta), max_depth,
        int(gated), conf_threshold, float(max_time), _id_bits_for(n),
        K.ptr(keys), K.ptr(data_local), K.ptr(index), max_depth_p, conf_p,
    )
    return index, data_local


def zbuffer(data, count, T_inv, cam: CameraModel, time, time_delta, max_depth,
            splat_gates=None):
    K.record("zbuffer", data=data, count=count, T_inv=T_inv, cam=cam, time=time,
             time_delta=time_delta, max_depth=max_depth, splat_gates=splat_gates)
    impl = zbuffer_cuda if data.is_cuda else zbuffer_plain
    return impl(data, count, T_inv, cam, time, time_delta, max_depth, splat_gates)


def predict_indices(
    smap: sm.SurfelMap,
    pose: torch.Tensor,  # [4,4] camera -> global (on the map's device)
    cam: CameraModel,
    time,
    time_delta,
    max_depth: float,
) -> IndexMap:
    """Data-association index map (index_map.vert gates: 0 < z <= maxDepth and
    time - last_update <= timeDelta; no confidence gate)."""
    index, data_local = zbuffer(
        smap.data, smap.count, se3.inverse_T(pose), cam, time, time_delta, max_depth
    )
    return IndexMap(index=index, data_local=data_local)


# ---------------------------------------------------------------- K12

def win_model_image(index: torch.Tensor, layout: FlatLayout) -> torch.Tensor:
    """[H, W] model of each pixel's winning flat surfel (n_models where none)."""
    out = torch.full_like(index, layout.n_models)
    b = layout.bases
    for m in range(layout.n_models):
        hit = (index >= b[m]) & (index < b[m + 1])
        out = torch.where(hit, torch.full_like(index, m), out)
    return out


def flat_keys(data, counts, layout: FlatLayout, T_inv, maxd, cam: CameraModel, time, time_delta):
    """(pixel [N] int64 with H*W for rejected surfels, packed key [N] int32,
    data_local [16, N]) of the composite z-buffer: key = (log-depth bin <<
    (id_bits + 1)) | (is_global << id_bits) | flat id, object depths moved
    ``_Z_PRIORITY`` nearer before the quantisation."""
    h, w = cam.height, cam.width
    n = layout.total
    dev = data.device
    seg = layout.seg_model(dev)
    data_local = transform_per_model(data, seg, T_inv.to(dev))
    alive = (layout.pos_in_seg(dev) < counts.to(dev)[seg.long()]) & (data[sm.ALIVE] > 0)
    z = data_local[sm.PZ]
    ok = _gates(data_local, alive, time, time_delta, maxd.to(dev)[seg.long()])
    u, v = _project(data_local, cam)
    ok = ok & (u >= 0) & (v >= 0) & (u < w) & (v < h)
    id_bits = _id_bits_for(n)
    if id_bits > 22:
        raise ValueError("flat bucket exceeds the packed id + priority range")
    levels = 1 << (30 - id_bits)
    z_eff = torch.where(seg > 0, torch.clamp(z - _Z_PRIORITY, min=1e-3), z)
    zq = (torch.log2(torch.clamp(z_eff, min=1e-6)) + 4.0) * (levels / 8.0)
    zq = torch.clamp(zq.to(torch.int32), 0, levels - 2)
    prio = (seg == 0).to(torch.int32)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    key = (zq << (id_bits + 1)) | (prio << id_bits) | ids
    key = torch.where(ok, key, torch.full_like(key, _KEY_INVALID))
    pix = torch.where(ok, v * w + u, torch.full_like(u, h * w)).long()
    return pix, key, data_local


def zbuffer_flat_plain(data, counts, layout: FlatLayout, T_inv, maxd, cam: CameraModel, time,
                       time_delta):
    """Plain PyTorch K12: (index [H, W] int32, data_local [16, N], win_model [H, W])."""
    h, w = cam.height, cam.width
    pix, key, data_local = flat_keys(data, counts, layout, T_inv, maxd, cam, time, time_delta)
    kmin = torch.full((h * w + 1,), _KEY_INVALID, dtype=torch.int32, device=data.device)
    kmin.scatter_reduce_(0, pix, key, reduce="amin", include_self=True)
    kmin = kmin[: h * w]
    mask = (1 << _id_bits_for(layout.total)) - 1
    idx = torch.where(kmin != _KEY_INVALID, kmin & mask, torch.full_like(kmin, INVALID))
    idx = idx.reshape(h, w)
    return idx, data_local, win_model_image(idx, layout)


_ZBF_ARGS = ([K.P, K.I, K.I, K.I, K.I, K.P, K.P, K.P] + [K.F] * 4 + [K.I, K.I] + [K.F] * 3
             + [K.I] + [K.P] * 4)


def zbuffer_flat_cuda(data, counts, layout: FlatLayout, T_inv, maxd, cam: CameraModel, time,
                      time_delta):
    """K12 on the card: ``csrc/zbuffer.cu`` ``mmf_zbuffer_flat`` (same contract
    as ``zbuffer_flat_plain``; poses, counts and max depths read by pointer)."""
    M = layout.n_models
    K.check(data, torch.float32, "data", contiguous=False)
    K.check(counts, torch.int32, "counts")
    K.check(T_inv, torch.float32, "T_inv")
    K.check(maxd, torch.float32, "maxd")
    n = layout.total
    if data.shape != (sm.CHANNELS, n) or data.stride(1) != 1:
        raise ValueError("data must be [16, total] with unit column stride")
    if tuple(T_inv.shape) != (M, 4, 4) or counts.shape != (M,) or maxd.shape != (M,):
        raise ValueError("T_inv must be [M, 4, 4], counts and maxd [M]")
    id_bits = _id_bits_for(n)
    if id_bits > 22:
        raise ValueError("flat bucket exceeds the packed id + priority range")
    h, w = cam.height, cam.width
    dev = data.device
    keys = torch.empty((h * w,), dtype=torch.int32, device=dev)
    data_local = torch.empty((sm.CHANNELS, n), dtype=torch.float32, device=dev)
    index = torch.empty((h, w), dtype=torch.int32, device=dev)
    win = torch.empty((h, w), dtype=torch.int32, device=dev)
    f = K.fn("zbuffer", "mmf_zbuffer_flat", _ZBF_ARGS)
    K.call(
        "zbuffer.flat", f, K.ptr(data), data.stride(0), layout.bg, layout.bo, layout.slots,
        K.ptr(counts), K.ptr(T_inv), K.ptr(maxd), cam.fx, cam.fy, cam.cx, cam.cy, w, h,
        float(time), float(time_delta), _Z_PRIORITY, id_bits, K.ptr(keys), K.ptr(data_local),
        K.ptr(index), K.ptr(win),
    )
    return index, data_local, win


def zbuffer_flat(data, counts, layout: FlatLayout, T_inv, maxd, cam: CameraModel, time,
                 time_delta):
    """Composite index map over the flat store of all models (index_map.vert
    gates per model: alive, 0 < z <= max depth of the surfel's model, time
    window; no confidence gate): (index, data_local, win_model)."""
    K.record("zbuffer.flat", data=data, counts=counts, layout=layout, T_inv=T_inv, maxd=maxd,
             cam=cam, time=time, time_delta=time_delta)
    impl = zbuffer_flat_cuda if data.is_cuda else zbuffer_flat_plain
    return impl(data, counts, layout, T_inv, maxd, cam, time, time_delta)


# ---------------------------------------------------------------- K13

class DepthStores(NamedTuple):
    """The stores K13 reads in place: the global map's bucket and the object
    slots' buckets, each model's count, and the strides of the global and the
    object segment (every ``gs``-th global and ``os``-th object column)."""

    gdata: torch.Tensor  # [16, >= bg] global map
    odata: torch.Tensor  # [S, 16, >= bo] object slots
    counts: torch.Tensor  # [M] int32 high-water marks (global first)
    bg: int
    bo: int
    gs: int = 2
    os: int = 1


def depth_keys(st: DepthStores, T_inv, maxd, conf, cam_c: CameraModel, time, time_delta):
    """(cell [N] int64, M * Hc * Wc for rejected surfels; key [N] int32) of
    K13's scatter: key = (conf_miss << 21) | log-depth bin (2^20 levels)."""
    dev = st.gdata.device
    S = st.odata.shape[0]
    M = 1 + S
    hc, wc = cam_c.height, cam_c.width
    npix = hc * wc
    gi = torch.arange(0, st.bg, st.gs, device=dev)
    oi = torch.arange(0, S * st.bo, st.os, device=dev)
    slot, pos = torch.div(oi, st.bo, rounding_mode="floor"), torch.remainder(oi, st.bo)
    data = torch.cat([st.gdata[:, gi], st.odata[slot, :, pos].T], dim=1)
    model = torch.cat([torch.zeros_like(gi), slot + 1]).to(torch.int32)
    at = torch.cat([gi, pos]).to(torch.int32)
    counts = st.counts.to(dev)
    alive = (at < counts[model.long()]) & (data[sm.ALIVE] > 0)
    local = transform_per_model(data, model, T_inv.to(dev))
    ok = _gates(local, alive, time, time_delta, maxd.to(dev)[model.long()])
    u, v = _project(local, cam_c)
    ok = ok & (u >= 0) & (v >= 0) & (u < wc) & (v < hc)
    miss = (data[sm.CONF] < conf.to(dev)[model.long()]).to(torch.int32)
    levels = 1 << 20
    zq = (torch.log2(torch.clamp(local[sm.PZ], min=1e-6)) + 4.0) * (levels / 8.0)
    zq = torch.clamp(zq.to(torch.int32), 0, levels - 2)
    key = torch.where(ok, (miss << 21) | zq, torch.full_like(zq, _KEY_INVALID))
    pix = torch.where(ok, model * npix + v * wc + u, torch.full_like(u, M * npix)).long()
    return pix, key


def render_depths_plain(st: DepthStores, T_inv, maxd, conf, cam_c: CameraModel, time,
                        time_delta) -> torch.Tensor:
    """Plain PyTorch K13: [M, Hc, Wc] per-model depth (0 where no surfel)."""
    dev = st.gdata.device
    M = 1 + st.odata.shape[0]
    hc, wc = cam_c.height, cam_c.width
    npix = hc * wc
    levels = 1 << 20
    pix, key = depth_keys(st, T_inv, maxd, conf, cam_c, time, time_delta)
    kmin = torch.full((M * npix + 1,), _KEY_INVALID, dtype=torch.int32, device=dev)
    kmin.scatter_reduce_(0, pix, key, reduce="amin", include_self=True)
    kmin = kmin[: M * npix]
    zw = torch.exp2((kmin & (levels - 1)).to(torch.float32) * (8.0 / levels) - 4.0)
    depth = torch.where(kmin != _KEY_INVALID, zw, torch.zeros_like(zw))
    return depth.reshape(M, hc, wc)


RENDER_DEPTHS_MAX_MODELS = 32  # csrc/zbuffer.cu RD_MAX_M


def depth_scratch(device, cells: int) -> torch.Tensor:
    """K13's keys on ``device``: [cells] int32, all ``_KEY_INVALID`` between
    calls (set once here; each launch leaves every key it read so), so no
    call fills them. One stream at a time, as the kernel's header says."""
    return K.scratch("zbuffer.depth_keys", cells, torch.int32, device, _KEY_INVALID)


def render_depths_cuda(st: DepthStores, T_inv, maxd, conf, cam_c: CameraModel, time,
                       time_delta) -> torch.Tensor:
    """K13 on the card: ``csrc/zbuffer.cu`` ``mmf_render_depths``, the
    scatter then the decode, no fill (the stores read in place; poses,
    counts, max depths and gates by pointer; the keys in ``depth_scratch``)."""
    K.check(st.gdata, torch.float32, "gdata", contiguous=False)
    K.check(st.odata, torch.float32, "odata", contiguous=False)
    K.check(st.counts, torch.int32, "counts")
    for name, t in (("T_inv", T_inv), ("maxd", maxd), ("conf", conf)):
        K.check(t, torch.float32, name)
    S = st.odata.shape[0]
    M = 1 + S
    if M > RENDER_DEPTHS_MAX_MODELS:
        raise ValueError(f"K13 takes at most {RENDER_DEPTHS_MAX_MODELS} models, got {M}")
    if st.gdata.stride(1) != 1 or st.odata.stride(2) != 1:
        raise ValueError("surfel columns must have unit stride")
    if tuple(T_inv.shape) != (M, 4, 4) or maxd.shape != (M,) or conf.shape != (M,) \
            or st.counts.shape != (M,):
        raise ValueError("T_inv must be [M, 4, 4], counts, maxd and conf [M]")
    if st.bg > st.gdata.shape[1] or st.bo > st.odata.shape[2]:
        raise ValueError("bucket beyond the store")
    if st.gs < 1 or st.os < 1:
        raise ValueError("column strides must be positive")
    hc, wc = cam_c.height, cam_c.width
    dev = st.gdata.device
    depth = torch.empty((M, hc, wc), dtype=torch.float32, device=dev)
    keys = depth_scratch(dev, M * hc * wc)
    f = K.fn("zbuffer", "mmf_render_depths",
             [K.P, K.I, K.I, K.I, K.P, K.I, K.L, K.I, K.I, K.I, K.P, K.P, K.P, K.P]
             + [K.F] * 4 + [K.I, K.I, K.F, K.F, K.P, K.P])
    K.call("zbuffer.depths", f, K.ptr(st.gdata), st.gdata.stride(0), st.bg, st.gs,
           K.ptr(st.odata), st.odata.stride(1), st.odata.stride(0), st.bo, S, st.os,
           K.ptr(st.counts), K.ptr(T_inv), K.ptr(maxd), K.ptr(conf), cam_c.fx, cam_c.fy,
           cam_c.cx, cam_c.cy, wc, hc, float(time), float(time_delta), K.ptr(keys), K.ptr(depth))
    return depth


def render_depths(st: DepthStores, T_inv, maxd, conf, cam_c: CameraModel, time,
                  time_delta) -> torch.Tensor:
    """Per-model predicted depth on the CRF grid [M, Hc, Wc] (the
    segmentation's reprojection term): every model's strided surfels,
    gated as the composite index map (no confidence gate when ``conf`` is
    0), the nearest per cell, confidence-gated surfels before the others."""
    K.record("zbuffer.depths", st=st, T_inv=T_inv, maxd=maxd, conf=conf, cam_c=cam_c, time=time,
             time_delta=time_delta)
    impl = render_depths_cuda if st.gdata.is_cuda else render_depths_plain
    return impl(st, T_inv, maxd, conf, cam_c, time, time_delta)


_WIN_CH =(sm.CR, sm.CG, sm.CB, sm.CONF, sm.NX, sm.NY, sm.NZ, sm.RADIUS, sm.INIT_T)


def _pixel_rays(cam: CameraModel, device):
    ys = torch.arange(cam.height, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(cam.width, dtype=torch.float32, device=device)[None, :]
    return div(xs - cam.cx, cam.fx), div(ys - cam.cy, cam.fy)


class Composite(NamedTuple):
    """Composite (multi-model) mode of the resolve: a tap must come from the
    pixel's winner model and passes that model's confidence gate."""

    conf_all: torch.Tensor  # [M] per-model confidence gate
    own: torch.Tensor  # [H, W] int32 winner model of each index-map pixel (M = none)


def splat_resolve_plain(index, data_local, cam: CameraModel, conf_threshold, time,
                        max_time, time_delta, window: int = 5,
                        composite: Composite | None = None) -> PredictedMaps:
    """Plain PyTorch K10 (combo_splat.frag ray-disk resolve, gates per candidate)."""
    h, w = cam.height, cam.width
    dev = index.device
    lx, ly = _pixel_rays(cam, dev)
    lnorm = torch.sqrt(lx * lx + ly * ly + 1.0)
    l0, l1, l2 = lx / lnorm, ly / lnorm, 1.0 / lnorm
    attrs = gather_attr_images(data_local, index)
    if composite is not None:
        gate_img = take_small(composite.conf_all.to(dev), composite.own, composite.conf_all.shape[0])
    best_z = torch.full((h, w), _BIG, dtype=torch.float32, device=dev)
    best_idx = torch.full((h, w), INVALID, dtype=torch.int32, device=dev)
    best_att = [torch.zeros((h, w), dtype=torch.float32, device=dev) for _ in _WIN_CH]
    r = window // 2
    for dy in range(-r, window - r):
        for dx in range(-r, window - r):
            cand = _shift2d(index, dy, dx, INVALID)
            cdat = _shift2d(attrs, dy, dx, 0.0)
            gate = conf_threshold
            cvalid = cand >= 0
            if composite is not None:
                gate = _shift2d(gate_img, dy, dx, 0.0)
                cvalid = cvalid & (_shift2d(composite.own, dy, dx, -1) == composite.own)
            cvalid = (
                cvalid
                & (cdat[sm.CONF] >= gate)
                & (float(time) - cdat[sm.LAST_T] <= time_delta)
                & (cdat[sm.LAST_T] <= max_time)
            )
            cpx, cpy, cpz = cdat[sm.PX], cdat[sm.PY], cdat[sm.PZ]
            cnx, cny, cnz = cdat[sm.NX], cdat[sm.NY], cdat[sm.NZ]
            crad = cdat[sm.RADIUS]
            ln = l0 * cnx + l1 * cny + l2 * cnz
            pn = cpx * cnx + cpy * cny + cpz * cnz
            t = pn / torch.where(torch.abs(ln) > 1e-12, ln, torch.full_like(ln, 1e-12))
            hx, hy, hz = t * l0, t * l1, t * l2
            d2 = (hx - cpx) ** 2 + (hy - cpy) ** 2 + (hz - cpz) ** 2
            disk = (d2 <= crad * crad) & (hz > 0)
            closer = cvalid & disk & (hz < best_z)
            best_z = torch.where(closer, hz, best_z)
            best_idx = torch.where(closer, cand, best_idx)
            best_att = [torch.where(closer, cdat[ch], acc) for ch, acc in zip(_WIN_CH, best_att)]
    valid = best_idx >= 0
    win = dict(zip(_WIN_CH, best_att))
    zero = torch.zeros((h, w), dtype=torch.float32, device=dev)

    def g(ch):
        return torch.where(valid, win[ch], zero)

    zc = torch.where(valid, best_z, zero)
    return PredictedMaps(
        color=torch.stack([g(sm.CR), g(sm.CG), g(sm.CB)], dim=-1),
        vertex_conf=torch.stack([lx * zc, ly * zc, zc, g(sm.CONF)], dim=-1),
        normal_rad=torch.stack([g(sm.NX), g(sm.NY), g(sm.NZ), g(sm.RADIUS)], dim=-1),
        time=g(sm.INIT_T).to(torch.int32),
        valid=valid,
    )


_SR_ARGS = ([K.P, K.P, K.I, K.I, K.I] + [K.F] * 4 + [K.F] * 4 + [K.I] + [K.P] * 5
            + [K.P, K.P, K.P, K.F, K.F, K.F, K.I, K.P] + [K.P, K.P, K.I])


class FillFrame(NamedTuple):
    """The live frame's inputs of the fill-in epilogue (model/fillin.py)."""

    rgb: torch.Tensor  # [H, W, 3] uint8
    depth_filt: torch.Tensor  # [H, W] filtered depth (m)
    frame_data: torch.Tensor  # [16, H*W] frame surfels (filtered normals, radius)
    depth_cutoff: float
    passthrough: bool = False
    gate: torch.Tensor | None = None  # [H, W] int32 mask: fill only where it is 0


def splat_resolve_cuda(index, data_local, cam: CameraModel, conf_threshold, time,
                       max_time, time_delta, window: int = 5,
                       fill: FillFrame | None = None,
                       composite: Composite | None = None) -> PredictedMaps:
    """K10 on the card: ``csrc/splat_resolve.cu``. With ``fill``, the fill-in
    epilogue writes the live frame wherever no surfel won (colour, vertex and
    normal maps are then the filled maps); with ``composite`` the resolve runs
    in its multi-model mode (launches counted as ``splat_resolve.composite``).
    ``window`` must be at most ``STAGE_MAX_WINDOW``."""
    window = check_stage_window(window)
    K.check(index, torch.int32, "index")
    K.check(data_local, torch.float32, "data_local")
    h, w = cam.height, cam.width
    if tuple(index.shape) != (h, w) or data_local.shape[0] != sm.CHANNELS:
        raise ValueError("index must be [H, W] and data_local [16, B]")
    fill_args = [None, None, None, 0.0, 0.0, 0.0, 0, None]
    if fill is not None:
        K.check(fill.rgb, torch.uint8, "fill.rgb")
        K.check(fill.depth_filt, torch.float32, "fill.depth_filt")
        K.check(fill.frame_data, torch.float32, "fill.frame_data")
        if fill.frame_data.shape != (sm.CHANNELS, h * w) or fill.rgb.shape != (h, w, 3):
            raise ValueError("fill frame must be [H, W, 3] colour and [16, H*W] surfels")
        if fill.gate is not None:
            K.check(fill.gate, torch.int32, "fill.gate")
        fill_args = [K.ptr(fill.rgb), K.ptr(fill.depth_filt), K.ptr(fill.frame_data),
                     1.0 / cam.fx, 1.0 / cam.fy, float(fill.depth_cutoff), int(fill.passthrough),
                     None if fill.gate is None else K.ptr(fill.gate)]
    comp_args = [None, None, 0]
    conf_threshold, conf_p = scalar_arg(conf_threshold, "conf_threshold")
    if conf_p is not None:  # one gate read by pointer (no owner image)
        if composite is not None:
            raise ValueError("a composite resolve takes its gates from composite.conf_all")
        comp_args = [conf_p, None, 1]
    if composite is not None:
        K.check(composite.conf_all, torch.float32, "conf_all")
        K.check(composite.own, torch.int32, "own")
        if tuple(composite.own.shape) != (h, w):
            raise ValueError("own must be [H, W]")
        comp_args = [K.ptr(composite.conf_all), K.ptr(composite.own),
                     composite.conf_all.shape[0]]
    dev = index.device
    color = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    vertex_conf = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    normal_rad = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    tmap = torch.empty((h, w), dtype=torch.int32, device=dev)
    valid = torch.empty((h, w), dtype=torch.bool, device=dev)
    f = K.fn("splat_resolve", "mmf_splat_resolve", _SR_ARGS)
    K.call(
        "splat_resolve" if composite is None else "splat_resolve.composite", f, K.ptr(index),
        K.ptr(data_local), data_local.shape[1], h, w, cam.fx, cam.fy, cam.cx, cam.cy,
        float(conf_threshold), float(time), float(max_time), float(time_delta), int(window),
        K.ptr(color), K.ptr(vertex_conf), K.ptr(normal_rad), K.ptr(tmap), K.ptr(valid),
        *fill_args, *comp_args,
    )
    return PredictedMaps(color, vertex_conf, normal_rad, tmap, valid)


def splat_resolve(index_map: IndexMap, cam: CameraModel, conf_threshold, time, max_time,
                  time_delta, window: int = 5) -> PredictedMaps:
    """combo_splat.frag ray-disk resolve over the data-association index map.

    The index map has no confidence gate; the splat.vert gates (confidence,
    time window, max time) apply per candidate inside the resolve."""
    K.record("splat_resolve", index=index_map.index, data_local=index_map.data_local,
             cam=cam, conf_threshold=conf_threshold, time=time, max_time=max_time,
             time_delta=time_delta, window=window)
    impl = splat_resolve_cuda if index_map.index.is_cuda else splat_resolve_plain
    return impl(index_map.index, index_map.data_local, cam, conf_threshold, time,
                max_time, time_delta, window)


def splat_indices(smap: sm.SurfelMap, pose: torch.Tensor, cam: CameraModel, conf_threshold,
                  time, max_time, time_delta, max_depth: float) -> IndexMap:
    """Index map of the dedicated splat render (first frame), the gated z-buffer.

    The confidence and max-time gates of splat.vert enter the z-buffer
    (``splat_gates``), so ``zbuffer`` (K6) serves both renders; the resolve
    re-applies them per candidate."""
    index, data_local = zbuffer(
        smap.data, smap.count, se3.inverse_T(pose), cam, time, time_delta, max_depth,
        splat_gates=(conf_threshold, max_time),
    )
    return IndexMap(index, data_local)


def splat_predict(smap: sm.SurfelMap, pose: torch.Tensor, cam: CameraModel, conf_threshold,
                  time, max_time, time_delta, max_depth: float, window: int = 5) -> PredictedMaps:
    """Dedicated splat render (first frame): gated z-buffer + resolve."""
    im = splat_indices(smap, pose, cam, conf_threshold, time, max_time, time_delta, max_depth)
    return splat_resolve(im, cam, conf_threshold, time, max_time, time_delta, window)
