"""Surfel map: one fixed-capacity ``[16, capacity]`` float32 array + a count.

Port of the reference package's ``model/surfel_map.py``, same channel layout.
``count`` is the high-water mark (a 0-dim int32 tensor on the map's device):
slots [0, count) have ever been used; a slot is live iff its ALIVE channel is
set. Culls clear the flag; ``compact`` repacks live surfels to the front
and ``compact_segments`` every segment of the multi-model flat store (on the
card with the one-launch order-preserving compaction of ``csrc/clean.cu``,
kernel K9, whose new counts stay on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import CameraModel
from multimotionfusion_tpu_torch.ops.image import div

# channel indices of the surfel attribute array
PX, PY, PZ, CONF = 0, 1, 2, 3
CR, CG, CB = 4, 5, 6
INIT_T, LAST_T = 7, 8
NX, NY, NZ, RADIUS = 9, 10, 11, 12
ALIVE = 13  # 1.0 = live, 0.0 = culled/free
CHANNELS = 16


class SurfelMap(NamedTuple):
    data: torch.Tensor  # [CHANNELS, capacity] float32
    count: torch.Tensor  # [] int32, high-water mark

    @property
    def capacity(self) -> int:
        return self.data.shape[1]

    def alive_mask(self) -> torch.Tensor:
        in_prefix = torch.arange(self.capacity, dtype=torch.int32, device=self.data.device) < self.count
        return in_prefix & (self.data[ALIVE] > 0)

    def alive_count(self) -> torch.Tensor:
        return torch.sum(self.alive_mask().to(torch.int32))

    def bucketed(self, bucket: int) -> "SurfelMap":
        """View of the first ``bucket`` slots (requires count <= bucket)."""
        return SurfelMap(data=self.data[:, :bucket], count=self.count)


def radius_from_depth(depth: torch.Tensor, norm_z: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    """r = sqrt(2) z / mean_focal, inflated by 1/|n_z| capped at 2x (getRadius)."""
    mean_focal = (abs(cam.fx) + abs(cam.fy)) / 2.0
    radius = depth * (1.4142135623730951 / mean_focal)
    radius_n = radius / torch.clamp(torch.abs(norm_z), min=1e-6)
    return torch.minimum(2.0 * radius, radius_n)


def pixel_confidence(cam: CameraModel, weighting, device=None) -> torch.Tensor:
    """Radial Gaussian confidence prior [H, W] (surfels.glsl confidence)."""
    ys = torch.arange(cam.height, dtype=torch.float32, device=device)[:, None] - cam.cy
    xs = torch.arange(cam.width, dtype=torch.float32, device=device)[None, :] - cam.cx
    radial = div(torch.sqrt(ys * ys + xs * xs), 400.0)
    return torch.exp(div(-(radial * radial), 0.72)) * weighting


class FrameSurfels(NamedTuple):
    """Per-pixel surfel candidates of one frame (camera frame)."""

    data: torch.Tensor  # [CHANNELS, H*W] float32
    valid: torch.Tensor  # [H*W] bool


def compute_frame_surfels(
    rgb: torch.Tensor,  # [H, W, 3] float32 0..255
    vmap_raw: torch.Tensor,  # [H, W, 3] from raw depth
    vmap_filt: torch.Tensor,  # [H, W, 3] from filtered depth
    nmap_filt: torch.Tensor,  # [H, W, 3]
    cam: CameraModel,
    time,
    max_depth: float,
    weighting=1.0,
) -> FrameSurfels:
    h, w = rgb.shape[:2]
    n = h * w
    dev = rgb.device
    z = vmap_raw[..., 2]
    valid = (z > 0) & (z <= max_depth) & (torch.sum(nmap_filt * nmap_filt, dim=-1) > 0)
    conf = pixel_confidence(cam, weighting, device=dev)
    rad = radius_from_depth(vmap_filt[..., 2], nmap_filt[..., 2], cam)
    data = torch.zeros((CHANNELS, n), dtype=torch.float32, device=dev)
    data[PX] = vmap_raw[..., 0].reshape(n)
    data[PY] = vmap_raw[..., 1].reshape(n)
    data[PZ] = z.reshape(n)
    data[CONF] = conf.reshape(n)
    data[CR] = rgb[..., 0].reshape(n)
    data[CG] = rgb[..., 1].reshape(n)
    data[CB] = rgb[..., 2].reshape(n)
    data[INIT_T] = float(time)
    data[LAST_T] = float(time)
    data[NX] = nmap_filt[..., 0].reshape(n)
    data[NY] = nmap_filt[..., 1].reshape(n)
    data[NZ] = nmap_filt[..., 2].reshape(n)
    data[RADIUS] = rad.reshape(n)
    data[ALIVE] = valid.reshape(n).to(torch.float32)
    return FrameSurfels(data=data, valid=valid.reshape(n))


def transform_surfels(data: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Rigidly transform positions and rotate normals ([C, N]; returns a new array)."""
    R = T[:3, :3].to(data.dtype)
    t = T[:3, 3].to(data.dtype)
    px, py, pz = data[PX], data[PY], data[PZ]
    nx, ny, nz = data[NX], data[NY], data[NZ]
    out = data.clone()
    for i, (row_p, row_n) in enumerate(((PX, NX), (PY, NY), (PZ, NZ))):
        out[row_p] = R[i, 0] * px + R[i, 1] * py + R[i, 2] * pz + t[i]
        out[row_n] = R[i, 0] * nx + R[i, 1] * ny + R[i, 2] * nz
    return out


def compact_plain(data: torch.Tensor, keep: torch.Tensor, capacity: int,
                  out: torch.Tensor | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    kept = data[:, keep]
    if out is None:
        out = torch.zeros((data.shape[0], capacity), dtype=data.dtype, device=data.device)
    else:
        out.zero_()
    n = min(kept.shape[1], capacity)
    out[:, :n] = kept[:, :n]
    return out, torch.sum(keep.to(torch.int32)).to(torch.int32)


_TILE = 1024  # the compaction's tile of csrc/clean.cu (CTILE: 4 sub-tiles of 256)
_WORDS = {}  # (device, tiles) -> the set of scan words the next call uses
_SCAN_VALUE = 0x3FFFFFFF  # csrc/scan.cuh's SCAN_VALUE: a segment has fewer columns
_MAX_SLOTS = 7  # csrc/clean.cu's MAXSEG: the global segment and 7 slots


def scan_tiles(n: int) -> int:
    return (n + _TILE - 1) // _TILE


def compaction_words(device, tiles: int) -> Tuple[torch.Tensor, int]:
    """The compaction's look-back scan words for ``tiles`` tiles on
    ``device``: two sets of ``tiles + 1`` int32 words that calls alternate
    between (a launch zeroes the other set, which the call before it used),
    and the set this call uses. The caller hands the sets over with
    ``compaction_launched`` once its launch was taken, so a refused call
    leaves them as they were. One stream at a time."""
    words = K.scratch(f"compaction.scan.{tiles}", 2 * (tiles + 1), torch.int32, device, 0)
    return words, _WORDS.get((torch.device(device), int(tiles)), 0)


def compaction_launched(device, tiles: int) -> None:
    """A compaction over ``tiles`` tiles was launched: the next call uses
    the other set of words."""
    key = (torch.device(device), int(tiles))
    _WORDS[key] = 1 - _WORDS.get(key, 0)


def check_columns(n: int, name: str) -> None:
    if not 1 <= n < _SCAN_VALUE:
        raise ValueError(f"{name} must have 1 to {_SCAN_VALUE - 1} columns, got {n}")


def compact_cuda(data: torch.Tensor, keep: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's compaction on the card: ``csrc/clean.cu`` ``mmf_compact``, one
    launch (the keep flags scanned, the kept columns scattered, the slots
    after them zeroed)."""
    K.check(data, torch.float32, "data", contiguous=False)
    K.check(keep, torch.bool, "keep")
    if data.shape[0] != CHANNELS or data.stride(1) != 1 or keep.shape != (data.shape[1],):
        raise ValueError("data must be [16, N] (unit column stride) and keep [N]")
    n = data.shape[1]
    check_columns(n, "data")
    if capacity < 0:
        raise ValueError("capacity must not be negative")
    dev = data.device
    out = torch.empty((CHANNELS, capacity), dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    words, parity = compaction_words(dev, scan_tiles(n))
    f = K.fn("clean", "mmf_compact", [K.P, K.L, K.I, K.P, K.P, K.L, K.I, K.P, K.P, K.I])
    K.call("compact", f, K.ptr(data), data.stride(0), n, K.ptr(keep), K.ptr(out), out.stride(0),
           capacity, K.ptr(count), K.ptr(words), parity)
    compaction_launched(dev, scan_tiles(n))
    return out, count


def compact(data: torch.Tensor, keep: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep surfels where ``keep``, packed densely to the front in order, the
    slots after them zeroed: ([16, capacity] map, [] int32 count)."""
    K.record("compact", data=data, keep=keep, capacity=capacity)
    impl = compact_cuda if data.is_cuda else compact_plain
    return impl(data, keep, capacity)


def compact_segments_plain(gsrc: torch.Tensor, osrc: torch.Tensor, counts: torch.Tensor,
                           gdst: torch.Tensor, odst: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``compact_segments``: ``compact_plain`` segment by
    segment, each into its destination."""
    segs = [(gsrc, gdst)] + [(osrc[:, k], odst[k]) for k in range(osrc.shape[1])]
    cnts = []
    for m, (src, dst) in enumerate(segs):
        size = src.shape[1]
        keep = (torch.arange(size, dtype=torch.int32, device=src.device) < counts[m]) \
            & (src[ALIVE] > 0)
        d, c = compact_plain(src, keep, size)
        dst.copy_(d)
        cnts.append(c)
    return torch.stack(cnts)


def compact_segments_cuda(gsrc: torch.Tensor, osrc: torch.Tensor, counts: torch.Tensor,
                          gdst: torch.Tensor, odst: torch.Tensor) -> torch.Tensor:
    """K9's repack of every segment on the card: ``csrc/clean.cu``
    ``mmf_compact_segments``, one launch; each segment's keep formed in the
    kernel."""
    for t, name in ((gsrc, "gsrc"), (osrc, "osrc"), (gdst, "gdst"), (odst, "odst")):
        K.check(t, torch.float32, name, contiguous=False)
    K.check(counts, torch.int32, "counts")
    S = osrc.shape[1]
    bg, bo = gsrc.shape[1], osrc.shape[2]
    if gsrc.shape[0] != CHANNELS or osrc.shape[0] != CHANNELS or gdst.shape != gsrc.shape \
            or tuple(odst.shape) != (S, CHANNELS, bo) or counts.shape != (1 + S,):
        raise ValueError("gsrc, gdst must be [16, Bg], osrc [16, S, Bo], odst [S, 16, Bo], "
                         "counts [1 + S]")
    if any(t.numel() and t.stride(-1) != 1 for t in (gsrc, osrc, gdst, odst)):
        raise ValueError("surfel columns must have unit stride")
    if gsrc.data_ptr() == gdst.data_ptr() or (S and osrc.data_ptr() == odst.data_ptr()):
        raise ValueError("the compaction's destinations must not be its sources")
    if S > _MAX_SLOTS:
        raise ValueError(f"at most {_MAX_SLOTS} slot segments, got {S}")
    check_columns(bg, "gsrc")
    if S:
        check_columns(bo, "osrc")
    dev = gsrc.device
    counts_out = torch.empty((1 + S,), dtype=torch.int32, device=dev)
    tiles = scan_tiles(bg) + S * scan_tiles(bo)
    words, parity = compaction_words(dev, tiles)
    f = K.fn("clean", "mmf_compact_segments",
             [K.P, K.L, K.P, K.L, K.I, K.P, K.L, K.L, K.P, K.L, K.L, K.I, K.I, K.P, K.P, K.P, K.I])
    K.call("compact.segments", f, K.ptr(gsrc), gsrc.stride(0), K.ptr(gdst), gdst.stride(0), bg,
           K.ptr(osrc), osrc.stride(0), osrc.stride(1), K.ptr(odst), odst.stride(1),
           odst.stride(0), bo, S, K.ptr(counts), K.ptr(counts_out), K.ptr(words), parity)
    compaction_launched(dev, tiles)
    return counts_out


def compact_segments(gsrc: torch.Tensor, osrc: torch.Tensor, counts: torch.Tensor,
                     gdst: torch.Tensor, odst: torch.Tensor) -> torch.Tensor:
    """The multi-model repack: the global segment ``gsrc`` [16, Bg] and
    every slot segment of ``osrc`` [16, S, Bo], each slot below its count
    with ALIVE > 0 kept, packed in order into ``gdst`` [16, Bg] and ``odst``
    [S, 16, Bo] (which must not be the sources), the slots after them zeroed;
    returns the new counts [1 + S] int32."""
    K.record("compact.segments", gsrc=gsrc, osrc=osrc, counts=counts, gdst=gdst, odst=odst)
    impl = compact_segments_cuda if gsrc.is_cuda else compact_segments_plain
    return impl(gsrc, osrc, counts, gdst, odst)


def init_from_frame(frame: FrameSurfels, capacity: int) -> SurfelMap:
    """First-frame initialisation (Model::initialise)."""
    data, count = compact(frame.data, frame.valid, capacity)
    return SurfelMap(data=data, count=count)
