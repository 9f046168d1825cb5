"""Each CUDA kernel against its plain PyTorch version, on the same inputs.

The inputs are those a wrapper recorded on the engine's path
(``kernels.start_capture`` / ``stop_capture``, keyed as ``LAUNCHES`` is).
``args(key, c)`` turns a record into the wrapper's positional arguments;
each ``check_*`` runs the kernel and the plain version once on them and
returns the errors, the tolerance (``tolerance``) and whether the kernel is
within it (``ok``). ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``
both hold the kernels to these checks. Needs a GPU.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from multimotionfusion_tpu_torch.model import deformation as DG
from multimotionfusion_tpu_torch.model import ferns as FN
from multimotionfusion_tpu_torch.model import fillin
from multimotionfusion_tpu_torch.model import fusion as FU
from multimotionfusion_tpu_torch.model import surfel_map as sm
from multimotionfusion_tpu_torch.odometry import levels as LV
from multimotionfusion_tpu_torch.odometry import multi as MO
from multimotionfusion_tpu_torch.odometry import rgbd
from multimotionfusion_tpu_torch.ops import frame_maps as FM
from multimotionfusion_tpu_torch.ops import ransac as RS
from multimotionfusion_tpu_torch.ops import rasterize as R
from multimotionfusion_tpu_torch.segmentation import components as CC
from multimotionfusion_tpu_torch.segmentation import crf as CRF
from multimotionfusion_tpu_torch.segmentation import flow as FL
from multimotionfusion_tpu_torch.segmentation import flow_crf as FC
from multimotionfusion_tpu_torch.segmentation import legacy_crf as LC
from multimotionfusion_tpu_torch.segmentation import slic as SL
from multimotionfusion_tpu_torch.tracking import superpoint as SP
from multimotionfusion_tpu_torch.tracking import tracker as TR

_ARG_NAMES = {
    "zbuffer": ("data", "count", "T_inv", "cam", "time", "time_delta", "max_depth",
                "splat_gates"),
    "splat_resolve": ("index", "data_local", "cam", "conf_threshold", "time", "max_time",
                      "time_delta", "window", "fill"),
    "fuse": ("data", "count", "frame_data", "frame_valid", "index", "data_local", "mask",
             "mask_id", "pose", "cam", "time", "cfg"),
    "gn_reduce": ("lv", "Rt_inv", "cam_l", "scale2", "p", "done"),
    "frame_maps.filter": ("depth_raw",),
    "frame_maps.surfels": ("rgb_u8", "depth_m", "depth_filt", "cam", "time", "max_depth",
                           "weighting"),
    "pyramid.frame": ("depth_filt", "rgb_u8", "mask", "cam", "cfg", "mask_id"),
    "pyramid.pred": ("vertex_conf", "normal_rad", "color", "cam", "cfg"),
    "odo_init": ("device",),
    "so3_reduce": ("last_img", "next_img", "cam_l", "state"),
    "so3_step": ("state", "sums", "verbatim"),
    "gn_step": ("state", "sums", "sp", "last"),
    "track": ("T_prev", "gl", "last_next_img_l2", "cfg", "cam", "T_init", "seed_valid"),
    "clean": ("data", "count", "index", "data_local", "depth", "mask", "mask_id", "cam", "time",
              "time_delta", "conf_threshold", "cfg", "compact"),
    "compact": ("data", "keep", "capacity"),
    "patch_score": ("intensity",),
    "nms_topk": ("heat", "max_kp", "conf_thresh", "nms_radius"),
    "patch_desc": ("blurred", "xy"),
    "mutual_match": ("q_desc", "t_desc", "q_valid", "t_valid", "max_dist"),
    "track_update": ("table", "kps", "depth", "time", "cam", "cfg", "pair"),
    "ransac_fit": ("u", "p0", "p1", "valid", "cfg"),
    "seed_select": ("state", "seed_Rt", "seed_valid", "sums_cur", "sums_so3", "scale2",
                    "use_icp", "arbitrate"),
    "sparse": ("img", "tracks", "depth_filt", "time", "u", "cam", "cfg"),
    "owner_prep": ("prev_mask", "pred_own", "frame", "gl", "cfg", "n_models"),
    "gn_multi": ("ml", "Tinv_all", "cam_l", "scale2", "p", "n_models", "done"),
    "multi_init": ("M", "device"),
    "multi_seed": ("state", "seed_Rt", "seed_valid", "active", "M"),
    "multi_arbitrate": ("state", "sums_cur", "sums_so3", "M", "scale2"),
    "gn_step_multi": ("state", "sums", "M", "sp", "last"),
    "multi_track": ("T_prev", "levels", "last_next_img_l2", "cfg", "cam", "n_models", "T_init",
                    "seed_valid", "active"),
    "zbuffer.flat": ("data", "counts", "layout", "T_inv", "maxd", "cam", "time", "time_delta"),
    "fuse_flat": ("data", "counts", "layout", "frame_data", "frame_valid", "index", "data_local",
                  "mask", "win_model", "poses", "maxd", "active", "cam", "time", "cfg"),
    "clean_flat": ("data", "counts", "layout", "index", "data_local", "win_model", "depth",
                   "conf_all", "cam", "time", "time_delta", "cfg"),
    "splat_resolve.composite": ("index", "data_local", "cam", "conf_threshold", "time",
                                "max_time", "time_delta", "window", "fill", "composite"),
    "zbuffer.depths": ("st", "T_inv", "maxd", "conf", "cam_c", "time", "time_delta"),
    "flow": ("prev", "nxt", "hc", "wc"),
    "crf": ("unary", "flow", "p", "iterations"),
    "components": ("masks", "iters"),
    "segment.unaries": ("frame_depth", "pred_c", "active", "track_xy", "track_vel",
                        "track_valid", "cfg", "allow_new"),
    "segment.fuse": ("q", "flow", "p_proj", "behind", "active", "cfg", "allow_new"),
    "segment.finish": ("lbl", "largest", "sizes", "fd", "h", "w", "cfg", "allow_new"),
    "ferns.frame": ("rgb_u8", "depth_filt", "cam", "cutoff", "factor"),
    "ferns.encode_hd": ("db", "frame", "fetch"),
    "ferns.insert": ("db", "frame", "hd", "pose", "time", "threshold", "skip"),
    "ferns.photo": ("T_rel", "kf_vertex", "kf_color", "live_rgb", "cam_s", "count", "best_sim",
                    "icp_error", "icp_count", "gates"),
    "deform.points": ("points", "point_times", "graph", "k", "look_back"),
    "deform.apply_map": ("data", "count", "graph", "k", "gate"),
    "gn_reduce.error_images": ("lv", "Rt_inv", "cam_l", "p"),
    "slic": ("image", "sp_size", "coh_weight", "iterations"),
    "sp.downsample": ("images", "labels", "count", "grid_hw", "bounds"),
    "sp.upsample": ("lbl_sp", "labels", "n_labels"),
    "legacy_crf.plan": ("lows", "mean_color", "mean_xy", "active", "allow_new"),
}


def args(key: str, c: dict) -> tuple:
    """Positional arguments of the wrapper whose inputs were recorded as ``key``
    (``gn_reduce.L0`` -> gn_reduce's, ``clean.compact`` -> clean's)."""
    names = _ARG_NAMES.get(key) or _ARG_NAMES[key.split(".")[0]]
    return tuple(c[n] for n in names)


def check_zbuffer(a: tuple) -> dict:
    idx_k, dl_k = R.zbuffer_cuda(*a)
    idx_p, dl_p = R.zbuffer_plain(*a)
    differ = int((idx_k != idx_p).sum())
    frac = 1.0 - differ / idx_k.numel()
    err = float((dl_k - dl_p).abs().max())
    return dict(
        max_abs_err=err, differing_pixels=differ, equal_frac=frac,
        ok=frac >= 0.9999 and err <= 1e-5,
        tolerance="index equal on >= 99.99% of pixels; data_local within 1e-5",
    )


def check_splat(a: tuple) -> dict:
    """The resolve and its fill-in epilogue: where both versions resolved a
    surfel the prediction's attributes, elsewhere the filled-in frame (in
    composite mode only where the fill gate, the mask, is 0)."""
    fill = a[8]
    pk = R.splat_resolve_cuda(*a)
    pp, fp = fillin.splat_fill_plain(*a)
    res = _check_resolved(pk, pp)
    neither = ~pk.valid & ~pp.valid
    if fill is not None and fill.gate is not None:
        neither = neither & (fill.gate == 0)
    ferr = float(torch.cat([(pk.color - fp.color).abs(), (pk.vertex_conf - fp.vertex_conf).abs(),
                            (pk.normal_rad - fp.normal_rad).abs()], -1)[neither].max())
    res.update(fill_err=ferr, filled_pixels=int(neither.sum()),
               ok=res["ok"] and ferr <= 1e-6 and int(neither.sum()) > 0 and fill is not None,
               tolerance=res["tolerance"] + "; filled-in pixels within 1e-6")
    return res


def _check_resolved(pk, pp) -> dict:
    vfrac = float((pk.valid == pp.valid).float().mean())
    both = pk.valid & pp.valid
    n_both = int(both.sum())
    diff = torch.cat([(pk.color - pp.color).abs(), (pk.vertex_conf - pp.vertex_conf).abs(),
                      (pk.normal_rad - pp.normal_rad).abs()], dim=-1)[both]
    err = float(diff.max()) if n_both else 0.0
    t_ok = bool((pk.time[both] == pp.time[both]).all())
    return dict(
        max_abs_err=err, valid_equal_frac=vfrac, time_exact=t_ok, both_valid_pixels=n_both,
        attr_differ_pixels=int((diff > 1e-5).any(-1).sum()),
        # no pixel valid in both versions would make the check vacuous
        ok=n_both > 0 and vfrac >= 0.9999 and err <= 1e-5 and t_ok,
        tolerance="valid equal on >= 99.99%; colour/vertex/normal within 1e-5 where both "
                  "valid; time exact",
    )


def check_fuse(a: tuple) -> dict:
    """Both versions start from a copy of the map, so the whole [16, B] output
    is compared: a merge or append the kernel skips shows as a difference."""
    dk, ck, ak = FU.fuse_cuda(*a)
    dp, cp, ap = FU.fuse_plain(*a)
    part = (ak > -2) | (ap > -2)
    tfrac = float((ak[part] == ap[part]).float().mean())
    ck, cp = int(ck), int(cp)
    cfrac = abs(ck - cp) / max(cp, 1)
    data_in = a[0]
    written_k = int((dk != data_in).any(0).sum())
    written_p = int((dp != data_in).any(0).sum())
    err = float(((dk - dp).abs() / dp.abs().clamp(min=1.0)).max())
    return dict(
        max_abs_err=float((dk - dp).abs().max()), max_rel_err=err, target_equal_frac=tfrac,
        count_kernel=ck, count_plain=cp, written_kernel=written_k, written_plain=written_p,
        # a frame that writes no surfel would make the data comparison vacuous
        ok=written_p > 0 and tfrac >= 0.9999 and cfrac <= 1e-4 and err <= 1e-4,
        tolerance="targets equal on >= 99.99% of participating pixels; count within 0.01%; "
                  "whole [16, B] output within 1e-4 relative (|a-b| / max(|b|, 1))",
    )


def block_order_sum(partials: torch.Tensor) -> torch.Tensor:
    """[blocks, n] float32 partials -> [n]: each column added from +0 in block
    order, in float32 on the CPU (the order of K4's and K11's last-block
    sums)."""
    s = torch.zeros(partials.shape[1], dtype=torch.float32)
    for row in partials.cpu():
        s = s + row
    return s


def gn_sums_from_partials(p1: torch.Tensor, p2=None) -> torch.Tensor:
    """gn_reduce's [N_SUMS] sums from its pass-1 ([blocks, 31]) and pass-2
    ([blocks, 28], or None without RGB: zeros) partials, summed in block
    order (``block_order_sum``)."""
    s1 = block_order_sum(p1)
    s2 = block_order_sum(p2) if p2 is not None else torch.zeros(28, dtype=torch.float32)
    return torch.cat([s1[:28], s2, s1[28:]])


def check_gn(a: tuple, level: int) -> dict:
    """The sums against the plain version (1e-4), and bit-equal to the
    block-order float32 sum of the same call's partials (zeros once the
    loop is done)."""
    sk, p1, p2 = rgbd.gn_reduce_cuda(*a, level=level, with_partials=True)
    sk = sk.cpu()
    done = a[5] is not None and bool(a[5].cpu() != 0)
    if done:
        expect = torch.zeros(rgbd.N_SUMS, dtype=torch.float32)
    else:
        expect = gn_sums_from_partials(p1, p2 if a[4].use_rgb else None)
    block_order = torch.equal(sk.view(torch.int32), expect.view(torch.int32))
    sp = rgbd.gn_reduce_plain(*a).cpu()
    Sk_i, Sp_i = rgbd._sym(sk[0:28]), rgbd._sym(sp[0:28])
    Sk_r, Sp_r = rgbd._sym(sk[28:56]), rgbd._sym(sp[28:56])
    e_icp = float(torch.linalg.norm(Sk_i - Sp_i) / torch.linalg.norm(Sp_i).clamp(min=1e-30))
    e_rgb = float(torch.linalg.norm(Sk_r - Sp_r) / torch.linalg.norm(Sp_r).clamp(min=1e-30))
    # icp count, rgb count, sum diff^2
    scalars = float(((sk[56:59] - sp[56:59]).abs() / sp[56:59].abs().clamp(min=1.0)).max())
    return dict(
        max_abs_err=float((sk - sp).abs().max()), rel_frob_icp=e_icp, rel_frob_rgb=e_rgb,
        counts_sigma_rel_err=scalars, sums_bit_equal_block_order=block_order, loop_done=done,
        ok=e_icp <= 1e-4 and e_rgb <= 1e-4 and scalars <= 1e-4 and block_order,
        tolerance="each 7x7 system within 1e-4 relative (Frobenius); both counts and "
                  "sum diff^2 within 0.01%; sums bit-equal to the block-order float32 sum "
                  "of the call's partials",
    )


# ------------------------------------------------------------ the append scan

SCAN_N = 76_800  # the time-parity checkerboard of 640x480
SCAN_LAYOUT = dict(bg=1 << 19, bo=1 << 16)  # chip_smoke's multi-model store
# how each model's appends stand to its segment's room in the "rooms" case
SCAN_ROOMS = ("full", "clipped", "at", "one_below", "far_below", "far_below")
# K8's capacity against its appends, by case
SCAN_K8_ROOM = {"no_new": "at", "all_new": "clipped", "one_model": "one_below",
                "eight_models": "far_below", "no_owner": "full", "rooms": "at",
                "ragged": "one_below", "small": "clipped", "one_tile": "far_below"}


def _room(rel: str, total: int, seg: int) -> int:
    """The room a segment of ``seg`` slots leaves for ``total`` appends."""
    return {"full": 0, "clipped": max(total - 5, 0), "at": total, "one_below": total + 1,
            "far_below": seg}[rel]


def scan_cases(seed: int = 0):
    """Hand-made inputs of the append scan shared by K8 and K14 (csrc/surfel.cuh
    ``append_scan``), on the CPU: [(name, flags [n] int32 (bit 1: new, bit 0:
    merge), own [n] int32, M, counts [M] int32, K8's count and capacity)].
    Cases: no new flag; every flag new; one model owning every pixel; M = 8
    with every owner present; pixels with no owner (-1 and M); the models'
    appends clipped by, at, one below and far below their segment's room
    (and a full segment); n not a multiple of the 256-pixel tile (76,763,
    1,000 and 200). K14's counts and K8's count are set from the appends so
    that each relation holds exactly."""
    rng = np.random.default_rng(seed)
    out = []

    def add(name, flags, own, M, rooms=None):
        flags, own = flags.astype(np.int32), own.astype(np.int32)
        new = (flags >> 1) & 1
        seg = np.array([SCAN_LAYOUT["bg"]] + [SCAN_LAYOUT["bo"]] * (M - 1))
        totals = np.array([int((new * (own == m)).sum()) for m in range(M)])
        rooms = rooms or ["far_below"] * M
        counts = np.array([seg[m] - _room(rooms[m], int(totals[m]), int(seg[m]) // 2)
                           for m in range(M)], np.int32)
        assert (counts >= 0).all() and (counts <= seg).all()
        total8 = int(new.sum())
        cap8 = 1 << 20
        count8 = cap8 - _room(SCAN_K8_ROOM[name], total8, cap8 // 2)
        out.append((name, torch.from_numpy(flags), torch.from_numpy(own), M,
                    torch.from_numpy(counts), count8, cap8))

    def flags_of(n, p_new=0.3, p_merge=0.3):
        u = rng.random(n)
        return np.where(u < p_new, 2, np.where(u < p_new + p_merge, 1, 0))

    n = SCAN_N
    add("no_new", rng.integers(0, 2, n), rng.integers(0, 6, n), 6)
    add("all_new", np.full(n, 2), rng.integers(0, 6, n), 6)
    add("one_model", flags_of(n), np.zeros(n), 6)
    add("eight_models", flags_of(n), rng.integers(0, 8, n), 8)
    own = rng.integers(0, 6, n)
    own[rng.random(n) < 0.4] = -1
    own[rng.random(n) < 0.2] = 6
    add("no_owner", flags_of(n, 0.5), own, 6)
    add("rooms", flags_of(n), rng.integers(0, 6, n), 6, list(SCAN_ROOMS))
    add("ragged", flags_of(n - 37), rng.integers(0, 6, n - 37), 6,
        ["at", "one_below", "clipped", "full", "far_below", "at"])
    add("small", flags_of(1000), rng.integers(0, 3, 1000), 3, ["clipped", "at", "one_below"])
    add("one_tile", flags_of(200), rng.integers(0, 2, 200), 2, ["at", "clipped"])
    return out


def scan_expected(flags: torch.Tensor, own: torch.Tensor, M: int, counts: torch.Tensor,
                  lens) -> tuple:
    """The append scan by ``torch.cumsum``: (prefix [n], -1 where the owner is
    no model; the new counts [M], each count + min(its new flags, the room
    lens[m] - count, at least 0))."""
    new = ((flags >> 1) & 1).long()
    owned = (own >= 0) & (own < M)
    o = own.clamp(0, M - 1).long()
    hot = (o[None] == torch.arange(M)[:, None]) & owned[None] & (new[None] > 0)
    inc = torch.cumsum(hot.long(), 1)
    excl = (inc - hot.long()).gather(0, o[None])[0]
    prefix = torch.where(owned, excl, torch.full_like(excl, -1)).to(torch.int32)
    rooms = (torch.as_tensor(lens, dtype=torch.long) - counts.long()).clamp(min=0)
    counts_out = (counts.long() + torch.minimum(inc[:, -1], rooms)).to(torch.int32)
    return prefix, counts_out


def check_scan_cases(device) -> dict:
    """The append scan on the card through K14's test entry
    (``fuse_flat_scan_cuda``) and K8's (``fuse_scan_cuda``, one model: every
    pixel its own) on ``scan_cases``: prefix where the flag is new, prefix
    where the owner is a model, and the counts, all exact against
    ``scan_expected``."""
    cases, ok = {}, True
    for name, flags, own, M, counts, count8, cap8 in scan_cases():
        layout = R.FlatLayout(bg=SCAN_LAYOUT["bg"], bo=SCAN_LAYOUT["bo"], slots=M - 1)
        lens = [SCAN_LAYOUT["bg"]] + [SCAN_LAYOUT["bo"]] * (M - 1)
        new = ((flags >> 1) & 1) > 0
        r = {}
        pk, ck = FU.fuse_flat_scan_cuda(flags.to(device), own.to(device), counts.to(device),
                                        layout)
        pe, ce = scan_expected(flags, own, M, counts, lens)
        pk, ck = pk.cpu(), ck.cpu()
        owned = pe >= 0
        r["fuse_flat"] = dict(prefix_new_exact=torch.equal(pk[new & owned], pe[new & owned]),
                              prefix_owned_exact=torch.equal(pk[owned], pe[owned]),
                              counts_exact=torch.equal(ck, ce), counts=ck.tolist(),
                              counts_in=counts.tolist())
        zeros = torch.zeros_like(own)
        c8 = torch.tensor(count8, dtype=torch.int32)
        pk, ck = FU.fuse_scan_cuda(flags.to(device), c8.to(device), cap8)
        pe, ce = scan_expected(flags, zeros, 1, c8[None], [cap8])
        pk, ck = pk.cpu(), ck.cpu()
        r["fuse"] = dict(prefix_new_exact=torch.equal(pk[new], pe[new]),
                         prefix_exact=torch.equal(pk, pe),
                         count_exact=int(ck) == int(ce[0]), count=int(ck), count_in=count8,
                         capacity=cap8)
        r["ok"] = all(v for side in ("fuse_flat", "fuse") for k, v in r[side].items()
                      if k.endswith("exact"))
        ok = ok and r["ok"]
        cases[f"{name}[n={flags.numel()}, M={M}]"] = r
    return dict(cases=cases, ok=ok, max_abs_err=0.0 if ok else None,
                tolerance="prefix (where new, and where the owner is a model) and the counts "
                          "exact against torch.cumsum")


# ---------------------------------------------------------------- slice 2

def _rel(a, b) -> float:
    """max |a - b| / max(|b|, 1) (0 for empty tensors)."""
    if a.numel() == 0:
        return 0.0
    return float(((a.float() - b.float()).abs() / b.float().abs().clamp(min=1.0)).max())


def _frob(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(min=1e-30))


def check_frame_depth(a: tuple) -> dict:
    mk, fk = FM.frame_depth_cuda(*a)
    mp, fp = FM.frame_depth_plain(*a)
    err = float((fk - fp).abs().max())
    mask_diff = int(((fk > 0) != (fp > 0)).sum())
    return dict(
        max_abs_err=err, metric_depth_err=float((mk - mp).abs().max()), mask_differ=mask_diff,
        ok=err <= 1e-5 and mask_diff == 0 and bool((mk == mp).all()),
        tolerance="filtered depth within 1e-5 m, its valid mask and the metric depth exact",
    )


def check_frame_surfels(a: tuple) -> dict:
    sk = FM.frame_surfels_cuda(*a)
    sp = FM.frame_surfels_plain(*a)
    vdiff = int((sk.valid != sp.valid).sum())
    err = _rel(sk.data, sp.data)
    return dict(
        max_abs_err=float((sk.data - sp.data).abs().max()), max_rel_err=err, valid_differ=vdiff,
        valid_pixels=int(sp.valid.sum()),
        ok=vdiff == 0 and err <= 1e-5 and int(sp.valid.sum()) > 0,
        tolerance="valid mask exact; every channel within 1e-5 relative (|a-b| / max(|b|, 1))",
    )


def _pyr_frame_pair(a: tuple):
    kern = LV.frame_levels(*a)  # CUDA tensors: the kernels
    plain = LV.frame_levels_plain(*a)
    return kern, plain


def check_pyramid_frame(a: tuple, level: int) -> dict:
    kern, plain = _pyr_frame_pair(a)
    k, p = kern[level], plain[level]
    sob = torch.cat([(k.didx - p.didx).abs().reshape(-1), (k.didy - p.didy).abs().reshape(-1)])
    sob_off = int((sob > 0).sum())
    sob_frac = sob_off / sob.numel()
    sv_diff = int((k.static_valid != p.static_valid).sum())
    vmask = int(((k.vmap[..., 2] > 0) != (p.vmap[..., 2] > 0)).sum())
    nmask = int(((k.nmap != 0).any(-1) != (p.nmap != 0).any(-1)).sum())
    depth_err = float((k.depth - p.depth).abs().max())
    img_err = float((k.img - p.img).abs().max())
    map_err = max(float((k.vmap - p.vmap).abs().max()), float((k.nmap - p.nmap).abs().max()))
    # a Sobel value one off can flip the gradient gate of that pixel only
    ok = (depth_err <= 1e-5 and img_err <= 1e-4 and map_err <= 1e-5 and vmask == 0
          and nmask == 0 and float(sob.max()) <= 1.0 and sob_frac <= 1e-4
          and sv_diff <= sob_off and int(p.static_valid.sum()) > 0)
    return dict(
        max_abs_err=max(depth_err, map_err), depth_err=depth_err, intensity_err=img_err,
        vertex_normal_err=map_err, sobel_off_by_one=sob_off, static_valid_differ=sv_diff,
        vmap_mask_differ=vmask, nmap_mask_differ=nmask, ok=ok,
        tolerance="depth, vertices, normals within 1e-5, intensity within 1e-4; vertex/normal "
                  "masks exact; Sobel exact but for <= 0.01% of values off by 1; static "
                  "validity exact but where a Sobel value differs",
    )


def check_pyramid_pred(a: tuple, level: int) -> dict:
    mk = LV.pred_levels(*a)[level]
    mp = LV.pred_levels_plain(*a)[level]
    if mk.dtype == torch.bfloat16:
        differ = int((mk.view(torch.int16) != mp.view(torch.int16)).sum())
        return dict(max_abs_err=float((mk.float() - mp.float()).abs().max()), bits_differ=differ,
                    ok=differ == 0 and bool((mp[..., 0] != 0).any()),
                    tolerance="bf16 sampling map bit-equal")
    geo = float((mk[..., :7] - mp[..., :7]).abs().max())
    img = float((mk[..., 7] - mp[..., 7]).abs().max())
    mask = int(((mk[..., 2] > 0) != (mp[..., 2] > 0)).sum())
    return dict(max_abs_err=max(geo, img), geometry_err=geo, intensity_err=img, mask_differ=mask,
                ok=geo <= 1e-5 and img <= 1e-4 and mask == 0,
                tolerance="f32 map: vertices, normals, depth within 1e-5, intensity within "
                          "1e-4; vertex mask exact")


def check_so3_reduce(a: tuple) -> dict:
    sk = rgbd.so3_reduce_cuda(*a).cpu()
    sp = rgbd.so3_reduce_plain(*a).cpu()
    e = _frob(rgbd._sym(sk[:10], 4), rgbd._sym(sp[:10], 4))
    return dict(max_abs_err=float((sk - sp).abs().max()), rel_frob=e, count_kernel=float(sk[10]),
                count_plain=float(sp[10]), ok=e <= 1e-4 and float(sk[10]) == float(sp[10]) > 0,
                tolerance="4x4 system within 1e-4 relative (Frobenius), count exact")


def _pose_err(Tk, Tp):
    """(translation m, rotation rad) between two poses; the angle from the
    Frobenius distance of the rotations (|R1 - R2|_F = 2 sqrt(2) sin(a / 2)),
    which stays exact for tiny angles where arccos of the trace does not."""
    Tk, Tp = Tk.double().cpu(), Tp.double().cpu()
    dt = float(torch.linalg.norm(Tk[:3, 3] - Tp[:3, 3]))
    d = float(torch.linalg.norm(Tk[:3, :3] - Tp[:3, :3])) / (2.0 * 2.0**0.5)
    return dt, 2.0 * float(torch.asin(torch.tensor(min(d, 1.0), dtype=torch.float64)))


def check_odo_init(a: tuple) -> dict:
    sk = rgbd.odo_init_cuda(*a).cpu()
    sp = rgbd.odo_init_plain(*a).cpu()
    return dict(max_abs_err=float((sk - sp).abs().max()), ok=bool((sk == sp).all()),
                tolerance="state exact")


def check_so3_step(a: tuple) -> dict:
    state, sums, verbatim = a
    sk, sp = state.clone(), state.clone()
    rgbd.so3_step_cuda(sk, sums, verbatim)
    rgbd.so3_step_plain(sp, sums, verbatim)
    sk, sp = sk.cpu(), sp.cpu()
    S = rgbd
    R_err = float((sk[S.S_R:S.S_R + 9] - sp[S.S_R:S.S_R + 9]).abs().max())
    flags = [S.S_SO3_DONE, S.S_SO3_ITERS]
    scal = [S.S_SO3_ERR, S.S_SO3_COUNT, S.S_SO3_LAST_ERR, S.S_SO3_LAST_COUNT]
    serr = _rel(sk[scal], sp[scal])
    return dict(max_abs_err=R_err, rotation_err=R_err, scalars_rel_err=serr,
                ok=R_err <= 1e-5 and serr <= 1e-5 and bool((sk[flags] == sp[flags]).all()),
                tolerance="rotation within 1e-5, errors and counts within 1e-5 relative, done "
                          "flag and iteration count exact")


def check_gn_step(a: tuple) -> dict:
    state, sums, sp_, last = a
    sk, spl = state.clone(), state.clone()
    rgbd.gn_step_cuda(sk, sums, sp_, last)
    rgbd.gn_step_plain(spl, sums, sp_, last)
    sk, spl = sk.cpu(), spl.cpu()
    S = rgbd
    dt, dr = _pose_err(sk[S.S_RT:S.S_RT + 16].view(4, 4), spl[S.S_RT:S.S_RT + 16].view(4, 4))
    flags = [S.S_GN_DONE, S.S_GN_J, S.S_GN_ITERS, S.S_GN_ITERS + 1, S.S_GN_ITERS + 2]
    A_err = _frob(sk[S.S_LAST_A:S.S_LAST_A + 36], spl[S.S_LAST_A:S.S_LAST_A + 36])
    scal = [S.S_ICP_ERR, S.S_ICP_COUNT, S.S_RGB_ERR, S.S_RGB_COUNT]
    serr = _rel(sk[scal], spl[scal])
    return dict(max_abs_err=max(dt, dr), trans_err_m=dt, rot_err_rad=dr, lastA_rel_frob=A_err,
                scalars_rel_err=serr,
                ok=dt <= 1e-5 and dr <= 1e-5 and A_err <= 1e-4 and serr <= 1e-4
                and bool((sk[flags] == spl[flags]).all()),
                tolerance="pose within 1e-5 m and 1e-5 rad, lastA within 1e-4 relative "
                          "(Frobenius), errors/counts within 1e-4 relative, flags exact")


# ---------------------------------------------------------------- K5's solve

_F = np.float32


def _jacobi_eigh_emulated(a: list):
    """``csrc/gn_step.cu`` ``jacobi_eigh<N>`` on an N x N list of float32
    scalars (rotated in place), op by op: (w ascending, V, sweeps run,
    rotations made)."""
    n = len(a)
    V = [[_F(1.0) if i == j else _F(0.0) for j in range(n)] for i in range(n)]
    sweeps = rotations = 0
    for _ in range(40):
        sweeps += 1
        rotated = False
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq = a[p][q]
                if abs(apq) <= _F(1e-10) * (abs(a[p][p]) + abs(a[q][q])) or apq == _F(0.0):
                    a[p][q] = a[q][p] = _F(0.0)
                    continue
                rotated = True
                rotations += 1
                theta = (a[q][q] - a[p][p]) / (_F(2.0) * apq)
                t = _F(1.0) / (abs(theta) + np.sqrt(theta * theta + _F(1.0)))
                if theta < _F(0.0):
                    t = -t
                if not np.isfinite(theta * theta):
                    t = _F(0.5) / theta
                c = _F(1.0) / np.sqrt(t * t + _F(1.0))
                s = t * c
                for k in range(n):
                    akp, akq = a[k][p], a[k][q]
                    a[k][p] = c * akp - s * akq
                    a[k][q] = s * akp + c * akq
                for k in range(n):
                    apk, aqk = a[p][k], a[q][k]
                    a[p][k] = c * apk - s * aqk
                    a[q][k] = s * apk + c * aqk
                for k in range(n):
                    vkp, vkq = V[k][p], V[k][q]
                    V[k][p] = c * vkp - s * vkq
                    V[k][q] = s * vkp + c * vkq
        if not rotated:
            break
    w = [a[i][i] for i in range(n)]
    for i in range(n - 1):  # selection sort: the first minimum, strict <
        m = i
        for j in range(i + 1, n):
            if w[j] < w[m]:
                m = j
        if m != i:
            w[i], w[m] = w[m], w[i]
            for k in range(n):
                V[k][i], V[k][m] = V[k][m], V[k][i]
    return w, V, sweeps, rotations


def _jacobi_scaled(A):
    """The kernel's Jacobi scaling of A (float32): (dinv, D^-1/2 A D^-1/2)."""
    n = A.shape[0]
    dinv = [_F(1.0) / np.sqrt(np.fmax(A[i, i], _F(1e-12))) for i in range(n)]
    return dinv, [[A[i, j] * dinv[i] * dinv[j] for j in range(n)] for i in range(n)]


def jacobi_work(A) -> tuple:
    """(sweeps, rotations) of K5's eigensolve on the Jacobi-scaled A."""
    with np.errstate(all="ignore"):
        return _jacobi_eigh_emulated(_jacobi_scaled(np.asarray(A, dtype=_F))[1])[2:]


def solve_preconditioned_emulated(A, b):
    """K5's ``solve_preconditioned<N>`` (``csrc/gn_step.cu``) in numpy float32
    scalars, op by op in the kernel's order: Jacobi scaling, cyclic Jacobi
    rotations with the kernel's skip rule and ``t``, at most 40 sweeps, the
    selection sort, the truncation at 1e-4 of the largest eigenvalue and x =
    0 where not finite. Every constant is float32, so nothing widens; IEEE
    + - * / and sqrt round alike here and on the card under -fmad=false, so
    the kernel's x and w are bit-equal to these. Returns (x [N], w [N]) as
    float32 arrays."""
    A = np.asarray(A, dtype=_F)
    b = np.asarray(b, dtype=_F)
    n = b.shape[0]
    with np.errstate(all="ignore"):
        dinv, ah = _jacobi_scaled(A)
        bh = [b[i] * dinv[i] for i in range(n)]
        w, V = _jacobi_eigh_emulated(ah)[:2]
        wmax = np.fmax(w[n - 1], _F(1e-12))
        tmp = []
        for k in range(n):
            inv_w = (_F(1.0) / (_F(1.0) if w[k] == _F(0.0) else w[k])
                     if w[k] > _F(1e-4) * wmax else _F(0.0))
            s = _F(0.0)
            for i in range(n):
                s = s + V[i][k] * bh[i]
            tmp.append(inv_w * s)
        x = []
        for i in range(n):
            s = _F(0.0)
            for k in range(n):
                s = s + V[i][k] * tmp[k]
            x.append(s * dinv[i])
    x = np.array(x, dtype=_F)
    if not np.isfinite(x).all():
        x = np.zeros(n, dtype=_F)
    return x, np.array(w, dtype=_F)


SOLVE_NEAR_CUT = ("spin_below_cut", "spin_above_cut")  # smallest at 1e-5 / 1e-3 of the largest
SOLVE_NEAR_CUT_CASES = tuple(f"{name}{suffix}" for name in SOLVE_NEAR_CUT for suffix in ("", "_full"))


def solve_cases(n: int, seed: int = 0):
    """Hand-made systems for K5's N x N solve (N = 3 or 6), float32:
    [(name, A [N, N], b [N])]. b = A x with x ~ U(-0.05, 0.05), a GN step's
    scale, where A is finite. "well_conditioned": eigenvalues 1..8;
    "scaled_six_decades": a unit-diagonal well-conditioned C between
    diagonals 1..1e6; "spin_below_cut" / "spin_above_cut": the sphere-spin
    near-degeneracy of a lone sphere's system (ROADMAP queue 3 #8): one
    eigenvalue at 1e-5 / 1e-3 of the largest, either side of the solve's
    1e-4 cut, between diagonals of 1e4 (translation) and 1 (rotation), and
    a step (|x| <= 0.05) whose scaled component along that weakest
    direction is a twentieth of its others' scale (a lone sphere's data
    hardly move its spin); "spin_below_cut_full" / "spin_above_cut_full":
    the same systems with that component at its others' scale;
    "rank_deficient": J^T J of an (N - 2) x N J; "all_zero"; "inf" (A[0, 1]
    and A[1, 0]) and "nan" (b[1]), whose x is 0; "repeated_eigenvalues": pairs of equal
    eigenvalues in a random basis; "exact_ties": unit-diagonal identical
    2x2 blocks (N = 6), whose rotations give bit-equal eigenvalues out of
    order, or diag(4, 1, 1) (N = 3), exactly the identity once scaled: the
    sort's ties."""
    rng = np.random.default_rng(seed * 7 + n)

    def orth():
        return np.linalg.qr(rng.standard_normal((n, n)))[0]

    def spd(eig, Q=None):
        Q = orth() if Q is None else Q
        A = Q @ np.diag(eig) @ Q.T
        return (A + A.T) / 2

    def unit_diag(A):
        d = 1.0 / np.sqrt(np.diag(A))
        return A * d[:, None] * d[None, :]

    x = rng.uniform(-0.05, 0.05, n)
    cases = []

    def add(name, A, b=None):
        A = np.asarray(A, dtype=np.float64)
        b = A @ x if b is None else b
        cases.append((name, A.astype(_F), np.asarray(b).astype(_F)))

    add("well_conditioned", spd(np.linspace(1.0, 8.0, n)))
    D = np.sqrt(10.0 ** np.linspace(0.0, 6.0, n))
    add("scaled_six_decades", unit_diag(spd(np.linspace(1.0, 8.0, n))) * D[:, None] * D[None, :])
    S = np.where(np.arange(n) < n // 2, 100.0, 1.0)
    for name, small in zip(SOLVE_NEAR_CUT, (1e-5, 1e-3)):
        eig = np.concatenate([[small], np.linspace(0.3, 1.0, n - 1)])
        A = spd(eig) * S[:, None] * S[None, :]
        d = 1.0 / np.sqrt(np.diag(A))
        c = rng.uniform(-1.0, 1.0, n)  # the step in the scaled system's eigenbasis
        Q = np.linalg.eigh(A * d[:, None] * d[None, :])[1]
        for suffix, weak in (("", 0.05), ("_full", 1.0)):
            xs = d * (Q @ (c * np.where(np.arange(n) == 0, weak, 1.0)))
            add(name + suffix, A, A @ (xs * 0.05 / np.abs(xs).max()))
    J = rng.standard_normal((n - 2, n))
    add("rank_deficient", J.T @ J)
    add("all_zero", np.zeros((n, n)), np.zeros(n))
    A = spd(np.linspace(1.0, 8.0, n))
    b = A @ x
    A[0, 1] = A[1, 0] = np.inf
    add("inf", A, b)
    A = spd(np.linspace(1.0, 8.0, n))
    b = A @ x
    b[1] = np.nan
    add("nan", A, b)
    add("repeated_eigenvalues", spd(np.repeat(np.arange(1.0, n // 2 + 2), 2)[:n]))
    if n == 6:
        blk = lambda r: np.array([[1.0, r], [r, 1.0]])  # noqa: E731
        T = np.zeros((6, 6))
        for k, r in enumerate((0.5, 0.25, 0.5)):
            T[2 * k:2 * k + 2, 2 * k:2 * k + 2] = blk(r)
        add("exact_ties", T)
    else:
        add("exact_ties", np.diag([4.0, 1.0, 1.0]))
    return cases


def check_solve_cases(device) -> dict:
    """K5's ``solve_preconditioned<6>`` and ``<3>`` on the card (test entry
    ``mmf_solve_cases``) on ``solve_cases`` against
    ``solve_preconditioned_emulated``: x and w bit-equal (w's NaNs as NaNs);
    and the steps' ``sincos_step`` bit-equal to ``sinf``/``cosf`` on every
    float below 105615 in magnitude (``mmf_trig_cases``)."""
    cases, ok = {}, True
    for n in (6, 3):
        cs = solve_cases(n)
        A = torch.from_numpy(np.stack([c[1] for c in cs])).to(device)
        b = torch.from_numpy(np.stack([c[2] for c in cs])).to(device)
        xk, wk = (t.cpu().numpy() for t in rgbd.solve_cases_cuda(A, b))
        for k, (name, Ak, bk) in enumerate(cs):
            xe, we = solve_preconditioned_emulated(Ak, bk)
            x_eq = bool((xk[k].view(np.int32) == xe.view(np.int32)).all())
            w_eq = bool(((wk[k].view(np.int32) == we.view(np.int32))
                         | (np.isnan(wk[k]) & np.isnan(we))).all())
            cases[f"{name}[N={n}]"] = dict(x_bit_equal=x_eq, w_bit_equal=w_eq,
                                           x=[float(v) for v in xk[k]])
            ok = ok and x_eq and w_eq
    # the steps' sine and cosine (csrc/gn_step.cu sincos_step) against sinf
    # and cosf on every float below 105615 (test entry mmf_trig_cases)
    from multimotionfusion_tpu_torch import kernels as K

    counts = torch.zeros(2, dtype=torch.int64, device=device)
    K.call("trig_cases", K.fn("gn_step", "mmf_trig_cases", [K.P]), K.ptr(counts))
    trig_bad, trig_n = (int(v) for v in counts.cpu())
    ok = ok and trig_bad == 0 and trig_n > 2_000_000_000
    return dict(cases=cases, trig_checked=trig_n, trig_mismatches=trig_bad, ok=ok,
                max_abs_err=0.0 if ok else None,
                tolerance="x and the eigenvalues bit-equal to the float32 emulation; the "
                          "steps' sine and cosine bit-equal to sinf and cosf on every float "
                          "below 105615 in magnitude")


def check_track(a: tuple) -> dict:
    """The whole device loop (kernels, CUDA tensors) against the plain loop
    on copies of the same inputs on the CPU."""
    T_prev, gl, last, cfg, cam, T_init, seed_valid = a
    rk = rgbd.track(T_prev, gl, last, cfg, cam, T_init, seed_valid)
    glc = [rgbd.GNLevel(*(_host(x) for x in g)) for g in gl]
    rp = rgbd.track(T_prev.cpu(), glc, last.cpu(), cfg, cam, _host(T_init), _host(seed_valid))
    dt, dr = _pose_err(rk.pose, rp.pose)
    ik, ip = rgbd.loop_iterations(rk), rgbd.loop_iterations(rp)
    return dict(max_abs_err=max(dt, dr), trans_err_m=dt, rot_err_rad=dr, iterations_kernel=ik,
                iterations_plain=ip, ok=dt <= 1e-5 and dr <= 1e-5 and ik == ip,
                tolerance="final pose within 1e-5 m and 1e-5 rad, iterations of every loop equal")


def _host(t):
    return t.cpu() if isinstance(t, torch.Tensor) else t


def _clean_pair(a: tuple):
    (data, count, index, data_local, depth, mask, mask_id, cam, time, time_delta, conf, cfg,
     compact) = a
    smap = sm.SurfelMap(data, count)
    im = R.IndexMap(index, data_local)
    args = (smap, im, depth, mask, mask_id, cam, time, time_delta, conf, cfg, compact)
    return FU.clean_cuda(*args), FU.clean_plain(*args), data


def check_clean(a: tuple) -> dict:
    ck, cp, data_in = _clean_pair(a)
    nk, np_ = int(ck.count), int(cp.count)
    alive_diff = int((ck.data[sm.ALIVE] != cp.data[sm.ALIVE]).sum())
    err = _rel(ck.data, cp.data)
    n_exact = int((ck.data != cp.data).any(0).sum())
    changed = int((cp.data[:, :np_] != data_in[:, :np_]).any(0).sum()) if not a[-1] else np_
    return dict(
        max_abs_err=float((ck.data - cp.data).abs().max()), max_rel_err=err, count_kernel=nk,
        count_plain=np_, keep_differ=alive_diff, columns_differ=n_exact, columns_changed=changed,
        ok=nk == np_ and alive_diff == 0 and err <= 1e-6 and changed > 0,
        tolerance="count and keep mask (ALIVE channel) exact; the whole [16, B] output "
                  "(compaction order included) within 1e-6 relative",
    )


def check_compact(a: tuple) -> dict:
    dk, ck = sm.compact_cuda(*a)
    dp, cp = sm.compact_plain(*a)
    differ = int((dk != dp).any(0).sum())
    return dict(max_abs_err=float((dk - dp).abs().max()), count_kernel=int(ck),
                count_plain=int(cp), columns_differ=differ,
                ok=int(ck) == int(cp) > 0 and differ == 0,
                tolerance="count exact, packed map (order, zeroed tail) exact")


# ---------------------------------------------------------------- keypoint path

def _maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_patch_score(a: tuple) -> dict:
    (sk, bk), (sp, bp) = SP.patch_score_cuda(*a), SP.patch_score_plain(*a)
    err = max(_maxerr(sk, sp), _maxerr(bk, bp))
    return dict(max_abs_err=err, score_differ=int((sk != sp).sum()),
                blurred_differ=int((bk != bp).sum()), positive_scores=int((sp > 0).sum()),
                ok=bool((sk == sp).all()) and bool((bk == bp).all()) and int((sp > 0).sum()) > 0,
                tolerance="score and blurred intensity bit-equal (same taps, order and weights, "
                          "-fmad=false)")


def check_nms_topk(a: tuple) -> dict:
    xk, sk, vk = SP.nms_topk_cuda(*a)
    xp, spl, vp = SP.nms_topk_plain(*a)
    eq = bool((xk == xp).all()) and bool((sk == spl).all()) and bool((vk == vp).all())
    return dict(max_abs_err=max(_maxerr(xk, xp), _maxerr(sk, spl)), valid_kernel=int(vk.sum()),
                valid_plain=int(vp.sum()), slots_differ=int(((xk != xp).any(-1) | (sk != spl)).sum()),
                ok=eq, tolerance="xy, score and valid equal in every slot (exact top-k, ties to "
                                 "the lower flat index)")


def check_patch_desc(a: tuple) -> dict:
    dk, dp = SP.patch_desc_cuda(*a), SP.patch_desc_plain(*a)
    return dict(max_abs_err=_maxerr(dk, dp), values_differ=int((dk != dp).sum()),
                ok=bool((dk == dp).all()),
                tolerance="descriptors bit-equal (the warp's summation order repeated)")


def check_mutual_match(a: tuple) -> dict:
    mk, tk = TR.mutual_match_cuda(*a)
    mp, tp = TR.mutual_match_plain(*a)
    return dict(max_abs_err=0.0, matches_kernel=int((mk >= 0).sum()),
                matches_plain=int((mp >= 0).sum()), differ=int((mk != mp).sum()),
                ok=bool((mk == mp).all()) and bool((tk == tp).all()) and int((mp >= 0).sum()) > 0,
                tolerance="match indices and matched tracks equal (sums over d in the same order)")


def _table_copy(table):
    return TR.TrackTable(*(t.clone() for t in table))


def check_track_update(a: tuple) -> dict:
    """Kernel and plain update, each on its own copy of the recorded table:
    all nine fields and the (p0, p1, valid) pair compared whole."""
    table, rest = a[0], a[1:]
    tk, tp = _table_copy(table), _table_copy(table)
    pk = TR.update_cuda(tk, *rest)
    pp = TR.update_plain(tp, *rest)
    differ = {f: int((getattr(tk, f) != getattr(tp, f)).sum()) for f in TR.FIELDS}
    pair_differ = 0 if pk is None else sum(int((x != y).sum()) for x, y in zip(pk, pp))
    err = max(_maxerr(tk.p3d, tp.p3d), _maxerr(tk.xy, tp.xy), _maxerr(tk.desc, tp.desc))
    return dict(max_abs_err=err, fields_differ=differ, pair_differ=pair_differ,
                active_tracks=int(tp.active.sum()),
                pairs=0 if pp is None else int(pp[2].sum()),
                ok=sum(differ.values()) == 0 and pair_differ == 0 and int(tp.active.sum()) > 0,
                tolerance="every field of the table and the pair equal")


def check_ransac(a: tuple) -> dict:
    rk, ik = RS.ransac_fit_cuda(*a, want_idx=True)
    rp, ip = RS.ransac_fit_plain(*a, want_idx=True)
    t_err = _maxerr(rk.transform, rp.transform)
    e_k, e_p = float(rk.error), float(rp.error)
    e_eq = e_k == e_p or abs(e_k - e_p) <= 1e-6 * abs(e_p)
    exact = bool((ik == ip).all()) and bool((rk.inliers == rp.inliers).all()) and \
        int(rk.num_inliers) == int(rp.num_inliers) and bool(rk.ok) == bool(rp.ok)
    return dict(max_abs_err=t_err, error_kernel=e_k, error_plain=e_p,
                num_inliers=int(rp.num_inliers), ok_flag=bool(rp.ok),
                ok=exact and t_err <= 1e-6 and e_eq,
                tolerance="minimal sets, inliers, num_inliers and ok equal; T within 1e-6 and "
                          "error within 1e-6 relative (the same sums in the same order; the "
                          "bound covers a reciprocal PyTorch may take for a division)")


def check_seed_select(a: tuple) -> dict:
    state, rest = a[0], a[1:]
    sk, sp = state.clone(), state.clone()
    rgbd.seed_select_cuda(sk, *rest)
    rgbd.seed_select_plain(sp, *rest)
    sk, sp = sk.cpu(), sp.cpu()
    S = rgbd
    rt = slice(S.S_RT, S.S_RT + 16)
    inv = slice(S.S_RT_INV, S.S_RT_INV + 16)
    err = _maxerr(sk[inv], sp[inv])
    return dict(max_abs_err=err, result_Rt_equal=bool((sk[rt] == sp[rt]).all()),
                ok=bool((sk[rt] == sp[rt]).all()) and err <= 1e-6,
                tolerance="chosen result_Rt equal; its inverse within 1e-6 (the plain version "
                          "inverts with einsum)")


def check_sparse(a: tuple, sp_net=None) -> dict:
    """Detect -> table -> RANSAC: the kernels on the card against the plain
    chain on CPU copies of the same inputs (the same uniforms)."""
    from multimotionfusion_tpu_torch import engine as E

    img, tracks, depth, time, u, cam, cfg = a
    rk = E.sparse_fit(img, _table_copy(tracks), depth, time, u, cam, cfg, sp_net)
    net_cpu = None if sp_net is None else copy.deepcopy(sp_net).cpu()
    rp = E.sparse_fit(img.cpu(), TR.TrackTable(*(t.cpu() for t in tracks)), depth.cpu(), time,
                      u.cpu(), cam, cfg, net_cpu)
    t_err = _maxerr(rk.transform.cpu(), rp.transform)
    same = int(rk.num_inliers) == int(rp.num_inliers) and bool(rk.ok) == bool(rp.ok)
    return dict(max_abs_err=t_err, num_inliers_kernel=int(rk.num_inliers),
                num_inliers_plain=int(rp.num_inliers), ok_kernel=bool(rk.ok),
                ok_plain=bool(rp.ok), ok=same and t_err <= 1e-5,
                tolerance="T within 1e-5, num_inliers and ok equal")


def components_inputs(h: int, w: int, device, labels: int = 3, seed: int = 0) -> tuple:
    """``keep_largest_components_batched`` arguments on a synthetic stack:
    blobs of a thresholded, box-smoothed random field per label, and in label
    0 a square spiral whose geodesic length exceeds the 64 sweeps."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    field = torch.rand((labels, 1, h, w), generator=g)
    for _ in range(3):
        field = torch.nn.functional.avg_pool2d(field, 9, stride=1, padding=4)
    masks = (field[:, 0] > field.mean()).clone()
    spiral = torch.zeros((h, w), dtype=torch.bool)
    rows, cols = min(h, 60) - 4, min(w, 60) - 4
    spiral[2:2 + rows, 2:2 + cols] = _spiral(rows, cols)
    masks[0, :62, :62] = spiral[:62, :62]
    return masks.to(device), 64


def _spiral(rows: int, cols: int) -> torch.Tensor:
    """A square spiral in a rows x cols box (walls one cell wide, one cell
    apart): its geodesic length exceeds 64 from about 20 x 20 on."""
    spiral = torch.zeros((rows, cols), dtype=torch.bool)
    lo_y, lo_x, hi_y, hi_x = 0, 0, rows - 1, cols - 1
    while lo_y < hi_y and lo_x < hi_x:
        spiral[lo_y, lo_x:hi_x + 1] = True
        spiral[lo_y:hi_y + 1, hi_x] = True
        spiral[hi_y, lo_x:hi_x + 1] = True
        spiral[lo_y + 2:hi_y + 1, lo_x] = True
        lo_y, lo_x, hi_y, hi_x = lo_y + 2, lo_x + 2, hi_y - 2, hi_x - 2
        if lo_y < hi_y:
            spiral[lo_y, lo_x - 2:lo_x + 1] = True
    return spiral


def nms_inputs(kind: str, h: int, w: int, device, seed: int = 0) -> tuple:
    """``nms_topk`` arguments on synthetic heat maps: ``plateau`` (a constant
    block holding more peaks than K, every pixel of it a peak), ``random``
    (uniform scores, radius 4) and ``superpoint`` (the heat map of a
    random-weight SuperPoint on a random image)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if kind == "plateau":
        heat = torch.zeros((h, w))
        heat[h // 4:3 * h // 4, w // 4:3 * w // 4] = 3.0
        return heat.to(device), 512, 1.0, 4
    if kind == "random":
        return torch.rand((h, w), generator=g).to(device), 512, 0.5, 4
    torch.manual_seed(seed)
    net = SP.SuperPointNet().to(device).eval()
    img = torch.rand((h, w), generator=g).to(device)
    heat, _ = SP.superpoint_apply(net, img)
    return heat.contiguous(), 512, 0.0, 4


# ---------------------------------------------------------------- slice 4

def check_owner_prep(a: tuple, level: int) -> dict:
    prev_mask, pred_own, frame, gl, cfg, M = a
    ms = LV._min_scale(cfg, level)
    k = MO.owner_level_cuda(level, prev_mask, pred_own, frame[level], M, ms)
    p = MO.owner_level_plain(level, prev_mask, pred_own, frame[level], M, ms)
    differ = [int((x != y).sum()) for x, y in zip(k, p)]
    return dict(max_abs_err=float(sum(differ)), differ_own_bank_valid=differ,
                band_pixels=int((p[1] == M).sum()), valid_pixels=int(p[2].sum()),
                ok=sum(differ) == 0 and int(p[2].sum()) > 0,
                tolerance="owner, eroded owner and static validity exact")


def check_gn_multi(a: tuple, level: int) -> dict:
    sk = MO.gn_multi_cuda(*a, level=level).cpu()
    sp = MO.gn_multi_plain(*a).cpu()
    e_icp = e_rgb = scal = 0.0
    for m in range(sk.shape[0]):
        Sp_i, Sp_r = rgbd._sym(sp[m, 0:28]), rgbd._sym(sp[m, 28:56])
        if float(sp[m, 56]) > 0:
            e_icp = max(e_icp, _frob(rgbd._sym(sk[m, 0:28]), Sp_i))
        if float(sp[m, 57]) > 0:
            e_rgb = max(e_rgb, _frob(rgbd._sym(sk[m, 28:56]), Sp_r))
        scal = max(scal, _rel(sk[m, 56:59], sp[m, 56:59]))
    counts_equal = bool((sk[:, 56:58] == sp[:, 56:58]).all())
    return dict(max_abs_err=float((sk - sp).abs().max()), rel_frob_icp=e_icp, rel_frob_rgb=e_rgb,
                counts_sigma_rel_err=scal, counts_equal=counts_equal,
                icp_counts=[float(x) for x in sp[:, 56]],
                ok=e_icp <= 1e-5 and e_rgb <= 1e-5 and scal <= 1e-4 and counts_equal
                and float(sp[:, 56].sum()) > 0,
                tolerance="each model's 7x7 systems within 1e-5 relative (Frobenius); ICP and "
                          "RGB counts exact, sum diff^2 (a sum of 76,800 squares in another "
                          "order) within 0.01%")


def check_multi_init(a: tuple) -> dict:
    sk = MO.multi_init_cuda(*a).cpu()
    sp = MO.multi_init_plain(*a).cpu()
    return dict(max_abs_err=float((sk - sp).abs().max()), ok=bool((sk == sp).all()),
                tolerance="state exact")


def _multi_rows(st, M):
    return st.cpu().view(M + 1, rgbd.S_SIZE)


def check_multi_seed(a: tuple) -> dict:
    state, rest, M = a[0], a[1:], a[4]
    sk, sp = state.clone(), state.clone()
    MO.multi_seed_cuda(sk, *rest)
    MO.multi_seed_plain(sp, *rest)
    rk, rp = _multi_rows(sk, M), _multi_rows(sp, M)
    rt = slice(rgbd.S_RT, rgbd.S_RT + 16)
    inv = slice(rgbd.S_RT_INV, rgbd.S_RT_INV + 16)
    same = bool((rk[:, rt] == rp[:, rt]).all()) and bool(
        (rk[:, MO.S_ACTIVE] == rp[:, MO.S_ACTIVE]).all())
    err = _maxerr(rk[:, inv], rp[:, inv])
    return dict(max_abs_err=err, ok=same and err <= 1e-6,
                tolerance="each model's start and active flag equal; its inverse within 1e-6")


def check_multi_arbitrate(a: tuple) -> dict:
    state, rest, M = a[0], a[1:], a[3]
    sk, sp = state.clone(), state.clone()
    MO.multi_arbitrate_cuda(sk, *rest)
    MO.multi_arbitrate_plain(sp, *rest)
    rk, rp = _multi_rows(sk, M), _multi_rows(sp, M)
    rt = slice(rgbd.S_RT, rgbd.S_RT + 16)
    inv = slice(rgbd.S_RT_INV, rgbd.S_RT_INV + 16)
    err = _maxerr(rk[:, inv], rp[:, inv])
    same = bool((rk[:, rt] == rp[:, rt]).all())
    return dict(max_abs_err=err, ok=same and err <= 1e-6,
                tolerance="each model's kept start equal; its inverse within 1e-6")


def check_gn_step_multi(a: tuple) -> dict:
    state, sums, M, sp_, last = a
    sk, spl = state.clone(), state.clone()
    MO.gn_step_multi_cuda(sk, sums, M, sp_, last)
    MO.gn_step_multi_plain(spl, sums, M, sp_, last)
    rk, rp = _multi_rows(sk, M), _multi_rows(spl, M)
    S = rgbd
    errs = [_pose_err(rk[m, S.S_RT:S.S_RT + 16].view(4, 4), rp[m, S.S_RT:S.S_RT + 16].view(4, 4))
            for m in range(M)]
    cam_t, cam_r = errs[0]
    dt, dr = max(e[0] for e in errs), max(e[1] for e in errs)
    A_err = serr = 0.0
    for m in range(M):
        A_err = max(A_err, _frob(rk[m, S.S_LAST_A:S.S_LAST_A + 36], rp[m, S.S_LAST_A:S.S_LAST_A + 36]))
        cols = [S.S_ICP_ERR, S.S_ICP_COUNT, S.S_RGB_ERR, S.S_RGB_COUNT]
        serr = max(serr, _rel(rk[m, cols], rp[m, cols]))
    flags = bool((rk[:, S.S_GN_DONE] == rp[:, S.S_GN_DONE]).all()) and bool(
        (rk[M, [S.S_GN_J, S.S_GN_ITERS, S.S_GN_ITERS + 1, S.S_GN_ITERS + 2]]
         == rp[M, [S.S_GN_J, S.S_GN_ITERS, S.S_GN_ITERS + 1, S.S_GN_ITERS + 2]]).all())
    return dict(max_abs_err=max(dt, dr), trans_err_m=dt, rot_err_rad=dr, camera_trans_err_m=cam_t,
                camera_rot_err_rad=cam_r, lastA_rel_frob=A_err, scalars_rel_err=serr,
                ok=cam_t <= 1e-5 and cam_r <= 1e-5 and dt <= 1e-4 and dr <= 1e-4
                and A_err <= 1e-4 and serr <= 1e-4 and flags,
                tolerance="the camera's pose within 1e-5 m and 1e-5 rad, every object's within "
                          "1e-4 m and 1e-4 rad (a sphere's spin about its centre is nearly "
                          "unobservable: the eigen-truncated solve of its nearly degenerate "
                          "system differs between the kernel's Jacobi eigensolver and LAPACK's), "
                          "lastA within 1e-4 relative, errors/counts within 1e-4 relative, stop "
                          "and done flags and counters exact")


def check_multi_track(a: tuple) -> dict:
    """The composite odometry loop on the card against the plain loop on CPU
    copies of the same inputs."""
    T_prev, levels, last, cfg, cam, M, T_init, seed_valid, active = a
    rk = MO.multi_track(T_prev, levels, last, cfg, cam, M, T_init, seed_valid, active)
    host = [MO.MultiLevel(rgbd.GNLevel(*(_host(x) for x in ml.gl)), ml.own.cpu(),
                          ml.bank_own.cpu()) for ml in levels]
    rp = MO.multi_track(T_prev.cpu(), host, last.cpu(), cfg, cam, M, _host(T_init),
                        _host(seed_valid), _host(active))
    errs = [_pose_err(rk.poses[m], rp.poses[m]) for m in range(M)]
    cam_t, cam_r = errs[0]
    dt, dr = max(e[0] for e in errs), max(e[1] for e in errs)
    ik, ip = MO.loop_iterations(rk), MO.loop_iterations(rp)
    counts_rel = _rel(rk.icp_count.cpu(), rp.icp_count)
    return dict(max_abs_err=max(dt, dr), trans_err_m=dt, rot_err_rad=dr, camera_trans_err_m=cam_t,
                camera_rot_err_rad=cam_r, per_model_err=errs, iterations_kernel=ik,
                iterations_plain=ip, icp_counts=[float(x) for x in rp.icp_count],
                icp_counts_rel_err=counts_rel,
                ok=cam_t <= 1e-5 and cam_r <= 1e-5 and dt <= 2e-3 and dr <= 5e-3 and ik == ip
                and counts_rel <= 1e-2,
                tolerance="the camera's final pose within 1e-5 m and 1e-5 rad; every object's "
                          "within 2e-3 m and 5e-3 rad (its spin about the sphere's centre is "
                          "nearly unobservable, and the per-step differences of the truncated "
                          "solve, below 1e-4 each, add up over the 19 iterations); the "
                          "iterations of every loop equal; ICP counts within 1% (an object's "
                          "count follows its pose)")


def check_zbuffer_flat(a: tuple) -> dict:
    ik, dk, wk = R.zbuffer_flat_cuda(*a)
    ip, dp, wp = R.zbuffer_flat_plain(*a)
    differ = int((ik != ip).sum())
    wdiffer = int((wk != wp).sum())
    err = float((dk - dp).abs().max())
    return dict(max_abs_err=err, differing_pixels=differ, win_model_differ=wdiffer,
                object_pixels=int(((wp > 0) & (wp < a[2].n_models)).sum()),
                ok=differ == 0 and wdiffer == 0 and err <= 1e-5,
                tolerance="index and winner model exact; data_local within 1e-5")


def check_fuse_flat(a: tuple) -> dict:
    dk, ck = FU.fuse_flat_cuda(*a)
    dp, cp = FU.fuse_flat_plain(*a)
    data_in = a[0]
    written = int((dp != data_in).any(0).sum())
    err = float(((dk - dp).abs() / dp.abs().clamp(min=1.0)).max())
    counts_equal = bool((ck == cp).all())
    return dict(max_abs_err=float((dk - dp).abs().max()), max_rel_err=err,
                counts_kernel=ck.tolist(), counts_plain=cp.tolist(), written_plain=written,
                ok=written > 0 and counts_equal and err <= 1e-4,
                tolerance="per-model counts exact; whole flat store within 1e-4 relative "
                          "(|a-b| / max(|b|, 1))")


def check_clean_flat(a: tuple) -> dict:
    ok_ = FU.clean_flat_cuda(*a)
    op = FU.clean_flat_plain(*a)
    data_in = a[0]
    alive_diff = int((ok_[sm.ALIVE] != op[sm.ALIVE]).sum())
    err = _rel(ok_, op)
    culled = int(((data_in[sm.ALIVE] > 0) & (op[sm.ALIVE] == 0)).sum())
    return dict(max_abs_err=float((ok_ - op).abs().max()), max_rel_err=err, keep_differ=alive_diff,
                culled_plain=culled, ok=alive_diff == 0 and err <= 1e-6,
                tolerance="ALIVE exact; the whole flat store within 1e-6 relative")


# ---------------------------------------------------------------- flow-CRF

def check_render_depths(a: tuple) -> dict:
    """K13: coverage exact; depth equal (both quantise the same expression;
    one log-depth bin, 5.3e-6 relative, tolerated)."""
    dk, dp = R.render_depths_cuda(*a), R.render_depths_plain(*a)
    cover_diff = int(((dk > 0) != (dp > 0)).sum())
    rel = float(((dk - dp).abs() / dp.clamp(min=1e-6)).max())
    return dict(max_abs_err=float((dk - dp).abs().max()), max_rel_err=rel,
                coverage_differ=cover_diff, covered=int((dp > 0).sum()),
                ok=cover_diff == 0 and rel <= 6e-6,
                tolerance="coverage exact; depth within one log-depth bin (6e-6 relative)")


def check_flow_prep(a: tuple) -> dict:
    """K15's resize, blur and pyramids: the same taps in the same order."""
    pk, pp = FL.flow_prep_cuda(*a), FL.flow_prep_plain(*a)
    err = max(float((k - p).abs().max()) for k, p in zip(pk, pp))
    return dict(max_abs_err=err, ok=err <= 1e-3,
                tolerance="every level within 1e-3 of intensities 0..255 (same taps and order)")


def flow_level_inputs(a: tuple, level: int):
    """(pair, coarser flow) of ``level`` from the plain front end and the plain
    coarser levels, so both versions of the level see the same inputs."""
    pyr = FL.flow_prep_plain(*a)
    flow = None
    for lvl in range(FL.LEVELS - 1, level, -1):
        flow = FL.lk_level_plain(pyr[lvl], flow)
    return pyr[level], flow


def check_lk_level(a: tuple, level: int) -> dict:
    """A K15 level (upsample + 4 Lucas-Kanade iterations) on the same pair and
    coarser flow: the same arithmetic in the same order."""
    pair, coarse = flow_level_inputs(a, level)
    fk = FL.lk_level_cuda(pair, coarse, level)
    fp = FL.lk_level_plain(pair, coarse)
    gap = (fk - fp).abs().amax(0)
    far = float((gap > 1e-4).float().mean())
    return dict(max_abs_err=float(gap.max()), share_beyond_1e4=far, ok=far <= 1e-3,
                tolerance="flow within 1e-4 px on >= 99.9% of the cells (a gate may flip "
                          "at its threshold)")


def check_flow(a: tuple) -> dict:
    fk = FL.dense_flow(*a)
    fp = FL.dense_flow_plain(*a)
    gap = (fk - fp).abs().amax(-1)
    far = float((gap > 1e-3).float().mean())
    return dict(max_abs_err=float(gap.max()), share_beyond_1e3=far, ok=far <= 2e-3,
                tolerance="whole flow within 1e-3 px on >= 99.8% of the cells")


def check_crf_iteration(a: tuple) -> dict:
    """One K16 iteration from the same Q (the plain plan's Q0)."""
    unary, flow, p, _ = a
    q0, plan_p = CRF.crf_plan_plain(unary, flow, p)
    qk0, plan_k = CRF.crf_plan_cuda(unary, flow, p)
    q1k = CRF.crf_iteration_cuda(q0, unary, plan_k, p)
    q1p = CRF.crf_iteration_plain(q0, unary, plan_p, p)
    err = float((q1k - q1p).abs().max())
    err0 = float((qk0 - q0).abs().max())
    return dict(max_abs_err=err, q0_err=err0, ok=err <= 1e-4 and err0 <= 1e-6,
                tolerance="Q0 within 1e-6; one iteration within 1e-4 (direct windowed box sums "
                          "against cumulative sums, 25 slab taps against a 64-wide contraction)")


CRF_TIE_EPS = 1e-4  # the one-iteration agreement


def _top2_margin(q: torch.Tensor) -> torch.Tensor:
    """[H, W] gap between the largest and the second largest label of Q."""
    top = torch.topk(q, 2, dim=0).values
    return top[0] - top[1]


def check_crf(a: tuple, eps: float = CRF_TIE_EPS) -> dict:
    """All K16 iterations (plan + 10) from the same unary and flow, two ways.

    Step by step: every kernel iteration from the plain chain's previous Q
    agrees with the plain iteration within 1e-4, as one iteration does.
    Free-running: the kernel's chain against the plain chain. Mean field with
    Potts weights of 160 and 40 oscillates and is bistable where labels tie:
    a difference below the one-iteration agreement (direct windowed box sums
    against cumulative sums) settles such a cell on the other label, and its
    neighbours' messages follow. A cell may end on another label only where
    the plain chain's top-two margin fell below ``eps`` in an iteration; the
    share of entries beyond 1e-4 is reported."""
    unary, flow, p, iters = a
    qp, plan_p = CRF.crf_plan_plain(unary, flow, p)
    qk, plan_k = CRF.crf_plan_cuda(unary, flow, p)
    step_err = float((qk - qp).abs().max())
    margin = torch.full_like(qp[0], float("inf"))
    for _ in range(iters):
        forced = CRF.crf_iteration_cuda(qp, unary, plan_k, p)
        qk = CRF.crf_iteration_cuda(qk, unary, plan_k, p)
        qp = CRF.crf_iteration_plain(qp, unary, plan_p, p)
        step_err = max(step_err, float((forced - qp).abs().max()))
        margin = torch.minimum(margin, _top2_margin(qp))
    gap = (qk - qp).abs()
    flipped = qk.argmax(0) != qp.argmax(0)
    off_ties = flipped & (margin >= eps)
    return dict(max_abs_err=float(gap.max()), step_err=step_err,
                argmax_differ=int(flipped.sum()), argmax_differ_off_ties=int(off_ties.sum()),
                flipped_min_margin=margin[flipped].tolist()[:20],
                share_beyond_1e4=float((gap > 1e-4).float().mean()),
                ok=step_err <= 1e-4 and not bool(off_ties.any()),
                tolerance=f"each of the {iters} iterations from the plain chain's Q within "
                          f"1e-4; free-running, a cell's label differs only where the plain "
                          f"chain's top-two margin fell below {eps} in an iteration")


def check_components(a: tuple) -> dict:
    kk, sk = CC.keep_largest_components_cuda(*a)
    kp, sp_ = CC.keep_largest_components_plain(*a)
    differ = int((kk != kp).sum())
    return dict(max_abs_err=float(differ), differing_cells=differ, sizes_kernel=sk.tolist(),
                sizes_plain=sp_.tolist(), ok=differ == 0 and bool((sk == sp_).all()),
                tolerance="kept cells and sizes exact")


# sizes of the hand-made K17 stacks: the legacy CRF's image, the flow-CRF's
# grid, and sides that neither tile side (64, 32) divides
COMPONENT_CASE_HW = ((480, 640), (120, 160), (487, 651))
COMPONENT_LABELS = ("spiral", "equal_sizes", "all_true", "empty", "last_cell", "blobs")


def component_cases(h: int, w: int, device, seed: int = 0) -> torch.Tensor:
    """A hand-made [6, h, w] mask stack for K17 (``COMPONENT_LABELS``):
    0 the spiral of ``components_inputs`` (58 x 58, scaled up three times
    where the image allows) placed off the tile grid, so it crosses tile
    edges and corners; 1 two equal 9 x 9
    squares in different tiles (the lower id, the top one, must win); 2 all
    True (one ball wider than 64 sweeps: it splits); 3 empty; 4 a one-cell
    component on the last row and column; 5 blobs of a smoothed random field."""
    masks = torch.zeros((len(COMPONENT_LABELS), h, w), dtype=torch.bool)
    scale = 3 if min(h, w) >= 3 * 58 + 40 else 1
    sp = _spiral(58, 58).repeat_interleave(scale, 0).repeat_interleave(scale, 1)
    y0, x0 = 29, 47
    masks[0, y0:y0 + sp.shape[0], x0:x0 + sp.shape[1]] = sp
    masks[1, 5:14, w - 20:w - 11] = True
    masks[1, h - 30:h - 21, 7:16] = True
    masks[2] = True
    masks[4, h - 1, w - 1] = True
    g = torch.Generator(device="cpu").manual_seed(seed)
    field = torch.rand((1, 1, h, w), generator=g)
    for _ in range(3):
        field = torch.nn.functional.avg_pool2d(field, 9, stride=1, padding=4)
    masks[5] = field[0, 0] > field.mean()
    return masks.to(device)


def check_components_cases(device) -> dict:
    """K17 on ``component_cases`` at each of ``COMPONENT_CASE_HW`` against the
    plain version on the CPU: kept cells and sizes exact."""
    cases, ok = {}, True
    for h, w in COMPONENT_CASE_HW:
        masks = component_cases(h, w, device)
        kk, sk = CC.keep_largest_components_cuda(masks)
        kp, sp_ = CC.keep_largest_components_plain(masks.cpu())
        differ = (kk.cpu() != kp).flatten(1).sum(1)
        r = dict(differing_cells=dict(zip(COMPONENT_LABELS, differ.tolist())),
                 sizes_kernel=dict(zip(COMPONENT_LABELS, sk.tolist())),
                 sizes_plain=dict(zip(COMPONENT_LABELS, sp_.tolist())),
                 spiral_split=0 < int(sp_[0]) < int(masks[0].sum()),
                 top_square_kept=bool(kp[1, 5:14, w - 20:w - 11].all()),
                 last_cell_kept=bool(kp[4, h - 1, w - 1]) and int(sp_[4]) == 1)
        r["ok"] = (int(differ.sum()) == 0 and bool((sk.cpu() == sp_).all()) and r["spiral_split"]
                   and r["top_square_kept"] and r["last_cell_kept"] and int(sp_[3]) == 0)
        ok = ok and r["ok"]
        cases[f"{h}x{w}"] = r
    return dict(cases=cases, ok=ok, tolerance="kept cells and sizes exact")


def check_seg_unaries(a: tuple) -> dict:
    uk, up = FC.unaries_cuda(*a), FC.unaries_plain(*a)
    errs = {name: float((x.float() - y.float()).abs().max()) for name, x, y in zip(
        uk._fields, uk, up)}
    behind = int((uk.behind != up.behind).sum())
    err = max(errs["p_proj"], errs["unary"], errs["frame_depth_c"])
    return dict(max_abs_err=err, errors=errs, behind_differ=behind, ok=behind == 0 and err <= 1e-6,
                tolerance="behind exact; rows and unaries within 1e-6 (the same expressions)")


def check_seg_fuse(a: tuple) -> dict:
    lk, sk = FC.fuse_labels_cuda(*a)
    lp, sp_ = FC.fuse_labels_plain(*a)
    differ = int((lk != lp).sum())
    return dict(max_abs_err=float(differ), differing_cells=differ,
                ok=differ == 0 and bool((sk == sp_).all()),
                tolerance="labels and label stack exact given equal inputs")


def check_seg_finish(a: tuple) -> dict:
    ok_ = FC.finish_cuda(*a)
    op = FC.finish_plain(*a)
    names = ("mask", "new_label_mask", "has_new_label", "pixel_counts")
    exact = {n: bool((x == y).all()) for n, x, y in zip(names, ok_[:4], op[:4])}
    err = float((ok_[4] - op[4]).abs().max())
    var_err = float((ok_[5] ** 2 - op[5] ** 2).abs().max())
    return dict(max_abs_err=err, var_err=var_err, exact=exact, has_new_label=bool(op[2]),
                ok=all(exact.values()) and err <= 1e-5 and var_err <= 2e-5,
                tolerance="masks, has_new_label and counts exact; depth means within 1e-5 m, "
                          "variances within 2e-5 m^2 (sums in another order; the one-pass "
                          "variance cancels)")


# ---------------------------------------------------------------- K22, K23

def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def check_fern_frame(a: tuple) -> dict:
    fk = FN.fern_frame_cuda(*a)
    fp = FN.fern_frame_plain(*a)
    exact = {n: _bits_equal(x, y) for n, x, y in zip(FN.FernFrame._fields, fk, fp)}
    err = max(_maxerr(x, y) for x, y in zip(fk, fp))
    return dict(max_abs_err=err, exact=exact, valid_px=int((fp.depth > 0).sum()),
                ok=all(exact.values()) and int((fp.depth > 0).sum()) > 0,
                tolerance="colour, vertices, normals and depth equal to the bit (K1's "
                          "vertex and normal arithmetic, -fmad=false)")


def _db_copy(db):
    return FN.FernDB(*(t.clone() for t in db))


def check_fern_encode_hd(a: tuple) -> dict:
    db, frame, _ = a
    rk = FN.encode_hd_cuda(db, frame, True)
    rp = FN.encode_hd_plain(db, frame, True)
    exact = {n: _bits_equal(x, y) for n, x, y in zip(FN.Retrieval._fields, rk, rp)}
    return dict(max_abs_err=_maxerr(rk.sim, rp.sim), exact=exact, keyframes=int(db.count),
                best=int(rp.best), best_sim=float(rp.best_sim),
                ok=all(exact.values()) and int(db.count) > 0,
                tolerance="codes, similarities (integer counts, one division), the first "
                          "argmax and the fetched keyframe equal to the bit")


def check_fern_insert(a: tuple) -> dict:
    db, frame, hd, pose, time, threshold, skip = a
    dk, dp = _db_copy(db), _db_copy(db)
    ik = FN.insert_cuda(dk, frame, hd, pose, time, threshold, skip)
    ip = FN.insert_plain(dp, frame, hd, pose, time, threshold, skip)
    exact = {n: _bits_equal(x, y) for n, x, y in zip(FN.FIELDS, dk, dp)}
    return dict(max_abs_err=max(_maxerr(x, y) for x, y in zip(dk, dp)), exact=exact,
                inserted_kernel=bool(ik), inserted_plain=bool(ip), count_after=int(dp.count),
                ok=all(exact.values()) and bool(ik) == bool(ip),
                tolerance="the decision and every field of the store after it equal")


def check_fern_photo(a: tuple) -> dict:
    ek, ok_k = FN.photo_cuda(*a)
    ep, ok_p = FN.photo_plain(*a)
    e_k, e_p = float(ek), float(ep)
    return dict(max_abs_err=abs(e_k - e_p), photo_kernel=e_k, photo_plain=e_p,
                ok_kernel=bool(ok_k), ok_plain=bool(ok_p),
                ok=e_k == e_p and bool(ok_k) == bool(ok_p),
                tolerance="photometric error equal to the bit (the plain version sums in the "
                          "kernel's block order), the gate decision equal")


def check_deform_points(a: tuple) -> dict:
    ok_, ck = DG.deform_points_cuda(*a)
    op, cp = DG.deform_points_plain(*a)
    nid_eq = _bits_equal(ck.nid, cp.nid)
    err = max(_maxerr(ok_, op), _maxerr(ck.wgt, cp.wgt))
    return dict(max_abs_err=err, nid_equal=nid_eq, points=int(ok_.shape[0]),
                bit_equal=_bits_equal(ok_, op) and _bits_equal(ck.wgt, cp.wgt),
                ok=nid_eq and err <= 1e-6,
                tolerance="node choices exact; weights and positions to the bit or within "
                          "1e-6 (m)")


def check_deform_apply(a: tuple) -> dict:
    data, count, graph, k, gate = a
    dk, dp = data.clone(), data.clone()
    DG.apply_to_map_cuda(dk, count, graph, k, gate)
    DG.apply_to_map_plain(dp, count, graph, k, gate)
    moved = int((dp[:3] != data[:3]).any(0).sum())
    return dict(max_abs_err=_maxerr(dk, dp), bit_equal=_bits_equal(dk, dp), moved_surfels=moved,
                ok=_maxerr(dk, dp) <= 1e-6 and moved > 0,
                tolerance="every surfel to the bit or within 1e-6 (m); some surfel moved")


# ---------------------------------------------------------------- K4 error images, K24

def check_error_images(a: tuple) -> dict:
    """K4's error-image mode against its plain version. The plain version
    transforms the vertices with a contraction (as the reference does), the
    kernel term by term (as its GN sums do): an ulp of the warp coordinate
    moves a bilinear blend that straddles a depth or an intensity step."""
    ik, rk = rgbd.error_images_cuda(*a)
    ip, rp = rgbd.error_images_plain(*a)
    zero_differ = int(((ik == 0) != (ip == 0)).sum() + ((rk == 0) != (rp == 0)).sum())
    err_icp = float((ik - ip).abs().max())
    rel_rgb = float(((rk - rp).abs() / rp.abs().clamp(min=1.0)).max())
    n = ik.numel()
    return dict(max_abs_err=max(err_icp, float((rk - rp).abs().max())), icp_err_m=err_icp,
                rgb_rel_err=rel_rgb, zero_set_differ=zero_differ,
                icp_nonzero=int((ik != 0).sum()), rgb_nonzero=int((rk != 0).sum()),
                icp_beyond_1e5=int(((ik - ip).abs() > 1e-5).sum()),
                bit_equal=_bits_equal(ik, ip) and _bits_equal(rk, rp),
                ok=zero_differ <= 1e-4 * n and err_icp <= 2e-4 and rel_rgb <= 2e-4,
                tolerance="zero sets equal on >= 99.99% of the pixels (a gate may flip at its "
                          "threshold); ICP distances within 2e-4 m and 0.001 diff^2 within "
                          "2e-4 relative (|a-b| / max(|b|, 1)): the plain contraction and the "
                          "kernel's terms round the warp apart by an ulp, and a bilinear blend "
                          "across a depth or an intensity step amplifies it (measured 8.2e-5)")


def _slic_chain(a: tuple):
    """(image, [labels after each assignment], [centres of each pass]) of the
    plain SLIC on the CPU: its sums run in pixel order (the reference's)."""
    image, sp_size, coh, iters = a
    img = image.cpu()
    h, w, _ = img.shape
    grid_hw = SL.grid_shape(h, w, sp_size)
    labels = [SL.grid_labels(h, w, sp_size, "cpu")]
    centres = []
    for _ in range(iters):
        centres.append(SL.slic_centres_plain(img, labels[-1], grid_hw[0] * grid_hw[1]))
        labels.append(SL.slic_assign_plain(img, labels[-1], centres[-1], grid_hw, sp_size, coh))
    centres.append(SL.slic_centres_plain(img, labels[-1], grid_hw[0] * grid_hw[1]))
    return grid_hw, labels, centres


def check_slic_centres(a: tuple) -> dict:
    """Every centres pass of K24a from the plain chain's labels (their boxes
    from ``label_bounds_cuda``), against the plain version's sums in pixel
    order (on the CPU; on the card the plain version's index_add_ adds in
    atomic order)."""
    image, sp_size, _, iters = a
    grid_hw, labels, centres = _slic_chain(a)
    err, equal = 0.0, True
    for it, (lab, cen) in enumerate(zip(labels, centres)):
        ck = SL.slic_centres_cuda(image, None if it == 0 else lab.to(image.device),
                                  cen.shape[0], grid_hw, sp_size).cpu()
        err = max(err, float((ck - cen).abs().max()))
        equal = equal and _bits_equal(ck, cen)
    return dict(max_abs_err=err, bit_equal=equal, passes=iters + 1, ok=equal,
                tolerance="every pass bit-equal to the plain sums in pixel order")


def check_slic_assign(a: tuple) -> dict:
    """Every assignment of K24a from the plain chain's labels and centres,
    and the bounding boxes of its epilogue."""
    image, sp_size, coh, iters = a
    grid_hw, labels, centres = _slic_chain(a)
    differ = box_differ = 0
    for it in range(iters):
        lk, bk = SL.slic_assign_cuda(image, None if it == 0 else labels[it].to(image.device),
                                     centres[it].to(image.device), grid_hw, sp_size, coh)
        differ += int((lk.cpu() != labels[it + 1]).sum())
        box_differ += int((bk.cpu() != SL.label_bounds_plain(labels[it + 1],
                                                             bk.shape[0])).sum())
    return dict(max_abs_err=float(differ + box_differ), differing_pixels=differ,
                differing_box_fields=box_differ, passes=iters,
                ok=differ == 0 and box_differ == 0,
                tolerance="labels exact (the same terms in the same order); bounding boxes exact")


def check_sp_means(a: tuple) -> dict:
    """K24b with the boxes the path handed it (the assignment's) and with its
    own (``label_bounds_cuda``), against the plain sums in pixel order."""
    images, labels, count, grid_hw, bounds = a
    mp = SL.superpixel_means_plain(images.cpu(), labels.cpu(), count.cpu())
    runs = [SL.superpixel_means_cuda(images, labels, grid_hw, b).cpu() for b in (bounds, None)]
    equal = all(_bits_equal(mk, mp) for mk in runs)
    return dict(max_abs_err=max(float((mk - mp).abs().max()) for mk in runs), bit_equal=equal,
                ok=equal, tolerance="bit-equal to the plain sums in pixel order (on the CPU), "
                                    "with the path's boxes and with the kernel's own")


SLIC_CASE_HW = (487, 651)  # a 30 x 40 grid; the last cells own the rows and columns beyond
SLIC_BIG, SLIC_EMPTY, SLIC_REACH = 410, 115, 820  # cells (10, 10), (2, 35), (20, 20)


def slic_label_cases(device, seed: int = 0):
    """Hand-made SLIC inputs at 487x651 (seeded colour): [(name, image,
    labels or None)]. "grid": the regular grid (the last row and column of
    cells own the pixels beyond 480 and 640). "handmade": label 410 owns
    the block of rows and columns 96..255, cells 6..15 (25,600 pixels less
    the speckle below: many chunks of the kernels' lists), which leaves the
    block's other cells nearly empty; label 820 (cell (20, 20)) also owns the cells (15,
    25) and (25, 15), five cells away; 2 % of the pixels take a label up to
    five cells from their own cell (the edge cells' pixels among them);
    label 115 (cell (2, 35)) gives all its pixels to label 114."""
    g = torch.Generator().manual_seed(seed)
    h, w = SLIC_CASE_HW
    sp = SL.SP_SIZE
    gy, gx = SL.grid_shape(h, w, sp)
    image = torch.rand((h, w, 3), generator=g) * 255.0
    lab = SL.grid_labels(h, w, sp, "cpu").clone()
    lab[96:256, 96:256] = SLIC_BIG
    for cy, cx in ((15, 25), (25, 15)):
        lab[cy * sp:(cy + 1) * sp, cx * sp:(cx + 1) * sp] = SLIC_REACH
    flat = lab.view(-1)
    pick = torch.randperm(h * w, generator=g)[:h * w // 50]
    cy = torch.clamp(torch.div(pick // w, sp, rounding_mode="floor"), max=gy - 1)
    cx = torch.clamp(torch.div(pick % w, sp, rounding_mode="floor"), max=gx - 1)
    off = torch.randint(-5, 6, (2, pick.numel()), generator=g)
    flat[pick] = ((cy + off[0]).clamp(0, gy - 1) * gx + (cx + off[1]).clamp(0, gx - 1)).to(
        flat.dtype)
    lab[lab == SLIC_EMPTY] = SLIC_EMPTY - 1
    return [("grid", image.to(device), None), ("handmade", image.to(device), lab.to(device))]


def slic_case_facts(labels: torch.Tensor, grid_hw) -> dict:
    """What a label image exercises: its largest and empty superpixels, the
    farthest a label lies from its pixel's grid cell (in cells), and whether
    pixels beyond the grid's last full cell carry labels of the last row or
    column."""
    h, w = labels.shape
    gy, gx = grid_hw
    sp = SL.SP_SIZE
    count = torch.bincount(labels.reshape(-1).long(), minlength=gy * gx)
    cell = SL.grid_labels(h, w, sp, labels.device)
    reach = torch.maximum((labels // gx - cell // gx).abs(), (labels % gx - cell % gx).abs())
    return dict(largest=int(count.max()), empty=int((count == 0).sum()),
                max_reach_cells=int(reach.max()),
                edge_rows=int((labels[gy * sp:] // gx == gy - 1).sum()),
                edge_cols=int((labels[:, gx * sp:] % gx == gx - 1).sum()))


def check_slic_cases(device, seed: int = 0, n_images=(1, 13, 40)) -> dict:
    """K24a (bounds, centres, assignment) and K24b on ``slic_label_cases``
    against the plain versions on the CPU: boxes and labels exact, sums
    bit-equal; the means for N = 1, 13 and 40 seeded images, with the
    kernel's own boxes and with the plain ones."""
    g = torch.Generator().manual_seed(seed + 1)
    cases, err, ok = {}, 0.0, True
    for name, image, labels in slic_label_cases(device, seed):
        h, w, _ = image.shape
        grid_hw = SL.grid_shape(h, w, SL.SP_SIZE)
        s = grid_hw[0] * grid_hw[1]
        lab_c = SL.grid_labels(h, w, SL.SP_SIZE, "cpu") if labels is None else labels.cpu()
        lab = lab_c.to(device)
        img_c = image.cpu()
        cen = SL.slic_centres_plain(img_c, lab_c, s)
        box = SL.label_bounds_plain(lab_c, s)
        ck = SL.slic_centres_cuda(image, labels, s, grid_hw, SL.SP_SIZE).cpu()
        bk = SL.label_bounds_cuda(lab, s).cpu()
        lk, abk = SL.slic_assign_cuda(image, labels, cen.to(device), grid_hw, SL.SP_SIZE,
                                      SL.COH_WEIGHT)
        lp = SL.slic_assign_plain(img_c, lab_c, cen, grid_hw, SL.SP_SIZE, SL.COH_WEIGHT)
        r = dict(facts=slic_case_facts(lab_c, grid_hw), centres_bit_equal=_bits_equal(ck, cen),
                 bounds_exact=bool((bk == box).all()),
                 assign_differing_pixels=int((lk.cpu() != lp).sum()),
                 assign_bounds_exact=bool((abk.cpu() == SL.label_bounds_plain(lp, s)).all()))
        err = max(err, float((ck - cen).abs().max()))
        for n in n_images:
            images = torch.rand((n, h, w), generator=g)
            mp = SL.superpixel_means_plain(images, lab_c, cen[:, 5])
            ims = images.to(device)
            runs = [SL.superpixel_means_cuda(ims, lab, grid_hw, b).cpu()
                    for b in (None, box.to(device))]
            err = max([err] + [float((mk - mp).abs().max()) for mk in runs])
            r[f"means_bit_equal[N={n}]"] = all(_bits_equal(mk, mp) for mk in runs)
        r["ok"] = (r["centres_bit_equal"] and r["bounds_exact"] and r["assign_bounds_exact"]
                   and r["assign_differing_pixels"] == 0
                   and all(v for k, v in r.items() if k.startswith("means_bit_equal")))
        ok = ok and r["ok"]
        cases[name] = r
    return dict(max_abs_err=err, cases=cases, ok=ok,
                tolerance="boxes and labels exact; centres and means bit-equal to the plain "
                          "sums in pixel order (on the CPU)")


def check_sp_upsample(a: tuple) -> dict:
    uk, up = SL.upsample_onehot_cuda(*a), SL.upsample_onehot_plain(*a)
    differ = int((uk != up).sum())
    return dict(max_abs_err=float(differ), differing_cells=differ, ok=differ == 0,
                tolerance="masks exact")


def check_lcrf_plan(a: tuple) -> dict:
    pk, pp = LC.crf_plan_cuda(*a), LC.crf_plan_plain(*a)
    errs = {n: float((x - y).abs().max()) for n, x, y in zip(pk._fields, pk, pp)}
    exact = {n: _bits_equal(x, y) for n, x, y in zip(pk._fields, pk, pp)}
    ok = exact["unary"] and exact["feat"] and errs["k_smooth"] <= 1e-6 and errs["k_app"] <= 1e-6 \
        and errs["q0"] <= 1e-6
    return dict(max_abs_err=max(errs.values()), errors=errs, exact=exact, ok=ok,
                tolerance="unaries and features exact; kernel matrices and Q0 within 1e-6 "
                          "(expf against the CPU's exp; row sums in another fixed order)")


LCRF_TIE_EPS = 1e-5


def check_lcrf_iterate(a: tuple, iters: int = 1, eps: float = LCRF_TIE_EPS) -> dict:
    """``iters`` K24c mean-field steps from the plain plan, kernel against the
    plain steps (torch.matmul, TF32 off): each step from the plain chain's Q
    within 1e-5; free-running, a superpixel's label differs only where the
    plain chain's top-two margin fell below ``eps``."""
    plan = LC.crf_plan_plain(*a)
    qp = qk = plan.q0
    step_err, lk = 0.0, None
    margin = torch.full((qp.shape[0],), float("inf"), device=qp.device)
    for it in range(iters):
        last = it == iters - 1
        forced, _ = LC.crf_iterate_cuda(qp, plan)
        qk, lk = LC.crf_iterate_cuda(qk, plan, want_labels=last)
        qp = LC.crf_iterate_plain(qp, plan)
        step_err = max(step_err, float((forced - qp).abs().max()))
        top2 = torch.topk(qp, 2, dim=-1).values
        margin = torch.minimum(margin, top2[:, 0] - top2[:, 1])
    flipped = lk.long() != qp.argmax(-1)
    off_ties = flipped & (margin >= eps)
    return dict(max_abs_err=float((qk - qp).abs().max()), step_err=step_err,
                argmax_differ=int(flipped.sum()), argmax_differ_off_ties=int(off_ties.sum()),
                ok=step_err <= 1e-5 and not bool(off_ties.any()),
                tolerance=f"each step from the plain chain's Q within 1e-5; labels differ only "
                          f"where the plain top-two margin fell below {eps}")
