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
    "so3_iteration": ("last_img", "next_img", "cam_l", "state", "verbatim"),
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


def derive_so3(c: dict) -> dict:
    """Add to a capture with an ``so3_iteration`` record the inputs of its
    two halves' standalone kernels (``so3_reduce``, ``so3_step``), which the
    path no longer launches: the same images, camera and state, and the
    sums ``so3_reduce_cuda`` computes from them. Returns ``c``."""
    r = c.get("so3_iteration")
    if r is not None:
        c.setdefault("so3_reduce", {k: r[k] for k in ("last_img", "next_img", "cam_l", "state")})
        if "so3_step" not in c:
            sums = rgbd.so3_reduce_cuda(r["last_img"], r["next_img"], r["cam_l"], r["state"])
            c["so3_step"] = dict(state=r["state"], sums=sums, verbatim=r["verbatim"])
    return c


def derive_backdating(c: dict, seed: int = 0) -> dict:
    """Add to a capture with a ``refine_track_subset`` record the back-dating
    batch with every active track selected (``ransac_fit.every_track``): the
    same table, ticks and shapes as the path's batch, whose fits select no
    track on a frame without a spawn; the uniforms from a generator seeded
    with ``seed``. Returns ``c``."""
    r = c.get("refine_track_subset")
    if r is not None and "ransac_fit.every_track" not in c:
        table, cfg = r["table"], r["ransac_cfg"]
        pa, pb, valid = TR.backdate_pairs(table, table.active, r["time"], r["length"])
        gen = torch.Generator(device=pa.device).manual_seed(seed)
        u = RS.draw_uniforms(gen, r["length"], cfg.iterations, pa.device)
        c["ransac_fit.every_track"] = dict(u=u, p0=pa, p1=pb, valid=valid, cfg=cfg)
    return c


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


def _frame_level_errors(k, p) -> dict:
    """One level of the frame side against the plain version's."""
    if k.img.shape != p.img.shape:
        return dict(max_abs_err=None, shape=list(k.img.shape), plain_shape=list(p.img.shape),
                    ok=False, tolerance="the plain version's level sizes")
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
          and sv_diff <= sob_off)
    return dict(
        max_abs_err=max(depth_err, map_err), depth_err=depth_err, intensity_err=img_err,
        vertex_normal_err=map_err, sobel_off_by_one=sob_off, static_valid_differ=sv_diff,
        vmap_mask_differ=vmask, nmap_mask_differ=nmask, static_valid=int(p.static_valid.sum()),
        ok=ok,
        tolerance="depth, vertices, normals within 1e-5, intensity within 1e-4; vertex/normal "
                  "masks exact; Sobel exact but for <= 0.01% of values off by 1; static "
                  "validity exact but where a Sobel value differs",
    )


def check_pyramid_frame(a: tuple, level: int) -> dict:
    kern, plain = _pyr_frame_pair(a)
    r = _frame_level_errors(kern[level], plain[level])
    r["ok"] = r["ok"] and r["static_valid"] > 0
    return r


def _pred_level_errors(mk, mp) -> dict:
    """One level's sampling map against the plain version's."""
    if mk.shape != mp.shape or mk.dtype != mp.dtype:
        return dict(max_abs_err=None, shape=list(mk.shape), plain_shape=list(mp.shape),
                    ok=False, tolerance="the plain version's level sizes and types")
    if mk.dtype == torch.bfloat16:
        differ = int((mk.view(torch.int16) != mp.view(torch.int16)).sum())
        return dict(max_abs_err=float((mk.float() - mp.float()).abs().max()), bits_differ=differ,
                    ok=differ == 0, tolerance="bf16 sampling map bit-equal")
    geo = float((mk[..., :7] - mp[..., :7]).abs().max())
    img = float((mk[..., 7] - mp[..., 7]).abs().max())
    mask = int(((mk[..., 2] > 0) != (mp[..., 2] > 0)).sum())
    return dict(max_abs_err=max(geo, img), geometry_err=geo, intensity_err=img, mask_differ=mask,
                ok=geo <= 1e-5 and img <= 1e-4 and mask == 0,
                tolerance="f32 map: vertices, normals, depth within 1e-5, intensity within "
                          "1e-4; vertex mask exact")


def check_pyramid_pred(a: tuple, level: int) -> dict:
    mk = LV.pred_levels(*a)[level]
    mp = LV.pred_levels_plain(*a)[level]
    r = _pred_level_errors(mk, mp)
    if mk.dtype == torch.bfloat16:
        r["ok"] = r["ok"] and bool((mp[..., 0] != 0).any())
    return r


def _side_result(levels: list) -> dict:
    errs = [r["max_abs_err"] for r in levels]
    return dict(levels=levels, ok=all(r["ok"] for r in levels),
                max_abs_err=None if None in errs else max(errs),
                tolerance=levels[0]["tolerance"] + ", at every level")


def check_pyramid_frame_side(a: tuple) -> dict:
    """Every level of the frame side (one launch) against the plain version,
    each held to ``check_pyramid_frame``'s tolerance."""
    kern, plain = _pyr_frame_pair(a)
    levels = []
    for k, p in zip(kern, plain):
        r = _frame_level_errors(k, p)
        r["ok"] = r["ok"] and r["static_valid"] > 0
        levels.append(r)
    return _side_result(levels)


def check_pyramid_pred_side(a: tuple) -> dict:
    """Every level's sampling map (one launch) against the plain version, each
    held to ``check_pyramid_pred``'s tolerance."""
    kern, plain = LV.pred_levels(*a), LV.pred_levels_plain(*a)
    levels = [_pred_level_errors(k, p) for k, p in zip(kern, plain)]
    if kern[0].dtype == torch.bfloat16:
        levels[0]["ok"] = levels[0]["ok"] and bool((plain[0][..., 0] != 0).any())
    return _side_result(levels)


# K1's hand-made filter cases: (name, height, width, depth kind, unit). The
# filter's tile is 64 x 8 and writes four pixels a thread as float4 where the
# width is a multiple of 4: 487 x 651 and the small ones divide neither.
FILTER_CASES = (("ragged_mm", 487, 651, "scene", "mm"), ("ragged_m", 487, 651, "scene", "m"),
                ("fern_80x60", 60, 80, "scene", "mm"), ("small_17x23", 17, 23, "scene", "m"),
                ("small_9x11", 9, 11, "scene", "mm"), ("all_zero", 120, 160, "zero", "mm"),
                ("range_edges_m", 120, 160, "edges", "m"),
                ("range_edges_mm", 120, 160, "edges", "mm"))


def _depth_scene(h: int, w: int, rng) -> np.ndarray:
    """Metres: a slanted plane, two boxes nearer, speckle, holes and depth
    beyond the filter's range."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    d = 1.2 + 1.5 * xs / max(w - 1, 1) + 0.6 * ys / max(h - 1, 1)
    d[h // 5:h // 2, w // 6:w // 3] = 0.8
    d[h // 2:4 * h // 5, w // 2:3 * w // 4] -= 0.35
    d += rng.normal(0.0, 0.004, d.shape)
    d[rng.random(d.shape) < 0.03] = 0.0
    d[rng.random(d.shape) < 0.01] = 25.0
    d[:, -max(w // 16, 1):] = 0.0
    return d


def filter_inputs(kind: str, unit: str, h: int, w: int, device, seed: int = 0) -> tuple:
    """The raw depth of one filter case: int16-carried millimetres or metres."""
    rng = np.random.default_rng(seed)
    if kind == "zero":
        d = np.zeros((h, w))
    elif kind == "scene":
        d = _depth_scene(h, w, rng)
    else:  # at, just inside and just outside min_d / max_d, among valid depth
        d = 1.0 + 0.2 * rng.random((h, w))
        lo, hi = (0.3, 20.0) if unit == "m" else (300, 20000)
        near = np.float32(lo), np.nextafter(np.float32(lo), np.float32(1e9))
        far = np.float32(hi), np.nextafter(np.float32(hi), np.float32(0))
        if unit == "mm":  # 299, 300, 301 mm and 19999, 20000, 20001 mm
            near, far = (lo - 1, lo, lo + 1), (hi - 1, hi, hi + 1)
        else:
            near += (np.nextafter(np.float32(lo), np.float32(0)),)
            far += (np.nextafter(np.float32(hi), np.float32(1e9)),)
        vals = np.array(near + far, dtype=np.float64) / (1000.0 if unit == "mm" else 1.0)
        pick = rng.random((h, w)) < 0.3
        d[pick] = rng.choice(vals, size=int(pick.sum()))
    if unit == "mm":
        mm = np.clip(np.round(d * 1000.0), 0, 65535).astype(np.uint16)
        return (torch.from_numpy(mm.view(np.int16).copy()).to(device),)
    return (torch.from_numpy(d.astype(np.float32)).to(device),)


def check_filter_cases(device) -> dict:
    """K1's filter on ``FILTER_CASES`` against the plain version on the same
    device, each held to ``check_frame_depth``'s tolerance."""
    cases, ok = {}, True
    for name, h, w, kind, unit in FILTER_CASES:
        a = filter_inputs(kind, unit, h, w, device)
        r = check_frame_depth(a)
        r["valid"] = int((FM.frame_depth_plain(*a)[1] > 0).sum())
        if kind == "edges":  # the range's edges themselves kept, beyond them dropped
            dm = FM.frame_depth_plain(*a)[0]
            r["at_range_edges"] = int(((dm == FM._MIN_D) | (dm == FM._MAX_D)).sum())
        cases[name] = r
        ok = ok and r["ok"]
    return dict(cases=cases, ok=ok, max_abs_err=max(r["max_abs_err"] for r in cases.values()),
                tolerance="each case within check_frame_depth's tolerance (filtered depth "
                          "within 1e-5 m, its valid mask and the metric depth exact)")


# K2's hand-made cases: (name, height, width, OdometryConfig changes, mask_id).
# Tiles of 8 x 8 at level 2 (32 x 32 at level 0) divide none of the ragged
# sizes, whose levels halve rounding up; 80 x 60 is the fern scale.
PYRAMID_CASES = (
    ("ragged_487x651", 487, 651, {}, 1),
    ("fern_80x60", 60, 80, dict(num_pyr=2, iterations=(10, 5), mask_icp=False, mask_rgb=False,
                                min_grad_magnitudes=(5.0, 3.0)), 0),
    ("small_17x23", 17, 23, {}, 2),
    ("small_9x11", 9, 11, {}, 1),
    ("masks_off", 120, 160, dict(mask_icp=False, mask_rgb=False), 2),
    ("mask_icp_only", 120, 160, dict(mask_rgb=False), 2),
    ("mask_rgb_only", 120, 160, dict(mask_icp=False), 3),
    ("use_rgb_off", 120, 160, dict(icp_weight=100.0), 1),
    ("f32_maps_rgb_only", 120, 160, dict(rgb_only=True), 1),
    ("f32_maps_icp_weight_0", 480, 640, dict(icp_weight=0.0), 0),
)


def pyramid_inputs(h: int, w: int, changes: dict, mask_id: int, device, seed: int = 0):
    """(frame side's arguments, prediction side's) of one K2 case: the depth
    scene (metres, as filtered), a textured colour, model ids 0-3 in blocks,
    and a prediction rendered from a second depth scene (its vertices,
    normals and colour, zeros where it has no depth)."""
    from multimotionfusion_tpu_torch.config import CameraModel, OdometryConfig
    from multimotionfusion_tpu_torch.ops import maps as mapops

    rng = np.random.default_rng(seed)
    f = 525.0 * w / 640.0
    cam = CameraModel(width=w, height=h, fx=f, fy=f, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0)
    cfg = OdometryConfig(**changes)
    depth = _depth_scene(h, w, rng)
    depth[depth > 20.0] = 0.0
    ys, xs = np.mgrid[0:h, 0:w]
    rgb = np.stack([(xs * 7 + ys * 3) % 256, (xs * xs + 5 * ys) % 256,
                    rng.integers(0, 256, (h, w))], -1)
    rgb[rng.random((h, w)) < 0.05] = 0  # black pixels fail the static window
    mask = ((xs * 4) // max(w, 1) + 2 * ((ys * 2) // max(h, 1))) % 4
    frame = (torch.from_numpy(depth.astype(np.float32)).to(device),
             torch.from_numpy(rgb.astype(np.uint8)).to(device),
             torch.from_numpy(mask.astype(np.int32)).to(device), cam, cfg, mask_id)
    pd = torch.from_numpy(_depth_scene(h, w, rng).astype(np.float32))
    pd[pd > 20.0] = 0.0
    v = mapops.create_vmap(pd, cam, 1e9)
    n = mapops.create_nmap(v)
    conf = torch.from_numpy(rng.random((h, w, 1)).astype(np.float32))
    color = torch.from_numpy(rng.integers(0, 256, (h, w, 3)).astype(np.float32))
    pred = (torch.cat([v, conf], -1).contiguous().to(device),
            torch.cat([n, conf], -1).contiguous().to(device), color.to(device), cam, cfg)
    return frame, pred


def check_pyramid_cases(device) -> dict:
    """K2's two sides on ``PYRAMID_CASES`` against the plain versions on the
    same device: every level held to ``check_pyramid_frame``'s and
    ``check_pyramid_pred``'s tolerances (no level need hold a valid pixel)."""
    cases, ok = {}, True
    for name, h, w, changes, mask_id in PYRAMID_CASES:
        fa, pa = pyramid_inputs(h, w, changes, mask_id, device)
        kern, plain = _pyr_frame_pair(fa)
        frame = [_frame_level_errors(k, p) for k, p in zip(kern, plain)]
        pred = [_pred_level_errors(k, p) for k, p in
                zip(LV.pred_levels(*pa), LV.pred_levels_plain(*pa))]
        r = dict(frame=frame, pred=pred, sizes=[list(p.img.shape) for p in plain],
                 ok=len(frame) == len(pred) == fa[4].num_pyr
                 and all(x["ok"] for x in frame + pred))
        cases[name] = r
        ok = ok and r["ok"]
    errs = [x["max_abs_err"] for r in cases.values() for x in r["frame"] + r["pred"]]
    return dict(cases=cases, ok=ok, max_abs_err=None if None in errs else max(errs),
                tolerance="every level of both sides within check_pyramid_frame's and "
                          "check_pyramid_pred's tolerances, at the plain version's sizes")


def check_so3_reduce(a: tuple) -> dict:
    sk = rgbd.so3_reduce_cuda(*a).cpu()
    sp = rgbd.so3_reduce_plain(*a).cpu()
    e = _frob(rgbd._sym(sk[:10], 4), rgbd._sym(sp[:10], 4))
    return dict(max_abs_err=float((sk - sp).abs().max()), rel_frob=e, count_kernel=float(sk[10]),
                count_plain=float(sp[10]), ok=e <= 1e-4 and float(sk[10]) == float(sp[10]) > 0,
                tolerance="4x4 system within 1e-4 relative (Frobenius), count exact")


def check_so3_iteration(a: tuple) -> dict:
    """The one-launch iteration against its two halves' kernels on the card
    (sums and state bit-equal), against the plain versions (so3_reduce's and
    so3_step's tolerances; the plain step on the kernel's sums), and on the
    same state with the loop done (zero sums, the halves' state)."""
    last, nxt, cam_l, state, verbatim = a
    sk, sh = state.clone(), state.clone()
    sums_k = rgbd.so3_iteration_cuda(last, nxt, cam_l, sk, verbatim)
    sums_h = rgbd.so3_reduce_cuda(last, nxt, cam_l, sh)
    rgbd.so3_step_cuda(sh, sums_h, verbatim)
    halves = torch.equal(sums_k, sums_h) and torch.equal(sk, sh)
    done = state.clone()
    done[rgbd.S_SO3_DONE] = 1.0
    dk, dh = done.clone(), done.clone()
    sums_d = rgbd.so3_iteration_cuda(last, nxt, cam_l, dk, verbatim)
    rgbd.so3_step_cuda(dh, torch.zeros_like(sums_d), verbatim)
    done_ok = not bool(sums_d.any()) and torch.equal(dk, dh)
    r = check_so3_reduce((last, nxt, cam_l, state))
    sp = state.clone()
    rgbd.so3_step_plain(sp, sums_k, verbatim)
    sk, sp = sk.cpu(), sp.cpu()
    S = rgbd
    R_err = float((sk[S.S_R:S.S_R + 9] - sp[S.S_R:S.S_R + 9]).abs().max())
    flags = [S.S_SO3_DONE, S.S_SO3_ITERS]
    scal = [S.S_SO3_ERR, S.S_SO3_COUNT, S.S_SO3_LAST_ERR, S.S_SO3_LAST_COUNT]
    serr = _rel(sk[scal], sp[scal])
    step_ok = R_err <= 1e-5 and serr <= 1e-5 and bool((sk[flags] == sp[flags]).all())
    return dict(max_abs_err=max(r["max_abs_err"], R_err), sums_rel_frob=r["rel_frob"],
                rotation_err=R_err, scalars_rel_err=serr, equal_to_halves=halves,
                done_loop_ok=done_ok, ok=r["ok"] and step_ok and halves and done_ok,
                tolerance="sums and state bit-equal to so3_reduce_cuda then so3_step_cuda; a "
                          "done loop's sums zero and its state the halves'; against the plain "
                          "versions: 4x4 system within 1e-4 relative (Frobenius), count exact, "
                          "rotation within 1e-5, errors and counts within 1e-5 relative, done "
                          "flag and iteration count exact")


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


# K19's patch_score cases: (name, height, width, image). The kernel's
# blocks own 32 x 20 tiles: sizes one off them both ways, 487 x 651, an
# image all border (16 x 16) and one smaller than the blur's reach (9 x 11).
# Images: "scene" (smooth shading, edges and noise, 0-255), "constant" (every
# gradient 0), "steps" (step edges of heights around the Sobel taps' whole
# numbers, both signs: truncations toward zero that flip with the sign).
SCORE_CASES = (("ragged_487x651", 487, 651, "scene"), ("engine_480x640", 480, 640, "scene"),
               ("tiny_9x11", 9, 11, "scene"), ("border_16x16", 16, 16, "scene"),
               ("constant_120x160", 120, 160, "constant"), ("steps_120x160", 120, 160, "steps"),
               ("off_19x32", 19, 32, "scene"), ("off_21x32", 21, 32, "steps"),
               ("off_20x31", 20, 31, "scene"), ("off_20x33", 20, 33, "steps"))


def score_inputs(h: int, w: int, kind: str, device, seed: int = 0) -> tuple:
    """``patch_score``'s argument: an [h, w] float32 intensity (0-255)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    if kind == "constant":
        img = np.full((h, w), 117.0)
    elif kind == "steps":  # columns and rows of steps 0.3-3.9 high, up and down
        heights = rng.choice([0.3, 0.6, 0.95, 1.0, 1.05, 1.3, 1.9, 2.0, 2.1, 3.9], 64)
        signs = rng.choice([-1.0, 1.0], 64)
        col = np.cumsum((heights * signs)[(xs // 3).astype(int) % 64] * (xs % 3 == 0), axis=1)
        row = np.cumsum((heights[::-1] * signs)[(ys // 4).astype(int) % 64] * (ys % 4 == 0),
                        axis=0)
        img = 128.0 + col + row
    else:
        img = 100.0 + 60.0 * np.sin(xs / 17.0) * np.cos(ys / 13.0) + rng.normal(0, 4.0, (h, w))
        img[(xs // 23 + ys // 19) % 3 == 0] += 50.0
    img = np.clip(img, 0.0, 255.0).astype(np.float32)
    return (torch.from_numpy(img).to(device),)


def check_score_cases(device) -> dict:
    """K19's patch_score on ``SCORE_CASES`` against the plain version on the
    same device: score and blurred intensity bit-equal."""
    cases, ok = {}, True
    for name, h, w, kind in SCORE_CASES:
        a = score_inputs(h, w, kind, device)
        (sk, bk), (sp, bp) = SP.patch_score_cuda(*a), SP.patch_score_plain(*a)
        r = dict(score_differ=int((sk != sp).sum()), blurred_differ=int((bk != bp).sum()),
                 positive_scores=int((sp > 0).sum()),
                 max_abs_err=max(_maxerr(sk, sp), _maxerr(bk, bp)))
        r["ok"] = _same_bytes(sk, sp) and _same_bytes(bk, bp)
        cases[name] = r
        ok = ok and r["ok"]
    return dict(cases=cases, ok=ok, max_abs_err=max(r["max_abs_err"] for r in cases.values()),
                tolerance="score and blurred intensity bit-equal, every case")


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
    differ = _table_differ(tk, tp)
    pair_differ = 0 if pk is None else sum(int((x != y).sum()) for x, y in zip(pk, pp))
    err = max(_maxerr(tk.p3d, tp.p3d), _maxerr(tk.xy, tp.xy), _maxerr(tk.desc, tp.desc))
    return dict(max_abs_err=err, fields_differ=differ, pair_differ=pair_differ,
                active_tracks=int(tp.active.sum()),
                pairs=0 if pp is None else int(pp[2].sum()),
                ok=sum(differ.values()) == 0 and pair_differ == 0 and int(tp.active.sum()) > 0,
                tolerance="every field of the table and the pair equal")


# ------------------------------------------------- K20 on hand-made tables

TRACK_CASES = ("full", "more_new_than_free", "all_matched", "no_valid", "ring_wrap",
               "ring_wrap_back", "no_depth", "add_only")
MATCH_CASES = ("duplicates", "invalid", "ragged")


def _unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def track_cases(cap: int = 4096, hist: int = 32, k: int = 512, d: int = 64, h: int = 480,
                w: int = 640, seed: int = 0):
    """Hand-made track updates, on the CPU: [(name, table, kps, depth, time,
    cam, cfg, pair)] with the default KeypointConfig's gates (0.7, prune
    below 30 keypoints after 30 ticks). Tables: ``cap`` slots, some free,
    last sightings 0-44 ticks back (so some tracks are outside the ring and
    some stale), random rings and descriptors; keypoints: copies of in-ring
    tracks' descriptors (+ noise) that match, random ones that do not, a few
    at pixel edges and at x.5 (rounded half to even), 90 % valid; depth 0 at
    ~20 % of the pixels. Cases: a full table (every new keypoint dropped);
    more new keypoints than free slots; every keypoint valid and matched;
    no valid keypoint; ``time`` at the ring's last slot (the cleared slot
    wraps to 0) and at its first (the pair's previous slot wraps); no depth
    anywhere; an update without the pair (``add_keypoints``)."""
    from multimotionfusion_tpu_torch.config import CameraModel, KeypointConfig
    from multimotionfusion_tpu_torch.tracking.superpoint import Keypoints

    cfg, cam = KeypointConfig(max_keypoints=k, max_tracks=cap, track_history=hist), \
        CameraModel(width=w, height=h)
    out = []
    for ci, name in enumerate(TRACK_CASES):
        rng = np.random.default_rng(seed * 100 + ci)
        time = {"ring_wrap": 5 * hist - 1, "ring_wrap_back": 5 * hist}.get(name, 1003)
        n_free = {"full": 0, "more_new_than_free": cap // 40}.get(name, cap // 4)
        active = np.ones(cap, bool)
        active[rng.choice(cap, n_free, replace=False)] = False
        # all matched: every active track within the ring, so that each keypoint has one
        last_seen = (time - rng.integers(0, hist if name == "all_matched" else 45, cap)
                     ).astype(np.int32)
        last_seen[~active & (rng.random(cap) < 0.5)] = -1
        nvalid = rng.integers(1, 60, cap).astype(np.int32)
        seen = rng.random((cap, hist)) < 0.6
        has_depth = seen & (rng.random((cap, hist)) < 0.7)
        xy = (rng.random((cap, hist, 2)) * [w, h]).astype(np.float32)
        p3d = np.where(has_depth[..., None], rng.standard_normal((cap, hist, 3)), 0)
        t_desc = _unit_rows(rng, cap, d)
        in_ring = np.flatnonzero(active & (time - last_seen <= hist))
        n_match = {"all_matched": k, "full": k // 3}.get(name, k // 5)
        n_match = min(n_match, in_ring.size)
        q_desc = _unit_rows(rng, k, d)
        q_desc[:n_match] = t_desc[rng.choice(in_ring, n_match, replace=False)]
        if name != "all_matched":
            q_desc[:n_match] += 0.02 * rng.standard_normal((n_match, d)).astype(np.float32)
        kxy = (rng.random((k, 2)) * [w - 1, h - 1]).astype(np.float32)
        kxy[:8] = [[-0.4, 0.5], [w - 0.6, h - 0.5], [2.5, 3.5], [3.5, 2.5], [0, 0],
                   [w - 1, h - 1], [100.5, 200.5], [101.5, 201.5]]
        valid = rng.random(k) < 0.9
        if name == "all_matched":
            valid[:] = True
        if name == "no_valid":
            valid[:] = False
        depth = (0.5 + 3.5 * rng.random((h, w))).astype(np.float32)
        depth[rng.random((h, w)) < 0.2] = 0.0
        if name == "no_depth":
            depth[:] = 0.0
        table = TR.TrackTable(
            xy=torch.from_numpy(xy), p3d=torch.from_numpy(p3d.astype(np.float32)),
            seen=torch.from_numpy(seen), has_depth=torch.from_numpy(has_depth),
            desc=torch.from_numpy(t_desc), last_seen=torch.from_numpy(last_seen),
            nvalid=torch.from_numpy(nvalid), active=torch.from_numpy(active),
            model_id=torch.zeros(cap, dtype=torch.int32))
        kps = Keypoints(xy=torch.from_numpy(kxy), score=torch.zeros(k),
                        desc=torch.from_numpy(q_desc), valid=torch.from_numpy(valid))
        out.append((name, table, kps, torch.from_numpy(depth), time, cam, cfg,
                    name != "add_only"))
    return out


def match_cases(seed: int = 0):
    """Hand-made matches, on the CPU: [(name, q_desc, t_desc, q_valid,
    t_valid, max_dist)]: duplicate descriptors among the tracks and among
    the queries (ties go to the first index), invalid rows and columns, and
    K = 300, T = 1000 (neither a multiple of the 64-wide tile)."""
    rng = np.random.default_rng(seed)
    out = []
    k, t, d = 512, 4096, 64
    tq = _unit_rows(rng, t, d)
    tq[1000:1100] = tq[900:1000]  # each of 100 tracks twice
    tq[2000:2010] = tq[5]  # one descriptor 11 times
    qd = _unit_rows(rng, k, d)
    qd[:100] = tq[900:1000]
    qd[100:110] = tq[5]
    qd[200:250] = qd[250:300]  # queries twice
    qd[250:300] = tq[rng.choice(np.arange(3000, 4000), 50, replace=False)]
    qd[200:250] = qd[250:300]
    out.append(("duplicates", qd, tq, np.ones(k, bool), np.ones(t, bool), 0.7))
    qd2 = tq[rng.choice(t, k, replace=False)] + 0.02 * rng.standard_normal((k, d))
    out.append(("invalid", qd2.astype(np.float32), tq, rng.random(k) < 0.7,
                rng.random(t) < 0.6, 0.7))
    k3, t3 = 300, 1000
    tq3 = _unit_rows(rng, t3, d)
    qd3 = _unit_rows(rng, k3, d)
    qd3[:150] = tq3[rng.choice(t3, 150, replace=False)] + 0.03 * rng.standard_normal((150, d))
    out.append(("ragged", qd3.astype(np.float32), tq3, rng.random(k3) < 0.9,
                rng.random(t3) < 0.9, 0.7))
    return [(n, torch.from_numpy(np.ascontiguousarray(q, np.float32)),
             torch.from_numpy(np.ascontiguousarray(tt, np.float32)), torch.from_numpy(qv),
             torch.from_numpy(tv), g) for n, q, tt, qv, tv, g in out]


def update_pull_emulated(table, kps, depth, time: int, cam, cfg, pair: bool = True):
    """The update as ``csrc/tracks.cu`` computes it, in place on ``table``
    (the plain PyTorch version pushes each keypoint to its track): each
    track takes its row from the query whose column minimum it is, when
    that query's match is this track, or, if the track was free, from the
    r-th unmatched valid keypoint, r being its rank among the free slots
    (none when r is past the new keypoints); then the next ring slot is
    cleared and, with ``pair``, the table pruned and the pair formed."""
    cap, hist = table.capacity, table.history
    t_valid = TR.in_history(table, time)
    match_idx, _ = TR.mutual_match_plain(kps.desc, table.desc, kps.valid, t_valid,
                                         cfg.match_dist_gate)
    d2 = TR.sq_dists(kps.desc, table.desc)
    d2 = torch.where(kps.valid[:, None] & t_valid[None, :], d2, torch.full_like(d2, 1e30))
    colbest = torch.argmin(d2, dim=0)  # first index on ties
    tracks = torch.arange(cap)
    tsrc = torch.where(match_idx.long()[colbest] == tracks, colbest, torch.full_like(colbest, -1))
    free = ~table.active
    rank = torch.cumsum(free.long(), 0) - 1
    inv = torch.nonzero(kps.valid & (match_idx < 0))[:, 0]
    taken = free & (rank < inv.numel())
    new_src = inv[rank.clamp(0, max(inv.numel() - 1, 0))] if inv.numel() else rank
    src = torch.where(tsrc >= 0, tsrc, torch.where(taken, new_src, torch.full_like(rank, -1)))
    rows = torch.nonzero(src >= 0)[:, 0]
    s = src[rows]
    p3d, has_depth = TR.backproject_keypoints(kps, depth, cam)
    slot = time % hist
    table.xy[rows, slot] = kps.xy[s]
    table.p3d[rows, slot] = p3d[s]
    table.seen[rows, slot] = True
    table.has_depth[rows, slot] = has_depth[s]
    table.desc[rows] = kps.desc[s]
    table.last_seen[rows] = time
    table.nvalid[rows] = torch.where(tsrc[rows] >= 0, table.nvalid[rows] + 1,
                                     torch.ones_like(table.nvalid[rows]))
    table.active[rows] = True
    nxt = (time + 1) % hist
    table.seen[:, nxt] = False
    table.has_depth[:, nxt] = False
    if not pair:
        return None
    TR.prune(table, time, cfg)
    return TR.last_pair(table, time)


def _table_differ(ta, tb) -> dict:
    return {f: int((getattr(ta, f) != getattr(tb, f)).sum()) for f in TR.FIELDS}


def check_track_cases(device) -> dict:
    """K20's update (the match and the pull-form update, three launches) on
    ``track_cases`` at the default shapes against the plain version on the
    CPU: the nine fields of the table and the pair exact."""
    cases, ok = {}, True
    for name, table, kps, depth, time, cam, cfg, pair in track_cases():
        tk = TR.TrackTable(*(x.to(device) for x in table))
        kk = type(kps)(*(x.to(device) for x in kps))
        pk = TR.update_cuda(tk, kk, depth.to(device), time, cam, cfg, pair)
        tp = _table_copy(table)
        pp = TR.update_plain(tp, kps, depth, time, cam, cfg, pair)
        differ = _table_differ(TR.TrackTable(*(x.cpu() for x in tk)), tp)
        pair_differ = 0 if pp is None else sum(int((x.cpu() != y).sum()) for x, y in zip(pk, pp))
        new = int((table.active != tp.active).sum())
        r = dict(fields_differ={f: v for f, v in differ.items() if v}, pair_differ=pair_differ,
                 active_before=int(table.active.sum()), active_after=int(tp.active.sum()),
                 pairs=0 if pp is None else int(pp[2].sum()), changed_active=new)
        r["ok"] = sum(differ.values()) == 0 and pair_differ == 0
        ok = ok and r["ok"]
        cases[name] = r
    return dict(cases=cases, ok=ok, max_abs_err=0.0 if ok else None,
                tolerance="every field of the table and the pair exact against the plain "
                          "version on the CPU")


def check_match_cases(device) -> dict:
    """K20's mutual_match on ``match_cases`` against the plain version on the
    CPU: match indices and matched tracks exact."""
    cases, ok = {}, True
    for name, q, t, qv, tv, gate in match_cases():
        mk, tk = TR.mutual_match_cuda(q.to(device), t.to(device), qv.to(device), tv.to(device),
                                      gate)
        mp, tp = TR.mutual_match_plain(q, t, qv, tv, gate)
        r = dict(matches=int((mp >= 0).sum()), differ=int((mk.cpu() != mp).sum()),
                 matched_t_differ=int((tk.cpu() != tp).sum()), shape=[q.shape[0], t.shape[0]])
        r["ok"] = r["differ"] == 0 and r["matched_t_differ"] == 0 and r["matches"] > 0
        ok = ok and r["ok"]
        cases[name] = r
    return dict(cases=cases, ok=ok, max_abs_err=0.0 if ok else None,
                tolerance="match indices and matched tracks exact against the plain version "
                          "on the CPU")


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


def check_ransac_batch(a: tuple) -> dict:
    """A batch of fits: every row bit-equal to a one-fit launch (the batch of
    one) on the same inputs, and the batch against the plain version per row
    with ``check_ransac``'s tolerances."""
    u, p0, p1, valid, cfg = a
    rk, ik = RS.ransac_fit_batch_cuda(u, p0, p1, valid, cfg, want_idx=True)
    rp, ip = RS.ransac_fit_batch_plain(u, p0, p1, valid, cfg, want_idx=True)
    rows_equal = True
    for b in range(u.shape[0]):
        r1, i1 = RS.ransac_fit_cuda(u[b], RS._row(p0, b), RS._row(p1, b), valid[b], cfg,
                                    want_idx=True)
        rows_equal = rows_equal and torch.equal(i1, ik[b]) and all(
            torch.equal(x, getattr(rk, name)[b]) for name, x in r1._asdict().items())
    t_err = _maxerr(rk.transform, rp.transform)
    ek, ep = rk.error.cpu(), rp.error.cpu()
    fin = torch.isfinite(ep)
    e_eq = torch.equal(torch.isinf(ek), torch.isinf(ep)) and bool(
        ((ek[fin] - ep[fin]).abs() <= 1e-6 * ep[fin].abs()).all())
    exact = torch.equal(ik, ip) and torch.equal(rk.inliers, rp.inliers) and \
        torch.equal(rk.num_inliers, rp.num_inliers) and torch.equal(rk.ok, rp.ok)
    return dict(max_abs_err=t_err, fits=int(u.shape[0]),
                hopeless_fits=int(RS.hopeless(valid, cfg).sum()), ok_fits=int(rp.ok.sum()),
                num_inliers=rp.num_inliers.tolist(), rows_equal_one_fit=rows_equal,
                ok=exact and rows_equal and t_err <= 1e-6 and e_eq,
                tolerance="every row bit-equal to a one-fit launch; against the plain version: "
                          "minimal sets, inliers, num_inliers and ok equal, T within 1e-6, error "
                          "within 1e-6 relative")


def check_draws(device, seed: int = 5, c: int = 200) -> dict:
    """The engine's per-fit draws (``draw_uniforms``: a frame's 6 seed fits,
    then its 8 back-dating fits) against 14 sequential ``torch.rand((C, 3))``
    calls on a generator with the same seed: the numbers, the generator's
    state after and its next draw equal."""
    ga = torch.Generator(device=device).manual_seed(seed)
    gb = torch.Generator(device=device).manual_seed(seed)
    batched = torch.cat([RS.draw_uniforms(ga, 6, c, device), RS.draw_uniforms(ga, 8, c, device)])
    seq = torch.stack([torch.rand((c, 3), generator=gb, device=device) for _ in range(14)])
    equal = torch.equal(batched, seq)
    state = torch.equal(ga.get_state(), gb.get_state())
    nxt = torch.equal(torch.rand(4, generator=ga, device=device),
                      torch.rand(4, generator=gb, device=device))
    return dict(draws_equal=equal, state_equal=state, next_draw_equal=nxt,
                ok=equal and state and nxt,
                tolerance="equal (torch.equal): numbers, generator state, next draw")


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
    (uniform scores, radius 4), ``superpoint`` (the heat map of a
    random-weight SuperPoint on a random image), ``few`` (40 bumps: fewer
    peaks than K, the other slots the lowest-index zeros), ``negative``
    (conf_thresh -0.5: two negative plateaus, every pixel a peak, and three
    positive bumps; fewer positive peaks and zeros than K, so negative
    scores fill the last slots, below the zeros) and ``all_pixels`` (K the
    pixel count)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if kind == "plateau":
        heat = torch.zeros((h, w))
        heat[h // 4:3 * h // 4, w // 4:3 * w // 4] = 3.0
        return heat.to(device), 512, 1.0, 4
    if kind == "random":
        return torch.rand((h, w), generator=g).to(device), 512, 0.5, 4
    if kind == "few":
        heat = torch.zeros((h, w))
        ys = torch.randint(0, h, (40,), generator=g)
        xs = torch.randint(0, w, (40,), generator=g)
        heat[ys, xs] = 1.5 + 3.5 * torch.rand((40,), generator=g)
        return heat.to(device), 512, 1.0, 4
    if kind == "negative":
        heat = torch.full((h, w), -0.3)
        heat[:, :w // 2] = -0.2
        for y, x in ((h // 6, w // 8), (h // 2, w // 4), (5 * h // 6, 3 * w // 8)):
            heat[y, x] = 2.0
        return heat.to(device), 512, -0.5, 4
    if kind == "all_pixels":
        return torch.rand((h, w), generator=g).to(device), h * w, 0.0, 4
    torch.manual_seed(seed)
    net = SP.SuperPointNet().to(device).eval()
    img = torch.rand((h, w), generator=g).to(device)
    heat, _ = SP.superpoint_apply(net, img)
    return heat.contiguous(), 512, 0.0, 4


# K19's hand-made top-K cases: (name, nms_inputs kind, height, width);
# plateau_1080p's blocks own chunks past a 16-bit list index and past the
# shared memory that stages a chunk's scores for the ties
TOPK_CASES = (("few_peaks", "few", 480, 640), ("negative_thresh", "negative", 60, 80),
              ("plateau", "plateau", 480, 640), ("ragged", "random", 487, 651),
              ("all_pixels", "all_pixels", 24, 32), ("plateau_1080p", "plateau", 1080, 1920))
# keypoints.cu's select: the cluster's blocks and a chunk's staged bytes at most
SELECT_BLOCKS, SELECT_STAGE_BYTES = 16, 180 * 1024


def topk_case_facts(name: str, a: tuple, plain: tuple) -> dict:
    """What makes each of ``TOPK_CASES`` the case its name says, read off the
    plain version's outputs."""
    heat, k = a[0], a[1]
    _, score, valid = plain
    chunk = ((heat.numel() + SELECT_BLOCKS - 1) // SELECT_BLOCKS + 3) & ~3
    facts = dict(k=k, valid=int(valid.sum()), positive=int((score > 0).sum()),
                 zero=int((score == 0).sum()), negative=int((score < 0).sum()), chunk=chunk)
    ok = {"few_peaks": 0 < facts["valid"] < k,
          "negative_thresh": facts["negative"] > 0 and facts["zero"] > 0
                             and facts["positive"] > 0,
          "plateau": facts["valid"] == k,
          "ragged": heat.shape[0] % 8 != 0 and heat.shape[1] % 32 != 0,
          "all_pixels": k == heat.numel(),
          "plateau_1080p": facts["valid"] == k and chunk > 65536
                           and 4 * chunk > SELECT_STAGE_BYTES
                           and int((heat == score[-1]).sum()) > k}[name]
    facts["ok"] = bool(ok)
    return facts


def check_topk_cases(device) -> dict:
    """K19's ``nms_topk`` on ``TOPK_CASES`` on the card against the plain
    version on the CPU: xy, score (bit for bit) and valid equal in every
    slot."""
    cases, ok = {}, True
    for name, kind, h, w in TOPK_CASES:
        a = nms_inputs(kind, h, w, device)
        xk, sk, vk = (t.cpu() for t in SP.nms_topk_cuda(*a))
        cpu = (a[0].cpu(),) + tuple(a[1:])
        xp, spl, vp = SP.nms_topk_plain(*cpu)
        r = dict(slots_differ=int(((xk != xp).any(-1) | (sk != spl) | (vk != vp)).sum()),
                 facts=topk_case_facts(name, cpu, (xp, spl, vp)))
        r["ok"] = (torch.equal(xk, xp) and _same_bits(sk, spl) and torch.equal(vk, vp)
                   and r["facts"]["ok"])
        ok = ok and r["ok"]
        cases[name] = r
    return dict(cases=cases, ok=ok, max_abs_err=0.0 if ok else None,
                tolerance="xy, score and valid equal in every slot (exact top-k, ties to the "
                          "lower flat index) against the plain version on the CPU")


# ---------------------------------------------------------------- slice 4

def _owner_result(k: list, p: list, M: int) -> dict:
    """K11's owner prep (every level) against the plain version: exact."""
    levels = []
    for kl, pl in zip(k, p):
        same_shape = [tuple(x.shape) == tuple(y.shape) for x, y in zip(kl, pl)]
        differ = [int((x != y).sum()) if ok else x.numel() for x, y, ok in zip(kl, pl, same_shape)]
        levels.append(dict(size=list(pl[0].shape), differ_own_bank_valid=differ,
                           band_pixels=int((pl[1] == M).sum()), valid_pixels=int(pl[2].sum())))
    total = sum(sum(r["differ_own_bank_valid"]) for r in levels)
    return dict(max_abs_err=float(total), levels=levels, ok=total == 0 and len(k) == len(p),
                tolerance="owner, eroded owner and static validity exact, at every level")


def check_owner_prep(a: tuple) -> dict:
    prev_mask, pred_own, frame, gl, cfg, M = a
    scales = [LV._min_scale(cfg, lvl) for lvl in range(len(frame))]
    r = _owner_result(MO.owner_levels_cuda(prev_mask, pred_own, frame, M, scales),
                      MO.owner_levels_plain(prev_mask, pred_own, frame, M, scales), M)
    r["ok"] = r["ok"] and all(x["valid_pixels"] > 0 for x in r["levels"])
    return r


# K11's hand-made owner cases: (name, height, width, levels, models). Owners
# hug every border of the mask and of the prediction (the erosion's wrap at
# work), the mask holds "no owner" ids (M and above), and the sizes lie off
# the kernel's 32 x 8 tile.
OWNER_CASES = (("ragged_487x651", 487, 651, 3, 6), ("engine_480x640", 480, 640, 3, 6),
               ("small_61x37", 61, 37, 3, 4), ("tiny_9x11", 9, 11, 3, 3),
               ("two_levels_120x160", 120, 160, 2, 5), ("one_level_37x61", 37, 61, 1, 2),
               ("one_model_60x80", 60, 80, 3, 1))


def owner_inputs(h: int, w: int, levels: int, M: int, device, seed: int = 0) -> tuple:
    """(prev_mask, pred_own, frame levels, M, min_scales) of one owner case:
    owners 1..4 (mod M) on bands along the top, bottom, left and right
    borders of the mask, a no-owner block (M) and scattered ids M + 2; the
    prediction's owners the mask's moved by (1, 2) pixels, with its own
    top-row band; the frame levels at the mask's size halved rounding up
    (intensity with 10 % zeros, gradients around the gate, depth with 10 %
    zeros)."""
    from multimotionfusion_tpu_torch.config import OdometryConfig

    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    b = max(1, min(h, w) // 8)
    mask = np.zeros((h, w), np.int64)
    mask[ys < b] = 1
    mask[ys >= h - b] = 2
    mask[xs < b] = 3
    mask[xs >= w - b] = 4
    mask %= M
    mask[(ys >= h // 3) & (ys < h // 2) & (xs >= w // 3) & (xs < w // 2)] = M
    mask[rng.random((h, w)) < 0.01] = M + 2
    pred = np.roll(mask, (1, 2), axis=(0, 1)).clip(0, M)
    pred[0, : w // 2] = (pred[0, : w // 2] + 1) % (M + 1)
    cfg = OdometryConfig()
    frame = []
    for hh, ww in LV.level_sizes(h, w, levels):
        img = rng.uniform(0, 255, (hh, ww)).astype(np.float32)
        img[rng.random((hh, ww)) < 0.1] = 0.0
        grads = rng.normal(0, 60, (2, hh, ww)).astype(np.float32)
        depth = rng.uniform(0.3, 4.0, (hh, ww)).astype(np.float32)
        depth[rng.random((hh, ww)) < 0.1] = 0.0
        t = [torch.from_numpy(x).to(device) for x in (depth, img, grads[0], grads[1])]
        frame.append(LV.FrameLevel(*t, None, None, None))
    i32 = lambda x: torch.from_numpy(x.astype(np.int32)).to(device)  # noqa: E731
    return (i32(mask), i32(pred), frame, M,
            [LV._min_scale(cfg, lvl) for lvl in range(levels)])


def check_owner_cases(device) -> dict:
    """K11's owner prep on ``OWNER_CASES`` against the plain version on the
    same device, exact at every level."""
    cases, ok = {}, True
    for name, h, w, levels, M in OWNER_CASES:
        mask, pred, frame, M, scales = owner_inputs(h, w, levels, M, device)
        r = _owner_result(MO.owner_levels_cuda(mask, pred, frame, M, scales),
                          MO.owner_levels_plain(mask, pred, frame, M, scales), M)
        r["ok"] = r["ok"] and len(r["levels"]) == levels
        cases[name] = r
        ok = ok and r["ok"]
    return dict(cases=cases, ok=ok, max_abs_err=0.0 if ok else None,
                tolerance="owner, eroded owner and static validity exact, at every level")


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
    """The kernel cleans a copy of the store in place; the plain version
    returns a new one."""
    data_in = a[0]
    ok_ = FU.clean_flat_cuda(data_in.clone(), *a[1:])
    op = FU.clean_flat_plain(*a)
    alive_diff = int((ok_[sm.ALIVE] != op[sm.ALIVE]).sum())
    err = _rel(ok_, op)
    culled = int(((data_in[sm.ALIVE] > 0) & (op[sm.ALIVE] == 0)).sum())
    return dict(max_abs_err=float((ok_ - op).abs().max()), max_rel_err=err, keep_differ=alive_diff,
                culled_plain=culled, ok=alive_diff == 0 and err <= 1e-6,
                tolerance="ALIVE exact; the whole flat store within 1e-6 relative")


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bytes (a float's sign of zero counts)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


def _case_camera(h: int, w: int):
    from multimotionfusion_tpu_torch.config import CameraModel

    f = 525.0 * w / 640.0
    return CameraModel(width=w, height=h, fx=f, fy=f, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0)


def _case_index(h: int, w: int, n: int, rng, empty_tile: bool) -> np.ndarray:
    """[h, w] ids below ``n``: distinct but for 3 % of pixels that repeat
    their left neighbour's, -1 on 15 % of pixels, on the image's last
    column and (``empty_tile``) on a 40 x 12 rectangle that holds a whole
    32 x 8 tile of the staged kernels wherever it lands."""
    index = rng.permutation(n)[:h * w].reshape(h, w).astype(np.int64)
    dup = rng.random((h, w)) < 0.03
    dup[:, 0] = False
    index[dup] = np.roll(index, 1, axis=1)[dup]
    index[rng.random((h, w)) < 0.15] = -1
    index[:, -1] = -1
    if empty_tile and h >= 24 and w >= 80:
        index[9:21, 33:73] = -1
    return index


# K10's hand-made cases: (name, height, width, window, mode, options). Modes:
# "static" (one confidence threshold), "slot" (the legacy step's gate read
# by pointer), "composite" (winner models in stripes 3 pixels wide and 5
# high, so model boundaries cross every tile; per-model gates). Options:
# "fill" (the fill-in epilogue), "gate" (fill only where the mask is 0),
# "passthrough". Every scene has image-border surfels, repeated ids, empty
# pixels, a plane facing the camera whose surfels all hit a pixel's ray at
# one depth (exact ties, which the strict < breaks by tap order) and parallel
# planes 0 to 64 ulps apart (near ties); the larger ones a whole tile without
# a surfel.
SPLAT_CASES = (
    ("ragged_487x651_w5_static_fill", 487, 651, 5, "static", ("fill",)),
    ("ragged_487x651_w5_composite_gate", 487, 651, 5, "composite", ("fill", "gate")),
    ("w1_37x61_static", 37, 61, 1, "static", ("fill",)),
    ("w3_17x23_composite", 17, 23, 3, "composite", ("fill", "gate")),
    ("w7_61x37_composite", 61, 37, 7, "composite", ("fill", "gate")),
    ("w7_120x160_static_passthrough", 120, 160, 7, "static", ("fill", "passthrough")),
    ("w2_9x11_static_no_fill", 9, 11, 2, "static", ()),
    ("w5_64x96_slot_pointer", 64, 96, 5, "slot", ("fill",)),
    ("w5_48x64_composite_no_gate", 48, 64, 5, "composite", ("fill",)),
    ("w5_480x640_composite_gate", 480, 640, 5, "composite", ("fill", "gate")),
)
SPLAT_TIME, SPLAT_MAX_TIME, SPLAT_TIME_DELTA = 50.0, 52.0, 30.0


def splat_inputs(h: int, w: int, window: int, mode: str, options: tuple, device,
                 seed: int = 0) -> tuple:
    """``splat_resolve_cuda``'s arguments of one case (surfels made on the
    pixels' rays, so neighbouring taps hit inside or outside each disk)."""
    rng = np.random.default_rng(seed)
    cam = _case_camera(h, w)
    npix = h * w
    B = npix + npix // 4 + 7
    index = _case_index(h, w, B, rng, empty_tile=True)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    rx = ((xs - np.float32(cam.cx)) / np.float32(cam.fx)).astype(np.float32)
    ry = ((ys - np.float32(cam.cy)) / np.float32(cam.fy)).astype(np.float32)
    z = (1.2 + 0.8 * xs / max(w - 1, 1) + 0.4 * np.sin(ys / 7.0)
         + rng.normal(0.0, 0.01, (h, w))).astype(np.float32)
    n = np.stack([rng.normal(0.0, 0.2, (h, w)), rng.normal(0.0, 0.2, (h, w)),
                  -np.ones((h, w))]).astype(np.float32)
    plane = (xs < w / 2) & (ys >= h / 2)  # the tie plane: z = 1.5, normal (0, 0, -1)
    z[plane] = np.float32(1.5)
    # near ties: parallel planes 0 to 64 ulps apart, around the resolve's
    # skip margin (a hit more than 2^-20 farther than the best skips)
    near = (xs >= w / 2) & (ys < h / 2)
    ulps = rng.choice(np.array([0, 1, 2, 3, 8, 16, 32, 64], np.int32), size=int(near.sum()))
    z[near] = (np.float32(1.25).view(np.int32) + ulps).view(np.float32)
    facing = plane | near
    n[:, facing] = np.array([[0.0], [0.0], [-1.0]], np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True).astype(np.float32)
    n[:, facing] = np.array([[0.0], [0.0], [-1.0]], np.float32)
    dl = rng.normal(0.0, 1.0, (16, B)).astype(np.float32)
    pix = index >= 0
    cols = index[pix]
    dl[sm.PX, cols] = (rx * z)[pix]
    dl[sm.PY, cols] = (ry * z)[pix]
    dl[sm.PZ, cols] = z[pix]
    for k, ch in enumerate((sm.NX, sm.NY, sm.NZ)):
        dl[ch, cols] = n[k][pix]
    # a disk of 0.3 to 1.6 times the window's reach
    reach = max(window / 2.0, 0.5) * z / np.float32(cam.fx)
    dl[sm.RADIUS, cols] = (reach * rng.uniform(0.3, 1.6, (h, w)))[pix]
    dl[sm.CONF, cols] = rng.uniform(0.0, 20.0, cols.size)
    dl[sm.LAST_T, cols] = rng.integers(0, 60, cols.size)
    dl[sm.INIT_T, cols] = rng.integers(0, 50, cols.size)
    for ch in (sm.CR, sm.CG, sm.CB):
        dl[ch, cols] = rng.integers(0, 256, cols.size)
    dev = device
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    conf_threshold = 5.0
    composite = None
    if mode == "slot":
        conf_threshold = torch.tensor(6.5, dtype=torch.float32, device=dev)
    if mode == "composite":
        M = 4
        own = ((xs.astype(np.int64) // 3) + 2 * (ys.astype(np.int64) // 5)) % M
        own[~pix] = M
        conf_all = rng.uniform(0.0, 12.0, M).astype(np.float32)
        composite = R.Composite(t(conf_all), t(own.astype(np.int32)))
    fill = None
    if "fill" in options:
        depth = rng.uniform(0.3, 4.0, (h, w)).astype(np.float32)
        depth[rng.random((h, w)) < 0.1] = 0.0
        frame = rng.normal(0.0, 1.0, (16, npix)).astype(np.float32)
        gate = None
        if "gate" in options:
            gate = t(np.where(rng.random((h, w)) < 0.5, 0, 1 + (xs.astype(np.int64) // 7) % 3)
                     .astype(np.int32))
        fill = R.FillFrame(t(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)), t(depth),
                           t(frame), 3.0, "passthrough" in options, gate)
    return (t(index.astype(np.int32)), t(dl), cam, conf_threshold, SPLAT_TIME, SPLAT_MAX_TIME,
            SPLAT_TIME_DELTA, window, fill, composite)


def splat_plain(a: tuple):
    """The plain version's maps of a K10 case: with fill-in, the filled
    colour, vertex and normal maps beside the prediction's time and valid."""
    if a[8] is None:
        return R.splat_resolve_plain(*a[:8], composite=a[9])
    pred, filled = fillin.splat_fill_plain(*a)
    return R.PredictedMaps(filled.color, filled.vertex_conf, filled.normal_rad, pred.time,
                           pred.valid)


def check_splat_cases(device) -> dict:
    """K10 on ``SPLAT_CASES`` against the plain version on the same device:
    colour, vertex+conf, normal+radius, time and valid bit for bit."""
    cases, ok = {}, True
    for name, h, w, window, mode, options in SPLAT_CASES:
        a = splat_inputs(h, w, window, mode, options, device)
        k, p = R.splat_resolve_cuda(*a), splat_plain(a)
        equal = {f: _same_bytes(x, y) for f, x, y in zip(k._fields, k, p)}
        r = dict(equal=equal, valid=int(p.valid.sum()),
                 max_abs_err=max(_maxerr(x, y) for x, y in zip(k, p)),
                 ok=all(equal.values()) and int(p.valid.sum()) > 0)
        cases[name] = r
        ok = ok and r["ok"]
    return dict(cases=cases, ok=ok, max_abs_err=max(r["max_abs_err"] for r in cases.values()),
                tolerance="every output bit-equal to the plain version")


# K14 clean's hand-made cases: (name, height, width, window; the engine's is
# 4, which the kernel compiles as a fixed window). Each is a flat store of
# four models (a 4096-slot global segment, three 1024-slot object segments)
# whose index map's winners belong to the winner-model image's model (stripes
# across every tile), with a stack of near-coplanar winners (redundancy culls),
# a stack of winners seen this frame behind their neighbours (z culls), depth
# in front of and behind the winners (see-through penalties; most rows keep a
# penalty of exactly 1), rows past each segment's count with a stale non-zero
# ALIVE, rows whose ALIVE is +0 or -0, unstable and inactive rows.
CLEAN_FLAT_CASES = (("ragged_37x61", 37, 61, 4), ("ragged_47x97", 47, 97, 4),
                    ("tile_exact_32x64", 32, 64, 4), ("small_9x11", 9, 11, 4),
                    ("w5_37x61", 37, 61, 5))
CLEAN_LAYOUT = dict(bg=4096, bo=1024, slots=3)
CLEAN_TIME = 60.0


def clean_flat_inputs(h: int, w: int, device, seed: int = 0, window: int = 4) -> tuple:
    """``clean_flat_cuda``'s arguments of one case."""
    from multimotionfusion_tpu_torch.config import SurfelConfig

    rng = np.random.default_rng(seed)
    cam = _case_camera(h, w)
    layout = R.FlatLayout(**CLEAN_LAYOUT)
    M, total = layout.n_models, layout.total
    bases = layout.bases
    ys, xs = np.mgrid[0:h, 0:w]
    win = (xs // 3 + 2 * (ys // 5)) % M
    # each pixel's winner from its model's segment (distinct but for repeats)
    index = np.full((h, w), -1, np.int64)
    for m in range(M):
        sel = win == m
        size = bases[m + 1] - bases[m]
        index[sel] = bases[m] + np.resize(rng.permutation(size), int(sel.sum()))
    dup = (rng.random((h, w)) < 0.03) & (xs > 0)
    dup &= np.roll(win, 1, axis=1) == win
    index[dup] = np.roll(index, 1, axis=1)[dup]
    empty = rng.random((h, w)) < 0.15
    if h >= 24 and w >= 48:
        empty[8:20, 0:40] = True  # a whole 32 x 8 tile without a winner
    index[empty] = -1
    win = np.where(index >= 0, win, M)
    u = rng.random((h, w))
    z = 1.0 + 0.3 * xs / max(w - 1, 1) + rng.normal(0.0, 0.002, (h, w))
    init = rng.integers(0, 50, (h, w)).astype(np.float64)
    last = rng.integers(20, 61, (h, w)).astype(np.float64)
    red = (ys < h // 2) & (xs < w // 2)  # near-coplanar, older in front
    z[red] = 1.0 + 0.009 * u[red]
    init[red] = 100.0 - 90.0 * u[red]
    zst = (ys >= h // 2) & (xs >= w // 2)  # seen this frame, spread in depth
    z[zst] = 1.0 + 0.05 * u[zst]
    last[zst & (u > 0.3)] = CLEAN_TIME
    dl = rng.normal(0.0, 1.0, (16, total)).astype(np.float32)
    pix = index >= 0
    cols = index[pix]
    f = 525.0 * w / 640.0
    dl[sm.PX, cols] = ((xs - (w - 1) / 2.0) / f * z)[pix]
    dl[sm.PY, cols] = ((ys - (h - 1) / 2.0) / f * z)[pix]
    dl[sm.PZ, cols] = z[pix]
    dl[sm.INIT_T, cols] = init[pix]
    dl[sm.LAST_T, cols] = last[pix]
    dl[sm.CONF, cols] = rng.uniform(0.0, 12.0, cols.size)
    dl[sm.RADIUS, cols] = rng.uniform(0.001, 0.02, cols.size)
    dl[sm.NZ, cols] = np.where(rng.random(cols.size) < 0.8, -0.95, -0.5)
    depth = (z + np.where(rng.random((h, w)) < 0.2, rng.uniform(0.04, 0.5, (h, w)),
                          rng.uniform(-0.2, 0.02, (h, w)))).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = 0.0
    data = rng.normal(0.0, 1.0, (16, total)).astype(np.float32)
    data[sm.CONF] = rng.uniform(0.0, 15.0, total)
    data[sm.LAST_T] = rng.integers(0, 61, total)
    data[sm.LAST_T, rng.random(total) < 0.05] = 0.0
    data[sm.ALIVE] = np.where(rng.random(total) < 0.9, 1.0, 0.0)
    data[sm.ALIVE, rng.random(total) < 0.02] = -0.0
    counts = np.array([int((bases[m + 1] - bases[m]) * q) for m, q in
                       enumerate((0.9, 0.75, 0.5, 1.0))], np.int32)
    conf_all = np.array([5.0, 0.5, 2.0, 8.0], np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    cfg = SurfelConfig(time_delta=25, assoc_window=window)
    return (t(data), t(counts), layout, t(index.astype(np.int32)), t(dl),
            t(win.astype(np.int32)), t(depth), t(conf_all), cam, CLEAN_TIME,
            float(cfg.time_delta), cfg)


def clean_flat_case_facts(a: tuple, out: torch.Tensor) -> dict:
    """What a case exercises, from the plain version's store ``out``."""
    data, counts, layout = a[0], a[1], a[2]
    pos = layout.pos_in_seg(data.device)
    past = pos >= counts.to(data.device)[layout.seg_model(data.device).long()]
    pen, voted, keep = FU.clean_flat_verdicts(*a)
    return dict(
        rows=layout.total, penalised=int((pen != 1.0).sum()), cull_votes=int(voted.sum()),
        culled=int(((data[sm.ALIVE] > 0) & ~past & ~keep).sum()),
        stale_past_count=int((past & (data[sm.ALIVE] != 0)).sum()),
        stale_cleared=int((past & (data[sm.ALIVE] != 0) & (out[sm.ALIVE] == 0)).sum()),
        alive_pen_exactly_1=int(((pen == 1.0) & keep).sum()))


def check_clean_flat_cases(device) -> dict:
    """K14's clean on ``CLEAN_FLAT_CASES``: the kernel (in place, on a copy)
    against the plain version on the same device, the whole store bit for
    bit."""
    cases, ok = {}, True
    for name, h, w, window in CLEAN_FLAT_CASES:
        a = clean_flat_inputs(h, w, device, window=window)
        p = FU.clean_flat_plain(*a)
        k = FU.clean_flat_cuda(a[0].clone(), *a[1:])
        r = dict(equal=_same_bytes(k, p), max_abs_err=_maxerr(k, p),
                 **clean_flat_case_facts(a, p))
        r["ok"] = r["equal"] and r["penalised"] > 0 and r["cull_votes"] > 0 \
            and r["stale_cleared"] > 0
        cases[name] = r
        ok = ok and r["ok"]
    return dict(cases=cases, ok=ok, max_abs_err=max(r["max_abs_err"] for r in cases.values()),
                tolerance="the whole cleaned store bit-equal to the plain version")


# ---------------------------------------------------------------- flow-CRF

def _depths_result(dk, dp, scratch_clean: bool) -> dict:
    """K13's depth against the plain version's: coverage exact, depth within
    one log-depth bin (the kernel's log2f and the plain version's log2 may
    round a bin edge apart), and the kernel's scratch all KEY_INVALID after
    the call."""
    cover_diff = int(((dk > 0) != (dp > 0)).sum())
    rel = float(((dk - dp).abs() / dp.clamp(min=1e-6)).max()) if dp.numel() else 0.0
    return dict(max_abs_err=float((dk - dp).abs().max()) if dp.numel() else 0.0,
                max_rel_err=rel, coverage_differ=cover_diff, covered=int((dp > 0).sum()),
                bins_differ=int((dk != dp).sum()), scratch_clean=scratch_clean,
                ok=cover_diff == 0 and rel <= 6e-6 and scratch_clean,
                tolerance="coverage exact; depth within one log-depth bin (6e-6 relative); "
                          "the keys' scratch all KEY_INVALID after the call")


def depth_scratch_clean(a: tuple) -> bool:
    """Whether K13's scratch for these arguments holds only KEY_INVALID."""
    st, cam_c = a[0], a[4]
    keys = R.depth_scratch(st.gdata.device, (1 + st.odata.shape[0]) * cam_c.height * cam_c.width)
    return bool((keys == 2**31 - 1).all())


def check_render_depths(a: tuple) -> dict:
    """K13: coverage exact; depth equal (both quantise the same expression;
    one log-depth bin, 5.3e-6 relative, tolerated); its scratch clean."""
    dk = R.render_depths_cuda(*a)
    r = _depths_result(dk, R.render_depths_plain(*a), depth_scratch_clean(a))
    r["ok"] = r["ok"] and r["covered"] > 0
    return r


# K13's hand-made cases: (name, CRF rows, CRF columns, global bucket, object
# bucket, slots, global stride, object stride, counts, extras). Counts:
# "zero" (every model empty), "full" (every bucket full), "part" (partly,
# the global map's count odd). Extras: "one_cell" (every surfel projects to
# one cell), "edges" (surfels with z exactly at the model's max depth and an
# ulp past it, z = 0 and behind the camera, u and v exactly halfway between
# two cells, time - last_t exactly the window and past it), "conf" (gates
# some surfels miss: the miss bit set). 122 x 163 with 3 models leaves the
# decode a partial vector of 4 cells; an object stride of 2 over an odd
# bucket starts slot 1 at its position 1.
DEPTH_CASES = (
    ("engine_120x160", 120, 160, 1 << 19, 1 << 16, 5, 2, 1, "part", ()),
    ("zero_counts", 120, 160, 4096, 1024, 5, 2, 1, "zero", ()),
    ("full_buckets", 120, 160, 4096, 1024, 5, 2, 1, "full", ()),
    ("one_model", 120, 160, 8192, 0, 0, 2, 1, "part", ()),
    ("slots_31", 60, 80, 2048, 512, 31, 2, 1, "part", ("conf",)),
    ("strides_1_1", 60, 80, 3000, 777, 3, 1, 1, "part", ()),
    ("strides_1_2_odd_bucket", 60, 80, 3000, 1001, 3, 1, 2, "part", ()),
    ("strides_2_2", 60, 80, 3001, 1001, 2, 2, 2, "full", ()),
    ("one_cell", 60, 80, 4096, 1024, 3, 2, 1, "full", ("one_cell",)),
    ("edges", 60, 80, 512, 256, 2, 1, 1, "full", ("edges",)),
    ("conf_miss", 120, 160, 8192, 2048, 4, 2, 1, "part", ("conf",)),
    ("ragged_122x163", 122, 163, 8192, 2048, 2, 2, 1, "part", ()),
)
DEPTH_TIME, DEPTH_TIME_DELTA = 10.0, 1.0


def _depth_camera(hc: int, wc: int):
    """A CRF camera whose projection of the edge surfels is exact in float32
    (focal length 32, centre on whole pixels)."""
    from multimotionfusion_tpu_torch.config import CameraModel

    return CameraModel(width=wc, height=hc, fx=32.0, fy=32.0, cx=float(wc // 2),
                       cy=float(hc // 2))


def depth_inputs(hc: int, wc: int, bg: int, bo: int, slots: int, gs: int, os: int, counts: str,
                 extras: tuple, device, seed: int = 0) -> tuple:
    """``render_depths``' arguments for one hand-made case: every column a
    surfel in front of its model's camera over the CRF grid (95 % alive,
    10 % outside the time window, 5 % behind the camera, 5 % past the max
    depth), the global map at the identity, each slot at a small rotation
    and translation (its surfels stored in the model's frame)."""
    rng = np.random.default_rng(seed)
    M = 1 + slots
    cam = _depth_camera(hc, wc)

    def store(n, m):
        u = rng.uniform(-0.5, wc - 0.5, n)
        v = rng.uniform(-0.5, hc - 0.5, n)
        if "one_cell" in extras:
            u = rng.uniform(wc // 3 - 0.4, wc // 3 + 0.4, n)
            v = rng.uniform(hc // 3 - 0.4, hc // 3 + 0.4, n)
        z = rng.uniform(0.5, 4.0, n)
        z[rng.random(n) < 0.05] *= -1.0
        z[rng.random(n) < 0.05] = 6.0
        d = np.zeros((16, n), np.float64)
        d[sm.PX] = (u - cam.cx) * z / cam.fx
        d[sm.PY] = (v - cam.cy) * z / cam.fy
        d[sm.PZ] = z
        d[sm.CONF] = rng.uniform(0.0, 4.0, n)
        d[sm.LAST_T] = DEPTH_TIME - rng.choice([0.0, 0.5, 1.0, 1.5], n, p=[0.6, 0.2, 0.1, 0.1])
        d[sm.ALIVE] = (rng.random(n) < 0.95).astype(np.float64)
        d[sm.RADIUS] = 0.01
        return d

    def pose(m):  # model -> camera: the identity for the global map
        if m == 0:
            return np.eye(4)
        a = rng.normal(0, 0.05, 3)
        c, s_ = np.cos(a), np.sin(a)
        Rz = np.array([[c[2], -s_[2], 0], [s_[2], c[2], 0], [0, 0, 1]])
        Ry = np.array([[c[1], 0, s_[1]], [0, 1, 0], [-s_[1], 0, c[1]]])
        T = np.eye(4)
        T[:3, :3] = Rz @ Ry
        T[:3, 3] = rng.normal(0, 0.05, 3)
        return T

    T_inv = np.stack([pose(m) for m in range(M)])  # world (model) -> camera

    def to_model(d, Ti):  # camera-frame columns into the model's frame
        out = d.copy()
        Tw = np.linalg.inv(Ti)
        out[:3] = Tw[:3, :3] @ d[:3] + Tw[:3, 3:4]
        return out

    gdata = to_model(store(bg, 0), T_inv[0])
    odata = np.stack([to_model(store(bo, m + 1), T_inv[m + 1]) for m in range(slots)]) \
        if slots else np.zeros((0, 16, bo))
    maxd = np.array([5.0] + [4.5 - 0.25 * (m % 4) for m in range(slots)], np.float32)
    conf = np.zeros(M, np.float32)
    if "conf" in extras:
        conf = np.array([1.0 + 0.5 * (m % 3) for m in range(M)], np.float32)
    if "edges" in extras:  # the global map at the identity: camera-frame values exact
        z32 = np.float32(maxd[0])
        k = 0
        edge = []
        for z in (z32, np.nextafter(z32, np.float32(9.0)), np.float32(0.0), np.float32(-1.0)):
            edge.append((5.0, 7.0, z, DEPTH_TIME))
        for u, v in ((-0.5, 3.0), (wc - 0.5, 3.0), (10.5, 3.0), (11.5, 4.0), (6.0, -0.5),
                     (6.0, hc - 0.5), (7.0, 12.5), (8.0, 13.5)):
            edge.append((u, v, np.float32(2.0), DEPTH_TIME))
        edge.append((20.0, 20.0, np.float32(2.0), DEPTH_TIME - DEPTH_TIME_DELTA))
        edge.append((21.0, 20.0, np.float32(2.0), DEPTH_TIME - DEPTH_TIME_DELTA - 0.5))
        for u, v, z, last in edge:
            zz = np.float64(z)
            gdata[:, k] = 0.0
            gdata[sm.PX, k] = (u - cam.cx) * (zz if zz > 0 else 1.0) / cam.fx
            gdata[sm.PY, k] = (v - cam.cy) * (zz if zz > 0 else 1.0) / cam.fy
            gdata[sm.PZ, k] = zz
            gdata[sm.LAST_T, k] = last
            gdata[sm.ALIVE, k] = 1.0
            k += gs
    caps = [bg] + [bo] * slots
    if counts == "zero":
        cnt = [0] * M
    elif counts == "full":
        cnt = caps
    else:
        cnt = [max(0, (c * (3 + m % 4)) // 7) | 1 if c else 0 for m, c in enumerate(caps)]
    def f32(x):  # a fresh tensor: numpy's strides of an empty store are 0
        return torch.zeros(x.shape, dtype=torch.float32, device=device).copy_(
            torch.from_numpy(np.asarray(x, np.float32)))

    st = R.DepthStores(f32(gdata), f32(odata.reshape(slots, 16, bo)),
                       torch.tensor(cnt, dtype=torch.int32, device=device), bg, bo, gs, os)
    return (st, f32(T_inv), f32(maxd), f32(conf), cam, DEPTH_TIME, DEPTH_TIME_DELTA)


def check_depth_cases(device) -> dict:
    """K13 on ``DEPTH_CASES`` against the plain version on the same device,
    held to ``check_render_depths``' tolerance, its scratch clean after each
    call."""
    cases, ok = {}, True
    for name, *spec in DEPTH_CASES:
        a = depth_inputs(*spec, device)
        r = _depths_result(R.render_depths_cuda(*a), R.render_depths_plain(*a),
                           depth_scratch_clean(a))
        cases[name] = r
        ok = ok and r["ok"]
    return dict(cases=cases, ok=ok, max_abs_err=max(r["max_abs_err"] for r in cases.values()),
                tolerance="coverage exact; depth within one log-depth bin (6e-6 relative); "
                          "the keys' scratch all KEY_INVALID after every call, every case")


def check_flow(a: tuple) -> dict:
    """K15 as a whole (one cluster launch) against the plain version on the
    same device: the same taps and sums in the same order."""
    fk = FL.dense_flow(*a)
    fp = FL.dense_flow_plain(*a)
    gap = (fk - fp).abs().amax(-1)
    return dict(max_abs_err=float(gap.max()), cells_differ=int((fk != fp).any(-1).sum()),
                ok=bool(torch.equal(fk, fp)), tolerance="the whole flow bit-equal")


# the inputs' full resolution and CRF grid of the flow cases: chip_smoke's
# 640x480 at 1/4, a grid whose 121 rows do not divide by the cluster, and
# 640x480 at 1/2, whose bands do not fit a block's shared memory
FLOW_CASE_SIZES = ((480, 640, 120, 160), (487, 651, 121, 162), (480, 640, 240, 320))


def flow_case_inputs(H: int, W: int, seed: int = 0):
    """(prev, next) [H, W] intensities 0..255 on the CPU: a smooth texture
    with fine noise, the next image the texture moved by (1.6, -0.9) px,
    with a square a third of the image high moved by (-3.2, 2.4) px."""
    rng = np.random.default_rng(seed)
    ph = rng.random(4) * 6.28

    def tex(x, y):
        return (128 + 50 * np.sin(0.043 * x + ph[0] + 0.8 * np.sin(0.017 * y + ph[1]))
                + 35 * np.cos(0.061 * y + ph[2] + 0.5 * np.sin(0.023 * x + ph[3]))
                + 20 * np.sin(0.21 * x) * np.cos(0.17 * y))

    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    noise = 3 * rng.standard_normal((H, W))
    prev = tex(x, y) + noise
    box = (abs(x - W / 2) < H / 6) & (abs(y - H / 2) < H / 6)
    nxt = np.where(box, tex(x + 3.2, y - 2.4), tex(x - 1.6, y + 0.9)) + noise
    f = lambda a: torch.from_numpy(np.clip(a, 0, 255).astype(np.float32))  # noqa: E731
    return f(prev), f(nxt)


def check_flow_cases(device) -> dict:
    """K15 on ``flow_case_inputs`` at each of ``FLOW_CASE_SIZES`` (the last
    with the blocks' state in global scratch) against ``dense_flow_plain``
    on the CPU: bit-equal."""
    cases, ok = {}, True
    for H, W, hc, wc in FLOW_CASE_SIZES:
        prev, nxt = flow_case_inputs(H, W)
        fp = FL.dense_flow_plain(prev, nxt, hc, wc)
        fk = FL.dense_flow_cuda(prev.to(device), nxt.to(device), hc, wc).cpu()
        r = dict(max_abs_err=float((fk - fp).abs().max()),
                 cells_differ=int((fk != fp).any(-1).sum()),
                 mean_flow=[float(v) for v in fp.mean((0, 1))])
        r["ok"] = bool(torch.equal(fk, fp))
        ok = ok and r["ok"]
        cases[f"{H}x{W}->{hc}x{wc}"] = r
    return dict(cases=cases, ok=ok, max_abs_err=0.0 if ok else None,
                tolerance="the whole flow bit-equal to the plain version on the CPU")


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


def _unaries_result(uk, up) -> dict:
    errs = {name: float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
            for name, x, y in zip(uk._fields, uk, up)}
    behind = int((uk.behind != up.behind).sum())
    err = max(errs["p_proj"], errs["unary"], errs["frame_depth_c"])
    return dict(max_abs_err=err, errors=errs, behind_differ=behind, ok=behind == 0 and err <= 1e-6,
                tolerance="behind exact; rows and unaries within 1e-6 (the same expressions)")


def check_seg_unaries(a: tuple) -> dict:
    return _unaries_result(FC.unaries_cuda(*a), FC.unaries_plain(*a))


# K18's hand-made unary cases: (name, CRF rows, CRF columns, pixels a cell,
# models, tracks, allow_new). The kernel's blocks own 160 cells each: 121 x
# 163 leaves the last block partial; 31 models, the most it takes, fill the
# most shared memory; a block locates 4,096 tracks a round, so 9,000 take three;
# tracks may be none, all in one cell, or clamped from outside the image;
# velocities hold inf and NaN, models are inactive.
UNARY_CASES = (("engine_120x160", 120, 160, 4, 6, 4096, True),
               ("no_tracks", 120, 160, 4, 6, 0, True), ("no_new", 120, 160, 4, 6, 4096, False),
               ("ragged_121x163", 121, 163, 4, 3, 700, True),
               ("one_cell", 60, 80, 2, 4, 300, True), ("models_31", 30, 40, 4, 31, 4096, True),
               ("tracks_9000", 60, 80, 2, 4, 9000, True))


def unaries_inputs(hc: int, wc: int, k: int, M: int, T: int, allow_new: bool, one_cell: bool,
                   device, seed: int = 0) -> tuple:
    """``unaries``' arguments for one hand-made case: depth (10 % zeros) and
    each model's cell depth near it, in front or behind (20 % uncovered),
    every third model inactive, tracks over the image and 5 % outside it
    (all in cell (3, 5) for ``one_cell``), 70 % valid, velocities around the
    threshold with inf and NaN."""
    from multimotionfusion_tpu_torch.config import SegmentationConfig

    rng = np.random.default_rng(seed)
    cfg = SegmentationConfig(scale=1.0 / k)
    h, w = hc * k, wc * k
    depth = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = 0.0
    fd = depth.reshape(hc, k, wc, k)[:, k // 2, :, k // 2]
    pred = (fd[None] + rng.normal(0, 2 * cfg.sigma_depth, (M, hc, wc))).astype(np.float32)
    pred[rng.random((M, hc, wc)) < 0.2] = 0.0
    active = np.arange(M) % 3 != 2
    active[0] = True
    xy = np.stack([rng.uniform(-0.05 * w, 1.05 * w, T), rng.uniform(-0.05 * h, 1.05 * h, T)], -1)
    if one_cell:
        xy[:] = (5 * k, 3 * k)
    vel = rng.uniform(0, 2 * cfg.velocity_threshold, (M, T))
    vel[rng.random((M, T)) < 0.03] = np.inf
    vel[rng.random((M, T)) < 0.03] = np.nan
    valid = rng.random(T) < 0.7
    def t(x, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)

    return (t(depth), t(pred), t(active, torch.bool), t(xy.reshape(T, 2)), t(vel.reshape(M, T)),
            t(valid, torch.bool), cfg, allow_new)


def check_unaries_cases(device) -> dict:
    """K18's unaries on ``UNARY_CASES`` against the plain version on the
    same device, held to ``check_seg_unaries``' tolerance."""
    cases, ok = {}, True
    for name, hc, wc, k, M, T, allow_new in UNARY_CASES:
        a = unaries_inputs(hc, wc, k, M, T, allow_new, name == "one_cell", device)
        up = FC.unaries_plain(*a)
        r = _unaries_result(FC.unaries_cuda(*a), up)
        r["known_cells"] = int(torch.isfinite(FC.sparse_unary(
            a[3], a[4], a[5], a[2], hc, wc, a[6].scale, a[6].velocity_threshold,
            allow_new)).any(0).sum())
        cases[name] = r
        ok = ok and r["ok"]
    errs = [r["max_abs_err"] for r in cases.values()]
    return dict(cases=cases, ok=ok, max_abs_err=max(errs),
                tolerance="behind exact; rows and unaries within 1e-6, every case")


def check_seg_fuse(a: tuple) -> dict:
    lk, sk = FC.fuse_labels_cuda(*a)
    lp, sp_ = FC.fuse_labels_plain(*a)
    differ = int((lk != lp).sum())
    return dict(max_abs_err=float(differ), differing_cells=differ,
                ok=differ == 0 and bool((sk == sp_).all()),
                tolerance="labels and label stack exact given equal inputs")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """float32 tensors equal bit for bit (-0.0 apart from 0.0)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def segment_ids(lbl, largest, sizes, cfg) -> torch.Tensor:
    """[Hc, Wc] K18's segment id of every cell: 0 where the label is global,
    l on label l's kept component where it passed the minimum-cells gate
    (the new-label class M always passes), else -1 (the ids
    ``csrc/segment.cu``'s finish stages)."""
    m = largest.shape[0]
    min_cells = max(1, int(round(cfg.min_mask_size_px * cfg.scale * cfg.scale)))
    segm = torch.where(lbl == 0, 0, -1).to(torch.int32)
    for l in range(1, m + 1):
        if l == m or int(sizes[l - 1]) >= min_cells:
            segm = torch.where(largest[l - 1], l, segm).to(torch.int32)
    return segm


def seg_stats_emulated(lbl, largest, sizes, fd, cfg):
    """(depth mean [M + 1], depth std [M + 1]) of K18's finish in the
    kernel's order, with torch float32 ops on the CPU: per segment and pass,
    1,024 partials, partial t summing (count, sum, sum of squares) over the
    cells t, t + 1024, ... in ascending order; then the halving tree
    red[t] + red[t + s], s = 512, ..., 1; then the statistics of
    ``flow_crf.py``'s ``_stats`` (pass 1 gives each segment's
    [mu - max(1.2 sd, 0.05), mu + ...] band, pass 2 its mean and std)."""
    lbl, largest, sizes, fd = (t.cpu() for t in (lbl, largest, sizes, fd))
    m = largest.shape[0]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    n = lbl.numel()
    nk = -(-n // 1024)
    pad = nk * 1024 - n
    seg = torch.nn.functional.pad(segment_ids(lbl, largest, sizes, cfg).reshape(-1), (0, pad),
                                  value=-1).reshape(nk, 1024)
    d = torch.nn.functional.pad(fd.reshape(-1), (0, pad)).reshape(nk, 1024)
    inside = (seg[:, None, :] == torch.arange(m + 1)[None, :, None]) & (d > f32(1e-6))[:, None, :]
    lo = hi = None
    for clip in (False, True):
        s = torch.zeros((3, m + 1, 1024), dtype=torch.float32)
        for k in range(nk):
            dk = d[k].expand(m + 1, 1024)
            sel = inside[k]
            if clip:
                sel = sel & (dk >= lo[:, None]) & (dk <= hi[:, None])
            s = torch.stack([torch.where(sel, s[0] + f32(1.0), s[0]),
                             torch.where(sel, s[1] + dk, s[1]),
                             torch.where(sel, s[2] + dk * dk, s[2])])
        while s.shape[2] > 1:  # red[t] + red[t + half], half = 512, ..., 1
            half = s.shape[2] // 2
            s = s[:, :, :half] + s[:, :, half:]
        r = s[:, :, 0]
        cnt = torch.maximum(r[0], f32(1.0))
        mu = r[1] / cnt
        var = r[2] / cnt - mu * mu
        sd = torch.sqrt(torch.maximum(var, f32(0.0)))
        band = torch.maximum(f32(1.2) * sd, f32(0.05))
        lo, hi = mu - band, mu + band
    return mu, sd


_FINISH_NAMES = ("mask", "new_label_mask", "has_new_label", "pixel_counts")


def check_seg_finish(a: tuple) -> dict:
    ok_ = FC.finish_cuda(*a)
    op = FC.finish_plain(*a)
    exact = {n: bool((x == y).all()) for n, x, y in zip(_FINISH_NAMES, ok_[:4], op[:4])}
    err = float((ok_[4] - op[4]).abs().max())
    var_err = float((ok_[5] ** 2 - op[5] ** 2).abs().max())
    em = seg_stats_emulated(*a[:4], a[6])
    contract = _same_bits(ok_[4].cpu(), em[0]) and _same_bits(ok_[5].cpu(), em[1])
    return dict(max_abs_err=err, var_err=var_err, exact=exact, has_new_label=bool(op[2]),
                stats_bit_equal_to_emulation=contract,
                ok=all(exact.values()) and contract and err <= 1e-5 and var_err <= 2e-5,
                tolerance="masks, has_new_label and counts exact; depth mean and std bit-equal "
                          "to seg_stats_emulated (the kernel's summation order) and, against "
                          "the plain version, means within 1e-5 m and variances within 2e-5 "
                          "m^2 (torch.sum's order; the one-pass variance cancels)")


# K18's hand-made finish cases: no new label; a new label hugging each
# border (has_new false) and one inside; objects exactly at and one cell
# under the minimum-cells gate; a segment with no valid depth; M = 16; a
# 487x651 frame whose CRF grid does not divide it (the upsample's scale)
FINISH_CASES = ("no_new", "new_top", "new_bottom", "new_left", "new_right", "new_inside",
                "at_min_cells", "no_depth", "m16", "ragged")


def finish_cases(device, seed: int = 0) -> list:
    """[(name, ``segment.finish`` arguments)] for ``FINISH_CASES``: M - 1
    objects, each a box (its kept component, depth ~1 + 0.1 l m with 15 %
    of its cells 1 m behind, which pass 2 clips) and a detached 2x2
    satellite that K17 dropped; background at ~3 m with 5 % of its cells 2 m
    behind; 5 % of the cells without depth; the new label M as the case
    says. The depths lie far from every segment's clipping band edges
    (``finish_case_facts`` measures the margin), so that the plain
    version's other summation order cannot move a cell across an edge: a
    rounding apart, not a different selection. The configuration's
    new_label_min_frac is 0.01, so that the border test decides the border
    cases."""
    from multimotionfusion_tpu_torch.config import SegmentationConfig

    cfg = SegmentationConfig(new_label_min_frac=0.01)
    min_cells = max(1, int(round(cfg.min_mask_size_px * cfg.scale * cfg.scale)))
    out = []
    for i, name in enumerate(FINISH_CASES):
        rng = np.random.default_rng(seed + i)
        h, w = (487, 651) if name == "ragged" else (480, 640)
        m = 16 if name == "m16" else 6
        hc, wc = int(h * cfg.scale), int(w * cfg.scale)
        lbl = np.zeros((hc, wc), np.int32)
        largest = np.zeros((m, hc, wc), bool)
        fd = rng.normal(3.0, 0.005, (hc, wc))
        fd[rng.random((hc, wc)) < 0.05] += 2.0
        for l in range(1, m):
            j = l - 1
            y, x = 10 + 35 * (j // 5), 8 + 30 * (j % 5)
            bh, bw = int(rng.integers(12, 26)), int(rng.integers(10, 23))
            if name == "at_min_cells" and l <= 2:  # exactly min_cells, and one under
                bh, bw = 1, min_cells + 1 - l
            lbl[y:y + bh, x:x + bw] = l
            largest[l - 1, y:y + bh, x:x + bw] = True
            lbl[y + bh + 3:y + bh + 5, x:x + 2] = l  # the satellite
            obj = 1.0 + 0.1 * l + rng.normal(0.0, 0.005, (bh, bw))
            obj[rng.random((bh, bw)) < 0.15] += 1.0
            fd[y:y + bh, x:x + bw] = obj
        box = {"new_top": (0, 4, 10, 151), "new_bottom": (hc - 4, hc, 10, 151),
               "new_left": (5, 116, 0, 4), "new_right": (5, 116, wc - 4, wc),
               "m16": (108, 116, 20, 121)}.get(name, (60, 91, 60, 101))
        if name != "no_new":
            y0, y1, x0, x1 = box
            lbl[y0:y1, x0:x1] = m
            largest[m - 1, y0:y1, x0:x1] = True
            fd[y0:y1, x0:x1] = rng.normal(2.0, 0.005, (y1 - y0, x1 - x0))
        fd[rng.random((hc, wc)) < 0.05] = 0.0
        if name == "no_depth":
            fd[lbl == 1] = 0.0
        sizes = largest.reshape(m, -1).sum(1).astype(np.int32)
        t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)  # noqa: E731
        out.append((name, (t(lbl), t(largest), t(sizes), t(fd.astype(np.float32)), h, w, cfg,
                           True)))
    return out


def finish_case_facts(name: str, a: tuple, plain: tuple) -> dict:
    """What makes each of ``finish_cases`` the case its name says, read off
    the plain version's outputs: has_new_label, and per case the gate's,
    the empty segment's or the upsample branch's effect."""
    lbl, largest, sizes, fd, h, w, cfg, _ = a
    _, _, has_new, counts, mean, _ = plain
    hc, wc = lbl.shape
    want_new = name in ("new_inside", "m16", "ragged", "at_min_cells", "no_depth")
    # the least distance of a segment's depth from its pass-1 band's edges
    segm, d = segment_ids(lbl, largest, sizes, cfg).numpy(), fd.numpy().astype(np.float64)
    margin = np.inf
    for l in range(largest.shape[0] + 1):
        v = d[(segm == l) & (fd.numpy() > np.float32(1e-6))]
        if v.size:
            band = max(1.2 * v.std(), 0.05)
            margin = min(margin, float(np.abs(np.abs(v - v.mean()) - band).min()))
    facts = dict(has_new_label=bool(has_new), has_new_expected=want_new, band_margin_m=margin)
    ok = bool(has_new) == want_new and margin > 1e-3
    if name == "at_min_cells":
        min_cells = max(1, int(round(cfg.min_mask_size_px * cfg.scale * cfg.scale)))
        facts.update(sizes=sizes[:2].tolist(), min_cells=min_cells,
                     pixel_counts=counts[1:3].tolist())
        ok = ok and sizes[:2].tolist() == [min_cells, min_cells - 1] and int(counts[1]) > 0 \
            and int(counts[2]) == 0
    if name == "no_depth":
        facts.update(mean_of_segment_1=float(mean[1]))
        ok = ok and float(mean[1]) == 0.0
    if name == "ragged":
        facts.update(integer_upsample=h == hc * (h // hc) and w == wc * (w // wc))
        ok = ok and not facts["integer_upsample"]
    facts["ok"] = ok
    return facts


def check_finish_cases(device) -> dict:
    """K18's finish on ``finish_cases`` on the card against the plain
    version on the CPU: masks, has_new_label and counts exact; depth mean
    and std bit-equal to ``seg_stats_emulated`` and within 1e-5 m / 2e-5
    m^2 of the plain version."""
    cases, ok = {}, True
    for name, a in finish_cases(device):
        ak = [x.cpu() for x in FC.finish_cuda(*a)]
        cpu = tuple(x.cpu() if isinstance(x, torch.Tensor) else x for x in a)
        ap = FC.finish_plain(*cpu)
        em = seg_stats_emulated(*cpu[:4], cpu[6])
        exact = {n: bool(torch.equal(x, y)) for n, x, y in zip(_FINISH_NAMES, ak[:4], ap[:4])}
        r = dict(exact=exact, mean_bit_equal=_same_bits(ak[4], em[0]),
                 std_bit_equal=_same_bits(ak[5], em[1]),
                 mean_err_plain=float((ak[4] - ap[4]).abs().max()),
                 var_err_plain=float((ak[5] ** 2 - ap[5] ** 2).abs().max()),
                 facts=finish_case_facts(name, cpu, ap))
        r["ok"] = (all(exact.values()) and r["mean_bit_equal"] and r["std_bit_equal"]
                   and r["mean_err_plain"] <= 1e-5 and r["var_err_plain"] <= 2e-5
                   and r["facts"]["ok"])
        ok = ok and r["ok"]
        cases[name] = r
    return dict(cases=cases, ok=ok, max_abs_err=0.0 if ok else None,
                tolerance="masks, has_new_label and counts exact against the plain version "
                          "on the CPU; mean and std bit-equal to seg_stats_emulated")


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
