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

import torch

from multimotionfusion_tpu_torch.model import fillin
from multimotionfusion_tpu_torch.model import fusion as FU
from multimotionfusion_tpu_torch.model import surfel_map as sm
from multimotionfusion_tpu_torch.odometry import levels as LV
from multimotionfusion_tpu_torch.odometry import rgbd
from multimotionfusion_tpu_torch.ops import frame_maps as FM
from multimotionfusion_tpu_torch.ops import ransac as RS
from multimotionfusion_tpu_torch.ops import rasterize as R
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
    "so3_step": ("state", "sums"),
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
    surfel the prediction's attributes, elsewhere the filled-in frame."""
    fill = a[-1]
    pk = R.splat_resolve_cuda(*a)
    pp, fp = fillin.splat_fill_plain(*a)
    res = _check_resolved(pk, pp)
    neither = ~pk.valid & ~pp.valid
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


def check_gn(a: tuple, level: int) -> dict:
    sk = rgbd.gn_reduce_cuda(*a, level=level).cpu()
    sp = rgbd.gn_reduce_plain(*a).cpu()
    Sk_i, Sp_i = rgbd._sym(sk[0:28]), rgbd._sym(sp[0:28])
    Sk_r, Sp_r = rgbd._sym(sk[28:56]), rgbd._sym(sp[28:56])
    e_icp = float(torch.linalg.norm(Sk_i - Sp_i) / torch.linalg.norm(Sp_i).clamp(min=1e-30))
    e_rgb = float(torch.linalg.norm(Sk_r - Sp_r) / torch.linalg.norm(Sp_r).clamp(min=1e-30))
    # icp count, rgb count, sum diff^2
    scalars = float(((sk[56:59] - sp[56:59]).abs() / sp[56:59].abs().clamp(min=1.0)).max())
    return dict(
        max_abs_err=float((sk - sp).abs().max()), rel_frob_icp=e_icp, rel_frob_rgb=e_rgb,
        counts_sigma_rel_err=scalars,
        ok=e_icp <= 1e-4 and e_rgb <= 1e-4 and scalars <= 1e-4,
        tolerance="each 7x7 system within 1e-4 relative (Frobenius); both counts and "
                  "sum diff^2 within 0.01%",
    )


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
    state, sums = a
    sk, sp = state.clone(), state.clone()
    rgbd.so3_step_cuda(sk, sums)
    rgbd.so3_step_plain(sp, sums)
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
