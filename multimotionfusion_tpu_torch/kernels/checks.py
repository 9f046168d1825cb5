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

import torch

from multimotionfusion_tpu_torch.model import fusion as FU
from multimotionfusion_tpu_torch.odometry import rgbd
from multimotionfusion_tpu_torch.ops import rasterize as R

_ARG_NAMES = {
    "zbuffer": ("data", "count", "T_inv", "cam", "time", "time_delta", "max_depth"),
    "splat_resolve": ("index", "data_local", "cam", "conf_threshold", "time", "max_time",
                      "time_delta", "window"),
    "fuse": ("data", "count", "frame_data", "frame_valid", "index", "data_local", "mask",
             "mask_id", "pose", "cam", "time", "cfg"),
    "gn_reduce": ("lv", "Rt_inv", "cam_l", "scale2", "p"),
}


def args(key: str, c: dict) -> tuple:
    """Positional arguments of the wrapper whose inputs were recorded as ``key``."""
    return tuple(c[n] for n in _ARG_NAMES[key.split(".")[0]])


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
    pk = R.splat_resolve_cuda(*a)
    pp = R.splat_resolve_plain(*a)
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
