"""Device time of the odometry's step and reduction kernel lines (K5's
``so3_step``, ``gn_step``, ``so3_step[multi, verbatim]``, ``gn_step_multi``;
K4's ``gn_reduce[L0/L1/L2]``; K11's ``gn_multi[L0/L1/L2]``; one SO(3)
iteration, static and multi), of the fusion's (K8 ``fuse``, K14
``fuse_flat`` and ``clean_flat``, each clean on a fresh copy of the recorded
store, made before the profile: the card's clean works in place), of K10's
resolve (static and composite), of K11's owner prep (``multi.owner_levels``,
every level: three launches in a tree before the one-launch design, one
after), of K18's unaries (``flow_crf.unaries_cuda`` on a flow-CRF frame's
inputs), of K13 (``rasterize.render_depths_cuda``) and K19's patch_score
(``superpoint.patch_score_cuda``) on the flow-CRF run's inputs, and of a
multi-model frame's 14 RANSAC fits (K21: the 6 per-model seeds and the 8
back-dating fits, with no track selected as on a frame without a spawn and
with every active track) for the package of one tree, every device event
counted, on the inputs that tree's ``chip_smoke.py`` records. An SO(3)
iteration is ``so3_iteration`` where the tree has it, else ``so3_reduce``
then ``so3_step``; the fits are two batches
where the tree has ``ransac_fit_batch``, else 14 one-fit calls (the
back-dating points copied contiguous first, as such a tree's engine does),
on the same inputs and uniforms. On a tree with the batched back-dating, the
8 every-track fits with the ring's gather, on two layouts of the points
(strided views of a [T, 9, 3] gather, or slices of a [9, T, 3] one).

Run it on two trees in one call to compare two versions of the kernels with
one reader (for example the parent unpacked with ``git archive`` into an
ignored directory: parent, change, change, parent):

    python3 tests/torch_odometry_times.py --tree DIR > times.json

``DIR`` holds ``chip_smoke.py`` and ``multimotionfusion_tpu_torch/`` (by
default this checkout); the kernels are built into ``DIR``'s ``build/``.
Needs one NVIDIA GPU; prints the GPU's name and power limit, then one JSON
line: per kernel line, device ms a call (``chip_smoke._device_profile``:
the mean of ``--reps`` calls after ``--warm`` warm-up calls inside one
profile, repeated ``--profiles`` times), device launches a call and each
kernel's share.
"""

import argparse
import json
import os
import sys
from collections import defaultdict


def by_kernel(by_name: dict) -> dict:
    """A profile's {event name: ms} summed by ``short_name``."""
    out = defaultdict(float)
    for name, ms in by_name.items():
        out[short_name(name)] += ms
    return dict(out)


def short_name(event: str) -> str:
    """A kernel's unqualified name (``(anonymous namespace)::pass1(...)`` ->
    ``pass1``); a memset's or copy's event name as it is."""
    if event.startswith("Mem"):
        return event
    name = event.replace("(anonymous namespace)::", "").split("(", 1)[0].split("<", 1)[0]
    return name.rsplit("::", 1)[-1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--warm", type=int, default=10)
    ap.add_argument("--profiles", type=int, default=5)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("torch_odometry_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as S
    from multimotionfusion_tpu_torch import kernels as K
    from multimotionfusion_tpu_torch.kernels import checks as C
    from multimotionfusion_tpu_torch.model import fusion as FU
    from multimotionfusion_tpu_torch.odometry import multi as MO
    from multimotionfusion_tpu_torch.odometry import rgbd
    from multimotionfusion_tpu_torch.ops import rasterize as R
    from multimotionfusion_tpu_torch.segmentation import flow_crf as FC
    from multimotionfusion_tpu_torch.tracking import superpoint as SP

    if not (S.__file__.startswith(tree) and K.__file__.startswith(tree)):
        raise SystemExit(f"imported {S.__file__} and {K.__file__}, not {tree}'s")
    K.build_all()
    cfg, frames, gt = S.static_frames(S.N_FRAMES + 2 * S.STAGE_FRAMES + S.SYNC_FRAMES)
    captured = S.run_engine(K, cfg, frames, gt)[2]
    m_cfg, m_frames = S.multi_frames(1 + S.MULTI_FRAMES + 2 * S.STAGE_FRAMES)
    m_captured = S.run_multi(K, m_cfg, m_frames)[2]
    f_cfg, f_frames = S.multi_frames(1 + S.MULTI_FRAMES, masks=False)
    f_captured = S.run_multi_flow(K, f_cfg, f_frames)[2]
    if hasattr(C, "derive_so3"):  # the halves' inputs, off the path since the one-launch iteration
        C.derive_so3(captured)
        C.derive_so3(m_captured)

    def step(cuda, rec, key):
        def fresh_calls():  # a step updates its state in place: fresh copies each profile
            a = C.args(key, rec[key])
            fresh = S._states(a[0], n=3 * (args.warm + args.reps) + 1)  # up to 3 tries
            return lambda: cuda(fresh(), *a[1:])
        return fresh_calls

    def evaluation(lvl):
        a = C.args(f"gn_multi.L{lvl}", m_captured[f"gn_multi.L{lvl}"])
        return lambda: lambda: MO.gn_multi_cuda(*a, level=lvl)

    def reduction(lvl):
        a = C.args(f"gn_reduce.L{lvl}", captured[f"gn_reduce.L{lvl}"])
        return lambda: lambda: rgbd.gn_reduce_cuda(*a, level=lvl)

    def fusion(cuda, rec, key, **kw):
        a = C.args(key, rec[key])
        return lambda: lambda: cuda(*a, **kw)

    def clean_flat():
        def fresh_calls():
            a = C.args("clean_flat", m_captured["clean_flat"])
            fresh = S._states(a[0], n=3 * (args.warm + args.reps) + 1)  # up to 3 tries
            return lambda: FU.clean_flat_cuda(fresh(), *a[1:])
        return fresh_calls

    def so3_iteration(rec, verbatim):
        last, nxt, cam_l, state = C.args("so3_reduce", rec["so3_reduce"])

        def fresh_calls():
            fresh = S._states(state, n=3 * (args.warm + args.reps) + 1)
            if hasattr(rgbd, "so3_iteration_cuda"):
                return lambda: rgbd.so3_iteration_cuda(last, nxt, cam_l, fresh(), verbatim)

            def halves():
                st = fresh()
                rgbd.so3_step_cuda(st, rgbd.so3_reduce_cuda(last, nxt, cam_l, st), verbatim)
            return halves
        return fresh_calls

    def frame_fits(every_track):
        from multimotionfusion_tpu_torch.ops import ransac as RS
        from multimotionfusion_tpu_torch.tracking import tracker as TR

        table, kps, depth, time, cam, kcfg, _ = C.args("track_update", m_captured["track_update"])
        tk = TR.TrackTable(*(x.clone() for x in table))
        p0, p1, valid = TR.update(tk, kps, depth, time, cam, kcfg)
        rcfg, m = m_cfg.ransac, 1 + m_cfg.object_slots
        ids = torch.arange(m, dtype=torch.int32, device=p0.device)
        masks = (valid[None] & (tk.model_id[None] == ids[:, None])).contiguous()
        sel = tk.active if every_track else torch.zeros_like(tk.active)
        gen = torch.Generator(device=p0.device).manual_seed(0)
        u = torch.rand((m + 8, rcfg.iterations, 3), generator=gen, device=p0.device)
        pairs = [TR.pair_between(tk, time - k - 1, time - k) for k in range(8)]
        if hasattr(RS, "ransac_fit_batch_cuda"):
            pa, pb, vb = TR.backdate_pairs(tk, sel, time, 8)
            return lambda: lambda: (RS.ransac_fit_batch_cuda(u[:m], p0, p1, masks, rcfg),
                                    RS.ransac_fit_batch_cuda(u[m:], pa, pb, vb, rcfg))
        vb = [(v & sel).contiguous() for _, _, v in pairs]

        def fits():
            for b in range(m):
                RS.ransac_fit_cuda(u[b], p0, p1, masks[b], rcfg)
            for k, (pa, pb, _) in enumerate(pairs):
                RS.ransac_fit_cuda(u[m + k], pa.contiguous(), pb.contiguous(), vb[k], rcfg)
        return lambda: fits

    def backdating_layout(contiguous):
        # the gather of the ring and the 8 back-dating fits with every active
        # track selected, on the points as strided views of one [T, 9, 3]
        # gather (108 bytes between points) or as slices of one [9, T, 3]
        from multimotionfusion_tpu_torch.ops import ransac as RS
        from multimotionfusion_tpu_torch.tracking import tracker as TR

        rec = m_captured["refine_track_subset"]
        table, time, length, rcfg = rec["table"], rec["time"], rec["length"], rec["ransac_cfg"]
        _, _, vb = TR.backdate_pairs(table, table.active, time, length)
        ticks = torch.arange(time, time - length - 1, -1, dtype=torch.int32, device=vb.device)
        slots = torch.remainder(ticks, table.history)
        gen = torch.Generator(device=vb.device).manual_seed(0)
        u = RS.draw_uniforms(gen, length, rcfg.iterations, vb.device)

        def fits():
            if contiguous:
                pts = table.p3d.transpose(0, 1).index_select(0, slots)
                pa, pb = pts[1:], pts[:-1]
            else:
                pts = table.p3d.index_select(1, slots)
                pa, pb = pts[:, 1:].transpose(0, 1), pts[:, :-1].transpose(0, 1)
            RS.ransac_fit_batch_cuda(u, pa, pb, vb, rcfg)
        return lambda: fits

    lines = {
        "so3_step": step(rgbd.so3_step_cuda, captured, "so3_step"),
        "gn_step": step(rgbd.gn_step_cuda, captured, "gn_step"),
        "so3_step[multi, verbatim]": step(rgbd.so3_step_cuda, m_captured, "so3_step"),
        "gn_step_multi": step(MO.gn_step_multi_cuda, m_captured, "gn_step_multi"),
        **{f"gn_reduce[L{lvl}]": reduction(lvl) for lvl in S.LEVELS},
        **{f"gn_multi[L{lvl}]": evaluation(lvl) for lvl in S.LEVELS},
        "fuse": fusion(FU.fuse_cuda, captured, "fuse", want_assoc=False),
        "fuse_flat": fusion(FU.fuse_flat_cuda, m_captured, "fuse_flat"),
        "clean_flat": clean_flat(),
        "owner_prep[L0-L2]": fusion(MO.owner_levels, m_captured, "owner_prep"),
        "segment.unaries": fusion(FC.unaries_cuda, f_captured, "segment.unaries"),
        "render_depths": fusion(R.render_depths_cuda, f_captured, "zbuffer.depths"),
        "patch_score": fusion(SP.patch_score_cuda, f_captured, "patch_score"),
        "splat_resolve+fill_in": fusion(R.splat_resolve_cuda, captured, "splat_resolve"),
        "splat_resolve[composite]+fill_in[gated]": fusion(R.splat_resolve_cuda, m_captured,
                                                          "splat_resolve.composite"),
        "so3_iteration": so3_iteration(captured, False),
        "so3_iteration[multi, verbatim]": so3_iteration(m_captured, True),
        "ransac[frame: 6 seeds + 8 back-dating, none selected]": frame_fits(False),
        "ransac[frame: 6 seeds + 8 back-dating, every track]": frame_fits(True),
    }
    if "refine_track_subset" in m_captured:  # a tree with the batched back-dating
        lines["ransac[back-dating, every track: gather + fits, strided views]"] = \
            backdating_layout(False)
        lines["ransac[back-dating, every track: gather + fits, contiguous]"] = \
            backdating_layout(True)
    out = {}
    for name, calls in lines.items():
        runs = [S._device_profile(calls(), args.reps, args.warm)
                for _ in range(args.profiles)]
        ms = sorted(r[0] for r in runs)
        out[name] = {"device_ms": ms, "device_ms_median": ms[len(ms) // 2],
                     "device_launches_per_call": runs[0][1],
                     "by_kernel_ms": by_kernel(runs[0][2])}
    print(S._gpu_line())
    print(json.dumps({"tree": tree, "reps": args.reps, "warm": args.warm, "lines": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
