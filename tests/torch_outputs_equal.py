"""Record, then compare, every output of some kernels over chip_smoke.py's
static (``odom_init=""`` and "kp"), external-mask, flow-CRF, legacy CRF and
relocalisation runs and K1's, K2's, K10's and K14's clean's hand-made cases,
to show that a redesigned kernel is bit-equal to the version it replaces.

    python3 tests/torch_outputs_equal.py --tree DIR --out A.pt   # record DIR's
    python3 tests/torch_outputs_equal.py --compare A.pt B.pt    # compare two

``--tree DIR`` (default this checkout) holds ``chip_smoke.py`` and
``multimotionfusion_tpu_torch/``; its kernels are built into ``DIR``'s
``build/``. Recorded per call, in call order: ``gn_reduce`` (K4) and
``gn_multi`` (K11) sums; ``fuse`` (K8) and ``fuse_flat`` (K14) counts and a
SHA-1 of the bytes of the whole [16, N] output; every RANSAC fit's (K21) T,
error, inliers, num_inliers, ok and minimal-set indices, a batch split into
its fits in order (a tree without ``ransac_fit_batch`` fits one at a time in
the same order); every SO(3) iteration's sums and the loop state after its
step (``so3_iteration``, or ``so3_reduce`` then ``so3_step``); the per-model
seeds and gates of ``engine_multi._kp_seeds`` and the back-dating
transforms of ``tracker.refine_track_subset``; K15's whole flow
(``flow.dense_flow``'s [hc, wc, 2]); K20's ``mutual_match`` calls (match_idx,
matched_t) and per tracker update (``tracker.update``) the matches of its
inputs (``mutual_match`` on the table's ``in_history``), the nine fields of
the table after it and the (p0, p1, valid) pair, each as a SHA-1 of its
bytes; K18's ``segment.finish`` (``flow_crf.finish_cuda``): mask,
new_label_mask, has_new_label and pixel_counts as digests, depth_mean and
depth_std as tensors; K19's ``nms_topk`` (``superpoint.nms_topk_cuda``): xy,
score and valid as digests; K1's filter (``frame_maps.frame_depth_cuda``):
the metric and the filtered depth, digests; K2 per side call
(``levels.frame_levels``: every level's depth, intensity, Sobel x and y,
vertices, normals and static validity; ``levels.pred_levels``: every
level's sampling map, bf16 or f32, whose f32 channels are the coarse
levels' depth, RGB depth and intensity pyramids), K10 per resolve
(``rasterize.splat_resolve_cuda``, static, slot and composite: colour,
vertex_conf, normal_rad, time and valid), K14's clean
(``fusion.clean_flat_cuda``: the whole cleaned store), K11's owner prep per
frame (``multi.owner_levels``: every level's own, bank_own and static
validity) and K18's unaries per flow-CRF frame (``flow_crf.unaries``:
frame_depth_c, p_proj, behind and unary), K13 per call
(``rasterize.render_depths_cuda``: the depth, and in a tree whose K13 keeps
its keys in a persistent scratch, ``rasterize.depth_scratch``, whether that
scratch holds only KEY_INVALID after the call) and K19's patch_score per
call (``superpoint.patch_score_cuda``: score and blurred intensity), digests
prefixed with the tensor's shape. The relocalisation run (chip_smoke.run_reloc) adds the
fern-scale K2 calls (80x60 and 40x30). The cases (``checks.FILTER_CASES``,
``checks.PYRAMID_CASES``, ``checks.SPLAT_CASES``,
``checks.CLEAN_FLAT_CASES``, ``checks.DEPTH_CASES``, ``checks.SCORE_CASES``,
taken from this checkout's ``checks.py``
whatever the tree) run through the tree's public wrappers, a run each. The outputs
are kept on the card during a run, so recording adds no host read to the
frame step.
``--compare`` holds every recorded tensor equal bit for bit (floats by their
bytes) and every digest equal, and prints one JSON line; digests of
tensors whose shapes differ between the trees are listed apart
(``reshaped``, and ``all_equal_but_reshaped``). The scratch's state is a
field one tree may lack: it is reported apart (``scratch``: calls recorded
and calls clean, per tree) and every recorded call must be clean. Needs one
NVIDIA GPU to record.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import sys
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record(tree: str, out: str) -> int:
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_outputs_equal: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as S
    from multimotionfusion_tpu_torch import engine_multi as EM
    from multimotionfusion_tpu_torch import kernels as K
    from multimotionfusion_tpu_torch.model import fusion as FU
    from multimotionfusion_tpu_torch.odometry import levels as LV
    from multimotionfusion_tpu_torch.odometry import multi as MO
    from multimotionfusion_tpu_torch.odometry import rgbd
    from multimotionfusion_tpu_torch.ops import frame_maps as FM
    from multimotionfusion_tpu_torch.ops import rasterize as R
    from multimotionfusion_tpu_torch.ops import ransac as RS
    from multimotionfusion_tpu_torch.segmentation import flow as FL
    from multimotionfusion_tpu_torch.segmentation import flow_crf as FC
    from multimotionfusion_tpu_torch.tracking import superpoint as SP
    from multimotionfusion_tpu_torch.tracking import tracker as TR

    if not (S.__file__.startswith(tree) and K.__file__.startswith(tree)):
        raise SystemExit(f"imported {S.__file__} and {K.__file__}, not {tree}'s")
    K.build_all()
    kept = defaultdict(list)  # kernel -> [tuple of tensors on the card]

    def wrap(module, name, pick):
        fn = getattr(module, name)

        def recorded(*args, **kwargs):
            res = fn(*args, **kwargs)
            kept[name].append(tuple(t.clone() for t in pick(res)))
            return res

        setattr(module, name, recorded)

    wrap(rgbd, "gn_reduce_cuda", lambda r: (r,))
    wrap(MO, "gn_multi_cuda", lambda r: (r,))
    wrap(FU, "fuse_cuda", lambda r: (r[0], r[1]))
    wrap(FU, "fuse_flat_cuda", lambda r: (r[0], r[1]))
    wrap(EM, "_kp_seeds", lambda r: r)
    wrap(TR, "refine_track_subset", lambda r: (r,))
    wrap(FL, "dense_flow", lambda r: (r,))
    wrap(FC, "finish_cuda", lambda r: r)
    wrap(SP, "nms_topk_cuda", lambda r: r)
    labelled = defaultdict(list)  # kernel -> [[(field, tensor on the card)] a call]

    def wrap_labelled(module, name, fields):
        fn = getattr(module, name)

        def recorded(*args, **kwargs):
            res = fn(*args, **kwargs)
            labelled[name].append([(f, t.clone()) for f, t in fields(res)])
            return res

        setattr(module, name, recorded)

    wrap_labelled(FM, "frame_depth_cuda", lambda r: zip(("depth_m", "depth_filt"), r))
    wrap_labelled(LV, "frame_levels", lambda r: [
        (f"L{lvl}.{f}", t) for lvl, lv in enumerate(r) for f, t in zip(lv._fields, lv)])
    wrap_labelled(LV, "pred_levels", lambda r: [(f"L{lvl}.map", m) for lvl, m in enumerate(r)])
    wrap_labelled(R, "splat_resolve_cuda", lambda r: zip(r._fields, r))
    wrap_labelled(FU, "clean_flat_cuda", lambda r: [("store", r)])
    wrap_labelled(MO, "owner_levels", lambda r: [
        (f"L{lvl}.{f}", t) for lvl, ml in enumerate(r)
        for f, t in (("own", ml.own), ("bank_own", ml.bank_own),
                     ("static_valid", ml.gl.static_valid))])
    wrap_labelled(FC, "unaries", lambda r: zip(r._fields, r))
    wrap_labelled(SP, "patch_score_cuda", lambda r: zip(("score", "blurred"), r))

    def depth_fields(r):
        out = [("depth", r)]
        if hasattr(R, "depth_scratch"):  # a tree whose keys persist between calls
            cells = r.numel()
            clean = (R.depth_scratch(r.device, cells) == 2**31 - 1).all()
            out.append(("scratch_clean", clean.reshape(1)))
        return out

    wrap_labelled(R, "render_depths_cuda", depth_fields)
    match, update = TR.mutual_match, TR.update
    in_update = []  # a tree whose update calls the public mutual_match

    def mutual_match(*args):
        res = match(*args)
        if not in_update:
            kept["mutual_match"].append(tuple(t.clone() for t in res))
        return res

    def tracker_update(table, kps, depth, time, cam, cfg, pair=True):
        m = match(kps.desc, table.desc, kps.valid, TR.in_history(table, time),
                  cfg.match_dist_gate)
        in_update.append(1)
        res = update(table, kps, depth, time, cam, cfg, pair)
        in_update.pop()
        kept["update"].append(tuple(x.clone() for x in m) + tuple(x.clone() for x in table)
                              + (() if res is None else tuple(x.clone() for x in res)))
        return res

    TR.mutual_match, TR.update = mutual_match, tracker_update
    fields = ("T", "error", "inliers", "num_inliers", "ok", "idx")

    def keep_fit(res, idx):
        kept["ransac"].append(tuple(t.clone() for t in res) + (idx.clone(),))

    if hasattr(RS, "ransac_fit_batch_cuda"):  # one fit is the batch of one
        batch = RS.ransac_fit_batch_cuda

        def fits(u, p0, p1, valid, cfg, want_idx=False):
            res, idx = batch(u, p0, p1, valid, cfg, want_idx=True)
            for b in range(idx.shape[0]):
                keep_fit(tuple(x[b] for x in res), idx[b])
            return (res, idx) if want_idx else res

        RS.ransac_fit_batch_cuda = fits
    else:
        one = RS.ransac_fit_cuda

        def fit(u, p0, p1, valid, cfg, want_idx=False):
            res, idx = one(u, p0, p1, valid, cfg, want_idx=True)
            keep_fit(res, idx)
            return (res, idx) if want_idx else res

        RS.ransac_fit_cuda = fit
    if hasattr(rgbd, "so3_iteration_cuda"):
        iteration = rgbd.so3_iteration_cuda

        def so3(last, nxt, cam_l, state, verbatim=False):
            sums = iteration(last, nxt, cam_l, state, verbatim)
            kept["so3"].append((sums.clone(), state.clone()))
            return sums

        rgbd.so3_iteration_cuda = so3
    else:
        step = rgbd.so3_step_cuda

        def so3_step(state, sums, verbatim=False):
            step(state, sums, verbatim)
            kept["so3"].append((sums.clone(), state.clone()))

        rgbd.so3_step_cuda = so3_step

    runs = {}

    def collect(tag):
        torch.cuda.synchronize()
        rec = {}
        for name, calls in kept.items():
            if name in ("dense_flow", "mutual_match", "update", "nms_topk_cuda"):
                names = {"dense_flow": ("flow",), "mutual_match": ("match_idx", "matched_t"),
                         "update": ("match_idx", "matched_t") + TR.FIELDS
                         + ("p0", "p1", "valid"), "nms_topk_cuda": ("xy", "score", "valid")}[name]
                rec[name] = {f"{field}_digests": [
                    hashlib.sha1(c[j].cpu().numpy().tobytes()).hexdigest() if j < len(c)
                    else None for c in calls] for j, field in enumerate(names)}
            elif name in ("fuse_cuda", "fuse_flat_cuda"):
                rec[name] = dict(
                    digests=[hashlib.sha1(c[0].cpu().numpy().tobytes()).hexdigest()
                             for c in calls],
                    counts=[c[1].cpu() for c in calls])
            elif name == "ransac":
                rec[name] = {f: [c[i].cpu() for c in calls] for i, f in enumerate(fields)}
            elif name == "so3":
                rec[name] = dict(sums=[c[0].cpu() for c in calls],
                                 state=[c[1].cpu() for c in calls])
            elif name == "_kp_seeds":
                rec[name] = dict(seeds=[c[0].cpu() for c in calls],
                                 ok=[c[1].cpu() for c in calls])
            elif name == "finish_cuda":
                rec[name] = {f"{field}_digests": [
                    hashlib.sha1(c[j].cpu().numpy().tobytes()).hexdigest() for c in calls]
                    for j, field in enumerate(("mask", "new_label_mask", "has_new_label",
                                               "pixel_counts"))}
                rec[name].update(depth_mean=[c[4].cpu() for c in calls],
                                 depth_std=[c[5].cpu() for c in calls])
            elif name == "refine_track_subset":
                rec[name] = dict(T=[c[0].cpu() for c in calls])
            else:
                rec[name] = dict(sums=[c[0].cpu() for c in calls])
        for name, calls in labelled.items():
            keys = list(dict.fromkeys(k for c in calls for k, _ in c))
            rec[name] = {f"{k}_digests": [shaped_digest(dict(c).get(k)) for c in calls]
                         for k in keys}
        runs[tag] = rec
        kept.clear()
        labelled.clear()

    import dataclasses

    cfg, frames, gt = S.static_frames(S.N_FRAMES)
    S.run_engine(K, cfg, frames, gt)
    collect("static")
    S.run_engine(K, dataclasses.replace(cfg, odom_init="kp"), frames, gt, S.KP_PATH, "kp_engine")
    collect("static_kp")
    m_cfg, m_frames = S.multi_frames(1 + S.MULTI_FRAMES)
    S.run_multi(K, m_cfg, m_frames)
    collect("multi")
    f_cfg, f_frames = S.multi_frames(1 + S.MULTI_FRAMES, masks=False)
    S.run_multi_flow(K, f_cfg, f_frames)
    collect("flow_crf")
    g_cfg = dataclasses.replace(f_cfg, segmentation=dataclasses.replace(f_cfg.segmentation,
                                                                          mode="crf"))
    S.run_multi_legacy(K, g_cfg, f_frames)
    collect("legacy_crf")
    S.run_reloc(K)
    collect("reloc")
    spec = importlib.util.spec_from_file_location(
        "mmf_case_checks",
        os.path.join(HERE, "multimotionfusion_tpu_torch", "kernels", "checks.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    for name, h, w, kind, unit in cases.FILTER_CASES:
        FM.frame_depth_cuda(*cases.filter_inputs(kind, unit, h, w, "cuda"))
        collect(f"filter_case.{name}")
    for name, h, w, changes, mask_id in cases.PYRAMID_CASES:
        fa, pa = cases.pyramid_inputs(h, w, changes, mask_id, "cuda")
        LV.frame_levels(*fa)
        LV.pred_levels(*pa)
        collect(f"pyramid_case.{name}")
    for name, h, w, window, mode, options in cases.SPLAT_CASES:
        R.splat_resolve_cuda(*cases.splat_inputs(h, w, window, mode, options, "cuda"))
        collect(f"splat_case.{name}")
    for name, h, w, window in cases.CLEAN_FLAT_CASES:
        FU.clean_flat_cuda(*cases.clean_flat_inputs(h, w, "cuda", window=window))
        collect(f"clean_flat_case.{name}")
    for name, *spec in cases.DEPTH_CASES:
        R.render_depths_cuda(*cases.depth_inputs(*spec, "cuda"))
        collect(f"depth_case.{name}")
    for name, h, w, kind in cases.SCORE_CASES:
        SP.patch_score_cuda(*cases.score_inputs(h, w, kind, "cuda"))
        collect(f"score_case.{name}")
    torch.save({"tree": tree, "gpu": S._gpu_line(), "runs": runs}, out)
    print(json.dumps({"tree": tree, "out": out, "calls": {
        tag: {k: len(next(iter(v.values()))) for k, v in rec.items()} for tag, rec in runs.items()}}))
    return 0


# the digest of a clean scratch's record: one True
CLEAN_SCRATCH = "1:" + hashlib.sha1(b"\x01").hexdigest()


def shaped_digest(t):
    """``HxW...:sha1`` of a tensor's bytes (None for no tensor)."""
    import torch

    if t is None:
        return None
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
    return "x".join(map(str, t.shape)) + ":" + hashlib.sha1(raw).hexdigest()


def reshaped(x, y) -> bool:
    """Two shaped digests of tensors of different shapes."""
    return (isinstance(x, str) and isinstance(y, str) and ":" in x and ":" in y
            and x.split(":")[0] != y.split(":")[0])


def same_bits(x, y) -> bool:
    """Equal dtype, shape and bytes (a float's sign of zero and NaN payload
    count)."""
    import torch

    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.is_floating_point():
        return torch.equal(x.contiguous().reshape(-1).view(torch.uint8),
                           y.contiguous().reshape(-1).view(torch.uint8))
    return torch.equal(x, y)


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    report, ok, ok_but_reshaped, shape_changes = {}, True, True, []
    scratch = {}  # tree -> [calls recorded, calls clean]
    for tag in sorted(set(a["runs"]) | set(b["runs"])):
        ra, rb = a["runs"].get(tag, {}), b["runs"].get(tag, {})
        for name in sorted(set(ra) | set(rb)):
            fa, fb = ra.get(name, {}), rb.get(name, {})
            line = {}
            for tree_name, fields in (("a", fa), ("b", fb)):
                digests = fields.get("scratch_clean_digests", [])
                n = scratch.setdefault(tree_name, [0, 0])
                n[0] += len(digests)
                n[1] += sum(d == CLEAN_SCRATCH for d in digests)
            for field in sorted((set(fa) | set(fb)) - {"scratch_clean_digests"}):
                xa, xb = fa.get(field, []), fb.get(field, [])
                if field.endswith("digests"):
                    equal = [x == y for x, y in zip(xa, xb)]
                else:
                    equal = [same_bits(x, y) for x, y in zip(xa, xb)]
                line[field] = dict(calls=(len(xa), len(xb)), equal=sum(equal),
                                   first_differing=next((i for i, e in enumerate(equal)
                                                         if not e), None))
                ok = ok and len(xa) == len(xb) > 0 and all(equal)
                moved = [i for i, (x, y) in enumerate(zip(xa, xb)) if reshaped(x, y)]
                if moved:
                    shape_changes.append(f"{tag}.{name}.{field}: {xa[moved[0]].split(':')[0]} "
                                         f"-> {xb[moved[0]].split(':')[0]} ({len(moved)} calls)")
                ok_but_reshaped = ok_but_reshaped and len(xa) == len(xb) > 0 and all(
                    e or i in moved for i, e in enumerate(equal))
            report[f"{tag}.{name}"] = line
    ok = ok and all(n[0] == n[1] for n in scratch.values())
    print(json.dumps({"a": a["tree"], "b": b["tree"], "gpu": a["gpu"], "all_equal": ok,
                      "all_equal_but_reshaped": ok_but_reshaped, "reshaped": shape_changes,
                      "scratch": scratch, "outputs": report}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    return record(os.path.abspath(args.tree), args.out)


if __name__ == "__main__":
    sys.exit(main())
