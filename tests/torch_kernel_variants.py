"""Times hand-written kernels as they are and as edited copies, to show
where their time goes (needs one NVIDIA GPU; not a test).

    python3 tests/torch_kernel_variants.py [--tree DIR] \
        [--only flow,tracks,finish,select,nms,levels,splat,owner,depths,score] \
        [--variants as_is,wrap_once,three_values,one_launch] [--baseline DIR]

``flow``: K15's one-launch flow (``csrc/flow.cu``) on
``checks.flow_case_inputs(480, 640)`` at the 640x480 CRF grid (120x160),
with 1, 2 and 4 Lucas-Kanade iterations: as it is (a cluster of 16 blocks);
with a cluster of 8 (the portable size); with every ``cluster.sync()``
doubled (the barriers' cost); and with a globaltimer stamp after each
barrier (block 0, thread 0: the phases' times). ``tracks``: K20's match
tile (``csrc/tracks.cu``) as it is (128x128 a block, 8x4 registers a
thread) and at 8x8 and at 64x64 a block with 4x4 and 4x8 registers, through
the wrappers (the edited library swapped in), on ``checks.track_cases``'
"more_new_than_free" table at the default shapes: the device time of each
kernel (torch.profiler, 20 calls after 5), and whether every track and
match case stays bit-equal to the plain version. ``finish`` and
``select``: K18's ``finish_kernel`` (``csrc/segment.cu``) and K19's
``select_kernel`` (``csrc/keypoints.cu``) with a globaltimer stamp (thread
0 of each block) at named points, on ``checks.finish_cases``
(``new_inside``: M = 6 at 640x480, the main path's shape; ``m16``) and on
``checks.nms_inputs`` heat maps (``random``, ``superpoint``, ``plateau``,
``few``) at 640x480, three calls each after ~50 ms of matrix products (to
keep the card's clocks up): per stamp the earliest and latest block, in
microseconds from the kernel's first stamp (a stamp inside the select's
round loop keeps its last round's value; ``round r`` stamps are per
round). ``nms``: K19's NMS as it is (one instance a radius) and with the
radius an argument of one instance, on the same heat maps (the device time
of each kernel, and the outputs against the plain version). ``levels``:
K1's filter (``csrc/frame_maps.cu``) as it is (a zero tap's
weight zeroed by an infinite gate in the exponent), with a select of the
weight instead, with a branch around each tap and with eight pixels a
thread, and the opcodes of each one's ``bilateral`` (``cuobjdump -sass``);
K2's two sides (``csrc/pyramid.cu``) as they are, at four blocks an SM
(``__launch_bounds__(NT, 4)``) and with a globaltimer stamp at the start,
after each barrier and at the end (thread 0 of the middle row's first 16
blocks); each reading the median of three profiles after ~50 ms of matrix
products; on ``checks.filter_inputs`` and ``checks.pyramid_inputs`` at
640x480, through the wrappers with the edited library swapped in: device us
a call and whether the outputs equal the source's. ``splat``: K10
(``csrc/splat_resolve.cu``, static and composite) and K14's clean
(``csrc/fuse_flat.cu``) on the inputs ``chip_smoke.py``'s static and
external-mask runs record (the clean on a fresh copy of the store each
call: it works in place): as they are; with the engine's window as a
run-time one (no unrolled instance); with a 32 x 16 tile; and, as
diagnostics whose outputs differ, without the tap loop, without the
staging's gathers, without the fill-in (K10) and without the window counts
(the clean); the median of three readings after ~50 ms of matrix products;
and the gather locality of both index maps (distinct 32-byte sectors a
warp's one-channel gather of 32 pixels of a row touches). ``owner``: K11's
owner prep (``csrc/gn_multi.cu``) and K18's unaries (``csrc/segment.cu``)
on the inputs the external-mask and flow-CRF runs record, as they are, with
other tiles, with parts dropped and with globaltimer stamps
(``owner_variants``; ``--variants`` names the ones to build and run, all
by default). ``depths`` and ``score``: K13 (``csrc/zbuffer.cu``) and
K19's patch_score (``csrc/keypoints.cu``) on the inputs the flow-CRF run
records, as they are and as edited copies (``depths_score_variants``: K13
in one launch, without the warp's runs, with other columns a thread and
blocks; patch_score with other tiles and cut after each phase), warm and
cold, with their launches a call; ``--baseline DIR`` adds another tree's
two sources. ``clean``, ``compact`` and ``lcrf``: K7/K9 (``csrc/clean.cu``:
the flag frame into the bucket and in place, the compaction frame,
``compact``, the multi-model repack) on the inputs the static and flow-CRF
runs record and K24c (``csrc/legacy_crf.cu``: the plan and the ten-step mean
field) on the legacy run's, as they are and as edited copies
(``clean_lcrf_variants``). Each copy is
written and built with the build's flags in ``DIR/build/variants``; an
edit whose text is no longer in the source stops the script. Prints JSON
lines.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from collections import defaultdict


def patch(text, old, new, count=1):
    """``text`` with ``old`` replaced by ``new`` (every occurrence for
    ``count=0``); raises if ``old`` is not there."""
    if old not in text:
        raise ValueError(f"the source no longer holds {old!r}")
    return text.replace(old, new) if count == 0 else text.replace(old, new, count)


LOGS = {}  # variant name -> the compiler's output (ptxas -v)


def build(tree, name, text):
    """The edited source built in ``build/variants`` (it includes the
    package's headers through -I)."""
    here = os.path.join(tree, "build", "variants")
    os.makedirs(here, exist_ok=True)
    path, out = os.path.join(here, f"{name}.cu"), os.path.join(here, f"{name}.so")
    with open(path, "w") as f:
        f.write(text)
    proc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
         "-I", os.path.join(tree, "multimotionfusion_tpu_torch", "csrc"), "-o", out, path],
        capture_output=True, text=True)
    LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode:
        print(json.dumps({"variant": name, "build_failed": proc.stdout + proc.stderr}))
        return None
    return ctypes.CDLL(out)


def ptxas_summary(log: str) -> dict:
    """{kernel: [registers, stack frame bytes, spill stores]} of a ptxas -v log."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = re.sub(r"^_ZN.*?(\d+)([a-z_]+)E.*$", r"\2", m.group(1))
            out[cur] = [None, None, None]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m and cur:
            out[cur][1], out[cur][2] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out[cur][0] = int(m.group(1))
    return out


def device_us(torch, fn, reps=20):
    """{kernel name: device us a call} over ``reps`` calls after 5."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            by[name] += e.time_range.elapsed_us() / reps
    return dict(by)


STAMPS = """#include <cuda_runtime.h>
__device__ unsigned long long g_stamp[16][64];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0 && blockIdx.x < 16) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamp[blockIdx.x][k] = t;
  }
}
extern "C" int read_stamps(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
}
"""


def read_stamps(lib):
    """[block][stamp] globaltimer readings (0 where a block wrote none)."""
    buf = (ctypes.c_ulonglong * (16 * 64))()
    assert lib.read_stamps(buf) == 0
    return [list(buf[64 * b:64 * (b + 1)]) for b in range(16)]


def stamped(text, marks):
    """``text`` with ``STAMPS`` in front and ``stamp(k)`` before or after
    each anchor of ``marks``: (label, anchor, k (an int or a C expression),
    after the anchor)."""
    for label, anchor, k, after in marks:
        if text.count(anchor) != 1:
            raise ValueError(f"the anchor of {label!r} no longer matches once")
        text = text.replace(anchor, (anchor + f"\n  stamp({k});\n") if after
                            else (f"stamp({k});\n  " + anchor))
    return STAMPS + text


def report(tag, lib, labels):
    """One JSON line: per labelled stamp [earliest, latest] block in us from
    the kernel's first stamp (stamps no block reached are left out)."""
    rows = read_stamps(lib)
    t0 = min(row[0] for row in rows if row[0])
    line = {}
    for k, label in sorted(labels.items()):
        col = [row[k] for row in rows if row[k]]
        if not col or min(col) < t0:
            continue
        line[label] = [round((min(col) - t0) / 1e3, 2), round((max(col) - t0) / 1e3, 2)]
    print(json.dumps({"case": tag, "us_earliest_latest_block": line}), flush=True)


def flow_variants(tree, torch, K, C, FL, imops):
    src = open(os.path.join(tree, "multimotionfusion_tpu_torch", "csrc", "flow.cu")).read()
    text = STAMPS + patch(src, "  const Layout L = layout(a);\n",
                          "  const Layout L = layout(a);\n  int ns_ = 0;\n  stamp(ns_++);\n")
    text = patch(text, "cluster.sync();", "cluster.sync(); stamp(ns_++);", count=0)
    k = text.rindex("}", 0, text.index("template <bool kShared>\nint launch"))
    text = text[:k] + "  stamp(ns_++);\n" + text[k:]
    c16 = f"constexpr int CLUSTER = {FL.CLUSTER};"
    variants = {"as_is": (FL.CLUSTER, src),
                "cluster_8": (8, patch(src, c16, "constexpr int CLUSTER = 8;")),
                "barriers_doubled": (FL.CLUSTER, patch(src, "cluster.sync();",
                                                       "cluster.sync(); cluster.sync();", count=0)),
                "stamped": (FL.CLUSTER, text)}
    prev, nxt = (x.cuda() for x in C.flow_case_inputs(480, 640))
    hc, wc = 120, 160
    ref = FL.dense_flow_plain(prev, nxt, hc, wc)
    taps = [float(t) for t in imops.gaussian_weights(FL.BLUR_SIGMA, FL.BLUR_RADIUS)]
    for name, (cluster, text) in variants.items():
        lib = build(tree, f"flow_{name}", text)
        if lib is None:
            continue
        f = lib.mmf_dense_flow
        f.argtypes = [K.P, K.P] + [K.I] * 5 + [K.F] * 7 + [K.I] * 5 + [K.P] * 4
        f.restype = K.I
        FL.CLUSTER, kept = cluster, FL.CLUSTER  # the bands of this variant's cluster
        try:
            band, halo, stage, near = FL.flow_band(hc, wc)
        finally:
            FL.CLUSTER = kept
        scratch = torch.empty(FL.flow_scratch_floats(hc, wc), device="cuda")
        out = torch.empty((hc, wc, 2), device="cuda")
        for iters in (1, 2, FL.ITERS):
            def run():
                err = f(prev.data_ptr(), nxt.data_ptr(), 480, 640, hc, wc, iters, *taps,
                        cluster, band, halo, near, stage, scratch.data_ptr(), None,
                        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            us = sum(device_us(torch, run).values())
            line = {"kernel": "flow", "variant": name, "cluster": cluster, "iters": iters,
                    "device_us": us}
            if iters == FL.ITERS:
                line["bit_equal_to_plain"] = bool(torch.equal(out, ref))
            if name == "stamped" and iters == FL.ITERS:
                t = [v for v in read_stamps(lib)[0] if v]
                line["stamps_us_after_start"] = [(v - t[0]) / 1e3 for v in t]
            print(json.dumps(line), flush=True)


def track_variants(tree, torch, K, C, TR):
    src = open(os.path.join(tree, "multimotionfusion_tpu_torch", "csrc", "tracks.cu")).read()
    shapes = {"t128_rt8_ct4": (128, 8, 4), "t128_rt8_ct8": (128, 8, 8),
              "t64_rt4_ct4": (64, 4, 4), "t64_rt4_ct8": (64, 4, 8)}
    _, table, kps, depth, time, cam, cfg, pair = C.track_cases()[1]
    for name, (tile, rt, ct) in shapes.items():
        text = patch(patch(src, "TQ = 128, TT = 128", f"TQ = {tile}, TT = {tile}"),
                     "RT = 8, CT = 4;", f"RT = {rt}, CT = {ct};")
        lib = build(tree, f"tracks_{name}", text)
        if lib is None:
            continue
        K._libs["tracks"], TR.MATCH_TILE = lib, tile
        ok = C.check_track_cases("cuda")["ok"] and C.check_match_cases("cuda")["ok"]
        tk = TR.TrackTable(*(x.cuda() for x in table))
        kk = type(kps)(*(x.cuda() for x in kps))
        dc = depth.cuda()
        print(json.dumps({"kernel": "tracker.update", "variant": name, "cases_bit_equal": ok,
                          "device_us": device_us(
                              torch, lambda: TR.update_cuda(tk, kk, dc, time, cam, cfg, pair))}),
              flush=True)


# (label, anchor, stamp index or expression, after the anchor)
FINISH = [
    ("start", "extern __shared__ __align__(16) unsigned char fsm[];", 0, True),
    ("band staged", "  cluster_wait();\n  if (warp == 0) {  // the band's count and box", 1, False),
    ("cells pushed", "  cluster_arrive();  // barrier 1: every partial's cells pushed", 2, False),
    ("upsample done", "  cluster_wait();\n\n  // has_new", 3, False),
    ("barrier 1 passed", "  // has_new and the pixel counts: block 0", 4, False),
    ("pass 1 pushed", "  cluster.sync();  // barrier 2", 5, False),
    ("barrier 2 passed",
     "  cluster.sync();  // barrier 2: every block's pass-1 results in every block", 6, True),
    ("pass 2 pushed", "  cluster.sync();  // barrier 3", 7, False),
    ("barrier 3 passed", "  cluster.sync();  // barrier 3: every block's pass-2 results in block 0",
     8, True),
]
SELECT = [
    ("start", "extern __shared__ __align__(16) unsigned stage[];", 0, True),
    ("zeros counted, keys listed", "  const bool listed = nlist <= LIST_CAP;", 1, True),
    ("round r histogram", "    cluster.sync();  // every block's histogram of this round",
     "2 + 2 * ((24 - shift) >> 3)", False),
    ("round r barrier passed", "    cluster.sync();  // every block's histogram of this round",
     "3 + 2 * ((24 - shift) >> 3)", True),
    ("last pick", "    if (done || shift == 0) break;", 10, False),
    ("keys gathered", "  cluster.sync();  // every block's list", 11, False),
    ("lists' barrier passed", "  cluster.sync();  // every block's list", 12, True),
    ("keys copied", "  cluster_arrive_relaxed();  // the lists are copied", 13, False),
    ("ranked and written", "  cluster_wait();\n}", 14, False),
]
FINISH_LABELS = {k: label for label, _, k, _ in FINISH}
SELECT_LABELS = {0: "start", 1: "zeros counted, keys listed", 10: "last pick",
                 11: "keys gathered", 12: "lists' barrier passed", 13: "keys copied",
                 14: "ranked and written"}
SELECT_LABELS.update({2 + 2 * r: f"round {r} histogram" for r in range(4)})
SELECT_LABELS.update({3 + 2 * r: f"round {r} barrier passed" for r in range(4)})


def _busy(torch):
    """~50 ms of matrix products, to keep the card's clocks up."""
    big = torch.randn(4096, 4096, device="cuda")
    for _ in range(20):
        big @ big


def finish_phases(tree, torch, K, C, FC):
    src = open(os.path.join(tree, "multimotionfusion_tpu_torch", "csrc", "segment.cu")).read()
    lib = build(tree, "segment_phases", stamped(src, FINISH))
    if lib is None:
        return
    f = lib.mmf_seg_finish
    f.argtypes = [K.P] * 4 + [K.I] * 8 + [K.F] * 3 + [K.P] * 7  # 6 tensors and the stream
    f.restype = K.I
    for name, a in C.finish_cases("cuda"):
        if name not in ("new_inside", "m16"):
            continue
        lbl, largest, sizes, fd, h, w, cfg, allow_new = a
        outs = FC.finish_cuda(*a)
        hc, wc = lbl.shape
        _busy(torch)
        for _ in range(3):
            err = f(lbl.data_ptr(), largest.data_ptr(), sizes.data_ptr(), fd.data_ptr(),
                    largest.shape[0], hc, wc, h, w, int(allow_new),
                    max(1, int(round(cfg.min_mask_size_px * cfg.scale * cfg.scale))),
                    max(1, int(round(20 * cfg.scale))), float(cfg.new_label_min_frac),
                    1.0 / (cfg.scale * cfg.scale), float(cfg.scale),
                    *[o.data_ptr() for o in outs], torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            assert err == 0, err
        report(f"segment.finish[{name}]", lib, FINISH_LABELS)


def select_phases(tree, torch, K, C, SP):
    import numpy as np

    src = open(os.path.join(tree, "multimotionfusion_tpu_torch", "csrc", "keypoints.cu")).read()
    lib = build(tree, "keypoints_phases", stamped(src, SELECT))
    if lib is None:
        return
    g = lib.mmf_nms_topk
    g.argtypes = [K.P, K.I, K.I, K.I, K.F, K.I] + [K.P] * 5  # 4 tensors and the stream
    g.restype = K.I
    for kind in ("random", "superpoint", "plateau", "few"):
        heat, k, thr, r = C.nms_inputs(kind, 480, 640, "cuda")
        xy, score, valid = SP.nms_topk_cuda(heat, k, thr, r)
        scores = torch.empty(heat.numel(), device="cuda")
        _busy(torch)
        for _ in range(3):
            err = g(heat.data_ptr(), heat.shape[0], heat.shape[1], k, float(np.float32(thr)), r,
                    scores.data_ptr(), xy.data_ptr(), score.data_ptr(), valid.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            assert err == 0, err
        report(f"nms_topk.select[{kind}]", lib, SELECT_LABELS)


def nms_variants(tree, torch, K, C, SP):
    """K19's NMS as it is (one instance a radius, the taps unrolled) and with
    the radius an argument of one instance, in the order as it is, run-time
    radius twice, as it is: the device time of each kernel of ``nms_topk`` on
    four 640x480 heat maps, and whether the outputs equal the plain
    version's."""
    import numpy as np

    src = open(os.path.join(tree, "multimotionfusion_tpu_torch", "csrc", "keypoints.cu")).read()
    head = ("template <int R>\n__global__ void __launch_bounds__(NMS_T)\nnms_kernel("
            "const float* __restrict__ heat, int H, int W, float thr, float* __restrict__ "
            "scores) {\n  constexpr int LW = NMS_W + 2 * R, LH = NMS_H + 2 * R;\n"
            "  __shared__ float s[LH][LW];\n  __shared__ float rm[LH][NMS_W];\n")
    one = head
    for a, b in (("template <int R>", "template <int R_>"), ("scores) {", "scores, int R) {"),
                 ("constexpr int LW", "const int LW"),
                 ("s[LH][LW]", "s[NMS_H + 2 * MAX_R][NMS_W + 2 * MAX_R]"),
                 ("rm[LH][NMS_W]", "rm[NMS_H + 2 * MAX_R][NMS_W]")):
        one = patch(one, a, b)
    runtime = patch(src, head, one)
    runtime = patch(runtime, "nms_kernel<R><<<grid, NMS_T, 0, stream>>>(heat, H, W, thr, scores);",
                    "nms_kernel<0><<<grid, NMS_T, 0, stream>>>(heat, H, W, thr, scores, R);")
    libs = {name: build(tree, f"keypoints_{name}", text)
            for name, text in (("as_is", src), ("runtime_r", runtime))}
    heats = {kind: C.nms_inputs(kind, 480, 640, "cuda")
             for kind in ("random", "superpoint", "plateau", "few")}
    for name in ("as_is", "runtime_r", "runtime_r", "as_is"):
        if libs[name] is None:
            continue
        g = libs[name].mmf_nms_topk
        g.argtypes = [K.P, K.I, K.I, K.I, K.F, K.I] + [K.P] * 5
        g.restype = K.I
        for kind, (heat, k, thr, r) in heats.items():
            scores = torch.empty(heat.numel(), device="cuda")
            xy = torch.empty((k, 2), device="cuda")
            score = torch.empty(k, device="cuda")
            valid = torch.empty(k, dtype=torch.bool, device="cuda")

            def run():
                err = g(heat.data_ptr(), heat.shape[0], heat.shape[1], k, float(np.float32(thr)),
                        r, scores.data_ptr(), xy.data_ptr(), score.data_ptr(), valid.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            us = device_us(torch, run)
            plain = SP.nms_topk_plain(heat.cpu(), k, thr, r)
            same = all(torch.equal(o.cpu(), e) for o, e in zip((xy, score, valid), plain))
            print(json.dumps({"kernel": "nms_topk", "variant": name, "heat": kind,
                              "device_us": us, "equal_to_plain": same}), flush=True)


def sass_opcodes(path: str, kernel: str) -> dict:
    """{opcode: count} of ``kernel``'s SASS in the library ``path``
    (``cuobjdump -sass``; {} where the tool is missing)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
    counts, inside = defaultdict(int), False
    for ln in out.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if inside and m:
            counts[m.group(1).split(".")[0]] += 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def level_variants(tree, torch, K, C, LV, FM):
    """K1's filter and K2's two sides at 640x480 as they are and as edited
    copies (see the module's docstring)."""
    csrc = os.path.join(tree, "multimotionfusion_tpu_torch", "csrc")
    fsrc = open(os.path.join(csrc, "frame_maps.cu")).read()
    psrc = open(os.path.join(csrc, "pyramid.cu")).read()
    gated = ("          float w = expf(-((sp + c2 * sigma_color) + g[i + ox]));\n"
             "          sum1[i] = sum1[i] + sq * w;\n          sum2[i] = sum2[i] + w;\n")
    select = patch(fsrc, gated, "          float w = expf(-(sp + c2 * sigma_color));\n"
                                "          w = sq > 0.f ? w : 0.f;\n"
                                "          sum1[i] = sum1[i] + sq * w;\n"
                                "          sum2[i] = sum2[i] + w;\n")
    branch = patch(fsrc, gated, "          if (sq > 0.f) {\n"
                                "          float w = expf(-(sp + c2 * sigma_color));\n"
                                "          sum1[i] = sum1[i] + sq * w;\n"
                                "          sum2[i] = sum2[i] + w;\n          }\n")
    tile = "constexpr int FX = 4, FTX = 16, FTY = 8;"
    filters = {"as_is": fsrc, "select_per_tap": select, "branch_per_tap": branch,
               "fx8": patch(fsrc, tile, "constexpr int FX = 8, FTX = 8, FTY = 8;")}
    stamps = patch(STAMPS, "blockIdx.x < 16", "blockIdx.x < 16 && blockIdx.y == gridDim.y / 2")
    cut = psrc.index("__global__ void __launch_bounds__(NT, 3) pred_levels")
    parts = []
    for part, end in ((psrc[:cut], None), (psrc[cut:], "inline Cam cam_of")):
        part = patch(part, "  const int t = threadIdx.x;\n",
                     "  const int t = threadIdx.x;\n  int ns_ = 0;\n  stamp(ns_++);\n")
        part = patch(part, "  __syncthreads();\n", "  __syncthreads();\n  stamp(ns_++);\n", count=0)
        part = patch(part, "    sync_low_half();\n", "    sync_low_half();\n    stamp(ns_++);\n")
        k = part.rindex("}", 0, part.index(end or "- prediction side\n"))
        parts.append(part[:k] + "  stamp(ns_++);\n" + part[k:])
    pyramids = {"as_is": psrc,
                "bounds_4": patch(psrc, "__launch_bounds__(NT, 3)", "__launch_bounds__(NT, 4)",
                                  count=0),
                "stamped": stamps + parts[0] + parts[1]}
    raw = C.filter_inputs("scene", "mm", 480, 640, "cuda")
    fa, pa = C.pyramid_inputs(480, 640, {}, 1, "cuda")
    lines = {"frame_maps": {"filter": lambda: FM.frame_depth_cuda(*raw)},
             "pyramid": {"frame": lambda: LV.frame_levels_cuda(*fa),
                         "pred": lambda: LV.pred_levels_cuda(*pa)}}
    flat = lambda r: [t for x in r for t in (x if isinstance(x, tuple) else (x,))]  # noqa: E731
    for lib_name, variants in (("frame_maps", filters), ("pyramid", pyramids)):
        kept, ref = K._libs[lib_name], {}
        built = {name: build(tree, f"{lib_name}_{name}", text) for name, text in variants.items()}
        try:
            for name in list(variants) + ["as_is"]:
                if built[name] is None:
                    continue
                K._libs[lib_name] = built[name]
                for what, fn in lines[lib_name].items():
                    out = [t.clone() for t in flat(fn())]
                    ref.setdefault(what, out)
                    same = all(a.shape == b.shape and torch.equal(a.view(torch.uint8),
                                                                   b.view(torch.uint8))
                               for a, b in zip(out, ref[what]))
                    runs = []
                    for _ in range(3):  # clocks up first; the median of three readings
                        _busy(torch)
                        runs.append(sum(device_us(torch, fn).values()))
                    line = {"kernel": f"{lib_name}.{what}", "variant": name,
                            "device_us": sorted(runs)[1], "device_us_runs": runs,
                            "equal_to_as_is": same}
                    if name == "stamped":
                        fn()
                        torch.cuda.synchronize()
                        rows = [r for r in read_stamps(built[name]) if r[0]]
                        t0 = min(r[0] for r in rows)
                        line["stamps_us_earliest_latest"] = [
                            [round((min(r[k] for r in rows) - t0) / 1e3, 2),
                             round((max(r[k] for r in rows) - t0) / 1e3, 2)]
                            for k in range(64) if all(r[k] for r in rows)]
                    print(json.dumps(line), flush=True)
                print(json.dumps({"variant": f"{lib_name}_{name}",
                                  "ptxas": ptxas_summary(LOGS.get(f"{lib_name}_{name}", ""))}))
                if lib_name == "frame_maps":
                    ops = sass_opcodes(os.path.join(tree, "build", "variants",
                                                    f"{lib_name}_{name}.so"), "bilateral")
                    print(json.dumps({"kernel": "frame_maps.filter", "variant": name,
                                      "sass_instructions": sum(ops.values()),
                                      "sass_opcodes": ops}), flush=True)
        finally:
            K._libs[lib_name] = kept


def _locality(torch, index) -> dict:
    """Distinct 32-byte sectors of a channel that 32 consecutive pixels of
    an index-map row gather (winners only), and the winners they hold."""
    h, w = index.shape
    runs = index[:, : (w // 32) * 32].reshape(-1, 32)
    sec = torch.where(runs >= 0, runs // 8, torch.full_like(runs, -1)).sort(dim=1).values
    distinct = ((sec[:, 1:] != sec[:, :-1]) & (sec[:, 1:] >= 0)).sum(1) + (sec[:, 0] >= 0).long()
    winners = (runs >= 0).sum(1)
    keep = winners > 0
    return dict(sectors_per_32_pixels=float(distinct[keep].float().mean()),
                winners_per_32_pixels=float(winners[keep].float().mean()),
                distinct_winners=int(torch.unique(index[index >= 0]).numel()))


def splat_sources(csrc):
    """({variant: K10 source}, {variant: K14 source}) of the ``splat`` part."""
    ssrc = open(os.path.join(csrc, "splat_resolve.cu")).read()
    fsrc = open(os.path.join(csrc, "fuse_flat.cu")).read()
    loop = ssrc[ssrc.index("#pragma unroll\n    for (int dy = 0; dy < window; ++dy) {"):
                ssrc.index("    const bool ok = best >= 0;")]
    stage = ssrc[ssrc.index("  float conf[ROUNDS], last[ROUNDS], gate[ROUNDS];"):
                 ssrc.index("  __syncthreads();\n\n  const int x = x0 + tx")]
    splats = {
        "as_is": ssrc,
        "three_values": patches(ssrc, THREE_VALUES),
        "runtime_window": patch(ssrc, "window == 5 ? resolve<5> : resolve<0>", "resolve<0>"),
        "tile_32x16": patch(ssrc, "constexpr int TW = 32, TH = 8;", "constexpr int TW = 32, TH = 16;"),
        "no_taps": patch(ssrc, loop, "    (void)l0; (void)l1; (void)l2; (void)own_p;\n"),
        "no_gathers": patch(ssrc, stage, """#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int s = threadIdx.x + k * THREADS;
    if (s < sw * sh) {
      st.pp[s] = st.nr[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      st.conf[s] = 0.f;
      st.key[s] = make_int2(c[k], oq[k]);
    }
  }
"""),
        "no_fill": patch(ssrc, "if (f.rgb != nullptr && (!ok || f.passthrough) && "
                               "(f.gate == nullptr || f.gate[p] == 0)) {", "if (false) {"),
    }
    counts = fsrc[fsrc.index("  window_counts_staged<CLEAN_STAGED, WINDOW>("):
                  fsrc.index("  bool viol;\n  float pen = see_through(")]
    cleans = {
        "as_is": fsrc,
        "runtime_window": patch(fsrc, "window == 4 ? pixel_pass<4> : pixel_pass<0>",
                                "pixel_pass<0>"),
        "tile_32x16": patch(fsrc, "constexpr int CTW = 32, CTH = 8;",
                            "constexpr int CTW = 32, CTH = 16;"),
        "no_counts": patch(fsrc, counts, "  count = z_count = 0;\n"),
    }
    return splats, cleans


def splat_variants(tree, torch, K, C, FU, R):
    """K10 and K14's clean on the engine's recorded inputs, as they are and
    as edited copies (see the module's docstring)."""
    import chip_smoke as S

    cfg, frames, gt = S.static_frames(S.N_FRAMES)
    captured = S.run_engine(K, cfg, frames, gt)[2]
    m_cfg, m_frames = S.multi_frames(1 + S.MULTI_FRAMES)
    m_captured = S.run_multi(K, m_cfg, m_frames)[2]
    static = C.args("splat_resolve", captured["splat_resolve"])
    composite = C.args("splat_resolve.composite", m_captured["splat_resolve.composite"])
    clean = C.args("clean_flat", m_captured["clean_flat"])
    for what, index in (("static", static[0]), ("composite", composite[0])):
        print(json.dumps({"kernel": f"splat_resolve.{what}", **_locality(torch, index)}))
    splats, cleans = splat_sources(os.path.join(tree, "multimotionfusion_tpu_torch", "csrc"))
    stores = iter([])

    def fresh():  # a store for each clean call, copied before the timing
        return next(stores)

    lines = {"splat_resolve": {"static": lambda: R.splat_resolve_cuda(*static),
                               "composite": lambda: R.splat_resolve_cuda(*composite)},
             "fuse_flat": {"clean": lambda: (FU.clean_flat_cuda(fresh(), *clean[1:]),)}}
    for lib_name, variants in (("splat_resolve", splats), ("fuse_flat", cleans)):
        kept, ref = K._libs[lib_name], {}
        built = {name: build(tree, f"{lib_name}_{name}", text) for name, text in variants.items()}
        try:
            for name in variants:
                if built[name] is None:
                    continue
                K._libs[lib_name] = built[name]
                for what, fn in lines[lib_name].items():
                    if what == "clean":
                        stores = iter([clean[0].clone() for _ in range(1 + 3 * 25)])
                    out = [t.clone() for t in fn()]
                    ref.setdefault(what, out)
                    same = all(a.shape == b.shape and torch.equal(a.view(torch.uint8),
                                                                   b.view(torch.uint8))
                               for a, b in zip(out, ref[what]))
                    runs = []
                    for _ in range(3):  # clocks up first; the median of three readings
                        _busy(torch)
                        runs.append(sum(device_us(torch, fn).values()))
                    print(json.dumps({"kernel": f"{lib_name}.{what}", "variant": name,
                                      "device_us": sorted(runs)[1], "device_us_runs": runs,
                                      "equal_to_as_is": same}), flush=True)
                print(json.dumps({"variant": f"{lib_name}_{name}",
                                  "ptxas": ptxas_summary(LOGS.get(f"{lib_name}_{name}", ""))}))
        finally:
            K._libs[lib_name] = kept


# K11's owner prep: thread 0 of every 100th block (blocks 0-74 are level
# 2's, 75-374 level 1's, the rest level 0's at 640x480), rows 0-15
OWNER_STAMP_BLOCKS = "blockIdx.x % 100 == 0 && blockIdx.x < 1600"
OWNER_MARKS = [
    ("start", "  const int b = blockIdx.x;\n", 0, True),
    ("own fields loaded, staging starts", "  // 1. (level 0) the prediction owners", 1, False),
    ("staged (stores issued)", "  __syncthreads();\n  if (!in) return;", 2, False),
    ("barrier passed", "  if (!in) return;\n", 3, False),
    ("end", "  L.sv[p] = valid ? 1 : 0;\n", 4, True),
]
UNARY_MARKS = [
    ("start", "  // every load of the first round in flight together", 0, False),
    ("first round loaded, tracks located", "  locate_tracks(a, 0, c0, local);\n", 1, True),
    ("barrier 1 passed", "n_list = 0;\n  __syncthreads();\n", 2, True),
    ("tracks listed", "    const int n = n_list;\n", 3, False),
    ("cell rows done", "    if (t0 == 0 && cell) cell_rows(a, act, c, npix, fd, pds);\n", 4, True),
    ("track errors done", "  __syncthreads();\n  if (!cell) return;\n  // softmax", 5, False),
    ("barrier 2 passed", "  if (!cell) return;\n  // softmax", 6, False),
    ("end", "    a.unary[l * npix + c] = -logf(fmaxf(pl, 1e-12f));\n  }\n", 7, True),
]
# K18's softmax as the three error values' exps and -logs, each taken once
# (arguments, which the compiler cannot fold), selected per label
THREE_VALUES = [
    ("  float max_err;\n", "  float max_err;\n  float e0, e1, einf;\n"),
    ("           max_err, fdc,", "           max_err, 0.f, 1.f, INFINITY, fdc,"),
    ("  float esum = 0.f;\n  for (int l = 0; l < L; ++l) esum = esum + expf(-__int_as_float(e[l * UN_C]));\n"
     "  const float uniform = (float)(1.0 / (double)L);\n"
     "  for (int l = 0; l < L; ++l) {\n"
     "    const float pl = esum > 0.f ? expf(-__int_as_float(e[l * UN_C])) / fmaxf(esum, 1e-12f)\n"
     "                                : uniform;\n"
     "    a.unary[l * npix + c] = -logf(fmaxf(pl, 1e-12f));\n  }\n",
     "  const float x0 = expf(-a.e0), x1 = expf(-a.e1), xinf = expf(-a.einf);\n"
     "  float esum = 0.f;\n  for (int l = 0; l < L; ++l) {\n"
     "    const float el = __int_as_float(e[l * UN_C]);\n"
     "    esum = esum + (el == 0.f ? x0 : el == 1.f ? x1 : xinf);\n  }\n"
     "  if (!(esum > 0.f)) {\n"
     "    const float u = -logf(fmaxf((float)(1.0 / (double)L), 1e-12f));\n"
     "    for (int l = 0; l < L; ++l) a.unary[l * npix + c] = u;\n    return;\n  }\n"
     "  const float u0 = -logf(fmaxf(x0 / fmaxf(esum, 1e-12f), 1e-12f));\n"
     "  const float u1 = -logf(fmaxf(x1 / fmaxf(esum, 1e-12f), 1e-12f));\n"
     "  const float uinf = -logf(fmaxf(xinf / fmaxf(esum, 1e-12f), 1e-12f));\n"
     "  for (int l = 0; l < L; ++l) {\n"
     "    const float el = __int_as_float(e[l * UN_C]);\n"
     "    a.unary[l * npix + c] = el == 0.f ? u0 : el == 1.f ? u1 : uinf;\n  }\n"),
]
# K11's level-0 staging wrapped by one add or subtract (valid where the
# image is at least the staged region, as at 640x480)
WRAP_ONCE = [
    ("// the eroded prediction owner of level-0 pixel",
     "__device__ __forceinline__ int wrap_once(int v, int n) {\n"
     "  v += v < 0 ? n : 0;\n  v -= v >= n ? n : 0;\n  return v;\n}\n\n"
     "// the eroded prediction owner of level-0 pixel"),
    ("po[k] = a.pred_own[wrap(Y0 + r, a.H0) * a.W0 + wrap(X0 + c, a.W0)];",
     "po[k] = a.pred_own[wrap_once(Y0 + r, a.H0) * a.W0 + wrap_once(X0 + c, a.W0)];"),
]


def patches(text, edits):
    """``text`` with every (old, new) of ``edits`` applied by ``patch``."""
    for old, new in edits:
        text = patch(text, old, new)
    return text


def owner_unaries_sources(csrc):
    """({variant: K11 source}, {variant: K18 source}) of the ``owner`` part."""
    gsrc = open(os.path.join(csrc, "gn_multi.cu")).read()
    ssrc = open(os.path.join(csrc, "segment.cu")).read()
    dispatch = "  const int b = blockIdx.x;\n"
    owners = {
        "as_is": gsrc,
        "wrap_once": patches(gsrc, WRAP_ONCE),
        "bounds_6": patch(gsrc, "__global__ void __launch_bounds__(OT) owner_prep(",
                          "__global__ void __launch_bounds__(OT, 6) owner_prep("),
        "tile_64x4": patch(gsrc, "constexpr int OTW = 32, OTH = 8, OT = OTW * OTH;",
                           "constexpr int OTW = 64, OTH = 4, OT = OTW * OTH;"),
        "level_0_only": patch(gsrc, dispatch, dispatch + "  if (b < a.L[1].block_end) return;\n"),
        "levels_1_2_only": patch(gsrc, dispatch,
                                 dispatch + "  if (b >= a.L[1].block_end) return;\n"),
        "every_block_returns": patch(gsrc, dispatch, dispatch + "  if (b >= 0) return;\n"),
        "stamped": stamped(gsrc, OWNER_MARKS).replace(
            "if (threadIdx.x == 0 && blockIdx.x < 16) {",
            f"if (threadIdx.x == 0 && {OWNER_STAMP_BLOCKS}) {{").replace(
            "g_stamp[blockIdx.x][k] = t;", "g_stamp[blockIdx.x / 100][k] = t;"),
    }
    scan = "  locate_tracks(a, 0, c0, local);\n"
    unaries = {
        "as_is": ssrc,
        "three_values": patches(ssrc, THREE_VALUES),
        "cells_320": patch(ssrc, "constexpr int UN_C = 160;", "constexpr int UN_C = 320;"),
        "cells_512": patch(ssrc, "constexpr int UN_C = 160;", "constexpr int UN_C = 512;"),
        "cells_96": patch(ssrc, "constexpr int UN_C = 160;", "constexpr int UN_C = 96;"),
        "threads_256": patch(ssrc, "constexpr int UN_T = 512;", "constexpr int UN_T = 256;"),
        "no_tracks": patch(ssrc, scan, scan + "  if (true) {\n    for (int k = 0; k < UN_TRACKS; "
                                            "++k) local[k] = -1;\n    a.T = 0;\n  }\n"),
        "no_cell_rows": patch(ssrc, "    if (t0 == 0 && cell) cell_rows(a, act, c, npix, fd, pds);\n",
                              ""),
        "no_softmax": patch(ssrc, "  if (!cell) return;\n  // softmax",
                            "  if (true) return;\n  // softmax"),
        "returns_at_once": patch(ssrc, "  const int npix = a.hc * a.wc, L = a.M + 1;\n",
                                 "  const int npix = a.hc * a.wc, L = a.M + 1;\n"
                                 "  if (npix > 0) return;\n"),
        "stamped": stamped(ssrc, UNARY_MARKS),
    }
    return owners, unaries


def owner_variants(tree, torch, K, C, MO, FC, names=None):
    """K11's owner prep and K18's unaries on the inputs ``chip_smoke.py``'s
    external-mask and flow-CRF runs record, as they are and as edited
    copies: the owner prep at six blocks an SM (``__launch_bounds__``),
    with a 64 x 4 tile and with its staging wrapped by one add or subtract
    (``WRAP_ONCE``) and, as diagnostics whose outputs differ, with only
    level 0's blocks, only levels 1 and 2's, and every block returning at
    once (the grid's own cost); the unaries with 320, 512 and 96 cells a
    block, 256 threads a block and the softmax's exps taken once per error
    value (``THREE_VALUES``) and, as diagnostics, without the tracks,
    without the cell rows, without the softmax and returning at once; the
    median of three readings after ~50 ms of matrix products, and whether
    the outputs equal the source's. The ``stamped`` copies print per block
    the globaltimer (us from the kernel's first stamp) at ``OWNER_MARKS`` /
    ``UNARY_MARKS`` (thread 0 of every 100th owner block, of the first 16
    unaries blocks)."""
    import chip_smoke as S

    m_cfg, m_frames = S.multi_frames(1 + S.MULTI_FRAMES)
    m_captured = S.run_multi(K, m_cfg, m_frames)[2]
    f_cfg, f_frames = S.multi_frames(1 + S.MULTI_FRAMES, masks=False)
    f_captured = S.run_multi_flow(K, f_cfg, f_frames)[2]
    own = C.args("owner_prep", m_captured["owner_prep"])
    un = C.args("segment.unaries", f_captured["segment.unaries"])
    owners, unaries = owner_unaries_sources(os.path.join(tree, "multimotionfusion_tpu_torch",
                                                         "csrc"))
    if names:
        owners = {k: v for k, v in owners.items() if k in names}
        unaries = {k: v for k, v in unaries.items() if k in names}

    lines = {"gn_multi": ("owner_prep", lambda: [
                 t for ml in MO.owner_levels(*own) for t in (ml.own, ml.bank_own,
                                                             ml.gl.static_valid)]),
             "segment": ("segment.unaries", lambda: list(FC.unaries_cuda(*un)))}
    for lib_name, variants in (("gn_multi", owners), ("segment", unaries)):
        kept, ref = K._libs[lib_name], None
        built = {name: build(tree, f"{lib_name}_{name}", text) for name, text in variants.items()}
        what, fn = lines[lib_name]
        try:
            for name in variants:
                if built[name] is None:
                    continue
                K._libs[lib_name] = built[name]
                if name == "stamped":  # per block, us from the kernel's first stamp
                    _busy(torch)
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                    rows = read_stamps(built[name])
                    t0 = min(row[0] for row in rows if row[0])
                    marks = OWNER_MARKS if lib_name == "gn_multi" else UNARY_MARKS
                    print(json.dumps({"kernel": what, "variant": name, "stamps": {
                        "labels": [m[0] for m in marks],
                        "blocks": [[round((v - t0) / 1e3, 2) if v else None
                                    for v in row[:len(marks)]] for row in rows]}}), flush=True)
                    continue
                out = [t.clone() for t in fn()]
                ref = out if ref is None else ref
                same = all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(out, ref))
                runs = []
                for _ in range(3):  # clocks up first; the median of three readings
                    _busy(torch)
                    runs.append(sum(device_us(torch, fn).values()))
                print(json.dumps({"kernel": what, "variant": name, "device_us": sorted(runs)[1],
                                  "device_us_runs": runs, "equal_to_as_is": same,
                                  "ptxas": ptxas_summary(LOGS.get(f"{lib_name}_{name}", ""))}),
                      flush=True)
        finally:
            K._libs[lib_name] = kept


# K13 in one cooperative launch: the scatter, a grid barrier, the decode by
# grid stride (the grid is the scatter's, which fits the card)
DEPTHS_ONE_LAUNCH = [
    ("#include <cuda_runtime.h>\n", "#include <cooperative_groups.h>\n#include <cuda_runtime.h>\n"),
    ("__global__ void __launch_bounds__(RD_T) scatter_depths(DepthArgs a) {\n",
     "__device__ __forceinline__ float decode_depth(int k);\n"
     "__global__ void __launch_bounds__(RD_T) scatter_depths(DepthArgs a) {\n"),
    ("    if (ok && ((heads >> lane) & 1u)) atomicMin(&a.keys[cell], kmin);\n  }\n}\n",
     "    if (ok && ((heads >> lane) & 1u)) atomicMin(&a.keys[cell], kmin);\n  }\n"
     "  cooperative_groups::this_grid().sync();\n"
     "  const int n = (a.slots + 1) * a.W * a.H;\n"
     "  for (int i = blockIdx.x * RD_T + threadIdx.x; i < n; i += gridDim.x * RD_T) {\n"
     "    const int k = __ldcg(a.keys + i);\n    a.depth[i] = decode_depth(k);\n"
     "    if (k != KEY_INVALID) a.keys[i] = KEY_INVALID;\n  }\n}\n"),
    ("  scatter_depths<<<grid, RD_T, 0, stream>>>(a);\n"
     "  decode_depths<<<decode_grid, RD_T, 0, stream>>>(a);\n",
     "  (void)decode_grid;\n  void* args[] = {&a};\n"
     "  e = cudaLaunchCooperativeKernel((const void*)scatter_depths, dim3(grid), dim3(RD_T), args, "
     "0, stream);\n  if (e != cudaSuccess) return (int)e;\n"),
]
# K13 without the warp's runs: one atomicMin a landed column
DEPTHS_PLAIN_ATOMICS = [
    ("    if (ok && ((heads >> lane) & 1u)) atomicMin(&a.keys[cell], kmin);\n",
     "    if (ok) atomicMin(&a.keys[cell], key);\n"),
]
# K13 grouping a warp's lanes by cell with __match_any_sync (any lanes, not
# runs) and __reduce_min_sync
DEPTHS_MATCH_ANY = [
    ("    if (ok && ((heads >> lane) & 1u)) atomicMin(&a.keys[cell], kmin);\n",
     "    const unsigned group = __match_any_sync(RD_FULL, id);\n"
     "    const int gmin = __reduce_min_sync(group, key);\n"
     "    if (ok && lane == __ffs(group) - 1) atomicMin(&a.keys[cell], gmin);\n"
     "    (void)kmin;\n"),
]


def depths_score_sources(csrc):
    """({variant: K13 source}, {variant: K19 source}) of the ``depths`` and
    ``score`` parts."""
    zsrc = open(os.path.join(csrc, "zbuffer.cu")).read()
    ksrc = open(os.path.join(csrc, "keypoints.cu")).read()
    launch = "  scatter_depths<<<grid, RD_T, 0, stream>>>(a);\n"
    decode = "  decode_depths<<<decode_grid, RD_T, 0, stream>>>(a);\n"
    depths = {
        "as_is": zsrc,
        "one_launch": patches(zsrc, DEPTHS_ONE_LAUNCH),
        "plain_atomics": patches(zsrc, DEPTHS_PLAIN_ATOMICS),
        "match_any": patches(zsrc, DEPTHS_MATCH_ANY),
        "two_blocks_an_sm": patch(zsrc, "resident[dev] = per_sm * sms;",
                                  "resident[dev] = (per_sm < 2 ? per_sm : 2) * sms;"),
        "scatter_only": patch(zsrc, decode, ""),
        "decode_only": patch(zsrc, launch, ""),
        "returns_at_once": patch(zsrc, "  __shared__ DepthShared S;\n",
                                 "  __shared__ DepthShared S;\n  if (a.W > 0) return;\n"),
    }
    tile = "constexpr int PS_TX = 32, PS_TY = 20, PS_ROWS = 5, PS_T = 256;"
    origin = "  const int x0 = blockIdx.x * PS_TX, y0 = blockIdx.y * PS_TY;\n"
    scores = {
        "as_is": ksrc,
        "tile_32x28": patch(ksrc, tile,
                            "constexpr int PS_TX = 32, PS_TY = 28, PS_ROWS = 7, PS_T = 256;"),
        "tile_32x12": patch(ksrc, tile,
                            "constexpr int PS_TX = 32, PS_TY = 12, PS_ROWS = 3, PS_T = 128;"),
        "tile_32x20_t192": patch(ksrc, tile,
                                 "constexpr int PS_TX = 32, PS_TY = 20, PS_ROWS = 5, PS_T = 192;"),
        "tile_32x20_t320": patch(ksrc, tile,
                                 "constexpr int PS_TX = 32, PS_TY = 20, PS_ROWS = 10, PS_T = 320;"),
        "t512": patch(ksrc, tile,
                      "constexpr int PS_TX = 32, PS_TY = 28, PS_ROWS = 14, PS_T = 512;"),
        "returns_at_once": patch(ksrc, origin, "  if (H > 0) return;\n" + origin),
        # the phases, cumulatively: each returns after the barrier that ends it
        "staged_only": patch(ksrc, "  __syncthreads();\n  // 2. Sobel products",
                             "  __syncthreads();\n  if (H > 0) return;\n  // 2. Sobel products"),
        "products_only": patch(ksrc, "  __syncthreads();\n  // 3. horizontal passes",
                               "  __syncthreads();\n  if (H > 0) return;\n"
                               "  // 3. horizontal passes"),
        "horizontal_only": patch(ksrc, "  __syncthreads();\n  // 4. vertical passes",
                                 "  __syncthreads();\n  if (H > 0) return;\n"
                                 "  // 4. vertical passes"),
    }
    return depths, scores


def depths_score_variants(tree, torch, K, C, R, SP, only, names=None, baseline=None):
    """K13 (``depths``) and K19's patch_score (``score``) on the inputs the
    flow-CRF run records, as they are and as edited copies: K13 in one
    cooperative launch (a grid barrier before the decode), without the
    warp's runs (an atomic a column), grouping lanes by __match_any_sync
    and with two blocks an SM; as diagnostics
    whose outputs differ, the scatter alone, the decode alone and the
    scatter returning at once (the launches' own cost); patch_score with
    32 x 20 tiles at 192 and 320 threads a block, 32 x 28 tiles (256; 512,
    two output rows a thread) and 32 x 12 tiles (128) and, as
    diagnostics, returning at once and after each phase's barrier (staged,
    products, horizontal sums). Each reading is chip_smoke's
    (``_device_profile``: every device event of 20 calls after 10 and 50 ms
    idle), the median of three, and one cold (a 64 MB fill before every
    call); with the launches a call and whether the outputs equal the
    source's. K13's scratch is set back to KEY_INVALID after each variant.
    With ``baseline`` (another tree), its ``zbuffer.cu`` and ``keypoints.cu``
    run too, as the variant ``baseline`` (the same entry points)."""
    import chip_smoke as S

    f_cfg, f_frames = S.multi_frames(1 + S.MULTI_FRAMES, masks=False)
    f_captured = S.run_multi_flow(K, f_cfg, f_frames)[2]
    da = C.args("zbuffer.depths", f_captured["zbuffer.depths"])
    sa = C.args("patch_score", f_captured["patch_score"])
    counts = da[0].counts.tolist()
    print(json.dumps({"kernel": "zbuffer.depths", "counts": counts,
                      "cells": (1 + da[0].odata.shape[0]) * da[4].height * da[4].width}))
    depths, scores = depths_score_sources(os.path.join(tree, "multimotionfusion_tpu_torch",
                                                       "csrc"))
    if baseline:
        other = os.path.join(baseline, "multimotionfusion_tpu_torch", "csrc")
        depths["baseline"] = open(os.path.join(other, "zbuffer.cu")).read()
        scores["baseline"] = open(os.path.join(other, "keypoints.cu")).read()
    parts = {"zbuffer": ("zbuffer.depths", depths, lambda: [R.render_depths_cuda(*da)]),
             "keypoints": ("patch_score", scores, lambda: list(SP.patch_score_cuda(*sa)))}
    flush = torch.empty(64 << 18, dtype=torch.float32, device="cuda")
    scratch = R.depth_scratch(da[0].gdata.device,
                              (1 + da[0].odata.shape[0]) * da[4].height * da[4].width)
    for lib_name, part in (("zbuffer", "depths"), ("keypoints", "score")):
        if part not in only:
            continue
        what, variants, fn = parts[lib_name]
        if names:
            variants = {k: v for k, v in variants.items() if k in names}
        kept, ref = K._libs[lib_name], None
        built = {name: build(tree, f"{lib_name}_{name}", text) for name, text in variants.items()}
        try:
            for name in variants:
                if built[name] is None:
                    continue
                K._libs[lib_name] = built[name]
                out = [t.clone() for t in fn()]
                torch.cuda.synchronize()
                clean = bool((scratch == 2**31 - 1).all())
                ref = out if ref is None else ref
                same = all(a.shape == b.shape and torch.equal(a.view(torch.uint8),
                                                               b.view(torch.uint8))
                           for a, b in zip(out, ref))
                # chip_smoke's reader (every device event of 20 calls in a
                # marked range after 10 warm-up calls and 50 ms idle), three
                # times, and once cold (a 64 MB fill before every call)
                reads = [S._device_profile(fn) for _ in range(3)]
                runs = [r[0] * 1e3 if r[0] is not None else None for r in reads]
                launches = reads[0][1]
                cold = S._device_profile(fn, before=lambda: flush.fill_(1.0),
                                         skip=("FillFunctor",))[0]
                cold_us = None if cold is None else cold * 1e3
                scratch.fill_(2**31 - 1)
                valid = sorted(r for r in runs if r is not None)
                print(json.dumps({"kernel": what, "variant": name,
                                  "device_us": valid[len(valid) // 2] if valid else None,
                                  "device_us_runs": runs, "cold_us": cold_us,
                                  "launches_per_call": launches, "equal_to_as_is": same,
                                  "scratch_clean_after": clean,
                                  "ptxas": ptxas_summary(LOGS.get(f"{lib_name}_{name}", ""))}),
                      flush=True)
        finally:
            K._libs[lib_name] = kept


# K7/K9 (csrc/clean.cu) and K24c (csrc/legacy_crf.cu) as edited copies
# where a flag frame's copy runs: all of it in the surfel pass (no copy
# blocks), or all of it in the pixel pass's launch
PIXEL_COPY = ("constexpr unsigned PIXEL_COPY = (1u << PX) | (1u << PY) | (1u << PZ) | (1u << CR) | "
              "(1u << CG) |\n                                (1u << CB) | (1u << INIT_T);")


LCRF_MARKS = [
    ("start", "  extern __shared__ float smem[];", 0, True),
    ("step t staged", "    __syncthreads();  // Q staged (and the rows), the last pass's messages "
     "read", "1 + 3 * t", True),
    ("step t rows done", "    if (t + 1 < a.steps) cg::this_grid().sync();", "2 + 3 * t", False),
    ("step t barrier passed", "    if (t + 1 < a.steps) cg::this_grid().sync();",
     "3 + 3 * t", True),
]
LCRF_LABELS = {0: "start"}
LCRF_LABELS.update({1 + 3 * t + k: f"step {t} {what}" for t in range(10)
                    for k, what in enumerate(("staged", "rows done", "barrier passed"))})


def clean_lcrf_sources(csrc):
    """({variant: K7/K9 source}, {variant: K24c source}) of the ``clean``,
    ``compact`` and ``lcrf`` parts."""
    csrc_clean = open(os.path.join(csrc, "clean.cu")).read()
    lsrc = open(os.path.join(csrc, "legacy_crf.cu")).read()
    pixels = "  pixels<<<copy_blocks + tiles, CLEAN_THREADS, 0, stream>>>(pa, verdicts);\n"
    clean = {
        "as_is": csrc_clean,
        "runtime_window": patch(csrc_clean, "auto pixels = window == 4 ? pixel_pass<4> : "
                                "pixel_pass<0>;", "auto pixels = pixel_pass<0>;"),
        "fill_launch": patch(csrc_clean, pixels,
                             "  fill_verdicts<<<(B + THREADS - 1) / THREADS, THREADS, 0, "
                             "stream>>>(verdicts, B);\n" + pixels),
        "copy_in_surfel_pass": patch(csrc_clean, PIXEL_COPY,
                                     "constexpr unsigned PIXEL_COPY = 0u;"),
        "copy_in_pixel_launch": patch(csrc_clean, PIXEL_COPY,
                                      "constexpr unsigned PIXEL_COPY = 0xffffu & ~((1u << CONF) | "
                                      "(1u << ALIVE));"),
        # diagnostics whose outputs differ: the pixel pass alone, the second
        # launch alone
        "pixel_pass_only": patch(csrc_clean, "  KeepArgs k{count, time, conf_thr, grace, "
                                 "time_delta, conf_p};\n",
                                 "  KeepArgs k{count, time, conf_thr, grace, time_delta, "
                                 "conf_p};\n  if (H > 0) return (int)cudaGetLastError();\n"),
        "second_launch_only": patch(csrc_clean, pixels, ""),
        "pixel_tiles_only": patches(csrc_clean, [(PIXEL_COPY, "constexpr unsigned PIXEL_COPY = 0u;"), (
            "  KeepArgs k{count, time, conf_thr, grace, time_delta, conf_p};\n",
            "  KeepArgs k{count, time, conf_thr, grace, time_delta, conf_p};\n"
            "  if (H > 0) return (int)cudaGetLastError();\n")]),
        "no_tail_zeroing": patch(csrc_clean, "  for (int z = s.n - e_incl + threadIdx.x; z < s.n - "
                                 "e_before && z < s.cap; z += CT)\n    zero_column(s.dst, "
                                 "s.dst_rs, z);\n", ""),
    }
    sync = "    if (t + 1 < a.steps) cg::this_grid().sync();\n"
    lcrf = {
        "as_is": lsrc,
        "unstaged": patch(lsrc, "const bool staged = q_bytes <= STAGE_MAX;",
                          "const bool staged = false;"),
        "rows_from_l2": patch(lsrc, "for (int rows = staged && q_bytes + msg_bytes + row_bytes <= "
                              "FIELD_MAX_SMEM; rows >= 0; --rows) {",
                              "for (int rows = 0; rows >= 0; --rows) {"),
        "row_batch_1": patch(lsrc, "constexpr int ROW_BATCH = 8;", "constexpr int ROW_BATCH = 1;"),
        "row_batch_4": patch(lsrc, "constexpr int ROW_BATCH = 8;", "constexpr int ROW_BATCH = 4;"),
        "stage_batch_1": patch(lsrc, "constexpr int STAGE_BATCH = 8;",
                               "constexpr int STAGE_BATCH = 1;"),
        "labels_8_a_warp": patch(lsrc, "constexpr int FIELD_LG = 4;", "constexpr int FIELD_LG = 8;"),
        "labels_2_a_warp": patch(lsrc, "constexpr int FIELD_LG = 4;", "constexpr int FIELD_LG = 2;"),
        "plan_one_row_a_block": patch(lsrc, "constexpr int PLAN_ROWS = 8;",
                                      "constexpr int PLAN_ROWS = 1;"),
        "stamps": stamped(lsrc, LCRF_MARKS),
        # diagnostics whose outputs differ: no grid barrier; the plan's first
        # launch alone
        "no_barrier": patch(lsrc, sync, ""),
        "plan_sums_only": patch(lsrc, "  plan_rows<<<row_blocks, THREADS, 0, stream>>>(a);\n", ""),
    }
    return clean, lcrf


def clean_lcrf_variants(tree, torch, K, C, FU, SM, LC, only, names=None):
    """K7/K9's flag frame (into the bucket and in place), compaction frame,
    ``compact`` and multi-model repack, and K24c's plan and ten-step mean
    field, on the inputs chip_smoke.py's static, flow-CRF and legacy runs
    record, as they are and as edited copies (``clean_lcrf_sources``):
    the pixel pass's window at run time, the parent's fill launch put back,
    the flag frame's whole copy in the surfel pass (no copy blocks) or in
    the pixel pass's launch; the mean field with its kernel rows read
    from the L2 at every step, with Q read from the L2,
    with one or four row terms loaded at a time and one staging load at a
    time, eight or two labels a warp, the plan at one row a block, and with
    globaltimer stamps (thread 0 of the first 16 blocks: each step's
    staging, rows and barrier); as diagnostics whose outputs differ, the
    pixel pass alone, the second launch alone, the compaction without its
    tail zeroing, the pixel tiles alone (no copy blocks), the mean field
    without its grid barrier and the plan's
    first launch alone. Each reading chip_smoke's
    (``_device_profile``), the median of three, with the launches a call and
    whether the outputs equal the source's."""
    import dataclasses

    import chip_smoke as S
    from multimotionfusion_tpu_torch.ops import rasterize as R

    reads, fns = {}, {}
    if only & {"clean", "compact"}:
        cfg, frames, gt = S.static_frames(S.N_FRAMES)
        captured = S.run_engine(K, cfg, frames, gt)[2]
        f_cfg, f_frames = S.multi_frames(1 + S.MULTI_FRAMES, masks=False)
        f_captured = S.run_multi_flow(K, f_cfg, f_frames)[2]
        for key in ("clean", "clean.compact"):
            (data, count, index, dl, depth, mask, mask_id, cam, t, td, conf, cfg_s,
             compact) = C.args(key, captured[key])
            args = (SM.SurfelMap(data, count), R.IndexMap(index, dl), depth, mask, mask_id, cam,
                    t, td, conf, cfg_s, compact)
            out = torch.empty_like(data)
            fns[f"{key}[bucket]"] = ("clean", lambda args=args, out=out: list(
                FU.clean_cuda(*args, out=out)), None)
            if key == "clean":  # fresh copies of the map, 91 calls a variant
                pool, used = [data.clone() for _ in range(100)], [0]

                def in_place(args=args, pool=pool, used=used, count=count):
                    used[0] += 1
                    d = pool[(used[0] - 1) % len(pool)]
                    r = FU.clean_cuda(SM.SurfelMap(d, count), *args[1:], out=d)
                    return [r.data, r.count]

                def refill(pool=pool, used=used, data=data):
                    for x in pool[:min(used[0], len(pool))]:
                        x.copy_(data)
                    used[0] = 0

                fns["clean[in place]"] = ("clean", in_place, refill)
        ca = C.args("compact", captured["compact"])
        fns["compact"] = ("compact", lambda: list(SM.compact_cuda(*ca)), None)
        gsrc, osrc, counts, gdst, odst = C.args("compact.segments",
                                                f_captured["compact.segments"])
        gk, ok_ = gdst.clone(), odst.clone()
        fns["compact.segments"] = ("compact", lambda: [
            SM.compact_segments_cuda(gsrc, osrc, counts, gk, ok_), gk, ok_], None)
    if "lcrf" in only:
        f_cfg, f_frames = S.multi_frames(1 + S.MULTI_FRAMES, masks=False)
        g_cfg = dataclasses.replace(f_cfg, segmentation=dataclasses.replace(
            f_cfg.segmentation, mode="crf"))
        g_captured = S.run_multi_legacy(K, g_cfg, f_frames)[2]
        la = C.args("legacy_crf.plan", g_captured["legacy_crf.plan"])
        plan = LC.crf_plan_cuda(*la)
        print(json.dumps({"kernel": "legacy_crf", "superpixels": plan.q0.shape[0],
                          "labels": plan.q0.shape[1]}))
        fns["legacy_crf.plan"] = ("lcrf", lambda: list(LC.crf_plan_cuda(*la)), None)
        fns["legacy_crf.mean_field[10]"] = ("lcrf", lambda: list(
            LC.crf_mean_field_cuda(plan, 10)), None)
    csrc = os.path.join(tree, "multimotionfusion_tpu_torch", "csrc")
    clean_src, lcrf_src = clean_lcrf_sources(csrc)
    for lib_name, part, variants in (("clean", "clean", clean_src),
                                     ("legacy_crf", "lcrf", lcrf_src)):
        mine = {k: v for k, v in fns.items() if v[0] == part
                or (part == "clean" and v[0] == "compact")}
        if not mine:
            continue
        if names:
            variants = {k: v for k, v in variants.items() if k in names or k == "as_is"}
        kept, ref = K._libs[lib_name], {}
        built = {name: build(tree, f"{lib_name}_{name}", text) for name, text in variants.items()}
        try:
            for name in variants:
                if built[name] is None:
                    continue
                K._libs[lib_name] = built[name]
                for what, (_, fn, refill) in mine.items():
                    # the persistent scratch as a fresh process has it: a
                    # diagnostic that drops a launch leaves verdicts voted or
                    # scan words used that the next launch expects reset
                    torch.cuda.synchronize()
                    for (sname, _dev), buf in K._SCRATCH.items():
                        if sname.startswith("compaction.scan."):
                            buf.zero_()
                        elif sname == "clean.verdicts":
                            buf.fill_(FU.VERDICT_NONE)
                    SM._WORDS.clear()
                    if refill is not None:
                        refill()
                    out = [x.clone() for x in fn()]
                    torch.cuda.synchronize()
                    ref.setdefault(what, out)
                    same = all(a.shape == b.shape and torch.equal(
                        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
                        for a, b in zip(out, ref[what]))
                    reads[(what, name)] = [S._device_profile(fn) for _ in range(3)]
                    runs = [r[0] * 1e3 if r[0] is not None else None
                            for r in reads[(what, name)]]
                    valid = sorted(r for r in runs if r is not None)
                    print(json.dumps({"kernel": what, "variant": name,
                                      "device_us": valid[len(valid) // 2] if valid else None,
                                      "device_us_runs": runs,
                                      "launches_per_call": reads[(what, name)][0][1],
                                      "equal_to_as_is": same,
                                      "ptxas": ptxas_summary(LOGS.get(f"{lib_name}_{name}", ""))}),
                          flush=True)
                    if name == "stamps" and what == "legacy_crf.mean_field[10]":
                        _busy(torch)
                        fn()
                        torch.cuda.synchronize()
                        report(what, built[name], LCRF_LABELS)
        finally:
            K._libs[lib_name] = kept


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--only",
                    default="flow,tracks,finish,select,nms,levels,splat,owner,depths,score,"
                            "clean,compact,lcrf",
                    help="comma-separated: flow, tracks, finish, select, nms, levels, splat, "
                         "owner, depths, score, clean, compact, lcrf")
    ap.add_argument("--baseline", default="",
                    help="another tree whose K13 and K19 sources the depths and score parts "
                         "also run (variant 'baseline')")
    ap.add_argument("--variants", default="",
                    help="comma-separated: the owner, depths, score, clean and lcrf parts' "
                         "variants to run (default all)")
    args = ap.parse_args()
    tree, only = os.path.abspath(args.tree), set(args.only.split(","))
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multimotionfusion_tpu_torch import kernels as K
    from multimotionfusion_tpu_torch.kernels import checks as C
    from multimotionfusion_tpu_torch.model import fusion as FU
    from multimotionfusion_tpu_torch.odometry import levels as LV
    from multimotionfusion_tpu_torch.odometry import multi as MO
    from multimotionfusion_tpu_torch.ops import frame_maps as FM
    from multimotionfusion_tpu_torch.ops import image as imops
    from multimotionfusion_tpu_torch.ops import rasterize as R
    from multimotionfusion_tpu_torch.segmentation import flow as FL
    from multimotionfusion_tpu_torch.segmentation import flow_crf as FC
    from multimotionfusion_tpu_torch.tracking import superpoint as SP
    from multimotionfusion_tpu_torch.tracking import tracker as TR

    K.build_all()
    if "flow" in only:
        flow_variants(tree, torch, K, C, FL, imops)
    if "tracks" in only:
        track_variants(tree, torch, K, C, TR)
    if "finish" in only:
        finish_phases(tree, torch, K, C, FC)
    if "select" in only:
        select_phases(tree, torch, K, C, SP)
    if "nms" in only:
        nms_variants(tree, torch, K, C, SP)
    if "levels" in only:
        level_variants(tree, torch, K, C, LV, FM)
    if "splat" in only:
        splat_variants(tree, torch, K, C, FU, R)
    names = set(filter(None, args.variants.split(",")))
    if "owner" in only:
        owner_variants(tree, torch, K, C, MO, FC, names)
    if only & {"clean", "compact", "lcrf"}:
        from multimotionfusion_tpu_torch.model import surfel_map as SM
        from multimotionfusion_tpu_torch.segmentation import legacy_crf as LC

        clean_lcrf_variants(tree, torch, K, C, FU, SM, LC, only, names)
    if "depths" in only or "score" in only:
        depths_score_variants(tree, torch, K, C, R, SP, only, names,
                              os.path.abspath(args.baseline) if args.baseline else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
