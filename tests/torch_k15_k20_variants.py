"""Times K15's one-launch flow and K20's match as they are and as edited
copies, to show where their time goes (needs one NVIDIA GPU; not a test).

    python3 tests/torch_k15_k20_variants.py [--tree DIR]

K15 (``csrc/flow.cu``) on ``checks.flow_case_inputs(480, 640)`` at the
640x480 CRF grid (120x160), with 1, 2 and 4 Lucas-Kanade iterations: as it
is (a cluster of 16 blocks); with a cluster of 8 (the portable size); with
every ``cluster.sync()`` doubled (the barriers' cost); and with a
globaltimer stamp after each barrier (block 0, thread 0: the phases'
times). K20 (``csrc/tracks.cu``): the match tile as
it is (128x128 a block, 8x4 registers a thread) and at 8x8 and at 64x64 a
block with 4x4 and 4x8 registers, through the wrappers (the edited library
swapped in), on ``checks.track_cases``' "more_new_than_free" table at the
default shapes: the device time of each kernel (torch.profiler, 20 calls
after 5), and whether every track and match case stays bit-equal to the
plain version. Each copy is written and built with the build's flags in
``DIR/build/variants``; an edit whose text is no longer in the source stops
the script. Prints JSON lines.
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
    if proc.returncode:
        print(json.dumps({"variant": name, "build_failed": proc.stdout + proc.stderr}))
        return None
    return ctypes.CDLL(out)


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


STAMPS = """#include <math.h>
__device__ unsigned long long g_stamp[64];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamp[k] = t;
  }
}
extern "C" int read_stamps(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
}
"""


def flow_variants(tree, torch, K, C, FL, imops):
    src = open(os.path.join(tree, "multimotionfusion_tpu_torch", "csrc", "flow.cu")).read()
    stamped = patch(src, "#include <math.h>\n", STAMPS)
    stamped = patch(stamped, "  const Layout L = layout(a);\n",
                    "  const Layout L = layout(a);\n  int ns_ = 0;\n  stamp(ns_++);\n")
    stamped = patch(stamped, "cluster.sync();", "cluster.sync(); stamp(ns_++);", count=0)
    k = stamped.rindex("}", 0, stamped.index("template <bool kShared>\nint launch"))
    stamped = stamped[:k] + "  stamp(ns_++);\n" + stamped[k:]
    c16 = f"constexpr int CLUSTER = {FL.CLUSTER};"
    variants = {"as_is": (FL.CLUSTER, src),
                "cluster_8": (8, patch(src, c16, "constexpr int CLUSTER = 8;")),
                "barriers_doubled": (FL.CLUSTER, patch(src, "cluster.sync();",
                                                       "cluster.sync(); cluster.sync();", count=0)),
                "stamped": (FL.CLUSTER, stamped)}
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
                buf = (ctypes.c_ulonglong * 64)()
                lib.read_stamps(buf)
                t = [v for v in buf if v]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_k15_k20_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multimotionfusion_tpu_torch import kernels as K
    from multimotionfusion_tpu_torch.kernels import checks as C
    from multimotionfusion_tpu_torch.ops import image as imops
    from multimotionfusion_tpu_torch.segmentation import flow as FL
    from multimotionfusion_tpu_torch.tracking import tracker as TR

    K.build_all()
    flow_variants(tree, torch, K, C, FL, imops)
    track_variants(tree, torch, K, C, TR)
    return 0


if __name__ == "__main__":
    sys.exit(main())
