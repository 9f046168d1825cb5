"""Device time of K1's filter and of K2's two sides (every level of the frame
side, every level's sampling map) for the package of one tree, warm and
cold, on the hand-made inputs of this checkout's ``checks.py`` at 640x480.

Run it on two trees in one call to compare two versions of the kernels with
one reader (for example the parent unpacked with ``git archive`` into an
ignored directory: parent, change, change, parent):

    python3 tests/torch_levels_times.py --tree DIR > times.json

``DIR`` holds ``multimotionfusion_tpu_torch/`` (by default this checkout);
its kernels are built into ``DIR``'s ``build/``. Each line goes through the
tree's public wrappers (``frame_maps.frame_depth_cuda``,
``levels.frame_levels``, ``levels.pred_levels``), so it times whatever
launches a tree makes for them. Readings: this checkout's
``chip_smoke._device_profile`` (every device event of 20 calls after 10
warm-up calls), warm (back to back: the inputs stay in the 50 MB L2) and
cold (``chip_smoke._cold``: a 64 MB fill before every call, left out of the
events by name). Needs one NVIDIA GPU; prints the GPU's name and power
limit, each kernel source's registers, shared memory and spills (ptxas -v),
then one JSON line.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_levels_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multimotionfusion_tpu_torch import kernels as K
    from multimotionfusion_tpu_torch.odometry import levels as LV
    from multimotionfusion_tpu_torch.ops import frame_maps as FM

    if not K.__file__.startswith(tree):
        raise SystemExit(f"imported {K.__file__}, not {tree}'s")
    smoke = load("mmf_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cases = load("mmf_case_checks", os.path.join(HERE, "multimotionfusion_tpu_torch", "kernels",
                                                 "checks.py"))
    K.build_all()
    print(smoke._gpu_line())
    print(json.dumps({"ptxas": {k: smoke.ptxas_table(v) for k, v in K.BUILD_LOG.items()
                                if k in ("frame_maps", "pyramid")}}))
    h, w = args.height, args.width
    raw = cases.filter_inputs("scene", "mm", h, w, "cuda")
    fa, pa = cases.pyramid_inputs(h, w, {}, 1, "cuda")
    _, pf = cases.pyramid_inputs(h, w, {"rgb_only": True}, 1, "cuda")
    lines = {"frame_maps[filter]": lambda: FM.frame_depth_cuda(*raw),
             "pyramid.frame": lambda: LV.frame_levels(*fa),
             "pyramid.pred[bf16 level 0]": lambda: LV.pred_levels(*pa),
             "pyramid.pred[f32 level 0]": lambda: LV.pred_levels(*pf)}
    out = {}
    for name, fn in lines.items():
        ms, n, by_name = smoke._device_profile(fn)
        out[name] = dict(device_ms=ms, device_launches=n,
                         device_ms_cold=smoke._cold(fn)["device_ms_cold"],
                         kernels=sorted(smoke._kernel_name(k) for k in by_name))
    print(json.dumps({"tree": tree, "size": [h, w], "lines": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
