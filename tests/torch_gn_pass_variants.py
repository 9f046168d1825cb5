"""What bounds the passes of K4 ``gn_reduce`` (``csrc/gn_reduce.cu``): device
time of each pass on the static run's recorded level inputs, for the kernel
as it is and for variants built from edited copies of its source.

    python3 tests/torch_gn_pass_variants.py [--tree DIR] > variants.json

``DIR`` (by default this checkout) holds ``chip_smoke.py`` and
``multimotionfusion_tpu_torch/``, whose ``gn_reduce.cu`` is edited and whose
``build/`` receives the builds.

Variants (each a copy of ``csrc/gn_reduce.cu`` with one edit, built with the
same ``nvcc`` flags as ``kernels.build_all`` into ``build/mmf_gn_variants/``;
their sums are not the kernel's and are not checked):
- ``as_is``: the kernel;
- ``no_outer``: each row's outer product (28 products and adds into the
  register accumulators) replaced by the sum of the row's seven entries, so
  the pixel's loads, warp, gates and row stay and the accumulation goes;
- ``no_pixels``: the pixel loop runs no iteration: the launch, the block
  reduction of zeros and the last block's sum alone;
- ``min_blocks_3``: ``__launch_bounds__(256, 3)``, so that ptxas fits three
  blocks of 256 threads on an SM (at most 85 registers a thread);
and the kernel at 150 and 600 blocks (the grid-stride loop's other shapes;
300 is the path's at levels 0 and 1). Prints the GPU's name and power limit,
then one JSON line: per variant and level, the device ms a call of pass 1
and pass 2 (``chip_smoke._device_profile``: every device event of 20 calls
after 10 warm-up calls, the median of 5 profiles) and ptxas's registers and
spills. Needs one NVIDIA GPU.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

EDITS = {
    "as_is": [],
    "no_outer": [("add_outer(acc, row);",
                  "acc[0] += row[0] + row[1] + row[2] + row[3] + row[4] + row[5] + row[6];")],
    "no_pixels": [("q < n; q += gridDim.x * THREADS", "q < 0; q += gridDim.x * THREADS")],
    "min_blocks_3": [("__global__ void __launch_bounds__(THREADS)\npass",
                      "__global__ void __launch_bounds__(THREADS, 3)\npass")],
}


def build(K, name: str, edits) -> tuple:
    """(ctypes library, ptxas table) of one variant of gn_reduce.cu."""
    import ctypes

    import chip_smoke as S

    src = (K.CSRC / "gn_reduce.cu").read_text()
    for old, new in edits:
        if src.count(old) < 1:
            raise SystemExit(f"variant {name}: {old!r} not in gn_reduce.cu")
        src = src.replace(old, new)
    out_dir = K.BUILD_DIR.parent / "mmf_gn_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"gn_reduce_{name}.cu"
    cu.write_text(src)
    so = out_dir / f"gn_reduce_{name}.so"
    cmd = [K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", f"-I{K.CSRC}",
           "-o", str(so), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"variant {name} failed to build:\n{res.stdout}{res.stderr}")
    table = S.ptxas_table(res.stdout + res.stderr)
    return ctypes.CDLL(str(so)), {k: v for k, v in table.items() if k in ("pass1", "pass2")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_gn_pass_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as S
    from multimotionfusion_tpu_torch import kernels as K
    from multimotionfusion_tpu_torch.kernels import checks as C
    from multimotionfusion_tpu_torch.odometry import rgbd

    if not (S.__file__.startswith(tree) and K.__file__.startswith(tree)):
        raise SystemExit(f"imported {S.__file__} and {K.__file__}, not {tree}'s")
    K.build_all()
    cfg, frames, gt = S.static_frames(S.N_FRAMES + 2 * S.STAGE_FRAMES + S.SYNC_FRAMES)
    captured = S.run_engine(K, cfg, frames, gt)[2]
    inputs = {lvl: C.args(f"gn_reduce.L{lvl}", captured[f"gn_reduce.L{lvl}"]) for lvl in S.LEVELS}

    def passes(a, lvl):
        runs = []
        for _ in range(5):
            _, _, by_name = S._device_profile(lambda: rgbd.gn_reduce_cuda(*a, level=lvl))
            runs.append({k: sum(v for n, v in by_name.items() if re.search(rf"::{k}\(", n))
                         for k in ("pass1", "pass2")})
        return {k: statistics.median(r[k] for r in runs) for k in ("pass1", "pass2")}

    kept = K._libs["gn_reduce"]
    out = {}
    for name, edits in EDITS.items():
        lib, table = build(K, name, edits)
        K._libs["gn_reduce"] = lib
        try:
            out[name] = {"ptxas": table, **{f"L{lvl}": passes(inputs[lvl], lvl)
                                           for lvl in S.LEVELS}}
        finally:
            K._libs["gn_reduce"] = kept
    threads, cap = rgbd._GN_THREADS, rgbd._GN_MAX_BLOCKS
    try:
        rgbd._GN_MAX_BLOCKS = 150  # the level-0 and level-1 grids in 150 blocks
        out["blocks_150"] = {f"L{lvl}": passes(inputs[lvl], lvl) for lvl in (0, 1)}
        rgbd._GN_MAX_BLOCKS, rgbd._GN_THREADS = cap, 128  # ... in 600 (still 256 threads)
        out["blocks_600"] = {f"L{lvl}": passes(inputs[lvl], lvl) for lvl in (0, 1)}
    finally:
        rgbd._GN_THREADS, rgbd._GN_MAX_BLOCKS = threads, cap
    print(S._gpu_line())
    print(json.dumps({"tree": tree, "variants": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
