"""Device time of the odometry's step and reduction kernel lines (K5's
``so3_step``, ``gn_step``, ``so3_step[multi, verbatim]``, ``gn_step_multi``;
K4's ``gn_reduce[L0/L1/L2]``; K11's ``gn_multi[L0/L1/L2]``) and of the
fusion's (K8 ``fuse``, K14 ``fuse_flat``) for the package of one tree, every
device event counted, on the inputs that tree's ``chip_smoke.py`` records.

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

    if not (S.__file__.startswith(tree) and K.__file__.startswith(tree)):
        raise SystemExit(f"imported {S.__file__} and {K.__file__}, not {tree}'s")
    K.build_all()
    cfg, frames, gt = S.static_frames(S.N_FRAMES + 2 * S.STAGE_FRAMES + S.SYNC_FRAMES)
    captured = S.run_engine(K, cfg, frames, gt)[2]
    m_cfg, m_frames = S.multi_frames(1 + S.MULTI_FRAMES + 2 * S.STAGE_FRAMES)
    m_captured = S.run_multi(K, m_cfg, m_frames)[2]

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

    lines = {
        "so3_step": step(rgbd.so3_step_cuda, captured, "so3_step"),
        "gn_step": step(rgbd.gn_step_cuda, captured, "gn_step"),
        "so3_step[multi, verbatim]": step(rgbd.so3_step_cuda, m_captured, "so3_step"),
        "gn_step_multi": step(MO.gn_step_multi_cuda, m_captured, "gn_step_multi"),
        **{f"gn_reduce[L{lvl}]": reduction(lvl) for lvl in S.LEVELS},
        **{f"gn_multi[L{lvl}]": evaluation(lvl) for lvl in S.LEVELS},
        "fuse": fusion(FU.fuse_cuda, captured, "fuse", want_assoc=False),
        "fuse_flat": fusion(FU.fuse_flat_cuda, m_captured, "fuse_flat"),
    }
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
