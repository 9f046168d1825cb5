"""Record, then compare, every output of some kernels over chip_smoke.py's
static, flow-CRF and legacy CRF runs, to show that a redesigned kernel is
bit-equal to the version it replaces.

    python3 tests/torch_outputs_equal.py --tree DIR --out A.pt   # record DIR's
    python3 tests/torch_outputs_equal.py --compare A.pt B.pt    # compare two

``--tree DIR`` (default this checkout) holds ``chip_smoke.py`` and
``multimotionfusion_tpu_torch/``; its kernels are built into ``DIR``'s
``build/``. Recorded per call, in call order: ``gn_reduce`` (K4) and
``gn_multi`` (K11) sums; ``fuse`` (K8) and ``fuse_flat`` (K14) counts and a
SHA-1 of the bytes of the whole [16, N] output (the outputs are kept on the
card during a run, so recording adds no host read to the frame step).
``--compare`` holds every recorded tensor equal with ``torch.equal`` and
every digest equal, and prints one JSON line. Needs one NVIDIA GPU to
record.
"""

import argparse
import hashlib
import json
import os
import sys
from collections import defaultdict


def record(tree: str, out: str) -> int:
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_outputs_equal: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as S
    from multimotionfusion_tpu_torch import kernels as K
    from multimotionfusion_tpu_torch.model import fusion as FU
    from multimotionfusion_tpu_torch.odometry import multi as MO
    from multimotionfusion_tpu_torch.odometry import rgbd

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

    runs = {}

    def collect(tag):
        torch.cuda.synchronize()
        rec = {}
        for name, calls in kept.items():
            if name in ("fuse_cuda", "fuse_flat_cuda"):
                rec[name] = dict(
                    digests=[hashlib.sha1(c[0].cpu().numpy().tobytes()).hexdigest()
                             for c in calls],
                    counts=[c[1].cpu() for c in calls])
            else:
                rec[name] = dict(sums=[c[0].cpu() for c in calls])
        runs[tag] = rec
        kept.clear()

    cfg, frames, gt = S.static_frames(S.N_FRAMES)
    S.run_engine(K, cfg, frames, gt)
    collect("static")
    f_cfg, f_frames = S.multi_frames(1 + S.MULTI_FRAMES, masks=False)
    S.run_multi_flow(K, f_cfg, f_frames)
    collect("flow_crf")
    import dataclasses

    g_cfg = dataclasses.replace(f_cfg, segmentation=dataclasses.replace(f_cfg.segmentation,
                                                                          mode="crf"))
    S.run_multi_legacy(K, g_cfg, f_frames)
    collect("legacy_crf")
    torch.save({"tree": tree, "gpu": S._gpu_line(), "runs": runs}, out)
    print(json.dumps({"tree": tree, "out": out, "calls": {
        tag: {k: len(next(iter(v.values()))) for k, v in rec.items()} for tag, rec in runs.items()}}))
    return 0


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    report, ok = {}, True
    for tag in sorted(set(a["runs"]) | set(b["runs"])):
        ra, rb = a["runs"].get(tag, {}), b["runs"].get(tag, {})
        for name in sorted(set(ra) | set(rb)):
            fa, fb = ra.get(name, {}), rb.get(name, {})
            line = {}
            for field in sorted(set(fa) | set(fb)):
                xa, xb = fa.get(field, []), fb.get(field, [])
                if field == "digests":
                    equal = [x == y for x, y in zip(xa, xb)]
                else:
                    equal = [torch.equal(x, y) for x, y in zip(xa, xb)]
                line[field] = dict(calls=(len(xa), len(xb)), equal=sum(equal),
                                   first_differing=next((i for i, e in enumerate(equal)
                                                         if not e), None))
                ok = ok and len(xa) == len(xb) > 0 and all(equal)
            report[f"{tag}.{name}"] = line
    print(json.dumps({"a": a["tree"], "b": b["tree"], "gpu": a["gpu"], "all_equal": ok,
                      "outputs": report}))
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
