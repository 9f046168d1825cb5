"""Runs K20's hand-made cases (``checks.track_cases``, ``checks.match_cases``)
through the kernels of a given tree, to show which side differs from the
plain version where two trees' kernels disagree (needs one NVIDIA GPU).

    python3 tests/torch_track_cases_tree.py --write CASES.pt           # this tree's cases
    python3 tests/torch_track_cases_tree.py --tree DIR --cases CASES.pt  # DIR's kernels

The second form imports DIR's ``multimotionfusion_tpu_torch`` (its kernels
built into DIR's ``build/``), runs each track case through its
``tracker.update`` on the card and ``tracker.update_plain`` on the CPU, and
the case's match (``mutual_match`` on the table's ``in_history``) and each
match case through its ``mutual_match`` on the card and
``mutual_match_plain`` on the CPU. It prints one JSON line per case: the
elements of each table field, of the pair and of the matches that differ,
and for each query whose match differs, both choices with the plain
version's squared distances (``tracker.sq_dists``) to the tracks the two
chose.
"""

import argparse
import json
import os
import sys


def write(path: str) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from multimotionfusion_tpu_torch.kernels import checks as C

    torch.save({"track": C.track_cases(), "match": C.match_cases()}, path)
    return 0


def _match_line(TR, torch, q, t, qv, tv, gate, device):
    mk, tk = TR.mutual_match(q.to(device), t.to(device), qv.to(device), tv.to(device), gate)
    mk, tk = mk.cpu(), tk.cpu()
    mp, tp = TR.mutual_match_plain(q, t, qv, tv, gate)
    bad = torch.nonzero(mk != mp)[:, 0]
    d2 = TR.sq_dists(q, t) if bad.numel() else None
    queries = []
    for k in bad[:8].tolist():
        picks = {"kernel": int(mk[k]), "plain": int(mp[k])}
        queries.append({"query": k, **{f"{side}_track": v for side, v in picks.items()},
                        **{f"{side}_d2": None if v < 0 else float(d2[k, v])
                           for side, v in picks.items()}})
    return {"matches_plain": int((mp >= 0).sum()), "matches_kernel": int((mk >= 0).sum()),
            "match_differ": int(bad.numel()), "matched_t_differ": int((tk != tp).sum()),
            "differing_queries": queries}


def run(tree: str, path: str) -> int:
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_track_cases_tree: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multimotionfusion_tpu_torch import kernels as K
    from multimotionfusion_tpu_torch.tracking import tracker as TR

    if not K.__file__.startswith(tree):
        raise SystemExit(f"imported {K.__file__}, not {tree}'s")
    K.build_all()
    cases = torch.load(path, weights_only=False)
    for name, table, kps, depth, time, cam, cfg, pair in cases["track"]:
        line = {"tree": tree, "case": f"track_{name}"}
        line.update(_match_line(TR, torch, kps.desc, table.desc, kps.valid,
                                TR.in_history(table, time), cfg.match_dist_gate, "cuda"))
        tk = TR.TrackTable(*(x.cuda() for x in table))
        kk = type(kps)(*(x.cuda() for x in kps))
        pk = TR.update(tk, kk, depth.cuda(), time, cam, cfg, pair)
        tp = TR.TrackTable(*(x.clone() for x in table))
        pp = TR.update_plain(tp, kps, depth, time, cam, cfg, pair)
        line["fields_differ"] = {f: int((getattr(tk, f).cpu() != getattr(tp, f)).sum())
                                 for f in TR.FIELDS}
        line["pair_differ"] = (0 if pp is None else
                               sum(int((x.cpu() != y).sum()) for x, y in zip(pk, pp)))
        print(json.dumps(line), flush=True)
    for name, q, t, qv, tv, gate in cases["match"]:
        print(json.dumps({"tree": tree, "case": f"match_{name}",
                          **_match_line(TR, torch, q, t, qv, tv, gate, "cuda")}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", metavar="CASES.pt")
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--cases", metavar="CASES.pt")
    args = ap.parse_args()
    if args.write:
        return write(args.write)
    if not args.cases:
        ap.error("give --write or --cases")
    return run(os.path.abspath(args.tree), os.path.abspath(args.cases))


if __name__ == "__main__":
    sys.exit(main())
