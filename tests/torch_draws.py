"""The port's flow-CRF journeys with their RANSAC uniforms under control.

The engine draws the uniforms of its RANSAC fits from its own
``torch.Generator`` on its device: Philox on the card, mt19937 on the CPU,
so one engine seed gives the card and the CPU different draws, and a
journey's readings on the two cannot be compared seed by seed. This script
runs a journey of the port on either device with the draws taken from

- ``engine``: the engine's own generator (what the engine does);
- ``cpu``: an mt19937 generator on the host seeded as the engine is, each
  draw copied to the device: the CPU port's uniforms, draw for draw;
- ``replay``: the uniforms an earlier run recorded (``--load DIR``);

and with ``--save DIR`` records every draw of each seed (``DIR/<journey>_
seed<n>.pt``). ``--plain ransac,crf`` swaps the kernels of the named port
modules for their plain versions on the card's tensors. Journeys: ``five``, tests/test_five_movers.py's (160x120,
1 + 16 frames; the readings and assertions of tests/torch_five_movers.py),
and ``spheres``, chip_smoke.py's flow-CRF journey (bench_multi_model's five
orbiting spheres, 640x480 at the chip capacities, 1 + 40 frames; the
largest camera drift and the spawn ticks). One JSON line per seed, then a
summary line. For example, the card's own draws, recorded, then replayed on
the CPU::

    python tests/torch_draws.py --journey five --device cuda --draws engine \
        --seeds 0-11 --save build/draws
    python tests/torch_draws.py --journey five --device cpu --draws replay \
        --load build/draws --seeds 0-1

A seed takes seconds on the card, a minute or two on the CPU (``five``).
"""

import os
import sys

# run as a file (python tests/<script>.py), the repo root first on the path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import contextlib
import dataclasses
import importlib
import inspect
import json

import numpy as np
import torch

import chip_smoke
from multimotionfusion_tpu_torch.engine import MultiMotionFusionTorch

try:
    from tests.torch_five_movers import failures, run_port
except ImportError:  # an installed package named tests hides this directory
    from torch_five_movers import failures, run_port


@contextlib.contextmanager
def controlled_draws(mode: str, seed: int, record: list, replay=None):
    """Route every ``torch.rand`` of the engine (its RANSAC uniforms) through
    ``mode``; append each draw, on the host, to ``record``."""
    real = torch.rand
    host = torch.Generator(device="cpu")
    host.manual_seed(seed)
    queue = list(replay or [])

    def rand(*size, generator=None, device=None, **kwargs):
        if mode == "engine":
            u = real(*size, generator=generator, device=device, **kwargs)
        elif mode == "cpu":
            u = real(*size, generator=host, **kwargs).to(device)
        else:
            u = queue.pop(0)
            if tuple(u.shape) != tuple(size[0] if len(size) == 1 else size):
                raise RuntimeError(f"replayed draw {tuple(u.shape)} where {size} was asked")
            u = u.to(device)
        record.append(u.cpu())
        return u

    torch.rand = rand
    try:
        yield
    finally:
        torch.rand = real
    if mode == "replay" and queue:
        raise RuntimeError(f"{len(queue)} recorded draws were not used")


@contextlib.contextmanager
def plain_versions(names: str):
    """Every kernel wrapper ``*_cuda`` of the named port modules (short names
    of chip_smoke.PORT_MODULES, as ``ransac,crf``) whose plain twin
    ``*_plain`` takes the same arguments takes that twin on the device's
    tensors while inside (printed)."""
    saved = []
    for full in chip_smoke.PORT_MODULES:
        if full.rsplit(".", 1)[1] not in names.split(","):
            continue
        mod = importlib.import_module(full)
        for attr in [a for a in vars(mod) if a.endswith("_cuda")]:
            twin = getattr(mod, attr[:-len("_cuda")] + "_plain", None)
            if callable(twin) and (inspect.signature(twin).parameters.keys()
                                   == inspect.signature(getattr(mod, attr)).parameters.keys()):
                saved.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, twin)
    print(json.dumps({"plain_versions": [f"{m.__name__}.{a}" for m, a, _ in saved]}))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def run_spheres(seed: int, device: str) -> dict:
    cfg, frames = chip_smoke.multi_frames(1 + chip_smoke.MULTI_FRAMES, masks=False)
    eng = MultiMotionFusionTorch(dataclasses.replace(cfg, seed=seed), device=device)
    for f in frames:
        eng.process_frame(f)
    eng.finish()
    _, spawn_log = eng._lifecycle_logs()
    drift = [float(np.linalg.norm(p[:3, 3])) for _, p in eng.pose_log]
    return {"max_camera_drift_m": max(drift), "final_camera_drift_m": drift[-1],
            "spawn_ticks": [j + 1 for j, (_, sp, _, _) in enumerate(spawn_log)
                            if sp is not None and bool(sp)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--journey", choices=("five", "spheres"), default="five")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", choices=("engine", "cpu", "replay"), default="engine")
    ap.add_argument("--seeds", default="0", help="engine seeds, e.g. 0-11")
    ap.add_argument("--save", default="", help="directory to record each seed's draws in")
    ap.add_argument("--load", default="", help="directory of recorded draws (--draws replay)")
    ap.add_argument("--plain", default="", help="modules whose kernels take their plain "
                    "versions, e.g. ransac,crf")
    a = ap.parse_args()
    lo, _, hi = a.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)
    if a.save:
        os.makedirs(a.save, exist_ok=True)
    rows = []
    for seed in seeds:
        replay = None
        if a.draws == "replay":
            replay = torch.load(os.path.join(a.load, f"{a.journey}_seed{seed}.pt"))
        record = []
        with controlled_draws(a.draws, seed, record, replay), plain_versions(a.plain):
            if a.journey == "five":
                r = run_port(seed, a.device)
                r = {"camera_m": r["camera_m"], "failures": failures(r),
                     "spawn_frames": r["spawn_frames"], "pixels_per_label": r["pixels_per_label"],
                     "active_per_frame": r["active_per_frame"],
                     "camera_per_frame_m": r["camera_per_frame_m"]}
            else:
                r = run_spheres(seed, a.device)
        if a.save:
            torch.save(record, os.path.join(a.save, f"{a.journey}_seed{seed}.pt"))
        r = {"journey": a.journey, "device": a.device, "draws": a.draws, "plain": a.plain,
             "seed": seed, "n_draws": len(record), **r}
        rows.append(r)
        print(json.dumps(r), flush=True)
    key = "camera_m" if a.journey == "five" else "max_camera_drift_m"
    vals = [r[key] for r in rows]
    summary = {"journey": a.journey, "device": a.device, "draws": a.draws, "plain": a.plain,
               "seeds": list(seeds), key: vals, "below_0.08_m": sum(v < 0.08 for v in vals),
               "median": float(np.median(vals))}
    if a.journey == "five":
        summary["passing_seeds"] = [r["seed"] for r in rows if not r["failures"]]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
