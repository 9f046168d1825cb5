"""The port's batched rigid RANSAC (K21's batch entry, plain version on the
CPU) and the engine code that batches its fits.

- ``ransac_fit_batch_plain`` against the reference's ``ransac_fit`` vmapped
  over keys and masks (as the reference's per-model seeds run it), with the
  uniforms ``jax.random.uniform(key, (C, 3))`` of each key, under
  tests/test_torch_ransac.py's tolerances (indices, inliers, counts and ok
  equal; T within 1e-5, the error within 1e-5 relative): shared points with
  per-fit masks (one of them empty), per-fit points, few valid points, no
  candidate passing, tied candidates;
- each row of the batch ``torch.equal`` to the one-fit plain version;
- the hopeless fits the kernel skips (valid count at most the gate): fits
  with 0-3 valid points give the one-fit results, not ok;
- the per-fit draws ``draw_uniforms`` equal sequential ``torch.rand`` calls
  on a CPU generator;
- ``engine_multi._kp_seeds`` and ``tracker.refine_track_subset`` on a track
  table of rigidly moving models, ``torch.equal`` to the per-fit loops they
  replace (one fit, one draw, one gate at a time), with a spawned model's
  tracks selected and with none.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import RansacConfig
from multimotionfusion_tpu.ops import ransac as jr
from multimotionfusion_tpu_torch import engine_multi as EM
from multimotionfusion_tpu_torch.config import EngineConfig
from multimotionfusion_tpu_torch.config import RansacConfig as TRansacConfig
from multimotionfusion_tpu_torch.ops import ransac as tr
from multimotionfusion_tpu_torch.tracking import tracker as ttr
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 1024
C = 64
CFG = RansacConfig(iterations=C)
TIED = RansacConfig(iterations=C, inlier_threshold=5.0)
F32 = torch.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _tcfg(cfg):
    return TRansacConfig(cfg.iterations, cfg.inlier_threshold, cfg.inlier_fraction)


def _motion(rng, a):
    R = np.float32([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    return R, rng.uniform(-0.03, 0.03, 3).astype(np.float32)


def _points(rng, case):
    """(p0, p1) [N, 3] of one rigid motion: noisy with 30 % outliers, or as
    tests/test_torch_ransac.py's other cases."""
    p1 = rng.uniform(-1, 1, (N, 3)).astype(np.float32) + np.float32([0, 0, 2])
    R, t = _motion(rng, rng.uniform(-0.08, 0.08))
    p0 = (p1 @ R.T + t).astype(np.float32)
    if case == "none_pass":  # every point moved at random: no consensus
        p0 += rng.uniform(-0.5, 0.5, p0.shape).astype(np.float32)
        return p0, p1
    p0 += rng.normal(0, 0.002, p0.shape).astype(np.float32)
    if case != "tied":
        out = rng.random(N) < 0.3
        p0[out] += rng.uniform(-0.3, 0.3, (out.sum(), 3)).astype(np.float32)
    return p0, p1


def _problem(case, seed=0):
    """(p0, p1, valid [B, N], cfg): p0, p1 shared [N, 3] or per fit [B, N, 3]."""
    rng = np.random.default_rng(seed)
    if case == "per_fit":
        pts = [_points(rng, "noisy") for _ in range(4)]
        p0, p1 = np.stack([p for p, _ in pts]), np.stack([q for _, q in pts])
        return p0, p1, rng.random((4, N)) < 0.2, CFG
    p0, p1 = _points(rng, case)
    if case == "shared":  # per-fit masks over shared points, one of them empty
        model = rng.integers(0, 3, N)
        valid = rng.random(N) < 0.6
        masks = np.stack([valid & (model == m) for m in range(3)] + [np.zeros(N, bool)])
        return p0, p1, masks, CFG
    if case == "few_valid":
        masks = np.zeros((4, N), bool)
        masks[0, [5, 900]] = True
        masks[1, 17] = True
        masks[2, [3, 4, 500]] = True
        return p0, p1, masks, CFG
    masks = rng.random((4, N)) < 0.15
    return p0, p1, masks, TIED if case == "tied" else CFG


@functools.partial(jax.jit, static_argnums=(4,))
def _reference(keys, p0, p1, valid, cfg):
    """The reference's fits vmapped over keys and masks (and points when
    they are per fit), their minimal sets and their uniforms."""
    fit = jax.vmap(lambda k, a, b, v: jr.ransac_fit(k, a, b, v, cfg),
                   in_axes=(0, None, None, 0) if p0.ndim == 2 else (0, 0, 0, 0))
    idx = jax.vmap(lambda k, v: jr._sample_minimal_sets(k, v, cfg.iterations))(keys, valid)
    u = jax.vmap(lambda k: jax.random.uniform(k, (cfg.iterations, 3)))(keys)
    return fit(keys, p0, p1, valid), idx, u


def _one_fit(u, p0, p1, valid, cfg, b):
    """Row b as one fit on fresh contiguous copies."""
    row = (lambda p: p if p.dim() == 2 else p[b])
    return tr.ransac_fit_plain(u[b].clone(), row(p0).contiguous().clone(),
                               row(p1).contiguous().clone(), valid[b].clone(), cfg, want_idx=True)


def _assert_rows_equal(res, idx, u, p0, p1, valid, cfg):
    for b in range(u.shape[0]):
        r1, i1 = _one_fit(u, p0, p1, valid, cfg, b)
        assert torch.equal(idx[b], i1), b
        for name, x in r1._asdict().items():
            assert torch.equal(getattr(res, name)[b], x), (b, name)


@pytest.mark.parametrize("case", ["shared", "per_fit", "few_valid", "none_pass", "tied"])
def test_batch_matches_reference_vmap(case):
    p0, p1, valid, cfg = _problem(case)
    keys = jax.random.split(jax.random.PRNGKey(7), valid.shape[0])
    rj, idx_j, u = _reference(keys, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid), cfg)
    idx_j, u = np.asarray(idx_j), np.asarray(u)
    tcfg = _tcfg(cfg)
    res, idx = tr.ransac_fit_batch_plain(_t(u), _t(p0), _t(p1), _t(valid), tcfg, want_idx=True)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_array_equal(res.num_inliers.numpy(), np.asarray(rj.num_inliers))
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(rj.ok))
    np.testing.assert_allclose(res.transform.numpy(), np.asarray(rj.transform), rtol=0, atol=1e-5)
    ej, et = np.asarray(rj.error), res.error.numpy()
    assert np.array_equal(np.isinf(ej), np.isinf(et))
    fin = np.isfinite(ej)
    assert np.all(np.abs(et[fin] - ej[fin]) <= 1e-5 * np.abs(ej[fin])), (et, ej)
    # every row is the one-fit plain version, bit for bit; the public entry
    # takes the same path on CPU tensors
    _assert_rows_equal(res, idx, _t(u), _t(p0), _t(p1), _t(valid), tcfg)
    rw = tr.ransac_fit_batch(_t(u), _t(p0), _t(p1), _t(valid), tcfg)
    assert torch.equal(rw.transform, res.transform)
    if case == "shared":
        assert res.ok[:3].all() and not res.ok[3] and res.num_inliers[3] == 0
    elif case in ("few_valid", "none_pass"):
        assert not res.ok.any() and torch.isinf(res.error).all() and not res.inliers.any()
    elif case == "tied":
        assert torch.equal(res.num_inliers, _t(valid).sum(1).to(torch.int32))


def test_hopeless_fits_give_one_fit_results():
    """Fits with 0-3 valid points (at most the gate of 3: the kernel's
    candidates stop after drawing their minimal sets) against the one-fit
    version, beside fits with 4 and with many valid points."""
    rng = np.random.default_rng(4)
    p0, p1 = _points(rng, "noisy")
    valid = np.zeros((6, N), bool)
    for b, k in enumerate((0, 1, 2, 3, 4)):
        valid[b, rng.choice(N, k, replace=False)] = True
    valid[5] = rng.random(N) < 0.2
    u = torch.rand((6, C, 3), generator=torch.Generator().manual_seed(1))
    cfg = _tcfg(CFG)
    res, idx = tr.ransac_fit_batch_plain(u, _t(p0), _t(p1), _t(valid), cfg, want_idx=True)
    _assert_rows_equal(res, idx, u, _t(p0), _t(p1), _t(valid), cfg)
    hopeless = tr.hopeless(_t(valid), cfg)
    assert hopeless.tolist() == [True, True, True, True, False, False]
    assert not res.ok[:4].any() and torch.isinf(res.error[:4]).all()
    assert not res.inliers[:4].any() and not res.num_inliers[:4].any()
    assert bool(res.ok[5])
    # with the whole valid count as the gate, no fit can pass
    strict = TRansacConfig(C, CFG.inlier_threshold, 1.0)
    assert tr.hopeless(_t(valid), strict).all()
    assert not tr.ransac_fit_batch_plain(u, _t(p0), _t(p1), _t(valid), strict).ok.any()


def test_draw_uniforms_equal_sequential_draws():
    ga, gb = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    u = tr.draw_uniforms(ga, 5, 200, "cpu")
    seq = torch.stack([torch.rand((200, 3), generator=gb) for _ in range(5)])
    assert torch.equal(u, seq)
    assert torch.equal(ga.get_state(), gb.get_state())


# ---------------------------------------------------------------- the engine's batches

CAP, HIST, TIME, SLOTS = 512, 32, 40, 5


def _table(seed=0, spawn_id=3):
    """A track table of 1 + SLOTS rigidly moving models over the last 12
    ticks: each active track carries its model's points (noise, 10 %
    outliers), seen and with depth most ticks; model ``spawn_id`` holds
    tracks too."""
    rng = np.random.default_rng(seed)
    model = rng.integers(0, 1 + SLOTS, CAP).astype(np.int32)
    active = rng.random(CAP) < 0.9
    base = rng.uniform(-1, 1, (CAP, 3)).astype(np.float32) + np.float32([0, 0, 2])
    p3d = np.zeros((CAP, HIST, 3), np.float32)
    seen = np.zeros((CAP, HIST), bool)
    motions = [_motion(rng, rng.uniform(-0.02, 0.02)) for _ in range(1 + SLOTS)]
    pts = base.copy()
    for tick in range(TIME - 12, TIME + 1):
        for m, (R, t) in enumerate(motions):
            sel = model == m
            pts[sel] = pts[sel] @ R.T + t
        s = tick % HIST
        p3d[:, s] = pts + rng.normal(0, 0.001, pts.shape).astype(np.float32)
        out = rng.random(CAP) < 0.1
        p3d[out, s] += rng.uniform(-0.2, 0.2, (out.sum(), 3)).astype(np.float32)
        seen[:, s] = rng.random(CAP) < 0.85
    has_depth = seen & (rng.random((CAP, HIST)) < 0.95)
    last_seen = np.where(rng.random(CAP) < 0.8, TIME, TIME - 1).astype(np.int32)
    d = 8
    return ttr.TrackTable(
        xy=torch.zeros((CAP, HIST, 2)), p3d=_t(p3d), seen=_t(seen), has_depth=_t(has_depth),
        desc=torch.zeros((CAP, d)), last_seen=_t(last_seen),
        nvalid=torch.full((CAP,), 5, dtype=torch.int32), active=_t(active),
        model_id=_t(model))


def _gate_one(res, min_inliers, max_step):
    T = res.transform
    return (res.ok & (res.num_inliers >= min_inliers) & (res.error < 0.008)
            & torch.isfinite(T).all() & (torch.linalg.norm(T[:3, 3]) < max_step))


def _kp_seeds_per_fit(tracks, pair, pose0, obj, cfg, gen):
    """The per-model loop that ``_kp_seeds`` batches: one draw, fit and gate
    at a time."""
    p0, p1, valid = pair
    eye = torch.eye(4, dtype=F32)
    poses = torch.cat([pose0[None], obj.pose], dim=0)
    seeds, oks = [], []
    for m in range(1 + obj.num_slots):
        u = torch.rand((cfg.ransac.iterations, 3), generator=gen)
        res = tr.ransac_fit(u, p0, p1, valid & (tracks.model_id == m), cfg.ransac)
        good = _gate_one(res, 24, 0.03) if m == 0 else _gate_one(res, 12, 0.05)
        seeds.append(poses[m] @ torch.where(good, res.transform, eye))
        oks.append(good)
    return torch.stack(seeds), torch.stack(oks)


def _refine_per_fit(table, model_sel, time, length, gen, cfg):
    """The per-step loop that ``refine_track_subset`` batches."""
    eye = torch.eye(4, dtype=F32)
    out = []
    for k in range(length):
        pa, pb, valid = ttr.pair_between(table, time - k - 1, time - k)
        valid = valid & model_sel
        u = torch.rand((cfg.iterations, 3), generator=gen)
        res = tr.ransac_fit(u, pa.contiguous(), pb.contiguous(), valid, cfg)
        ok = res.ok & torch.isfinite(res.transform).all() & (valid.to(torch.int32).sum() >= 3)
        out.append(torch.where(ok, res.transform, eye))
    return torch.stack(out)


def _engine_cfg():
    import dataclasses

    cfg = EngineConfig()
    return dataclasses.replace(cfg, ransac=TRansacConfig(C, cfg.ransac.inlier_threshold,
                                                         cfg.ransac.inlier_fraction))


def test_kp_seeds_equal_per_fit_loop():
    cfg = _engine_cfg()
    table = _table()
    pair = ttr.last_pair(table, TIME)
    rng = np.random.default_rng(5)
    obj = types.SimpleNamespace(num_slots=SLOTS, pose=_t(np.stack(
        [np.eye(4, dtype=np.float32) + np.float32(0.01) * rng.normal(size=(4, 4)).astype(np.float32)
         for _ in range(SLOTS)])))
    pose0 = torch.eye(4)
    ga, gb = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    seeds, ok = EM._kp_seeds(table, pair, TIME, pose0, obj, cfg, ga)
    seeds_ref, ok_ref = _kp_seeds_per_fit(table, pair, pose0, obj, cfg, gb)
    assert torch.equal(seeds, seeds_ref) and torch.equal(ok, ok_ref)
    assert torch.equal(ga.get_state(), gb.get_state())
    assert ok.any()  # some model's seed passed its gate


@pytest.mark.parametrize("spawn", [True, False])
def test_refine_track_subset_equals_per_fit_loop(spawn):
    table = _table(seed=1)
    sel = table.model_id == (3 if spawn else 1 + SLOTS)  # no track of a model 1 + S
    cfg = _tcfg(CFG)
    ga, gb = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    out = ttr.refine_track_subset(table, sel, TIME, 8, ga, cfg)
    ref = _refine_per_fit(table, sel, TIME, 8, gb, cfg)
    assert torch.equal(out, ref)
    assert torch.equal(ga.get_state(), gb.get_state())
    eye = torch.eye(4).expand(8, 4, 4)
    moved = ~(out == eye).flatten(1).all(1)
    assert moved.any() if spawn else not moved.any()
    pa, pb, valid = ttr.backdate_pairs(table, sel, TIME, 8)
    for k in range(8):
        ra, rb, rv = ttr.pair_between(table, TIME - k - 1, TIME - k)
        assert torch.equal(pa[k], ra) and torch.equal(pb[k], rb)
        assert torch.equal(valid[k], rv & sel)
