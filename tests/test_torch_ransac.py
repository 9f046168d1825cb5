"""The port's rigid RANSAC (K21 plain version, on the CPU) against the
reference package, with the reference's own uniforms.

``ransac_fit`` takes its uniforms as an argument; each test draws them with
``jax.random.uniform(key, (C, 3))``, the draw the reference makes inside, so
both pick the same minimal sets. Held: the minimal-set indices, the inlier
mask, ``num_inliers`` and ``ok`` equal; the transform within 1e-5 and the
error within 1e-5 relative (the sums over the points run in another order
than XLA's). Cases: a noisy rigid motion with 30 % outliers; fewer than
three valid points; no candidate passing the gate (the all-valid fallback,
error = inf); and noisy data without outliers where every candidate ends with the same
inlier set (tied scores: the first index wins, and the tied refits are
bit-equal). Some minimal sets of three points that are close to collinear
fit poorly within Horn's 40 power steps (the reference's algorithm, kept:
the shifted power iteration converges slowly when the top two eigenvalues
are close), and their partial inlier sets refit to errors that differ from
the full set's only in float noise; so the tied case takes a 5 m threshold,
within which every minimal fit keeps every valid point. ``kabsch_fit`` and
``horn_rotation`` on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import RansacConfig
from multimotionfusion_tpu.ops import ransac as jr
from multimotionfusion_tpu_torch.config import RansacConfig as TRansacConfig
from multimotionfusion_tpu_torch.ops import ransac as tr
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 4096
TIED = RansacConfig(inlier_threshold=5.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(case, seed=0):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(-1, 1, (N, 3)).astype(np.float32) + np.float32([0, 0, 2])
    a = 0.05
    R = np.float32([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    p0 = (p1 @ R.T + np.float32([0.01, -0.02, 0.005])).astype(np.float32)
    valid = rng.random(N) < 0.15
    if case == "noisy":
        p0 += rng.normal(0, 0.002, p0.shape).astype(np.float32)
        out = rng.random(N) < 0.3
        p0[out] += rng.uniform(-0.3, 0.3, (out.sum(), 3)).astype(np.float32)
    elif case == "few_valid":
        valid[:] = False
        valid[[5, 900]] = True
    elif case == "none_pass":  # every point moved at random: no consensus
        p0 += rng.uniform(-0.5, 0.5, p0.shape).astype(np.float32)
    else:  # "tied": noise only, so the mean error is well above rounding
        p0 += rng.normal(0, 0.002, p0.shape).astype(np.float32)
    return p0, p1, valid


def _compare(p0, p1, valid, cfg=RansacConfig(), key=3):
    key = jax.random.PRNGKey(key)
    rj = jr.ransac_fit(key, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid), cfg)
    idx_j = np.asarray(jr._sample_minimal_sets(key, jnp.asarray(valid), cfg.iterations))
    u = np.asarray(jax.random.uniform(key, (cfg.iterations, 3)))
    tcfg = TRansacConfig(cfg.iterations, cfg.inlier_threshold, cfg.inlier_fraction)
    rt, idx_t = tr.ransac_fit_plain(_t(u), _t(p0), _t(p1), _t(valid), tcfg, want_idx=True)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers)
    assert bool(rt.ok) == bool(rj.ok)
    np.testing.assert_allclose(rt.transform.numpy(), np.asarray(rj.transform), rtol=0, atol=1e-5)
    ej, et = float(rj.error), float(rt.error)
    assert (np.isinf(ej) and np.isinf(et)) or abs(et - ej) <= 1e-5 * abs(ej), (et, ej)
    # the public wrapper takes the same path on CPU tensors
    rw = tr.ransac_fit(_t(u), _t(p0), _t(p1), _t(valid), tcfg)
    assert torch.equal(rw.transform, rt.transform)
    return rj, rt


@pytest.mark.parametrize("case", ["noisy", "few_valid", "none_pass", "tied"])
def test_ransac_fit_matches_reference(case):
    p0, p1, valid = _problem(case)
    rj, rt = _compare(p0, p1, valid, TIED if case == "tied" else RansacConfig())
    if case == "noisy":
        assert bool(rt.ok) and int(rt.num_inliers) > 300
    elif case in ("few_valid", "none_pass"):
        assert not bool(rt.ok) and np.isinf(float(rt.error)) and not rt.inliers.any()
    else:
        assert bool(rt.ok) and int(rt.num_inliers) == int(valid.sum())


def test_tied_candidates_refit_bit_equal():
    """With one inlier set for all candidates, every refit is the same bits."""
    p0, p1, valid = _problem("tied")
    u = _t(jax.random.uniform(jax.random.PRNGKey(3), (TIED.iterations, 3)))
    idx = tr.sample_minimal_sets(u, _t(valid))
    T_min = tr._kabsch(_t(p0)[idx], _t(p1)[idx], torch.ones(idx.shape), tr.seq_sum)
    inl = (tr.residual_norms(T_min, _t(p0), _t(p1)) < TIED.inlier_threshold) & _t(valid)[None]
    assert bool((inl == _t(valid)[None]).all())
    c = idx.shape[0]
    T_refit = tr._kabsch(_t(p0).expand(c, -1, -1), _t(p1).expand(c, -1, -1), inl.float(),
                         tr.block_sum)
    assert bool((T_refit == T_refit[0]).all())


def test_kabsch_and_horn_match_reference():
    p0, p1, valid = _problem("noisy", seed=5)
    for w in (valid, valid.astype(np.float32) * 0.5 + 0.25, np.zeros(N, bool)):
        Tj = np.asarray(jr.kabsch_fit(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(w)))
        Tt = tr.kabsch_fit(_t(p0), _t(p1), _t(w)).numpy()
        np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-5)
    rng = np.random.default_rng(2)
    for _ in range(5):
        A = rng.normal(size=(3, 3)).astype(np.float32)
        Rj = np.asarray(jr._horn_rotation(jnp.asarray(A)))
        Rt = tr.horn_rotation(_t(A)).numpy()
        np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(Rt @ Rt.T, np.eye(3), atol=1e-5)
