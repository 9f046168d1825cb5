"""The port's embedded deformation graph (K23 plain versions and the
analytic Gauss-Newton, ``model/deformation.py``) against the reference
package's, on the CPU.

- ``sample_nodes``: positions, times and valid flags exactly equal (a map
  with culled surfels, fewer live surfels than nodes, more);
- ``deform_points`` where the clipped candidate window repeats nodes, with
  distance ties and with the uniform fallback (every weight 0; fewer valid
  nodes than k + 1): the chosen nodes equal to the reference's own
  searchsorted / top_k choice, positions within 1e-6;
- ``optimise`` on tests/test_deformation.py's line graph: the analytic
  Jacobian against the reference's ``jax.jacfwd`` one within 1e-5 (at rest
  and at a perturbed graph), the parameters after five iterations within
  1e-4; ``apply_to_map`` of the optimised graph within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimotionfusion_tpu.config import DeformationConfig as JCfg
from multimotionfusion_tpu.model import deformation as jdg
from multimotionfusion_tpu.model import surfel_map as jsm
from multimotionfusion_tpu_torch.config import DeformationConfig
from multimotionfusion_tpu_torch.model import deformation as tdg
from multimotionfusion_tpu_torch.model import surfel_map as tsm
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CFGK = dict(max_nodes=32, k_neighbours=4, iterations=5)
JCFG, TCFG = JCfg(**CFGK), DeformationConfig(**CFGK)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def port_graph(g) -> tdg.DeformationGraph:
    return tdg.DeformationGraph(_t(g.positions), _t(g.times), _t(g.A), _t(g.t),
                                _t(g.valid, torch.bool))


def ref_choice(points, times, g, k, look_back=20):
    """The reference deform_points' node choice (its own lines)."""
    n = g.positions.shape[0]
    idx0 = jnp.searchsorted(g.times, jnp.asarray(times))
    offs = jnp.arange(-look_back // 2, look_back - look_back // 2)
    cand = jnp.clip(idx0[:, None] + offs[None, :], 0, n - 1)
    d = jnp.linalg.norm(jnp.asarray(points)[:, None] - g.positions[cand], axis=-1)
    d = jnp.where(g.valid[cand], d, jnp.inf)
    _, sel = jax.lax.top_k(-d, k + 1)
    return np.asarray(jnp.take_along_axis(cand, sel[:, :k], axis=1))


def _map(n_alive, cap=4096, seed=0, culled=0.0):
    rng = np.random.default_rng(seed)
    data = np.zeros((jsm.CHANNELS, cap), np.float32)
    data[jsm.PX, :n_alive] = np.linspace(0, 3, n_alive)
    data[jsm.PY, :n_alive] = rng.normal(0, 0.05, n_alive)
    data[jsm.PZ, :n_alive] = 2.0
    data[jsm.INIT_T, :n_alive] = np.arange(n_alive) // 10
    data[jsm.ALIVE, :n_alive] = (rng.random(n_alive) >= culled).astype(np.float32)
    return data


@pytest.mark.parametrize("n_alive,culled", [(1000, 0.0), (20, 0.0), (3000, 0.3)])
def test_sample_nodes_exact(n_alive, culled):
    data = _map(n_alive, culled=culled)
    jg = jdg.sample_nodes(jsm.SurfelMap(data=jnp.asarray(data), count=jnp.int32(n_alive)), 32)
    tg = tdg.sample_nodes(tsm.SurfelMap(_t(data), _t(n_alive, torch.int32)), 32)
    for k in ("positions", "times", "A", "t", "valid"):
        assert np.array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k))), k


def _graph(n, valid=None, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.stack([np.linspace(0.0, 1.0, n), np.zeros(n), np.full(n, 2.0)], -1)
    A = np.eye(3) + rng.normal(0, 0.05, (n, 3, 3))
    return jdg.DeformationGraph(
        positions=jnp.asarray(pos, jnp.float32), times=jnp.arange(n, dtype=jnp.float32),
        A=jnp.asarray(A, jnp.float32), t=jnp.asarray(rng.normal(0, 0.02, (n, 3)), jnp.float32),
        valid=jnp.asarray(np.ones(n, bool) if valid is None else valid))


CASES = {
    # 6 nodes: every point's 20 clipped candidates repeat nodes
    "clipped duplicates": (_graph(6), None),
    # points on the line midway between two nodes: equal distances
    "distance ties": (_graph(11), "mid"),
    # all candidates equidistant (every weight (1 - d/dmax)^2 is 0: uniform 1/k)
    "uniform fallback": (jdg.DeformationGraph(
        positions=jnp.zeros((8, 3), jnp.float32), times=jnp.arange(8, dtype=jnp.float32),
        A=jnp.broadcast_to(jnp.eye(3), (8, 3, 3)), t=jnp.ones((8, 3), jnp.float32) * 0.1,
        valid=jnp.ones((8,), bool)), "sphere"),
    # fewer valid nodes than k + 1 (inf distances: dmax = inf)
    "few valid": (_graph(8, valid=np.array([1, 0, 1, 0, 0, 1, 0, 0], bool)), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deform_points_choices_and_positions(case):
    g, kind = CASES[case]
    n = g.positions.shape[0]
    rng = np.random.default_rng(1)
    if kind == "mid":
        xs = (np.arange(n - 1) + 0.5) / (n - 1)
        pts = np.stack([xs, np.zeros_like(xs), np.full_like(xs, 2.0)], -1)
    elif kind == "sphere":
        v = rng.normal(size=(12, 3))
        pts = 0.3 * v / np.linalg.norm(v, axis=1, keepdims=True)
    else:
        pts = np.stack([rng.uniform(-0.2, 1.2, 24), rng.normal(0, 0.1, 24),
                        rng.uniform(1.8, 2.2, 24)], -1)
    pts = pts.astype(np.float32)
    times = rng.integers(0, n, len(pts)).astype(np.float32)
    jm = np.asarray(jdg.deform_points(jnp.asarray(pts), g.positions, g.times, g.A, g.t, g.valid,
                                      JCFG, jnp.asarray(times)))
    tm, ch = tdg.deform_points(_t(pts), _t(times), port_graph(g), TCFG)
    assert np.array_equal(ch.nid.numpy(), ref_choice(pts, times, g, 4))
    if kind == "sphere":
        assert np.allclose(ch.wgt.numpy(), 0.25)
    assert np.isfinite(jm).all()
    np.testing.assert_allclose(tm.numpy(), jm, atol=1e-6, rtol=0)


def _line_graph(n=32):
    xs = np.linspace(0.0, 3.1, n).astype(np.float32)
    pos = np.stack([xs, np.zeros(n), np.full(n, 2.0)], axis=-1)
    return jdg.DeformationGraph(
        positions=jnp.asarray(pos, jnp.float32), times=jnp.arange(n, dtype=jnp.float32),
        A=jnp.broadcast_to(jnp.eye(3), (n, 3, 3)), t=jnp.zeros((n, 3)),
        valid=jnp.ones((n,), bool))


def _constraints():
    """tests/test_deformation.py's: the end 0.1 m off in +y, the start held."""
    src_end = np.stack([np.linspace(2.9, 3.1, 8), np.zeros(8), np.full(8, 2.0)], -1)
    src_start = np.stack([np.linspace(0.0, 0.2, 8), np.zeros(8), np.full(8, 2.0)], -1)
    src = np.concatenate([src_end, src_start]).astype(np.float32)
    dst = np.concatenate([src_end + np.array([0.0, 0.1, 0.0]), src_start]).astype(np.float32)
    times = np.concatenate([np.full(8, 31.0), np.zeros(8)]).astype(np.float32)
    valid = np.ones(16, bool)
    valid[3] = False
    return src, dst, valid, times


@pytest.fixture(scope="module")
def optimised():
    src, dst, valid, times = _constraints()
    g = _line_graph()
    jopt = jdg.optimise(g, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
                        jnp.asarray(times), JCFG)
    topt = tdg.optimise(port_graph(g), _t(src), _t(dst), _t(valid, torch.bool), _t(times), TCFG)
    return g, jopt, topt


@pytest.mark.parametrize("at", ["rest", "perturbed"])
def test_analytic_jacobian_matches_jacfwd(at):
    src, dst, valid, times = _constraints()
    g = _line_graph()
    n = g.positions.shape[0]
    params = np.concatenate([np.asarray(g.A).reshape(n, 9), np.asarray(g.t)], -1)
    if at == "perturbed":
        params = params + np.random.default_rng(3).normal(0, 0.05, params.shape)
    params = params.astype(np.float32)
    args = (g, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), jnp.asarray(times), JCFG)
    r_ref = np.asarray(jdg._residuals(jnp.asarray(params), *args))
    J_ref = np.asarray(jax.jacfwd(lambda p: jdg._residuals(p, *args))(jnp.asarray(params)))
    J_ref = J_ref.reshape(r_ref.shape[0], -1)
    tg = port_graph(g)
    tp = _t(params)
    moved, choice = tdg.deform_points(
        _t(src), _t(times), tg._replace(A=tp[:, :9].reshape(n, 3, 3).contiguous(),
                                        t=tp[:, 9:].contiguous()), TCFG)
    r = tdg.residuals(tp, tg, moved, _t(dst), _t(valid, torch.bool), TCFG).numpy()
    J = tdg.jacobian(tp, tg, _t(src), _t(valid, torch.bool), choice, TCFG).numpy()
    assert J.shape == J_ref.shape
    np.testing.assert_allclose(r, r_ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(J, J_ref, atol=1e-5, rtol=0)


def test_optimise_and_apply_match_reference(optimised):
    g, jopt, topt = optimised
    np.testing.assert_allclose(topt.A.numpy(), np.asarray(jopt.A), atol=1e-4, rtol=0)
    np.testing.assert_allclose(topt.t.numpy(), np.asarray(jopt.t), atol=1e-4, rtol=0)
    # tests/test_deformation.py's gate: the end constraints met
    src, dst, _, _ = _constraints()
    moved, _ = tdg.deform_points(_t(src[:8]), torch.full((8,), 31.0), topt, TCFG)
    assert np.linalg.norm(moved.numpy() - dst[:8], axis=1).max() < 0.02
    data = _map(1000, culled=0.2)
    data[jsm.INIT_T, :1000] = np.arange(1000) * 32 // 1000
    jout = jdg.apply_to_map(jsm.SurfelMap(data=jnp.asarray(data), count=jnp.int32(1000)), jopt,
                            JCFG)
    tdata = _t(data)
    tdg.apply_to_map(tsm.SurfelMap(tdata, _t(1000, torch.int32)), port_graph(jopt), TCFG)
    np.testing.assert_allclose(tdata.numpy(), np.asarray(jout.data), atol=1e-6, rtol=0)
    assert np.abs(tdata.numpy() - data).max() > 0.01  # the map moved
