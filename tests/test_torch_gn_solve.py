"""K5's solve (``csrc/gn_step.cu`` ``solve_preconditioned<N>``) held to the
reference package on the CPU.

The kernel cannot run here, so ``checks.solve_preconditioned_emulated``
repeats it op by op in numpy float32 (Jacobi scaling, cyclic rotations with
the kernel's skip rule, at most 40 sweeps, the selection sort, the 1e-4
truncation, x = 0 where not finite); on the card ``chip_smoke.py``'s
``solve_cases`` phase and ``tests/test_torch_kernels_cuda.py`` hold the
kernel bit-equal to it. Here the emulation's x must agree with
``multimotionfusion_tpu.odometry.rgbd.solve_preconditioned`` (LAPACK's eigh
through JAX) on ``checks.solve_cases`` for N = 6 and N = 3, within
``check_gn_step``'s 1e-5 (a step's metres and radians; these x are of a GN
step's size, |x| < 0.1), the sphere-spin cases a decade either side of the
truncation cut (ROADMAP queue 3 #8) included. There the weakest kept
direction's step is amplified by 1 / w, so each solver is also held, on its
own, to a float64 solve of the same float32 system: within 4 eps kappa
max|x| (eps float32's, kappa the kept scaled spectrum's condition), the
float32 rounding of the system amplified by what the solve keeps; the test
shows which side, if either, drifts. Non-finite and all-zero systems give
x = 0 in both, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from multimotionfusion_tpu.odometry.rgbd import solve_preconditioned
from multimotionfusion_tpu_torch.kernels import checks
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

STEP_TOL = 1e-5  # check_gn_step: pose within 1e-5 m and 1e-5 rad
EXACT_ZERO = ("all_zero", "inf", "nan")

CASES = [(n, name) for n in (6, 3) for name, _, _ in checks.solve_cases(n)]


def _case(n: int, name: str):
    return next((A, b) for c, A, b in checks.solve_cases(n) if c == name)


@pytest.mark.parametrize("n,name", CASES, ids=[f"{name}-N{n}" for n, name in CASES])
def test_emulated_solve_matches_reference(n, name):
    A, b = _case(n, name)
    x, w = checks.solve_preconditioned_emulated(A, b)
    x_ref = np.asarray(solve_preconditioned(jnp.asarray(A), jnp.asarray(b)))
    assert x.dtype == np.float32 and x.shape == (n,)
    if name in EXACT_ZERO:
        assert (x == 0).all() and (x_ref == 0).all(), (x, x_ref)
        return
    err = float(np.abs(x - x_ref).max())
    assert err <= STEP_TOL, (name, n, err, x, x_ref)
    # the emulation's eigenvalues are the scaled system's spectrum, ascending
    d = 1.0 / np.sqrt(np.diag(A.astype(np.float64)))
    w64 = np.linalg.eigvalsh(A.astype(np.float64) * d[:, None] * d[None, :])
    assert (np.diff(w) >= 0).all()
    assert np.abs(w - w64).max() <= 1e-5 * np.abs(w64).max()


def _solve_float64(A, b):
    """The solve in float64 on the float32 system: Jacobi scaling, eigh, the
    1e-4 cut. Returns (x, the kept scaled spectrum's condition)."""
    A, b = A.astype(np.float64), b.astype(np.float64)
    d = 1.0 / np.sqrt(np.fmax(np.diag(A), 1e-12))
    w, V = np.linalg.eigh(A * d[:, None] * d[None, :])
    keep = w > 1e-4 * max(w[-1], 1e-12)
    inv_w = np.where(keep, 1.0 / np.where(w == 0, 1.0, w), 0.0)
    return d * (V @ (inv_w * (V.T @ (b * d)))), w[-1] / w[keep].min()


NEAR_CUT = [(n, name) for n in (6, 3) for name in checks.SOLVE_NEAR_CUT_CASES]


@pytest.mark.parametrize("n,name", NEAR_CUT, ids=[f"{name}-N{n}" for n, name in NEAR_CUT])
def test_near_cut_solves_match_float64(n, name):
    """Each solver on its own against the float64 solve: the full-size spin
    cases as well as those with a small component along the weakest
    direction."""
    A, b = _case(n, name)
    x64, kappa = _solve_float64(A, b)
    bound = 4 * np.finfo(np.float32).eps * kappa * np.abs(x64).max()
    x_emu = checks.solve_preconditioned_emulated(A, b)[0]
    x_ref = np.asarray(solve_preconditioned(jnp.asarray(A), jnp.asarray(b)))
    errs = {"emulation": float(np.abs(x_emu - x64).max()),
            "reference": float(np.abs(x_ref - x64).max())}
    assert max(errs.values()) <= bound, (name, n, errs, bound)


@pytest.mark.parametrize("n", (6, 3))
def test_near_cut_cases_straddle_the_truncation(n):
    """The sphere-spin cases sit either side of the 1e-4 cut of the scaled
    spectrum, by at least a factor 1.5, so both eigensolvers cut alike."""
    ratios = []
    for name in checks.SOLVE_NEAR_CUT:
        A, _ = _case(n, name)
        d = 1.0 / np.sqrt(np.diag(A.astype(np.float64)))
        w = np.linalg.eigvalsh(A.astype(np.float64) * d[:, None] * d[None, :])
        ratios.append(w[0] / w[-1])
    assert ratios[0] < 1e-4 / 1.5 and ratios[1] > 1e-4 * 1.5, ratios


def test_exact_ties_are_ties():
    """N = 6's identical blocks give bit-equal eigenvalues out of order, so
    the sort's choice among ties is exercised."""
    A, b = _case(6, "exact_ties")
    _, w = checks.solve_preconditioned_emulated(A, b)
    assert len(set(w.tolist())) < len(w)
