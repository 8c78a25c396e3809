"""End-to-end 1D solver tests (the mg_1d.c capability, BASELINE config 1)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from multigrid_parallel import (
    CycleConfig,
    Hierarchy,
    poisson_1d_cos,
    solve,
)
from multigrid_parallel.ops import stencils_1d as ops1


def _solve_1d(n_levels, smoother="rb", n_smooth=2, tol=1e-8):
    # rel tol 1e-8 matches the reference 3D driver (test_mg_3d.c:19);
    # tighter tolerances at N=1025 hit the f64 residual roundoff floor
    # (the 1/h^2 = 1e6 scaling amplifies rounding to ~7e-9 absolute).
    hier = Hierarchy(ndim=1, coarse_n=5, num_levels=n_levels, length=1.0)
    cfg = CycleConfig(n_smooth=n_smooth, smoother=smoother)
    return solve(poisson_1d_cos(), hier, cfg, rel_tol=tol, max_cycles=100)


def test_1d_rb_converges_and_matches_analytic():
    res = _solve_1d(n_levels=9)  # N = 1025, the BASELINE config-1 size
    assert res.converged
    # discretization error of the 3-point stencil at h = 1/1024
    h = 1.0 / 1024
    assert res.error_norm < 40 * h * h  # loose O(h^2) bound

    # pointwise check against the analytic solution (mg_1d.c:151-152)
    x = np.linspace(0, 1, 1025)
    exact = -np.cos(x) + x * (math.cos(1.0) - 1.0) + 1.0
    np.testing.assert_allclose(np.asarray(res.u), exact, atol=1e-6)


def test_1d_jacobi_converges():
    res = _solve_1d(n_levels=7, smoother="jacobi")
    assert res.converged
    assert res.error_norm < 1e-4


def test_1d_gridsize_independent_cycle_count():
    n_small = _solve_1d(n_levels=6).n_cycles
    n_large = _solve_1d(n_levels=9).n_cycles
    # textbook multigrid: iteration count independent of grid size
    assert abs(n_small - n_large) <= 3


def test_1d_residual_ratio_is_multigrid_fast():
    res = _solve_1d(n_levels=8)
    ratios = res.residual_ratios[1:-1]  # skip first (init-norm scale differs)
    assert all(r < 0.35 for r in ratios), ratios


def test_1d_lex_gs_oracle_converges():
    res = _solve_1d(n_levels=5, smoother="lex", tol=1e-9)
    assert res.converged


def test_1d_restrict_prolong_roundtrip():
    rng = np.random.default_rng(1)
    nf = 17
    r = np.zeros(nf)
    r[1:-1] = rng.standard_normal(nf - 2)
    rc = ops1.restrict_full_weighting(jnp.asarray(r))
    assert rc.shape == (9,)
    # constants preserved on the interior
    ones = jnp.ones(nf)
    np.testing.assert_allclose(np.asarray(ops1.restrict_full_weighting(ones)), 1.0)
    # prolongation reproduces linear functions
    xc = jnp.linspace(0.0, 1.0, 9)
    xf = np.linspace(0.0, 1.0, 17)
    got = np.asarray(ops1.prolong_correct(3 * xc - 1, jnp.zeros(nf)))
    np.testing.assert_allclose(got, 3 * xf - 1, atol=1e-14)


def test_1d_rb_matches_sequential_two_color_semantics():
    rng = np.random.default_rng(2)
    n = 17
    h = 1.0 / (n - 1)
    u = rng.standard_normal(n)
    f = rng.standard_normal(n)
    # sequential two-color sweep: odd then even
    want = u.copy()
    for color in (1, 0):
        for j in range(1, n - 1):
            if j % 2 == color:
                want[j] = (want[j - 1] + want[j + 1] - h * h * f[j]) * 0.5
    got = np.asarray(ops1.rb_smooth(jnp.asarray(u), jnp.asarray(f), h, 1))
    # ulp-level: XLA may contract a-h2*f into an FMA (single rounding)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)
