"""Coarse-grid direct solve tests (gauss_elim.h / test_lu.c capability)."""

import numpy as np
import jax.numpy as jnp
import pytest

from multigrid_parallel.ops import coarse


def test_coarse_matrix_3d_structure():
    n, h = 5, 0.25
    a = coarse.build_coarse_matrix_3d(n, h)
    nn = n * n
    inv_h2 = 1.0 / (h * h)
    # identity boundary row
    assert a[0, 0] == 1.0 and np.count_nonzero(a[0]) == 1
    # interior row: -6/h^2 diag, +1/h^2 at the six neighbors
    p = nn * 2 + n * 2 + 2  # center point
    assert a[p, p] == -6.0 * inv_h2
    for off in (nn, -nn, n, -n, 1, -1):
        assert a[p, p + off] == inv_h2
    assert np.count_nonzero(a[p]) == 7


@pytest.mark.parametrize("method", ["lu", "inverse"])
def test_coarse_solver_matches_numpy(method):
    n, h = 5, 0.25
    rng = np.random.default_rng(3)
    f = np.zeros((n, n, n))
    f[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3)
    a = coarse.build_coarse_matrix_3d(n, h)
    want = np.linalg.solve(a, f.reshape(-1)).reshape(n, n, n)
    solve = coarse.make_coarse_solver(n, h, 3, jnp.float64, method)
    got = np.asarray(solve(jnp.asarray(f)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    # zero-RHS boundary stays pinned to zero (identity rows)
    assert np.allclose(got[0], 0) and np.allclose(got[:, -1], 0)


def test_coarse_solver_1d():
    n, h = 5, 0.25
    f = np.zeros(n)
    f[1:-1] = [1.0, -2.0, 3.0]
    a = coarse.build_coarse_matrix_1d(n, h)
    want = np.linalg.solve(a, f)
    solve = coarse.make_coarse_solver(n, h, 1, jnp.float64, "lu")
    np.testing.assert_allclose(np.asarray(solve(jnp.asarray(f))), want, rtol=1e-12)


def test_direct_solve_full_poisson_reproduces_analytic():
    # test_lu.c capability: direct dense solve of the full system with
    # Dirichlet data in the RHS boundary entries. The quadratic analytic
    # solution is exact for the 7-point stencil.
    n = 9
    h = 1.0 / (n - 1)
    c = np.arange(n) * h
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    exact = x * x - 2 * y * y + z * z
    f = np.zeros((n, n, n))
    mask = np.zeros((n, n, n), dtype=bool)
    mask[[0, -1], :, :] = mask[:, [0, -1], :] = mask[:, :, [0, -1]] = True
    f[mask] = exact[mask]
    got = np.asarray(coarse.direct_solve_poisson(jnp.asarray(f), h))
    np.testing.assert_allclose(got, exact, atol=1e-9)
