"""Cascadic 1D multigrid (mg_1d_old.c) parity + debug printers."""

import numpy as np
import pytest

from golden1d_cascade import cascade_golden
from multigrid_parallel.cascade import cascade_solve_1d
from multigrid_parallel.utils.debug import (
    format_grid_3d,
    format_matrix,
    print_grid_3d,
    print_matrix,
)


@pytest.mark.parametrize(
    "coarse_n,num_levels,gs_iters",
    [(5, 3, 4), (3, 4, 2), (5, 4, 10)],
)
def test_cascade_matches_golden(coarse_n, num_levels, gs_iters):
    res = cascade_solve_1d(coarse_n, num_levels, gs_iters)
    v_g, err_g = cascade_golden(coarse_n, num_levels, gs_iters)
    np.testing.assert_allclose(np.asarray(res.v), v_g, rtol=0, atol=1e-13)
    assert res.error_sq == pytest.approx(err_g, rel=1e-10, abs=1e-15)


def test_cascade_matches_golden_nonzero_rhs():
    # rhs = cos(x): exercises the reference's j*h coordinate quirk on the
    # up-leg, which faithful mode must reproduce exactly.
    res = cascade_solve_1d(
        5, 3, 4,
        func=lambda x: x,
        rhs_func=lambda x: np.cos(np.asarray(x, dtype=np.float64)),
    )
    v_g, _ = cascade_golden(5, 3, 4, rhs_func=lambda x: np.cos(x))
    np.testing.assert_allclose(np.asarray(res.v), v_g, rtol=0, atol=1e-13)


def test_cascade_converges_with_enough_smoothing():
    # Laplace with ramp BCs: exact solution is v(x) = x; with generous
    # smoothing the cascade should approach it (mg_1d_old.c:146-157).
    # In faithful mode the coarse solve contributes nothing (b stays
    # zero), so convergence is smoothing-only — test on the 17-point
    # grid where 400 sweeps suffice.
    res = cascade_solve_1d(5, 3, 400)
    assert res.error_sq < 1e-12


def test_cascade_fixed_coarse_rhs_shallow_improvement():
    # Filling the coarse RHS (faithful=False) helps at shallow
    # hierarchies; at depth > 2 the cascade's additive midpoint
    # interpolation double-counts a NONZERO coarse solution (up-leg adds
    # interpolant on top of already-smoothed values, mg_1d_old.c:129-130)
    # so the planted solution can overshoot — a structural quirk of the
    # reference scheme that its zeroed coarse solve sidesteps. Pin the
    # shallow-case win; the deep-case behavior is documented, not fixed.
    faithful = cascade_solve_1d(5, 2, 4)
    fixed = cascade_solve_1d(5, 2, 4, faithful=False)
    assert fixed.error_sq < faithful.error_sq


def test_cascade_fixed_coarse_solve_couples_boundary_rows():
    # Pins the coarse tridiagonal coupling: for Laplace with ramp BCs
    # (func(1)=1, rhs=0) the faithful=False coarse solve must return the
    # exact linear ramp [0, .25, .5, .75, 1] — which requires the
    # interior rows ADJACENT to the identity boundary rows to keep their
    # -1 coupling (mg_1d_old.c fills A[nii-1] for i=1 and A[nii+1] for
    # i=N-2). With that coupling broken the interior decouples from the
    # x=1 boundary, the coarse solve returns zero interior, and
    # faithful=False degenerates to faithful=True. At (5, 2, 1) the
    # planted ramp cuts the final error by ~12x vs the zeroed coarse
    # solve; pin a conservative 4x so the coupling can't silently break.
    faithful = cascade_solve_1d(5, 2, 1)
    fixed = cascade_solve_1d(5, 2, 1, faithful=False)
    assert fixed.error_sq < 0.25 * faithful.error_sq


def test_cascade_validates_inputs():
    with pytest.raises(ValueError):
        cascade_solve_1d(2, 3, 1)
    with pytest.raises(ValueError):
        cascade_solve_1d(5, 0, 1)


def test_format_grid_3d_layout():
    # mg_3d.h:51-72: "LEVEL i" per i-plane, k rows top-down, j columns.
    g = np.arange(8, dtype=np.float64).reshape(2, 2, 2)
    out = format_grid_3d(g)
    lines = out.split("\n")
    assert lines[0] == "LEVEL 0"
    # first printed row of LEVEL 0 is k=1: values g[0, j, 1] = 1, 3
    row = lines[1].split()
    assert row == ["1", "3"]
    # next row k=0: g[0, j, 0] = 0, 2
    assert lines[2].split() == ["0", "2"]
    assert "LEVEL 1" in out
    with pytest.raises(ValueError):
        format_grid_3d(np.zeros((2, 2)))


def test_format_matrix_layout():
    m = np.array([[1.0, 2.0], [3.0, 4.5]])
    out = format_matrix(m)
    rows = [r.split() for r in out.split("\n")]
    assert rows == [["1.00000", "2.00000"], ["3.00000", "4.50000"]]
    with pytest.raises(ValueError):
        format_matrix(np.zeros(3))


def test_print_wrappers(capsys):
    print_grid_3d(np.zeros((2, 2, 2)))
    print_matrix(np.eye(2))
    out = capsys.readouterr().out
    assert "LEVEL 0" in out and "1.00000" in out
