"""Mixed-precision (f32 V-cycle + f64 outer defect correction) tests."""

import numpy as np

from multigrid_parallel import (
    CycleConfig,
    Hierarchy,
    poisson_3d_quadratic,
    solve,
    solve_mixed,
    solve_on_device_mixed,
)


def test_mixed_converges_to_f64_accuracy():
    # The inner f32 V-cycle alone floors at ~1e-5 relative; the defect
    # correction must push through to f64-level tolerance.
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    res = solve_mixed(poisson_3d_quadratic(), hier, CycleConfig(n_smooth=2), rel_tol=1e-8)
    assert res.converged, res.residual_norms
    assert res.error_norm < 2e-8, res.error_norm


def test_mixed_cycle_rate_matches_full_f64():
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    full = solve(poisson_3d_quadratic(), hier, CycleConfig(n_smooth=2), rel_tol=1e-8)
    mixed = solve_mixed(poisson_3d_quadratic(), hier, CycleConfig(n_smooth=2), rel_tol=1e-8)
    assert mixed.converged
    # same multigrid convergence rate: within a couple cycles of full f64
    assert abs(mixed.n_cycles - full.n_cycles) <= 2, (mixed.n_cycles, full.n_cycles)


def test_mixed_on_device_loop():
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    u, norm, n_cycles, init = solve_on_device_mixed(
        poisson_3d_quadratic(), hier, CycleConfig(n_smooth=2), rel_tol=1e-8
    )
    assert norm <= 1e-8 * init
    host = solve_mixed(poisson_3d_quadratic(), hier, CycleConfig(n_smooth=2), rel_tol=1e-8)
    assert n_cycles == host.n_cycles
    np.testing.assert_allclose(np.asarray(u), np.asarray(host.u), atol=1e-10)


def test_mixed_reaches_tight_tolerance_small_grid():
    # 1e-10 relative at 17^3: inner f32 cycles cannot do this; the f64
    # outer loop must. (At 257^3 even f64 hits the roundoff floor around
    # 1e-9 relative to ||f|| — see bench.py for the large-grid treatment.)
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    res = solve_mixed(
        poisson_3d_quadratic(), hier, CycleConfig(n_smooth=2), rel_tol=1e-10,
        max_cycles=40,
    )
    assert res.converged
    assert res.error_norm < 1e-9
