"""End-to-end 3D solver tests: the reference's analytic oracle and
per-cycle residual-reduction fingerprint (SURVEY.md §4, §6).

Reference behavior to reproduce (measured from the C code, BASELINE.md):
  * 33^3, coarseN=5, 2 RB-GS pre+post sweeps, rel tol 1e-8: converges in
    ~14 V-cycles with per-cycle ratios 0.12-0.17, final error vs the
    analytic solution ~2.5e-9.
"""

import numpy as np
import pytest

from multigrid_parallel import (
    CycleConfig,
    Hierarchy,
    MultigridSolver,
    poisson_3d_quadratic,
    poisson_3d_trig,
    solve,
)
from multigrid_parallel.cycles import solve_on_device


def test_33cubed_matches_reference_fingerprint():
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=1.0)  # 33^3
    res = solve(poisson_3d_quadratic(), hier, CycleConfig(n_smooth=2), rel_tol=1e-8)
    assert res.converged
    # cycle count fingerprint: C reference takes 14 (BASELINE.md)
    assert 12 <= res.n_cycles <= 16, res.n_cycles
    # per-cycle residual reduction 0.12-0.17 (slowly rising)
    ratios = res.residual_ratios[1:]
    assert all(0.05 < r < 0.30 for r in ratios), ratios
    # analytic oracle: stencil exact on quadratics -> error is pure solver
    # tolerance (C measures 2.52e-9)
    assert res.error_norm < 2e-8, res.error_norm


def test_17cubed_converges_tight_tolerance():
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    res = solve(poisson_3d_quadratic(), hier, CycleConfig(n_smooth=2), rel_tol=1e-12)
    assert res.converged
    assert res.error_norm < 1e-10


def test_cycle_count_grid_size_independent():
    counts = []
    for levels in (3, 4):
        hier = Hierarchy(ndim=3, coarse_n=5, num_levels=levels)
        res = solve(poisson_3d_quadratic(), hier, CycleConfig(n_smooth=2), rel_tol=1e-8)
        assert res.converged
        counts.append(res.n_cycles)
    assert abs(counts[0] - counts[1]) <= 2, counts


def test_trig_problem_discretization_error_is_h2():
    # f != 0 path: error should scale as h^2 between 9^3 and 17^3
    errs = []
    for levels in (2, 3):
        hier = Hierarchy(ndim=3, coarse_n=5, num_levels=levels)
        res = solve(poisson_3d_trig(), hier, CycleConfig(n_smooth=2), rel_tol=1e-10)
        assert res.converged
        n = hier.finest_n
        # RMS error (normalize the L2 norm by sqrt(#points))
        errs.append(res.error_norm / n**1.5)
    rate = errs[0] / errs[1]
    assert 3.0 < rate < 5.0, (errs, rate)  # ~4x per halving


def test_fmg_reduces_cycle_count():
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    plain = solve(poisson_3d_quadratic(), hier, CycleConfig(n_smooth=2), rel_tol=1e-8)
    fmg = solve(
        poisson_3d_quadratic(), hier, CycleConfig(n_smooth=2), rel_tol=1e-8,
        use_fmg=True,
    )
    assert fmg.converged
    assert fmg.n_cycles <= plain.n_cycles


def test_jacobi_smoother_3d_converges():
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    res = solve(
        poisson_3d_quadratic(), hier, CycleConfig(n_smooth=3, smoother="jacobi"),
        rel_tol=1e-8, max_cycles=60,
    )
    assert res.converged


def test_coarse_method_inverse_equivalent_to_lu():
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    a = solve(poisson_3d_quadratic(), hier, CycleConfig(coarse_method="lu"), rel_tol=1e-9)
    b = solve(
        poisson_3d_quadratic(), hier, CycleConfig(coarse_method="inverse"), rel_tol=1e-9
    )
    assert a.converged and b.converged
    assert a.n_cycles == b.n_cycles
    np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), atol=1e-8)


def test_solve_on_device_matches_host_loop():
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    host = solve(poisson_3d_quadratic(), hier, CycleConfig(), rel_tol=1e-8)
    u, norm, n_cycles, init = solve_on_device(
        poisson_3d_quadratic(), hier, CycleConfig(), rel_tol=1e-8
    )
    assert n_cycles == host.n_cycles
    assert norm <= 1e-8 * init
    np.testing.assert_allclose(np.asarray(u), np.asarray(host.u), atol=1e-12)


def test_facade_api_mirrors_reference_driver():
    # the test_mg_3d.c flow through the facade
    s = MultigridSolver(coarse_n=5, num_levels=3, gs_iter=2)
    s.setup_boundary_conditions()
    init = s.get_initial_residual()
    assert init > 0
    norms = s.solve(rel_tol=1e-8)
    assert norms[-1] <= 1e-8 * init
    assert s.error_vs_analytic() < 1e-8
    assert s.get_residual() == pytest.approx(norms[-1], rel=1e-6)
    s.finalize()


def test_facade_profiled_cycle_times_stages():
    s = MultigridSolver(coarse_n=5, num_levels=3, gs_iter=2)
    s.setup_boundary_conditions()
    norm = s.lin_solve_profiled()
    assert norm > 0
    top = s.timing[-1]
    assert all(c == 1 for c in top.num_calls), top.num_calls
    assert all(t > 0 for t in top.time_taken)
    table = top.table()
    assert "Smoother1" in table and "Recurse, Direct Solve" in table
    s.reset_timing_info()
    assert sum(s.timing[-1].num_calls) == 0


def test_w_cycle_converges_faster_per_cycle():
    """gamma=2 (W-cycle, beyond-reference) contracts at least as fast per
    cycle as the V-cycle and converges in fewer or equal cycles."""
    import multigrid_parallel as mg

    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    v = mg.solve(mg.poisson_3d_quadratic(), hier,
                 mg.CycleConfig(n_smooth=2, gamma=1), rel_tol=1e-8)
    w = mg.solve(mg.poisson_3d_quadratic(), hier,
                 mg.CycleConfig(n_smooth=2, gamma=2), rel_tol=1e-8)
    assert v.converged and w.converged
    assert w.n_cycles <= v.n_cycles
    assert w.error_norm < 1e-8


def test_w_cycle_depth_cap_semantics():
    """gamma_min_n (W-cycle depth cap) semantics on the reference-shaped
    cycle: a cap above the finest level disables every revisit (the
    capped W-cycle IS the V-cycle, identical residual trajectory), and a
    mid-hierarchy cap (17 at 33^3: only the 9-level revisit skipped)
    still converges at W-cycle-like rate."""
    import multigrid_parallel as mg

    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    prob = mg.poisson_3d_quadratic()
    v = mg.solve(prob, hier, mg.CycleConfig(n_smooth=2, gamma=1),
                 rel_tol=1e-8)
    w_off = mg.solve(prob, hier,
                     mg.CycleConfig(n_smooth=2, gamma=2, gamma_min_n=999),
                     rel_tol=1e-8)
    assert w_off.n_cycles == v.n_cycles
    assert w_off.residual_norms == v.residual_norms  # bitwise: same unroll

    w_cap = mg.solve(prob, hier,
                     mg.CycleConfig(n_smooth=2, gamma=2, gamma_min_n=17),
                     rel_tol=1e-8)
    assert w_cap.converged and w_cap.n_cycles <= v.n_cycles
    assert w_cap.error_norm < 1e-8
