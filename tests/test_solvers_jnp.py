"""Solve-level checks of the jnp performance path: the one-jit mixed
solver against the analytic oracle with V- and W-cycles, the FMG
bootstrap in the mixed loop, and the 1e-10 north star."""

import numpy as np
import jax.numpy as jnp
import pytest

from multigrid_parallel import (
    CycleConfig,
    Hierarchy,
    poisson_3d_quadratic,
    solve_mixed,
)
from multigrid_parallel.cycles import (
    make_mixed_cycle,
    make_on_device_mixed_solver,
    setup_problem,
)
from multigrid_parallel.hierarchy import evaluate_on_grid
from multigrid_parallel.ops import stencils_3d as ops3


@pytest.mark.parametrize("gamma,gamma_min_n", [(1, 0), (2, 0), (2, 17)])
def test_on_device_mixed_solver_converges_to_oracle(gamma, gamma_min_n):
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3, f64 outer
    cfg = CycleConfig(n_smooth=2, gamma=gamma, gamma_min_n=gamma_min_n)
    prob = poisson_3d_quadratic()
    run = make_on_device_mixed_solver(hier, cfg, rel_tol=1e-8)
    u0, f = setup_problem(prob, hier)
    u, norm, n_cycles = run(u0, f)
    init = float(jnp.sqrt(jnp.sum(f * f)))
    assert float(norm) <= 1e-8 * init
    # the W-cycle contracts at least as fast per cycle as the V-cycle
    assert int(n_cycles) <= (14 if gamma == 1 else 13), int(n_cycles)
    exact = evaluate_on_grid(prob.analytic, hier, 3)
    err = float(jnp.sqrt(jnp.sum((u - exact) ** 2)))
    assert err < 2e-8, err


def test_on_device_mixed_solver_reuses_one_compilation():
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    run = make_on_device_mixed_solver(hier, CycleConfig(n_smooth=2))
    u0, f = setup_problem(poisson_3d_quadratic(), hier)
    a = run(u0, f)
    b = run(2.0 * u0, 2.0 * f)  # u0 carries the Dirichlet values
    assert run._cache_size() == 1
    np.testing.assert_allclose(np.asarray(b[0]), 2.0 * np.asarray(a[0]),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("levels", [3, 4])
def test_fmg_bootstrap_in_mixed_loop(levels):
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=levels)
    prob = poisson_3d_quadratic()
    cold = solve_mixed(prob, hier, CycleConfig(n_smooth=2), rel_tol=1e-8)
    fmg = solve_mixed(prob, hier, CycleConfig(n_smooth=2), rel_tol=1e-8,
                      use_fmg=True)
    assert cold.converged and fmg.converged
    assert fmg.n_cycles < cold.n_cycles, (fmg.n_cycles, cold.n_cycles)
    assert fmg.error_norm < 2e-8


@pytest.mark.parametrize("levels", [3, 4])
def test_north_star_1e10_under_10_cycles(levels):
    # BASELINE north star under the iterative convention (docs/ACCURACY.md):
    # residual reduced 1e-10 RELATIVE TO THE INITIAL INTERIOR RESIDUAL in
    # under 10 V-cycles with 4 smoothing sweeps. The contraction rate is
    # grid-size independent, so it is pinned at 17^3 and 33^3 here.
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=levels)
    cycle = make_mixed_cycle(hier, CycleConfig(n_smooth=4))
    u, f = setup_problem(poisson_3d_quadratic(), hier)
    n0 = float(ops3.residual_norm(u, f, hier.finest_spacing))
    for _ in range(9):
        u, nrm = cycle(u, f)
    assert float(nrm) / n0 <= 1e-10, float(nrm) / n0
