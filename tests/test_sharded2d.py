"""2D-mesh (i, j) decomposition vs single-device equivalence."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multigrid_parallel import CycleConfig, Hierarchy, poisson_3d_quadratic
from multigrid_parallel.cycles import make_cycle_fn, setup_problem
from multigrid_parallel.parallel import sharded2d as s2


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return s2.make_mesh_2d(4, 2)


def test_plan_2d_alignment():
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    plan = s2.plan_sharding_2d(hier, 4, 2)
    align = 1 << plan.n_sharded
    assert plan.fine_local_i % align == 0
    assert plan.fine_local_j % align == 0
    assert plan.padded_i(0) >= hier.finest_n
    assert plan.padded_j(0) >= hier.finest_n
    assert plan.local_i(plan.n_sharded) >= 1
    assert plan.local_j(plan.n_sharded) >= 1


def test_sharded2d_cycle_matches_single_device(mesh):
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()

    cycle_1 = make_cycle_fn(hier, cfg)
    u1, f1 = setup_problem(prob, hier)

    cycle_2, plan = s2.make_sharded2d_cycle(hier, cfg, mesh)
    u2, f2 = s2.setup_problem_sharded2d(prob, hier, mesh, plan)

    for it in range(3):
        u1, n1 = cycle_1(u1, f1)
        u2, n2 = cycle_2(u2, f2)
        assert float(n2) == pytest.approx(float(n1), rel=1e-10), it

    np.testing.assert_allclose(
        np.asarray(s2.unpad2d(u2, hier)), np.asarray(u1), rtol=0, atol=1e-11
    )


def test_sharded2d_df_cycle_converges_all_f32(mesh):
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()
    cycle, plan = s2.make_sharded2d_df_cycle(hier, cfg, mesh)
    u_hi, u_lo, f_hi, f_lo = s2.setup_df_problem_sharded2d(prob, hier, mesh, plan)
    init = float(jnp.sqrt(jnp.sum(f_hi.astype(jnp.float64) ** 2)))
    norm = init
    for _ in range(25):
        u_hi, u_lo, norm_d = cycle(u_hi, u_lo, f_hi, f_lo)
        norm = float(norm_d)
        if norm <= 1e-8 * init:
            break
    assert norm <= 1e-8 * init, norm
    from multigrid_parallel.hierarchy import evaluate_on_grid
    from multigrid_parallel.ops import df as dfo

    u = dfo.df_to_f64(s2.unpad2d(u_hi, hier), s2.unpad2d(u_lo, hier))
    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1)
    err = float(jnp.sqrt(jnp.sum((u - exact) ** 2)))
    assert err < 5e-8, err


def test_sharded2d_df_matches_1d_sharded_norms(mesh):
    """2D-mesh df cycle produces the same norm sequence as the 1D-mesh
    df cycle (same math, different decomposition)."""
    from multigrid_parallel.parallel import sharded as s1

    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()

    mesh1 = s1.make_mesh(8)
    cyc1, plan1 = s1.make_sharded_df_cycle(hier, cfg, mesh1)
    a = s1.setup_df_problem_sharded(prob, hier, mesh1, plan1)

    cyc2, plan2 = s2.make_sharded2d_df_cycle(hier, cfg, mesh)
    b = s2.setup_df_problem_sharded2d(prob, hier, mesh, plan2)

    for it in range(3):
        *a_new, n1 = cyc1(*a)
        a = (*a_new, a[2], a[3])
        *b_new, n2 = cyc2(*b)
        b = (*b_new, b[2], b[3])
        assert float(n2) == pytest.approx(float(n1), rel=1e-5), it


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_sharded2d_df_solver_converges_to_oracle(shape):
    """Whole-solve while_loop 2D driver on both mesh orientations."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = s2.make_mesh_2d(*shape)
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()
    run, plan = s2.make_sharded2d_df_solver(
        hier, cfg, mesh, rel_tol=1e-8, inner_cycles=2
    )
    st = s2.setup_df_problem_sharded2d(prob, hier, mesh, plan)
    u_hi, u_lo, norm, n_outer = run(*st)
    init = float(jnp.sqrt(jnp.sum(st[2].astype(jnp.float64) ** 2)))
    assert float(norm) <= 1e-8 * init
    assert int(n_outer) <= 10, int(n_outer)
    from multigrid_parallel.hierarchy import evaluate_on_grid
    from multigrid_parallel.ops import df as dfo

    u = dfo.df_to_f64(s2.unpad2d(u_hi, hier), s2.unpad2d(u_lo, hier))
    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1)
    err = float(jnp.sqrt(jnp.sum((u - exact) ** 2)))
    assert err < 5e-8, err


def test_sharded2d_df_solver_matches_1d_residual(mesh):
    """The 2D whole-solve driver lands on the same final residual and
    outer-step count as a host loop over the 1D df cycle with the same
    inner_cycles (same math, different decomposition)."""
    from multigrid_parallel.parallel import sharded as s1

    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()

    run2, plan2 = s2.make_sharded2d_df_solver(
        hier, cfg, mesh, rel_tol=1e-8, inner_cycles=2
    )
    st2 = s2.setup_df_problem_sharded2d(prob, hier, mesh, plan2)
    _, _, norm2, n2 = run2(*st2)

    mesh1 = s1.make_mesh(8)
    cyc1, plan1 = s1.make_sharded_df_cycle(hier, cfg, mesh1, inner_cycles=2)
    u_hi, u_lo, f_hi, f_lo = s1.setup_df_problem_sharded(prob, hier, mesh1, plan1)
    init = float(jnp.sqrt(jnp.sum(f_hi * f_hi)))
    for n1 in range(1, 41):
        u_hi, u_lo, norm1 = cyc1(u_hi, u_lo, f_hi, f_lo)
        if float(norm1) <= 1e-8 * init:
            break

    assert int(n2) == int(n1)
    assert float(norm2) == pytest.approx(float(norm1), rel=1e-3)


@pytest.mark.parametrize("gamma_min_n", [0, 17])
def test_sharded2d_gamma_wcycle_matches_single_device(mesh, gamma_min_n):
    """W-cycle (gamma=2) through the 2D recursion equals the
    single-device W-cycle; gamma_min_n=17 pins the depth cap (skips
    the 9-level revisit) against the identically-capped host cycle."""
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)  # 17^3
    cfg = CycleConfig(n_smooth=2, gamma=2, gamma_min_n=gamma_min_n)
    prob = poisson_3d_quadratic()

    cycle_1 = make_cycle_fn(hier, cfg)
    u1, f1 = setup_problem(prob, hier)
    cycle_2, plan = s2.make_sharded2d_cycle(hier, cfg, mesh)
    u2, f2 = s2.setup_problem_sharded2d(prob, hier, mesh, plan)

    for it in range(3):
        u1, n1 = cycle_1(u1, f1)
        u2, n2 = cycle_2(u2, f2)
        assert float(n2) == pytest.approx(float(n1), rel=1e-10), it


def test_sharded2d_converges_to_oracle(mesh):
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()
    cycle, plan = s2.make_sharded2d_cycle(hier, cfg, mesh)
    u, f = s2.setup_problem_sharded2d(prob, hier, mesh, plan)
    init = float(jnp.sqrt(jnp.sum(f * f)))
    norm = init
    for _ in range(20):
        u, nd = cycle(u, f)
        norm = float(nd)
        if norm <= 1e-8 * init:
            break
    assert norm <= 1e-8 * init
    from multigrid_parallel.hierarchy import evaluate_on_grid

    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1)
    err = float(jnp.sqrt(jnp.sum((s2.unpad2d(u, hier) - exact) ** 2)))
    assert err < 2e-8, err


@pytest.mark.parametrize("shape", [(4, 4), (3, 3)])
def test_make_mesh_2d_raises_on_too_few_devices(shape):
    with pytest.raises(ValueError, match="devices"):
        s2.make_mesh_2d(*shape)


@pytest.mark.parametrize("shape", [(2, 4), (8, 1), (1, 8), (2, 2)])
def test_sharded2d_cycle_mesh_orientation_invariance(shape):
    """The f64 2D cycle equals the single-device cycle whatever the mesh
    orientation, including degenerate 1-wide meshes."""
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()
    mesh = s2.make_mesh_2d(*shape)
    cycle_1 = make_cycle_fn(hier, cfg)
    u1, f1 = setup_problem(prob, hier)
    cycle_2, plan = s2.make_sharded2d_cycle(hier, cfg, mesh)
    u2, f2 = s2.setup_problem_sharded2d(prob, hier, mesh, plan)
    for it in range(2):
        u1, n1 = cycle_1(u1, f1)
        u2, n2 = cycle_2(u2, f2)
        assert float(n2) == pytest.approx(float(n1), rel=1e-10), it
    np.testing.assert_allclose(
        np.asarray(s2.unpad2d(u2, hier)), np.asarray(u1), rtol=0, atol=1e-11
    )
