"""Sharded mixed-BC (electrospray) cycle vs single-device equivalence."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multigrid_parallel.hierarchy import Hierarchy
from multigrid_parallel.mixed_bc import MixedBCSolver
from multigrid_parallel.models.electrospray import electrospray_problem
from multigrid_parallel.parallel import sharded_mixed as sm
from multigrid_parallel.parallel.sharded import make_mesh


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


@pytest.mark.parametrize("gamma,gamma_min_n", [(1, 0), (2, 0), (2, 17)])
def test_sharded_mixed_cycle_matches_single_device(mesh, gamma, gamma_min_n):
    # gamma_min_n=17 pins the W-cycle depth cap through the sharded
    # mixed recursion (skips only the 9-level revisit) against the
    # identically-capped host cycle.
    prob = electrospray_problem()
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=prob.length)
    s = MixedBCSolver(prob, hier, n_smooth=2, gamma=gamma,
                      gamma_min_n=gamma_min_n)

    cycle_n, plan = sm.make_sharded_mixed_bc_cycle(s, mesh)
    un, fn = sm.setup_mixed_problem_sharded(s, mesh, plan)
    u1, f1 = s.initial_state()

    for it in range(3):
        u1, n1 = s._cycle(u1, f1)
        un, nn = cycle_n(un, fn)
        assert float(nn) == pytest.approx(float(n1), rel=1e-10), it

    n = hier.finest_n
    np.testing.assert_allclose(
        np.asarray(un[:n]), np.asarray(u1), rtol=0, atol=1e-8
    )


def test_sharded_mixed_converges(mesh):
    prob = electrospray_problem()
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=prob.length)
    s = MixedBCSolver(prob, hier, n_smooth=2, gamma=2)
    cycle, plan = sm.make_sharded_mixed_bc_cycle(s, mesh)
    u, f = sm.setup_mixed_problem_sharded(s, mesh, plan)
    lvl = hier.num_levels - 1
    from multigrid_parallel.ops import stencils_3d as ops3

    n = hier.finest_n
    init = float(ops3.residual_norm(u[:n], f[:n], hier.spacing(lvl)))
    norm = init
    for _ in range(25):
        u, nd = cycle(u, f)
        norm = float(nd)
        if norm <= 1e-8 * init:
            break
    assert norm <= 1e-8 * init, norm


def test_sharded_mixed_band_wcycle_matches_single_device(mesh):
    """The production config (gamma=2 + boundary band) through the
    sharded cycle equals the single-device cycle (round-3 review:
    the band options used to be silently ignored)."""
    prob = electrospray_problem()
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=prob.length)
    s = MixedBCSolver(prob, hier, n_smooth=2, gamma=2,
                      boundary_band_width=2, boundary_band_iters=2)

    cycle_n, plan = sm.make_sharded_mixed_bc_cycle(s, mesh)
    un, fn = sm.setup_mixed_problem_sharded(s, mesh, plan)
    u1, f1 = s.initial_state()
    for it in range(3):
        u1, n1 = s._cycle(u1, f1)
        un, nn = cycle_n(un, fn)
        assert float(nn) == pytest.approx(float(n1), rel=1e-10), it


def test_apply_bcs_local_shard_boundary(mesh):
    """Global plane n-1 at LOCAL ROW 0 (L divides n-1): the x-face
    Neumann copy's source lives on the PREVIOUS device — a purely-local
    shift read a pad plane here (round-4 regression; fixed with a
    one-plane ppermute)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from multigrid_parallel.ops import stencils_3d as ops3
    from multigrid_parallel.parallel.sharded import plan_sharding

    n = 17
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    plan = plan_sharding(hier, 8)
    L = plan.local_planes(0)
    assert (n - 1) % L == 0  # the trigger geometry
    rng = np.random.default_rng(0)
    u = np.zeros((plan.padded_planes(0), n, n))
    u[:n] = rng.standard_normal((n, n, n))
    pin0 = jnp.zeros((n, n))
    pin1 = jnp.zeros((n, n))
    f = jax.jit(jax.shard_map(
        lambda x: sm.apply_bcs_local(x, n, "x", 8, pin0, pin1),
        mesh=mesh, in_specs=P("x"), out_specs=P("x"), check_vma=False))
    got = np.asarray(f(jax.device_put(
        jnp.asarray(u), NamedSharding(mesh, P("x")))))
    want = np.asarray(ops3.apply_neumann_copy(jnp.asarray(u[:n])))
    np.testing.assert_allclose(got[:n], want, rtol=0, atol=0)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_mixed_device_count_invariance(n_dev):
    """The mixed-BC cycle on n_dev devices equals the single-device
    MixedBCSolver cycle (W-cycle with band relaxation)."""
    prob = electrospray_problem()
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3, length=prob.length)
    s = MixedBCSolver(prob, hier, n_smooth=2, gamma=2,
                      boundary_band_width=2, boundary_band_iters=2)
    m = make_mesh(n_dev)
    cycle_n, plan = sm.make_sharded_mixed_bc_cycle(s, m)
    un, fn = sm.setup_mixed_problem_sharded(s, m, plan)
    u1, f1 = s.initial_state()
    for it in range(2):
        u1, n1 = s._cycle(u1, f1)
        un, nn = cycle_n(un, fn)
        assert float(nn) == pytest.approx(float(n1), rel=1e-10), it
    n = hier.finest_n
    np.testing.assert_allclose(np.asarray(un[:n]), np.asarray(u1), rtol=0,
                               atol=1e-8)
