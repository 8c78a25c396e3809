"""Sharded (shard_map + ppermute halos) vs single-device equivalence.

The analogue of the reference's 1..8-thread invariance check
(red_black_gs_scalability.txt pins identical convergence across thread
counts): the same V-cycle on an 8-device virtual CPU mesh must match the
single-device result to roundoff.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multigrid_parallel import CycleConfig, Hierarchy, poisson_3d_quadratic
from multigrid_parallel.cycles import make_cycle_fn, setup_problem
from multigrid_parallel.parallel import sharded as sh

N_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < N_DEV:
        pytest.skip("needs 8 virtual devices")
    return sh.make_mesh(N_DEV)


def test_plan_sharding_alignment():
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    plan = sh.plan_sharding(hier, N_DEV)
    assert plan.fine_local % (1 << plan.n_sharded) == 0
    assert plan.padded_planes(0) >= hier.finest_n
    # the gather level still has >= 1 plane per device
    assert plan.local_planes(plan.n_sharded) >= 1
    # coarsest level is never sharded
    assert plan.n_sharded <= hier.num_levels - 1


@pytest.mark.parametrize("gamma,gamma_min_n", [(1, 0), (2, 0), (2, 17)])
def test_sharded_cycle_matches_single_device(mesh, gamma, gamma_min_n):
    # gamma=2 pins the W-cycle plumbing through _recurse_sharded (both
    # the sharded revisits and the gather-level e_init handoff);
    # gamma_min_n=17 pins the depth cap (skips only the 9-level revisit)
    # against the identically-capped single-device recursion.
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    cfg = CycleConfig(n_smooth=2, gamma=gamma, gamma_min_n=gamma_min_n)
    prob = poisson_3d_quadratic()

    cycle_1 = make_cycle_fn(hier, cfg)
    u1, f1 = setup_problem(prob, hier)

    cycle_n, plan = sh.make_sharded_cycle(hier, cfg, mesh)
    un, fn = sh.setup_problem_sharded(prob, hier, mesh, plan)

    for it in range(3):
        u1, norm1 = cycle_1(u1, f1)
        un, normn = cycle_n(un, fn)
        assert float(normn) == pytest.approx(float(norm1), rel=1e-10), it

    np.testing.assert_allclose(
        np.asarray(sh.unpad(un, hier)), np.asarray(u1), rtol=0, atol=1e-11
    )


def test_sharded_mixed_cycle_converges(mesh):
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()
    cycle, plan = sh.make_sharded_mixed_cycle(hier, cfg, mesh)
    u, f = sh.setup_problem_sharded(prob, hier, mesh, plan)
    init = float(jnp.sqrt(jnp.sum(f * f)))
    norm = init
    for _ in range(20):
        u, norm_d = cycle(u, f)
        norm = float(norm_d)
        if norm <= 1e-8 * init:
            break
    assert norm <= 1e-8 * init
    # analytic oracle on the gathered solution
    from multigrid_parallel.hierarchy import evaluate_on_grid

    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1)
    err = float(jnp.sqrt(jnp.sum((sh.unpad(u, hier) - exact) ** 2)))
    assert err < 2e-8, err


def test_sharded_halo_smoother_matches(mesh):
    # one pre-smoother application, sharded vs not
    from multigrid_parallel.ops import stencils_3d as ops3
    from jax.sharding import PartitionSpec as P

    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)  # 17^3
    n = hier.finest_n
    h = hier.finest_spacing
    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.standard_normal((n, n, n)))
    f = jnp.asarray(rng.standard_normal((n, n, n)))
    want = ops3.rb_smooth(u, f, h, 2, red_first=True)

    plan = sh.plan_sharding(hier, N_DEV)
    pad = plan.padded_planes(0) - n
    up = jnp.pad(u, ((0, pad), (0, 0), (0, 0)))
    fp = jnp.pad(f, ((0, pad), (0, 0), (0, 0)))

    fn = jax.shard_map(
        lambda ul, fl: sh.rb_smooth_local(ul, fl, h, 2, n, "x", N_DEV, True),
        mesh=mesh,
        in_specs=(P("x"), P("x")),
        out_specs=P("x"),
        check_vma=False,
    )
    got = np.asarray(fn(up, fp))[:n]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-13)


def test_sharded_transfer_ops_match(mesh):
    from multigrid_parallel.ops import stencils_3d as ops3
    from jax.sharding import PartitionSpec as P

    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    nf = hier.finest_n  # 17
    nc = (nf + 1) // 2
    rng = np.random.default_rng(8)
    # residual-like input: zero boundary
    r = np.zeros((nf, nf, nf))
    r[1:-1, 1:-1, 1:-1] = rng.standard_normal((nf - 2,) * 3)
    want_c = np.asarray(ops3.restrict_full_weighting(jnp.asarray(r)))

    plan = sh.plan_sharding(hier, N_DEV)
    pad = plan.padded_planes(0) - nf
    rp = jnp.pad(jnp.asarray(r), ((0, pad), (0, 0), (0, 0)))

    fn = jax.shard_map(
        lambda rl: sh.restrict_local(rl, nf, "x", N_DEV),
        mesh=mesh,
        in_specs=(P("x"),),
        out_specs=P("x"),
        check_vma=False,
    )
    got_c = np.asarray(fn(rp))[:nc]
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-13)

    # prolongation: coarse correction with zero boundary
    ec = np.zeros((nc, nc, nc))
    ec[1:-1, 1:-1, 1:-1] = rng.standard_normal((nc - 2,) * 3)
    ef = rng.standard_normal((nf, nf, nf))
    want_f = np.asarray(ops3.prolong_correct(jnp.asarray(ec), jnp.asarray(ef)))

    pad_c = plan.padded_planes(1) - nc
    ecp = jnp.pad(jnp.asarray(ec), ((0, pad_c), (0, 0), (0, 0)))
    efp = jnp.pad(jnp.asarray(ef), ((0, pad), (0, 0), (0, 0)))
    fn2 = jax.shard_map(
        lambda e, u: sh.prolong_correct_local(e, u, nc, "x", N_DEV),
        mesh=mesh,
        in_specs=(P("x"), P("x")),
        out_specs=P("x"),
        check_vma=False,
    )
    got_f = np.asarray(fn2(ecp, efp))[:nf]
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=1e-13)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_cycle_device_count_invariance(n_dev):
    # the analogue of the reference's 1..8-thread invariance study
    # (red_black_gs_scalability.txt): convergence must not depend on the
    # device count
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()
    m = sh.make_mesh(n_dev)
    cycle, plan = sh.make_sharded_cycle(hier, cfg, m)
    u, f = sh.setup_problem_sharded(prob, hier, m, plan)
    norms = []
    for _ in range(3):
        u, norm = cycle(u, f)
        norms.append(float(norm))
    # reference single-device norms
    cycle_1 = make_cycle_fn(hier, cfg)
    u1, f1 = setup_problem(prob, hier)
    for want in range(3):
        u1, n1 = cycle_1(u1, f1)
        assert norms[want] == pytest.approx(float(n1), rel=1e-10)


def test_sharded_df_cycle_converges_all_f32(mesh):
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()
    cycle, plan = sh.make_sharded_df_cycle(hier, cfg, mesh)
    u_hi, u_lo, f_hi, f_lo = sh.setup_df_problem_sharded(prob, hier, mesh, plan)
    init = float(jnp.sqrt(jnp.sum(f_hi.astype(jnp.float64) ** 2)))
    norm = init
    for _ in range(25):
        u_hi, u_lo, norm_d = cycle(u_hi, u_lo, f_hi, f_lo)
        norm = float(norm_d)
        if norm <= 1e-8 * init:
            break
    assert norm <= 1e-8 * init, norm
    # oracle on the reconstructed f64 solution
    from multigrid_parallel.hierarchy import evaluate_on_grid
    from multigrid_parallel.ops import df as dfo

    u = dfo.df_to_f64(sh.unpad(u_hi, hier), sh.unpad(u_lo, hier))
    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1)
    err = float(jnp.sqrt(jnp.sum((u - exact) ** 2)))
    assert err < 5e-8, err


def test_sharded_df_cycle_inner_cycles_amortize(mesh):
    """inner_cycles=2 on the jnp sharded df cycle: fewer outer defect
    steps to tolerance (the amortization knob shared with the fused
    distributed solver and the single-chip df solver)."""
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)  # 17^3
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()
    steps = {}
    for ic in (1, 2):
        cycle, plan = sh.make_sharded_df_cycle(hier, cfg, mesh, inner_cycles=ic)
        u_hi, u_lo, f_hi, f_lo = sh.setup_df_problem_sharded(prob, hier, mesh, plan)
        init = float(jnp.sqrt(jnp.sum(f_hi.astype(jnp.float64) ** 2)))
        norm = init
        for it in range(25):
            u_hi, u_lo, norm_d = cycle(u_hi, u_lo, f_hi, f_lo)
            norm = float(norm_d)
            if norm <= 1e-8 * init:
                break
        assert norm <= 1e-8 * init, (ic, norm)
        steps[ic] = it + 1
    assert steps[2] < steps[1], steps


@pytest.mark.parametrize("n_dev", [9, 16])
def test_make_mesh_raises_on_too_few_devices(n_dev):
    with pytest.raises(ValueError, match="devices"):
        sh.make_mesh(n_dev)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_df_cycle_device_count_invariance(n_dev):
    """The all-f32 df cycle gives the same norms on n_dev devices as on
    one (the decomposition changes only where planes live)."""
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    cfg = CycleConfig(n_smooth=2)
    prob = poisson_3d_quadratic()
    norms = {}
    for n in (1, n_dev):
        m = sh.make_mesh(n)
        cycle, plan = sh.make_sharded_df_cycle(hier, cfg, m)
        u_hi, u_lo, f_hi, f_lo = sh.setup_df_problem_sharded(prob, hier, m, plan)
        norms[n] = []
        for _ in range(3):
            u_hi, u_lo, nrm = cycle(u_hi, u_lo, f_hi, f_lo)
            norms[n].append(float(nrm))
    np.testing.assert_allclose(norms[n_dev], norms[1], rtol=1e-5)
