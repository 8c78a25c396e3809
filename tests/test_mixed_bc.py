"""Electrospray mixed-BC solver tests (the mg_3d_bkup.c capability)."""

import numpy as np
import jax.numpy as jnp
import pytest

from multigrid_parallel.hierarchy import Hierarchy
from multigrid_parallel.mixed_bc import MixedBCSolver, build_mixed_coarse_matrix
from multigrid_parallel.models.electrospray import (
    EXTRACTOR_VOLTAGE,
    electrospray_problem,
)


@pytest.fixture(scope="module")
def solver():
    prob = electrospray_problem()
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3, length=prob.length)  # 17^3
    return MixedBCSolver(prob, hier, n_smooth=2)


def test_mixed_coarse_matrix_rows():
    prob = electrospray_problem()
    n = 5
    mask, _ = prob.boundary_masks(n)
    h = prob.length / (n - 1)
    a = build_mixed_coarse_matrix(n, h, mask)
    # capillary center on X=0 face is Dirichlet -> identity row
    p = 0 * n * n + (n // 2) * n + (n // 2)
    assert mask[0, n // 2, n // 2]
    assert a[p, p] == 1.0 and np.count_nonzero(a[p]) == 1
    # corner (0,0,0) is Neumann with z-face copy source (0,0,1)
    assert a[0, 0] == 1.0 and a[0, 1] == -1.0 and np.count_nonzero(a[0]) == 2
    # nonsingular
    assert np.linalg.matrix_rank(a) == a.shape[0]


def test_electrospray_converges(solver):
    u, norms, init = solver.solve(rel_tol=1e-8, max_cycles=60)
    assert norms[-1] <= 1e-8 * init, norms[-5:]
    un = np.asarray(u)
    # physical sanity: potential bracketed by the electrode voltages
    assert un.min() >= EXTRACTOR_VOLTAGE - 1e-6
    assert un.max() <= 1e-6
    # Dirichlet electrodes held exactly
    n = un.shape[0]
    mask, vals = solver.problem.boundary_masks(n)
    np.testing.assert_allclose(un[mask], np.asarray(vals)[mask], atol=1e-10)
    # Neumann faces: boundary equals adjacent interior (zero normal
    # derivative), checked on face interiors away from electrodes
    s = slice(1, -1)
    ymask = ~mask[s, 0, s]
    np.testing.assert_allclose(
        un[s, 0, s][ymask], un[s, 1, s][ymask], atol=1e-8
    )


def test_electrospray_residual_decreases_multigrid_fast(solver):
    _, norms, init = solver.solve(rel_tol=1e-8, max_cycles=60)
    ratios = [b / a for a, b in zip([init] + norms, norms)][1:6]
    assert all(r < 0.7 for r in ratios), ratios


# ---- C-parity against the loop-level golden (mg_3d_bkup.c:51-174) ----


def test_golden_smoother_shares_fixed_point(solver):
    """The C smoother's in-sweep Neumann copies and MixedBCSolver's
    post-sweep formulation must agree on the converged state: applying
    the transliterated golden smoother to our converged solution leaves
    it unchanged to solver tolerance."""
    from golden_mixed import calculate_residual, gauss_seidel_smoother

    u, norms, init = solver.solve(rel_tol=1e-10, max_cycles=80)
    assert norms[-1] <= 1e-10 * init
    un = np.asarray(u, dtype=np.float64)
    h = solver.problem.length / (un.shape[0] - 1)
    d = np.zeros_like(un)

    ug = un.copy()
    gauss_seidel_smoother(ug, d, h, 1)
    # measured 3.2e-8 absolute on the 1350 V scale (2.4e-11 relative)
    assert np.abs(ug - un).max() < 1e-6

    # our converged state has ~zero golden (h^2-scaled) residual too
    ssq, _ = calculate_residual(un, d, h)
    u0, _ = solver.initial_state()
    ssq0, _ = calculate_residual(np.asarray(u0, dtype=np.float64), d, h)
    assert np.sqrt(ssq) < 1e-9 * np.sqrt(ssq0)


def test_golden_vs_post_sweep_smoothing_trajectory(solver):
    """Smoothing-only convergence trajectories: sequential in-sweep C
    semantics vs our vectorized post-sweep RB. Same asymptotic
    per-sweep ratio to ~1%% (measured 0.982-0.985 both at 17^3)."""
    from golden_mixed import calculate_residual, gauss_seidel_smoother

    import jax.numpy as jnp

    u0, _ = solver.initial_state()
    n = u0.shape[0]
    h = solver.problem.length / (n - 1)
    d = np.zeros((n,) * 3)
    lvl = solver.hier.num_levels - 1

    vg = np.asarray(u0, dtype=np.float64).copy()
    gn = []
    for _ in range(40):
        gauss_seidel_smoother(vg, d, h, 1)
        ssq, _ = calculate_residual(vg, d, h)
        gn.append(np.sqrt(ssq))

    uo = u0
    on = []
    for _ in range(40):
        uo = solver._smooth(uo, jnp.zeros_like(uo), lvl, 1, True, False)
        ssq, _ = calculate_residual(np.asarray(uo, dtype=np.float64), d, h)
        on.append(np.sqrt(ssq))

    g_ratio = gn[-1] / gn[-2]
    o_ratio = on[-1] / on[-2]
    assert o_ratio == pytest.approx(g_ratio, abs=0.01), (g_ratio, o_ratio)
    # overall reduction after 40 sweeps in the same ballpark
    assert on[-1] / gn[-1] < 2.0 and gn[-1] / on[-1] < 2.0


def test_on_device_mixed_bc_matches_host(solver):
    """The one-jit while_loop solver (f32 inner correction cycles, f64
    outer defect) must track the all-f64 host-loop solver: same cycle
    count, same solution to f32-correction roundoff."""
    u_dev, norm, it, init = solver.solve_on_device(rel_tol=1e-8, max_cycles=60)
    u_host, norms, init_h = solver.solve(rel_tol=1e-8, max_cycles=60)
    assert it == len(norms)
    assert norm <= 1e-8 * init
    assert float(jnp.max(jnp.abs(u_dev - u_host))) < 1e-7


def test_on_device_inner_cycles_amortize(solver):
    """inner_cycles=2 halves the outer f64-residual passes (the same
    amortization the Dirichlet df solver uses)."""
    _, n1, it1, init1 = solver.solve_on_device(rel_tol=1e-8, inner_cycles=1)
    _, n2, it2, init2 = solver.solve_on_device(rel_tol=1e-8, inner_cycles=2)
    assert it2 < it1
    assert n1 <= 1e-8 * init1 and n2 <= 1e-8 * init2


def test_on_device_fingerprint_65():
    """65^3 electrospray fingerprint on the jit-fused path: 31 outer
    steps to 1e-8 (measured), potential bracketed by the electrode
    voltages."""
    prob = electrospray_problem()
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=5, length=prob.length)
    s = MixedBCSolver(prob, hier, n_smooth=2)
    u, norm, it, init = s.solve_on_device(rel_tol=1e-8, max_cycles=80)
    assert norm <= 1e-8 * init
    assert it == pytest.approx(31, abs=3)
    un = np.asarray(u)
    assert un.min() >= EXTRACTOR_VOLTAGE - 1e-6 and un.max() <= 1e-6


# ---- full C-driver golden (mg_3d_bkup.c:515-589, 831-883) ----


def test_golden_bkup_faithful_trajectory_17():
    """Pins the transliterated C driver's per-cycle squared norms at
    17^3 (coarse 9^3, numLevels=2, gsIter=2) — the recorded run of the
    reference program's exact scheme, h^2-scaling quirk included."""
    from golden_mixed import solve_bkup

    _, norms, init = solve_bkup(9, 2, 2, max_cycles=5)
    assert init == pytest.approx(160380000.0, rel=1e-10)
    want = [7.902116e06, 3.272338e06, 2.002871e06, 1.424979e06, 1.087616e06]
    for got, w in zip(norms, want):
        assert got == pytest.approx(w, rel=1e-5), (norms, want)


def test_golden_bkup_scaling_bug_nulls_coarse_correction():
    """The h^2 bug makes the coarse correction ~1e-10 of its fixed-
    scaling size, so faithful and fixed trajectories are nearly equal
    (both smoothing-dominated) — the quirk documented in golden_mixed.
    If the faithful mode ever got a REAL coarse correction, the two
    would diverge sharply."""
    from golden_mixed import solve_bkup

    _, nf, _ = solve_bkup(9, 2, 2, max_cycles=4, faithful=True)
    _, nx, _ = solve_bkup(9, 2, 2, max_cycles=4, faithful=False)
    for a, b in zip(nf, nx):
        assert abs(a - b) / a < 0.12, (nf, nx)
    # and the asymptotic ratio is the smoothing rate, not the MG rate
    assert nf[-1] / nf[-2] > 0.7


def test_mixed_solver_dominates_c_golden():
    """MixedBCSolver (correct scaling + Neumann coarse rows) reaches in
    a few cycles what the C program's scheme cannot: at matched 17^3 /
    tolerance its cycle count is at most a third of the golden's."""
    from golden_mixed import solve_bkup

    prob = electrospray_problem()
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3, length=prob.length)
    s = MixedBCSolver(prob, hier, n_smooth=2)
    _, norms, init = s.solve(rel_tol=1e-3, max_cycles=30)
    ours = len(norms)
    assert norms[-1] <= 1e-3 * init

    # golden: same relative tolerance on sqrt norms = tol^2 on squared
    _, gn, ginit = solve_bkup(9, 2, 2, tolerance=1e-3, max_cycles=3 * ours)
    golden_converged_in = len(gn) if gn[-1] < ginit * 1e-6 else None
    assert golden_converged_in is None or ours * 3 <= golden_converged_in


def test_mixed_band_wcycle_fingerprint_33():
    """The production config (W-cycle + boundary-band relaxation,
    docs/MIXED_BC.md): 11 cycles at ~0.22/cycle — same solution as the
    reference-shaped cycle to solver tolerance."""
    prob = electrospray_problem()
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=prob.length)
    fast = MixedBCSolver(prob, hier, n_smooth=2, gamma=2,
                         boundary_band_width=2, boundary_band_iters=2)
    u, norms, init = fast.solve(rel_tol=1e-8, max_cycles=30)
    assert norms[-1] <= 1e-8 * init
    assert len(norms) <= 13, len(norms)
    tail = [b / a for a, b in zip(norms[-4:-1], norms[-3:])]
    assert all(r < 0.35 for r in tail), tail

    ref = MixedBCSolver(prob, hier, n_smooth=2)
    u0, norms0, init0 = ref.solve(rel_tol=1e-8, max_cycles=45)
    # same fixed point: 1e-3 absolute on the 1350 V scale (~7e-7
    # relative; the 1e-8 RESIDUAL tolerance leaves ~1e-4 solution slack)
    assert float(jnp.max(jnp.abs(u - u0))) < 1e-3


def test_mixed_band_wcycle_on_device_matches_host():
    prob = electrospray_problem()
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=3, length=prob.length)
    s = MixedBCSolver(prob, hier, n_smooth=2, gamma=2,
                      boundary_band_width=2, boundary_band_iters=2)
    u_dev, norm, it, init = s.solve_on_device(rel_tol=1e-8, max_cycles=40)
    u_host, norms, _ = s.solve(rel_tol=1e-8, max_cycles=40)
    assert norm <= 1e-8 * init
    assert it == len(norms)
    assert float(jnp.max(jnp.abs(u_dev - u_host))) < 1e-7


def test_mixed_vcycle_fingerprint_33():
    """33^3 mixed-BC V-cycle fingerprint: 29 cycles to 1e-8, asymptotic
    per-cycle ratio ~0.588 (measured; Neumann faces degrade the ratio
    vs the Dirichlet problem's 0.12-0.17)."""
    prob = electrospray_problem()
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=prob.length)
    s = MixedBCSolver(prob, hier, n_smooth=2)
    u, norms, init = s.solve(rel_tol=1e-8, max_cycles=45)
    assert norms[-1] <= 1e-8 * init
    assert len(norms) == pytest.approx(29, abs=3)
    tail = [b / a for a, b in zip(norms[-6:-1], norms[-5:])]
    assert all(0.55 < r < 0.62 for r in tail), tail
