"""Cycle orchestration: V-cycle, FMG bootstrap, and the outer solve loop.

A re-design of the reference's recursive vcycle (mg_3d.h:1242-1362)
and driver loop (test_mg_3d.c:37-67):

  * The recursion over levels is statically unrolled at trace time (levels
    are compile-time constants, exactly like the reference's argv-derived
    ``numLevels``), so one jit compiles the entire cycle into a single
    fused XLA program.
  * The reference zeroes every non-finest level's solution at cycle entry
    (mg_3d.h:1254-1260) and overwrites every non-finest RHS by restriction
    each cycle — so the only true cycle state is the finest ``u``; coarse
    arrays here are values created inside the cycle, not buffers.
  * The outer convergence loop runs on the host (one scalar sync per
    cycle, matching the reference's per-iteration residual print), with a
    fully-on-device ``lax.while_loop`` variant for benchmarking.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from multigrid_parallel.hierarchy import Hierarchy, apply_boundary, evaluate_on_grid
from multigrid_parallel.models.poisson import Problem
from multigrid_parallel.ops import coarse as coarse_ops
from multigrid_parallel.ops import stencils_1d, stencils_3d


@dataclasses.dataclass(frozen=True)
class CycleConfig:
    """Cycle hyper-parameters (the reference's argv: gsIterNum, mg_3d.h:118).

    smoother: "rb" (red-black GS, the reference's parallel default),
      "jacobi" (weighted Jacobi), or "lex" (sequential GS oracle).
    coarse_method: "lu" | "inverse" (see ops.coarse).
    gamma: recursion count per level — 1 = V-cycle (the reference's only
      cycle shape), 2 = W-cycle (beyond-reference; each coarse solve is
      visited 2^depth times, so the static unroll grows exponentially —
      practical at moderate depth, and rarely worth it for Poisson where
      the V-cycle already contracts ~0.15/cycle). Honored by every
      CycleConfig-taking cycle: cycles._descend and the sharded paths
      (parallel/sharded.py via _recurse_sharded, parallel/sharded2d.py
      via _recurse2d). MixedBCSolver takes its own gamma field directly
      (plus the boundary-band options) rather than a CycleConfig.
    gamma_min_n: W-cycle depth cap — gamma revisits apply only to
      sub-levels of size >= gamma_min_n (0 = full W-cycle). The deep
      revisits are many small launches and contribute nothing past
      ~finest/4 (docs/MIXED_BC.md §4 measures the electrospray analog);
      honored by the same cycles MixedBCSolver.gamma_min_n is.
    """

    n_smooth: int = 2
    smoother: str = "rb"
    omega: float = 2.0 / 3.0
    coarse_method: str = "lu"
    gamma: int = 1
    gamma_min_n: int = 0


def _ops(ndim: int):
    return stencils_3d if ndim == 3 else stencils_1d


def _smooth(ops, cfg: CycleConfig, u, f, h, red_first: bool):
    if cfg.smoother == "rb":
        return ops.rb_smooth(u, f, h, cfg.n_smooth, red_first=red_first)
    if cfg.smoother == "jacobi":
        return ops.jacobi_smooth(u, f, h, cfg.n_smooth, omega=cfg.omega)
    if cfg.smoother == "lex":
        return ops.gauss_seidel_lex(u, f, h, cfg.n_smooth)
    raise ValueError(f"unknown smoother {cfg.smoother!r}")


def _descend(
    ops,
    hier: Hierarchy,
    cfg: CycleConfig,
    coarse_solve,
    u,
    f,
    level: int,
    correction: bool = False,
):
    """One V-cycle from `level` down; returns the updated solution at
    `level`. Matches the stage order of mg_3d.h:1242-1362.

    ``correction=True`` marks a sub-solve of the error equation, whose
    RHS boundary is exactly zero; its coarse-solve output boundary is
    re-zeroed to kill O(eps) pivoted-solve noise that the interior-only
    outer residual could otherwise never correct (critical in the f32
    mixed-precision path, harmless 1e-15 hygiene in f64).
    """
    if level == 0:
        # Coarsest: direct solve (mg_3d.h:1262-1277). The reference zeroes
        # v first then LU-solves into it; a direct solve needs no init.
        with jax.named_scope("L0/direct_solve"):
            x = coarse_solve(f)
        return ops.zero_boundary(x) if correction else x
    h = hier.spacing(level)
    # named scopes mirror the reference's 7 timing stages (mg_3d.h:136-137)
    # so jax.profiler traces group per level/stage.
    with jax.named_scope(f"L{level}/Smoother1"):
        u = _smooth(ops, cfg, u, f, h, red_first=True)  # preSmoother
    with jax.named_scope(f"L{level}/CalcResidual1"):
        r = ops.residual(u, f, h)  # calculateResidual
    with jax.named_scope(f"L{level}/Restrict"):
        fc = ops.restrict_full_weighting(r)  # restrictResidual
    # Recurse with zero initial guess (the mg_3d.h:1254-1260 memset);
    # gamma > 1 revisits the coarse correction (W-cycle), re-entering
    # from the previous ec.
    ec = jnp.zeros((hier.sizes[level - 1],) * hier.ndim, dtype=u.dtype)
    n_rec = cfg.gamma if (
        level - 1 > 0 and hier.sizes[level - 1] >= cfg.gamma_min_n
    ) else 1
    for _ in range(n_rec):
        ec = _descend(
            ops, hier, cfg, coarse_solve, ec, fc, level - 1, correction=True
        )
    with jax.named_scope(f"L{level}/ProlongateCorrect"):
        u = ops.prolong_correct(ec, u)  # prolongateAndCorrectError
    with jax.named_scope(f"L{level}/Smoother2"):
        u = _smooth(ops, cfg, u, f, h, red_first=False)  # postSmoother
    return u


def v_cycle(
    u: jnp.ndarray,
    f: jnp.ndarray,
    hier: Hierarchy,
    coarse_solve: Callable,
    cfg: CycleConfig = CycleConfig(),
):
    """One V-cycle from the finest level. Returns (u_new, residual_norm),
    the norm being the post-cycle interior residual (mg_3d.h:1354-1361)."""
    ops = _ops(hier.ndim)
    level = hier.num_levels - 1
    u = _descend(ops, hier, cfg, coarse_solve, u, f, level)
    norm = ops.residual_norm(u, f, hier.spacing(level))
    return u, norm


def fmg_initialize(
    f: jnp.ndarray,
    hier: Hierarchy,
    coarse_solve: Callable,
    cfg: CycleConfig,
    bc_fn=None,
):
    """Full-multigrid bootstrap (mg_dirichlet_analytic.c:771-806): solve the
    coarsest grid directly, then per finer level prolongate the solution up,
    re-impose boundary conditions, and run one V-cycle.

    ``f`` is the finest RHS (boundary entries = Dirichlet values, as set up
    by the driver); coarser RHS/BCs are re-evaluated via ``bc_fn(level)``
    returning the boundary-value grid for that level (None = zero BCs).
    """
    ops = _ops(hier.ndim)

    # Build the per-level RHS by successively injecting the finest one —
    # the reference evaluates BCs per level instead; for f=0-interior
    # problems these coincide on the boundary and the interior is zero.
    f_levels: List[jnp.ndarray] = [f]
    for lvl in range(hier.num_levels - 1, 0, -1):
        coarse = f_levels[-1][(slice(None, None, 2),) * hier.ndim]
        f_levels.append(coarse)
    f_levels.reverse()  # coarsest first

    u = coarse_solve(f_levels[0])
    for lvl in range(1, hier.num_levels):
        uf = jnp.zeros((hier.sizes[lvl],) * hier.ndim, dtype=f.dtype)
        u = ops.prolong_correct(u, uf)  # prolong solution up (":795")
        if bc_fn is not None:
            u = apply_boundary(u, bc_fn(lvl))  # re-impose BCs (":798")
        sub = dataclasses.replace(hier, num_levels=lvl + 1)
        u = _descend(ops, sub, cfg, coarse_solve, u, f_levels[lvl], lvl)
    return u


@dataclasses.dataclass
class SolveResult:
    u: jnp.ndarray
    residual_norms: List[float]
    initial_residual: float
    n_cycles: int
    converged: bool
    error_norm: Optional[float] = None
    wall_time_s: float = 0.0

    @property
    def residual_ratios(self) -> List[float]:
        norms = [self.initial_residual] + self.residual_norms
        return [b / a for a, b in zip(norms, norms[1:])]


def setup_problem(problem: Problem, hier: Hierarchy):
    """Build (u0, f) on the finest grid, reference-style:

    * f interior = rhs, f boundary = Dirichlet values
      (SolverSetupBoundaryConditions writes BCFunc onto the finest d,
      mg_3d.h:1412-1413 — those boundary values only enter through the
      initial-residual norm, which is ||f||_2 over the WHOLE cube,
      mg_3d.h:1430-1433);
    * u0 interior = 0, u0 boundary = Dirichlet values (test_mg_3d.c:29).
    """
    lvl = hier.num_levels - 1
    bc_vals = evaluate_on_grid(problem.bc, hier, lvl)
    f = evaluate_on_grid(problem.rhs, hier, lvl)
    f = apply_boundary(f, bc_vals)
    u0 = apply_boundary(jnp.zeros_like(f), bc_vals)
    return u0, f


def make_cycle_fn(hier: Hierarchy, cfg: CycleConfig = CycleConfig()):
    """Jit-compile one V-cycle for this hierarchy/config."""
    coarse_solve = coarse_ops.make_coarse_solver(
        hier.coarse_n, hier.spacing(0), hier.ndim, hier.dtype, cfg.coarse_method
    )
    return jax.jit(lambda u, f: v_cycle(u, f, hier, coarse_solve, cfg))


def solve(
    problem: Problem,
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    rel_tol: float = 1e-8,
    max_cycles: int = 100,
    use_fmg: bool = False,
    verbose: bool = False,
) -> SolveResult:
    """Full solve: setup, optional FMG bootstrap, V-cycles to convergence.

    Convergence criterion matches test_mg_3d.c:40: residual norm (interior)
    <= rel_tol * ||f||_2 (whole finest cube, BC values included).
    """
    coarse_solve = coarse_ops.make_coarse_solver(
        hier.coarse_n, hier.spacing(0), hier.ndim, hier.dtype, cfg.coarse_method
    )
    u, f = setup_problem(problem, hier)

    cycle = jax.jit(lambda u, f: v_cycle(u, f, hier, coarse_solve, cfg))
    if use_fmg:
        bc_fn = lambda lvl: evaluate_on_grid(problem.bc, hier, lvl)
        fmg = jax.jit(lambda f: fmg_initialize(f, hier, coarse_solve, cfg, bc_fn))
        u = fmg(f)

    return _host_solve_loop(problem, hier, cycle, u, f, rel_tol, max_cycles, verbose)


def make_mixed_cycle(hier: Hierarchy, cfg: CycleConfig = CycleConfig()):
    """Mixed-precision defect-correction cycle: f64 state, f32 V-cycle.

    Accuracy strategy (SURVEY.md §7 step 6): the hot smoothing sweeps run
    in f32, at half the bytes of f64, while the outer iteration keeps the
    solution and residual in f64:

        r64 = f - A u64          (one f64 stencil pass)
        e32 = Vcycle32(A, r64/s) (all smoothing in f32, s = ||r|| scaling
                                  so the f32 correction solve is O(1))
        u64 += s * e64(e32)

    Classic iterative refinement: converges at the V-cycle rate to f64
    accuracy, because each defect equation is solved on a rescaled O(1)
    right-hand side where f32 precision is ample.

    Returns (cycle_fn, ops): cycle_fn(u64, f64) -> (u64', ||r||_2 in f64).
    """
    ops = _ops(hier.ndim)
    f32 = jnp.float32
    hier32 = dataclasses.replace(hier, dtype=f32)
    coarse32 = coarse_ops.make_coarse_solver(
        hier.coarse_n, hier.spacing(0), hier.ndim, f32, cfg.coarse_method
    )
    level = hier.num_levels - 1
    h = hier.spacing(level)

    def cycle(u, f):
        r = ops.residual(u, f, h)  # f64
        nrm = jnp.sqrt(jnp.sum(r * r))
        # Guard: if already fully converged, avoid dividing by ~0.
        safe = jnp.maximum(nrm, jnp.asarray(1e-300, dtype=u.dtype))
        r32 = (r / safe).astype(f32)
        e0 = jnp.zeros_like(r32)
        e32 = _descend(ops, hier32, cfg, coarse32, e0, r32, level, correction=True)
        u = u + safe * e32.astype(u.dtype)
        norm_after = ops.residual_norm(u, f, h)
        return u, norm_after

    return cycle


def _host_solve_loop(
    problem: Problem,
    hier: Hierarchy,
    cycle,
    u,
    f,
    rel_tol: float,
    max_cycles: int,
    verbose: bool,
) -> SolveResult:
    """Shared host convergence loop (the test_mg_3d.c:37-67 driver shape):
    one scalar sync per cycle, per-iteration residual/ratio printing."""
    init_resid = float(jnp.sqrt(jnp.sum(f * f)))
    t0 = time.perf_counter()
    norms: List[float] = []
    converged = False
    old = init_resid
    for it in range(max_cycles):
        u, norm = cycle(u, f)
        n = float(norm)
        norms.append(n)
        if verbose:
            print(f"cycle {it:3d}  resid {n:.6e}  ratio {n / old:.4f}")
        old = n
        if n <= rel_tol * init_resid:
            converged = True
            break
    u.block_until_ready()
    wall = time.perf_counter() - t0
    err = None
    if problem.analytic is not None:
        exact = evaluate_on_grid(problem.analytic, hier, hier.num_levels - 1)
        err = float(jnp.sqrt(jnp.sum((u - exact) ** 2)))
    return SolveResult(
        u=u,
        residual_norms=norms,
        initial_residual=init_resid,
        n_cycles=len(norms),
        converged=converged,
        error_norm=err,
        wall_time_s=wall,
    )


def solve_mixed(
    problem: Problem,
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    rel_tol: float = 1e-8,
    max_cycles: int = 100,
    use_fmg: bool = False,
    verbose: bool = False,
) -> SolveResult:
    """Host-loop driver around the mixed-precision cycle (f64 hierarchy).

    ``use_fmg`` bootstraps with a full-multigrid pass in the outer
    precision before the mixed defect loop (mg_dirichlet_analytic.c's
    useFMG driver combined with the mixed-precision iteration)."""
    cycle = jax.jit(make_mixed_cycle(hier, cfg))
    u, f = setup_problem(problem, hier)
    if use_fmg:
        coarse_solve = coarse_ops.make_coarse_solver(
            hier.coarse_n, hier.spacing(0), hier.ndim, hier.dtype,
            cfg.coarse_method,
        )
        bc_fn = lambda lvl: evaluate_on_grid(problem.bc, hier, lvl)
        fmg = jax.jit(lambda f: fmg_initialize(f, hier, coarse_solve, cfg, bc_fn))
        u = fmg(f)
    return _host_solve_loop(problem, hier, cycle, u, f, rel_tol, max_cycles, verbose)


def make_on_device_mixed_solver(
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    rel_tol: float = 1e-8,
    max_cycles: int = 100,
):
    """Build run(u0, f) -> (u, norm, n_cycles): the whole mixed-precision
    solve as ONE jitted lax.while_loop. Jit once, call many times — the
    benchmark path.

    One f64 residual pass per cycle: the loop carries (u, r, ||r||), so
    the post-update residual doubles as the next defect (no recompute).
    """
    ops = _ops(hier.ndim)
    f32 = jnp.float32
    hier32 = dataclasses.replace(hier, dtype=f32)
    coarse32 = coarse_ops.make_coarse_solver(
        hier.coarse_n, hier.spacing(0), hier.ndim, f32, cfg.coarse_method
    )
    level = hier.num_levels - 1
    h = hier.spacing(level)

    def body(state):
        u, r, nrm, it, f = state
        safe = jnp.maximum(nrm, jnp.asarray(1e-300, dtype=u.dtype))
        r32 = (r / safe).astype(f32)
        e0 = jnp.zeros_like(r32)
        e32 = _descend(ops, hier32, cfg, coarse32, e0, r32, level, correction=True)
        u = u + safe * e32.astype(u.dtype)
        r = ops.residual(u, f, h)
        nrm = jnp.sqrt(jnp.sum(r * r))
        return u, r, nrm, it + 1, f

    @jax.jit
    def run(u0, f):
        init = jnp.sqrt(jnp.sum(f * f))
        tol = rel_tol * init

        def cond(state):
            _, _, nrm, it, _ = state
            return jnp.logical_and(nrm > tol, it < max_cycles)

        r0 = ops.residual(u0, f, h)
        n0 = jnp.sqrt(jnp.sum(r0 * r0))
        u, _, nrm, it, _ = jax.lax.while_loop(
            cond, body, (u0, r0, n0, jnp.asarray(0), f)
        )
        return u, nrm, it

    return run


def solve_on_device_mixed(
    problem: Problem,
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    rel_tol: float = 1e-8,
    max_cycles: int = 100,
):
    """Mixed-precision solve in one jitted lax.while_loop (benchmark path)."""
    run = make_on_device_mixed_solver(hier, cfg, rel_tol, max_cycles)
    u0, f = setup_problem(problem, hier)
    init = float(jnp.sqrt(jnp.sum(f * f)))
    u, norm, n_cycles = run(u0, f)
    return u, float(norm), int(n_cycles), init


def solve_on_device(
    problem: Problem,
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    rel_tol: float = 1e-8,
    max_cycles: int = 100,
):
    """Whole solve in ONE jitted lax.while_loop — no host sync per cycle.

    The convergence check runs on device, so the accelerator never
    round-trips to the host between cycles.
    """
    coarse_solve = coarse_ops.make_coarse_solver(
        hier.coarse_n, hier.spacing(0), hier.ndim, hier.dtype, cfg.coarse_method
    )
    u0, f = setup_problem(problem, hier)
    init = jnp.sqrt(jnp.sum(f * f))

    def body(state):
        u, _, it = state
        u, norm = v_cycle(u, f, hier, coarse_solve, cfg)
        return u, norm, it + 1

    def cond(state):
        _, norm, it = state
        return jnp.logical_and(norm > rel_tol * init, it < max_cycles)

    @jax.jit
    def run(u0):
        big = jnp.asarray(np.finfo(np.float32).max, dtype=u0.dtype)
        return jax.lax.while_loop(cond, body, (u0, big, jnp.asarray(0)))

    u, norm, n_cycles = run(u0)
    return u, float(norm), int(n_cycles), float(init)
