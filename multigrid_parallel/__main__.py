"""CLI mirroring the reference drivers.

Positional signature matches the reference exactly
(``<coarse grid pts per side> <num levels> <GS iterations>``,
mg_3d.h:109-118; test_mg_3d.c), with flags for the capabilities the
reference selects at compile time (problem choice, FMG, VTK output,
tolerance, smoother).

    python -m multigrid_parallel 5 4 2            # = ./test_mg_3d 5 4 2
    python -m multigrid_parallel 5 4 2 --fmg      # mg_dirichlet_analytic useFMG
    python -m multigrid_parallel 5 9 2 --ndim 1   # = ./mg_1d
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="multigrid_parallel",
        description="Geometric multigrid Poisson solver (JAX)",
    )
    p.add_argument("coarse_n", type=int, help="coarse grid points per side")
    p.add_argument("num_levels", type=int, help="number of multigrid levels")
    p.add_argument("gs_iter", type=int, help="smoothing sweeps per stage")
    p.add_argument("--ndim", type=int, default=3, choices=(1, 3))
    p.add_argument("--problem", default="quadratic",
                   choices=("quadratic", "trig", "cos1d"))
    p.add_argument("--tol", type=float, default=1e-8,
                   help="relative residual tolerance (test_mg_3d.c:19)")
    p.add_argument("--max-cycles", type=int, default=100)
    p.add_argument("--fmg", action="store_true",
                   help="FMG bootstrap (mg_dirichlet_analytic.c:771-806)")
    p.add_argument("--smoother", default="rb", choices=("rb", "jacobi", "lex"))
    p.add_argument("--gamma", type=int, default=1,
                   help="recursion count per level: 1=V-cycle, 2=W-cycle")
    p.add_argument("--mixed", action="store_true",
                   help="f32 V-cycle inside an f64 defect-correction loop")
    p.add_argument("--f32", action="store_true", help="pure float32")
    p.add_argument("--vtk", metavar="FILE", default=None,
                   help="write the error field as legacy VTK (postprocess.h)")
    p.add_argument("--profile", action="store_true",
                   help="per-level per-stage timing table (timing_info.h)")
    p.add_argument("--study", action="store_true",
                   help="standalone smoother convergence study "
                        "(test_rb_gs_3d.c / test_gs_3d.c)")
    p.add_argument("--electrospray", action="store_true",
                   help="mixed-BC electrospray potential problem "
                        "(mg_3d_bkup.c)")
    p.add_argument("--band", type=int, nargs=2, default=None,
                   metavar=("WIDTH", "ITERS"),
                   help="electrospray boundary-band relaxation (the "
                        "docs/MIXED_BC.md convergence fix, e.g. "
                        "--band 2 2; combine with --gamma 2)")
    p.add_argument("--gamma-min", type=int, default=0, metavar="N",
                   help="W-cycle depth cap: gamma revisits only on "
                        "sub-levels of size >= N (0 = full W-cycle; "
                        "the deep revisits contribute nothing past "
                        "~finest/4 — docs/MIXED_BC.md). Applies to both the "
                        "Dirichlet (CycleConfig) and --electrospray "
                        "paths; a no-op unless --gamma > 1")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    import jax

    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from multigrid_parallel import (
        CycleConfig,
        Hierarchy,
        MultigridSolver,
        poisson_1d_cos,
        poisson_3d_quadratic,
        poisson_3d_trig,
        solve,
        solve_mixed,
    )

    if args.study:
        from multigrid_parallel.studies import smoother_study

        res = smoother_study(
            num_levels=args.num_levels, coarse_n=args.coarse_n,
            smoother=args.smoother, max_iters=5000, rel_tol=args.tol,
            verbose=not args.quiet,
        )
        print(
            f"iters: {res.n_iters}  converged: {res.converged}  "
            f"final ResidRatio: {res.final_ratio:.6f}  "
            f"wall: {res.wall_time_s:.3f} s"
        )
        return

    if args.electrospray:
        if args.fmg:
            p.error("--fmg is not supported with --electrospray "
                    "(MixedBCSolver has no FMG bootstrap)")
        from multigrid_parallel.hierarchy import Hierarchy as _H
        from multigrid_parallel.mixed_bc import MixedBCSolver
        from multigrid_parallel.models.electrospray import electrospray_problem

        prob = electrospray_problem()
        hier = _H(ndim=3, coarse_n=args.coarse_n, num_levels=args.num_levels,
                  length=prob.length)
        bw, bi = args.band if args.band else (0, 0)
        ms = MixedBCSolver(prob, hier, n_smooth=args.gs_iter,
                           gamma=args.gamma, boundary_band_width=bw,
                           boundary_band_iters=bi,
                           gamma_min_n=args.gamma_min)
        t0 = time.perf_counter()
        if args.mixed:
            # jit-fused performance path: one lax.while_loop, f32 inner
            u, norm, n_cycles, init = ms.solve_on_device(
                rel_tol=args.tol, max_cycles=args.max_cycles
            )
            n_cycles_out = n_cycles
        else:
            u, norms, init = ms.solve(rel_tol=args.tol, max_cycles=args.max_cycles,
                                      verbose=not args.quiet)
            n_cycles_out = len(norms)
        print(f"cycles: {n_cycles_out}   wall time: {time.perf_counter() - t0:.4f} s")
        if args.vtk:
            from multigrid_parallel.utils import write_vtk

            write_vtk(args.vtk, u, hier.finest_spacing)
            print(f"wrote {args.vtk}")
        return

    problem = {
        "quadratic": poisson_3d_quadratic,
        "trig": poisson_3d_trig,
        "cos1d": poisson_1d_cos,
    }[args.problem if args.ndim == 3 else "cos1d"]()

    if args.profile:
        s = MultigridSolver(
            args.coarse_n, args.num_levels, args.gs_iter,
            problem=problem, smoother=args.smoother,
        )
        s.setup_boundary_conditions()
        init = s.get_initial_residual()
        t0 = time.perf_counter()
        norm, old = init, init
        for it in range(args.max_cycles):
            norm = s.lin_solve_profiled()
            if not args.quiet:
                print(f"iter {it:3d}  resid {norm:.6e}  ResidRatio {norm / old:.4f}")
            old = norm
            if norm <= args.tol * init:
                break
        wall = time.perf_counter() - t0
        s.print_timing_info()
        err = s.error_vs_analytic()
        u = s.u
        n_cycles = it + 1
    else:
        hier = Hierarchy(
            ndim=problem.ndim, coarse_n=args.coarse_n,
            num_levels=args.num_levels, length=problem.length,
            dtype=jnp.float32 if args.f32 else jnp.float64,
        )
        cfg = CycleConfig(n_smooth=args.gs_iter, smoother=args.smoother,
                          gamma=args.gamma, gamma_min_n=args.gamma_min)
        solver_fn = solve_mixed if args.mixed else solve
        res = solver_fn(
            problem, hier, cfg, rel_tol=args.tol, max_cycles=args.max_cycles,
            verbose=not args.quiet, use_fmg=args.fmg,
        )
        wall, err, u, n_cycles = (
            res.wall_time_s, res.error_norm, res.u, res.n_cycles,
        )
        if not res.converged:
            print(f"WARNING: not converged after {res.n_cycles} cycles",
                  file=sys.stderr)

    print(f"cycles: {n_cycles}   wall time: {wall:.4f} s")
    if err is not None:
        print(f"error vs analytic (L2): {err:.6e}")

    if args.vtk and problem.ndim == 3:
        from multigrid_parallel.hierarchy import evaluate_on_grid
        from multigrid_parallel.utils import write_vtk

        hier = Hierarchy(
            ndim=3, coarse_n=args.coarse_n, num_levels=args.num_levels,
            length=problem.length,
        )
        if problem.analytic is not None:
            import numpy as np

            exact = evaluate_on_grid(problem.analytic, hier, args.num_levels - 1)
            field = np.asarray(u) - np.asarray(exact)  # error field, as
            # the reference driver writes (diff2.vtk, test_mg_3d.c:99)
        else:
            field = u
        write_vtk(args.vtk, field, hier.finest_spacing)
        print(f"wrote {args.vtk}")


if __name__ == "__main__":
    from multigrid_parallel.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
