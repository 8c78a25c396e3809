"""Headline benchmark: 3D Poisson 257^3 solved to 1e-8 on one GPU.

Reproduces the reference's headline workload (test_mg_3d.c: coarseN=5,
levels such that finest=257, 2 RB-GS pre+post sweeps, relative residual
tolerance 1e-8 against ||f||_2 — BASELINE.md measures the C/OpenMP code at
10.74 s wall on 4 CPU threads).

Solver under test: ``cycles.make_on_device_mixed_solver``, the whole solve
in one jitted ``lax.while_loop``: f32 correction V-cycles inside an f64
defect-correction loop, so the answer carries f64 accuracy.

Metric: time to solution, the best of 6 warm runs, each timed
on the host clock around a call that ends in ``block_until_ready``.
Compilation is reported apart as set-up. Every result names the device
it ran on; without a GPU the script exits non-zero. Prints one JSON line.

    python bench.py               # 257^3
    python bench.py --levels 9    # 1025^3
"""

import argparse
import json
import statistics
import time

import jax
import jax.numpy as jnp

import multigrid_parallel as mg
from multigrid_parallel.cycles import make_on_device_mixed_solver, setup_problem
from multigrid_parallel.hierarchy import evaluate_on_grid
from multigrid_parallel.utils.compile_cache import enable_compile_cache
from multigrid_parallel.utils.device import (
    gpu_name_power,
    peak_bytes_in_use,
    require_gpu,
)

BASELINE_WALL_S = 10.74  # BASELINE.md: C/OpenMP at 257^3, 4 threads
REL_TOL = 1e-8  # the reference driver's tolerance (test_mg_3d.c:19)


def run(levels: int = 7, n_smooth: int = 2, repeats: int = 6) -> dict:
    dev = require_gpu()
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=levels)
    problem = mg.poisson_3d_quadratic()
    solver = make_on_device_mixed_solver(
        hier, mg.CycleConfig(n_smooth=n_smooth), rel_tol=REL_TOL, max_cycles=40
    )
    u0, f = setup_problem(problem, hier)
    init = float(jnp.sqrt(jnp.sum(f * f)))

    t0 = time.perf_counter()
    compiled = solver.lower(u0, f).compile()
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        u, norm, n_cycles = jax.block_until_ready(compiled(u0, f))
        times.append(time.perf_counter() - t0)
    norm, n_cycles = float(norm), int(n_cycles)
    if norm > REL_TOL * init:
        raise SystemExit(f"not converged: {norm:.3e} > {REL_TOL} x {init:.3e}")
    exact = evaluate_on_grid(problem.analytic, hier, hier.num_levels - 1)
    err = float(jnp.sqrt(jnp.sum((u - exact) ** 2)))

    best = min(times)
    n = hier.finest_n
    return {
        "metric": f"3d_poisson_{n}_time_to_solution",
        "value": best,
        "unit": "s",
        "vs_baseline": BASELINE_WALL_S / best if n == 257 else None,
        "detail": {
            "wall_times_s": times,
            "wall_time_median_s": statistics.median(times),
            "compile_s": compile_s,
            "n_vcycles": n_cycles,
            "rel_tol": REL_TOL,
            "final_residual": norm,
            "initial_residual": init,
            "error_vs_analytic": err,
            "grid": f"{n}^3",
            "n_smooth": n_smooth,
            "peak_bytes_in_use": peak_bytes_in_use(),
            "platform": dev["platform"],
            "device_kind": dev["kind"],
            "device_count": dev["count"],
            "gpu_name_power_limit": gpu_name_power(),
        },
    }


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="257^3 time-to-solution on one GPU")
    p.add_argument("--levels", type=int, default=7,
                   help="multigrid levels; finest = 4 * 2^(levels-1) + 1")
    args = p.parse_args()
    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    print(json.dumps(run(levels=args.levels)))
