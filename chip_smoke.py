"""Smoke check of the solver on NVIDIA GPUs, at full size.

Drives the main path once through the entry points a user calls and
checks every result:

  1. device        JAX sees a GPU; prints its kind and count, the JAX
                   version, and the card's name and power limit.
  2. c_parity      ``mg.solve`` (f64 host loop) and the CLI at 257^3,
                   against the C reference's fingerprint (BASELINE.md).
  3. perf_path     ``make_on_device_mixed_solver`` (the whole solve in one
                   jit: f32 V-cycle inside an f64 defect loop) at 513^3,
                   against the analytic solution and an f64 ``mg.solve``
                   of the same grid.
  4. electrospray  ``MixedBCSolver`` at 257^3 (W-cycle, band relaxation):
                   ``solve_on_device`` against the f64 host ``solve``.
  5. transfer      matmul against strided-slice transfer operators at
                   257^3 and 513^3, alone (f32 and f64) and inside the
                   whole solve; one red-black half-sweep against a pass
                   that moves the same bytes.

``--four`` runs only the sharded solves on four GPUs (1D slabs, a 2x2
mesh, the electrospray slabs) and the single-GPU solves they are
compared with.

Everything runs in this one process. A failed check raises and the
script exits non-zero; a run that passed ends with the line
``{"ok": true, "device": {...}}``. Without a GPU it exits non-zero
before any phase runs.

    python chip_smoke.py
    python chip_smoke.py --four
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import statistics
import sys
import time

import jax
import jax.numpy as jnp

import multigrid_parallel as mg
from multigrid_parallel.__main__ import main as cli_main
from multigrid_parallel.cycles import make_on_device_mixed_solver, setup_problem
from multigrid_parallel.hierarchy import evaluate_on_grid
from multigrid_parallel.mixed_bc import MixedBCSolver
from multigrid_parallel.models.electrospray import electrospray_problem
from multigrid_parallel.ops import stencils_3d as ops3
from multigrid_parallel.utils.compile_cache import enable_compile_cache
from multigrid_parallel.utils.device import (
    gpu_name_power,
    peak_bytes_in_use,
    require_gpu,
)

REL_TOL = 1e-8  # the reference driver's tolerance (test_mg_3d.c:19)

# C reference runs (BASELINE.md): V-cycles to 1e-8 and the L2 error
# against the analytic x^2 - 2y^2 + z^2, by finest size.
C_REFERENCE = {33: (14, 2.52e-9), 65: (15, 1.60e-9), 257: (16, 2.81e-9)}
CYCLE_SLACK = 1
ERR_FACTOR = 2.0
# BASELINE.md's per-cycle ratios run 0.123 -> 0.171 at 257^3; the upper
# bound is that range's 0.17 read to the digit it was rounded from.
RATIO_RANGE = (0.12, 0.175)

# The stencil is exact on the quadratic, so the error left after the
# residual drops below 1e-8 ||f|| is algebraic. The C reference measures
# 1.60e-9 to 4.94e-9 from 33^3 to 257^3 with no trend in n; the bound is
# four times the largest.
ANALYTIC_ERR_TOL = 2e-8
# Two solves that both stop below 1e-8 ||f|| differ by their algebraic
# errors (~3e-9 absolute L2, ~1e-13 of ||u|| at 513^3) plus roundoff of
# reduction order. All products are f64 or f32 at HIGHEST precision, so
# no TF32 rounding enters; the f32 inner cycle only changes the defect
# path. 1e-10 of ||u|| leaves three orders of margin.
SOLUTION_REL_TOL = 1e-10
# Electrospray potentials span 1350 V. The one-jit solve (f32 inner
# cycle) and the f64 host solve are different iterations, so they stop at
# different points inside the 1e-8 residual tolerance. That slack grows
# with n: below 1e-7 V at 17^3 (tests/test_mixed_bc.py), 1.0e-6 V at
# 257^3 on an H100 (700 W). The bound, 1e-5 V, is 7.4e-9 of the span.
ELECTROSPRAY_ABS_TOL = 1e-5
# Sharded and single-device f64 cycles run the same arithmetic; only
# reduction order differs, so they are held to the small-size bound.
SHARDED_ELECTROSPRAY_ABS_TOL = 1e-7
# The two transfer forms sum the same weights in another order.
TRANSFER_TOL = {jnp.float32: 1e-5, jnp.float64: 1e-12}


class SmokeFailure(RuntimeError):
    pass


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _per_call_s(fn, *args, calls: int = 20) -> float:
    """Mean device time of ``fn`` over back-to-back calls (warmed up)."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / calls


def _rel_l2(a, b) -> float:
    return float(jnp.linalg.norm((a - b).ravel()) / jnp.linalg.norm(b.ravel()))


def _analytic_err(u, prob, hier) -> float:
    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1)
    return float(jnp.sqrt(jnp.sum((u - exact) ** 2)))


def _on_device0(x):
    return jax.device_put(x, jax.devices()[0])


def result_line(dev: dict) -> str:
    """The last line of a run that passed."""
    return json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": dev["count"],
    }})


# ------------------------------------------------------------------ phases


def phase_device(count: int = 1) -> dict:
    dev = require_gpu(count)
    print(f"device: {dev['kind']} x{dev['count']} ({dev['platform']}), "
          f"jax {jax.__version__}")
    print(f"nvidia-smi name, power.limit: {gpu_name_power()}")
    return dev


def phase_c_parity(levels: int = 7) -> dict:
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=levels,
                        dtype=jnp.float64)
    c_cycles, c_err = C_REFERENCE[hier.finest_n]
    res = mg.solve(mg.poisson_3d_quadratic(), hier, mg.CycleConfig(n_smooth=2),
                   rel_tol=REL_TOL)
    ratios = res.residual_ratios[1:]
    _check(res.converged, "mg.solve did not converge")
    _check(abs(res.n_cycles - c_cycles) <= CYCLE_SLACK,
           f"{res.n_cycles} V-cycles, C reference {c_cycles}")
    _check(all(RATIO_RANGE[0] <= r <= RATIO_RANGE[1] for r in ratios),
           f"per-cycle ratios {ratios} outside {RATIO_RANGE}")
    _check(res.error_norm <= ERR_FACTOR * c_err,
           f"error {res.error_norm:.3e} > {ERR_FACTOR} x C {c_err:.3e}")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(["5", str(levels), "2", "--quiet"])
    cli_s = time.perf_counter() - t0
    text = buf.getvalue()
    cli_cycles = int(re.search(r"cycles: (\d+)", text).group(1))
    cli_err = float(re.search(r"error vs analytic \(L2\): (\S+)", text).group(1))
    _check(abs(cli_cycles - c_cycles) <= CYCLE_SLACK,
           f"CLI: {cli_cycles} V-cycles, C reference {c_cycles}")
    _check(cli_err <= ERR_FACTOR * c_err, f"CLI: error {cli_err:.3e}")
    return {
        "grid": hier.finest_n, "n_cycles": res.n_cycles, "c_cycles": c_cycles,
        "ratio_min": min(ratios), "ratio_max": max(ratios),
        "ratio_range": RATIO_RANGE, "error": res.error_norm,
        "error_tol": ERR_FACTOR * c_err,
        "solve_loop_s_incl_compile": res.wall_time_s,
        "cli_n_cycles": cli_cycles, "cli_error": cli_err, "cli_s": cli_s,
    }


def phase_perf_path(levels: int = 8, repeats: int = 3) -> dict:
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=levels,
                        dtype=jnp.float64)
    cfg = mg.CycleConfig(n_smooth=2)
    prob = mg.poisson_3d_quadratic()
    u0, f = setup_problem(prob, hier)
    init = float(jnp.sqrt(jnp.sum(f * f)))
    run = make_on_device_mixed_solver(hier, cfg, rel_tol=REL_TOL)
    t0 = time.perf_counter()
    compiled = run.lower(u0, f).compile()
    compile_s = time.perf_counter() - t0
    warm = []
    for _ in range(repeats):
        (u, norm, n_cycles), s = _timed(compiled, u0, f)
        warm.append(s)
    n_cycles = int(n_cycles)
    _check(float(norm) <= REL_TOL * init,
           f"mixed solve stopped at {float(norm):.3e} > {REL_TOL} x {init:.3e}")
    err = _analytic_err(u, prob, hier)
    _check(err <= ANALYTIC_ERR_TOL, f"mixed solve error {err:.3e}")

    ref = mg.solve(prob, hier, cfg, rel_tol=REL_TOL)
    _check(ref.converged, "f64 mg.solve did not converge")
    rel = _rel_l2(u, ref.u)
    _check(rel <= SOLUTION_REL_TOL, f"mixed vs f64 solve: rel L2 {rel:.3e}")
    return {
        "grid": hier.finest_n, "n_cycles": n_cycles, "compile_s": compile_s,
        "warm_s": warm, "warm_median_s": statistics.median(warm),
        "error": err, "error_tol": ANALYTIC_ERR_TOL,
        "f64_n_cycles": ref.n_cycles, "f64_error": ref.error_norm,
        "rel_l2_vs_f64": rel, "rel_l2_tol": SOLUTION_REL_TOL,
    }


def _electrospray_solver(levels: int, gamma_min_n: int = 0) -> MixedBCSolver:
    prob = electrospray_problem()
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=levels,
                        length=prob.length, dtype=jnp.float64)
    # gamma_min_n = finest/4 (docs/MIXED_BC.md §4): 65 at 257^3.
    cap = gamma_min_n or (hier.finest_n - 1) // 4 + 1
    return MixedBCSolver(prob, hier, n_smooth=2, gamma=2,
                         boundary_band_width=2, boundary_band_iters=2,
                         gamma_min_n=cap)


def phase_electrospray(levels: int = 7) -> dict:
    ms = _electrospray_solver(levels)
    t0 = time.perf_counter()
    u_dev, norm, n_dev_cycles, init = ms.solve_on_device(rel_tol=REL_TOL)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    u_host, norms, init_host = ms.solve(rel_tol=REL_TOL, max_cycles=100)
    host_s = time.perf_counter() - t0
    _check(norm <= REL_TOL * init, f"solve_on_device stopped at {norm:.3e}")
    _check(norms[-1] <= REL_TOL * init_host, "host solve did not converge")
    _check(n_dev_cycles == len(norms),
           f"{n_dev_cycles} outer steps on device, {len(norms)} on host")
    diff = float(jnp.max(jnp.abs(u_dev - u_host)))
    _check(diff <= ELECTROSPRAY_ABS_TOL, f"device vs host: max |du| {diff:.3e}")
    return {
        "grid": ms.hier.finest_n, "gamma_min_n": ms.gamma_min_n,
        "n_cycles": n_dev_cycles, "host_n_cycles": len(norms),
        "max_abs_diff_V": diff, "tol_V": ELECTROSPRAY_ABS_TOL,
        "on_device_s_incl_compile": dev_s, "host_s_incl_compile": host_s,
    }


@contextlib.contextmanager
def _transfer_form(form: str):
    """Make every cycle traced inside use the ``form`` transfer operators."""
    saved = ops3.restrict_full_weighting, ops3.prolong_correct
    ops3.restrict_full_weighting = getattr(ops3, f"restrict_full_weighting_{form}")
    ops3.prolong_correct = getattr(ops3, f"prolong_correct_{form}")
    try:
        yield
    finally:
        ops3.restrict_full_weighting, ops3.prolong_correct = saved


FORMS = ("matmul", "slices")


def _transfer_ops(n: int, dtype) -> dict:
    """Each form's restriction and prolongation alone at n^3 (ms)."""
    nc = (n + 1) // 2
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    r = ops3.zero_boundary(jax.random.normal(k1, (n,) * 3, dtype))
    ec = ops3.zero_boundary(jax.random.normal(k2, (nc,) * 3, dtype))
    ef = jax.random.normal(k3, (n,) * 3, dtype)
    out, got = {}, {}
    for form in FORMS:
        rst = jax.jit(getattr(ops3, f"restrict_full_weighting_{form}"))
        prl = jax.jit(getattr(ops3, f"prolong_correct_{form}"))
        got[form] = (rst(r), prl(ec, ef))
        out[f"restrict_{form}_ms"] = 1e3 * _per_call_s(rst, r)
        out[f"prolong_{form}_ms"] = 1e3 * _per_call_s(prl, ec, ef)
    tol = TRANSFER_TOL[dtype]
    for a, b, name in zip(got["matmul"], got["slices"], ("restrict", "prolong")):
        diff = float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
        _check(diff <= tol, f"{name} forms differ by {diff:.3e} at {n}^3")
    return out


def _half_sweep_vs_copy(n: int) -> dict:
    """One f32 red half-sweep (reads u and f, writes u) against u + f,
    which moves the same bytes with no stencil."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    u = jax.random.normal(k1, (n,) * 3, jnp.float32)
    f = jax.random.normal(k2, (n,) * 3, jnp.float32)
    red = jnp.asarray(ops3._masks_np(n)[0])
    h = 1.0 / (n - 1)
    sweep = jax.jit(lambda u, f: ops3._half_sweep(u, f, h, red))
    copy = jax.jit(lambda u, f: u + f)
    nbytes = 3 * 4 * n ** 3
    t_sweep, t_copy = _per_call_s(sweep, u, f), _per_call_s(copy, u, f)
    return {
        "grid": n, "bytes": nbytes, "half_sweep_ms": 1e3 * t_sweep,
        "copy_ms": 1e3 * t_copy, "half_sweep_GBps": nbytes / t_sweep / 1e9,
        "copy_GBps": nbytes / t_copy / 1e9,
    }


def phase_transfer(levels=(7, 8), repeats: int = 3) -> dict:
    out = {}
    prob = mg.poisson_3d_quadratic()
    cfg = mg.CycleConfig(n_smooth=2)
    for lv in levels:
        hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=lv,
                            dtype=jnp.float64)
        n = hier.finest_n
        for dtype in (jnp.float32, jnp.float64):
            out[f"ops_{n}_{jnp.dtype(dtype).name}"] = _transfer_ops(n, dtype)
        u0, f = setup_problem(prob, hier)
        sols = {}
        for form in FORMS:
            with _transfer_form(form):
                run = make_on_device_mixed_solver(hier, cfg, rel_tol=REL_TOL)
                t0 = time.perf_counter()
                compiled = run.lower(u0, f).compile()
                compile_s = time.perf_counter() - t0
            warm = []
            for _ in range(repeats):
                (u, _, it), s = _timed(compiled, u0, f)
                warm.append(s)
            sols[form] = u
            out[f"solve_{n}_{form}"] = {
                "n_cycles": int(it), "compile_s": compile_s, "warm_s": warm,
                "warm_median_s": statistics.median(warm),
            }
        _check(out[f"solve_{n}_matmul"]["n_cycles"]
               == out[f"solve_{n}_slices"]["n_cycles"],
               f"transfer forms take different cycle counts at {n}^3")
        rel = _rel_l2(sols["slices"], sols["matmul"])
        _check(rel <= SOLUTION_REL_TOL, f"transfer forms' solutions: {rel:.3e}")
        out[f"solve_{n}_rel_l2"] = rel
    out["half_sweep"] = _half_sweep_vs_copy(
        mg.Hierarchy(ndim=3, coarse_n=5, num_levels=max(levels)).finest_n)
    return out


def _host_loop(cycle, u, f, init: float, max_cycles: int = 100):
    """Run a cycle(u, f) -> (u, norm) to REL_TOL * init."""
    for it in range(1, max_cycles + 1):
        u, norm = cycle(u, f)
        if float(norm) <= REL_TOL * init:
            return u, it
    raise SmokeFailure(f"no convergence in {max_cycles} cycles")


def phase_four(levels: int = 8, n_dev: int = 4) -> dict:
    """The three sharded solves on n_dev devices, each against the
    single-device solve of the same problem on device 0."""
    from multigrid_parallel.ops import df as dfo
    from multigrid_parallel.parallel import sharded as sh
    from multigrid_parallel.parallel import sharded2d as s2
    from multigrid_parallel.parallel import sharded_mixed as smx

    out = {}
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=levels,
                        dtype=jnp.float64)
    cfg = mg.CycleConfig(n_smooth=2)
    prob = mg.poisson_3d_quadratic()
    ref = mg.solve(prob, hier, cfg, rel_tol=REL_TOL)
    _check(ref.converged, "single-device mg.solve did not converge")
    init = ref.initial_residual
    out["single"] = {"grid": hier.finest_n, "n_cycles": ref.n_cycles,
                     "error": ref.error_norm, "s_incl_compile": ref.wall_time_s}

    # 1D i-slabs, f64 cycle.
    mesh = sh.make_mesh(n_dev)
    cycle, plan = sh.make_sharded_cycle(hier, cfg, mesh)
    u, f = sh.setup_problem_sharded(prob, hier, mesh, plan)
    t0 = time.perf_counter()
    u, it = _host_loop(cycle, u, f, init)
    s = time.perf_counter() - t0
    rel = _rel_l2(_on_device0(sh.unpad(u, hier)), ref.u)
    _check(it == ref.n_cycles, f"1D: {it} cycles, single device {ref.n_cycles}")
    _check(rel <= SOLUTION_REL_TOL, f"1D vs single device: rel L2 {rel:.3e}")
    out["slabs_1d"] = {"n_dev": n_dev, "n_sharded_levels": plan.n_sharded,
                       "n_cycles": it, "rel_l2": rel, "s_incl_compile": s}

    # 2D (i, j) mesh, whole-solve double-float driver.
    nx = 2 if n_dev % 2 == 0 else 1
    mesh2 = s2.make_mesh_2d(nx, n_dev // nx)
    run2, plan2 = s2.make_sharded2d_df_solver(hier, cfg, mesh2, rel_tol=REL_TOL)
    st = s2.setup_df_problem_sharded2d(prob, hier, mesh2, plan2)
    (u_hi, u_lo, norm2, n_outer), s = _timed(run2, *st)
    u2 = _on_device0(dfo.df_to_f64(s2.unpad2d(u_hi, hier),
                                   s2.unpad2d(u_lo, hier)))
    rel2 = _rel_l2(u2, ref.u)
    err2 = _analytic_err(u2, prob, hier)
    _check(rel2 <= SOLUTION_REL_TOL, f"2D vs single device: rel L2 {rel2:.3e}")
    _check(err2 <= ANALYTIC_ERR_TOL, f"2D: error {err2:.3e}")
    out["mesh_2d"] = {"mesh": [nx, n_dev // nx], "n_outer": int(n_outer),
                      "rel_l2": rel2, "error": err2, "s_incl_compile": s}

    # Electrospray i-slabs, f64 cycle, against MixedBCSolver.solve.
    ms = _electrospray_solver(levels)
    u_host, norms, init_m = ms.solve(rel_tol=REL_TOL, max_cycles=100)
    cyc_m, plan_m = smx.make_sharded_mixed_bc_cycle(ms, mesh)
    um, fm = smx.setup_mixed_problem_sharded(ms, mesh, plan_m)
    t0 = time.perf_counter()
    um, it_m = _host_loop(cyc_m, um, fm, init_m)
    s = time.perf_counter() - t0
    diff = float(jnp.max(jnp.abs(_on_device0(sh.unpad(um, ms.hier)) - u_host)))
    _check(it_m == len(norms),
           f"electrospray: {it_m} cycles, single device {len(norms)}")
    _check(diff <= SHARDED_ELECTROSPRAY_ABS_TOL,
           f"electrospray vs single device: max |du| {diff:.3e}")
    out["electrospray_1d"] = {"n_cycles": it_m, "max_abs_diff_V": diff,
                              "tol_V": SHARDED_ELECTROSPRAY_ABS_TOL,
                              "s_incl_compile": s}
    out["rel_l2_tol"] = SOLUTION_REL_TOL
    return out


ONE_CARD_PHASES = (
    ("c_parity", phase_c_parity),
    ("perf_path", phase_perf_path),
    ("electrospray", phase_electrospray),
    ("transfer", phase_transfer),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded solves on four GPUs")
    args = p.parse_args(argv)
    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    dev = phase_device(4 if args.four else 1)
    phases = (("four", phase_four),) if args.four else ONE_CARD_PHASES
    for name, fn in phases:
        t0 = time.perf_counter()
        out = fn()
        out["phase_s"] = time.perf_counter() - t0
        out["peak_bytes_in_use"] = peak_bytes_in_use()
        print(f"phase {name}: {json.dumps(out)}", flush=True)
    print(result_line(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
