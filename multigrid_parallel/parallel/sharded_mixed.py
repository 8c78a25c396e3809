"""Sharded mixed-BC (electrospray) multigrid: shard_map over a 1D mesh.

The distributed tier of the mg_3d_bkup.c capability: the i axis is
sharded exactly as in parallel/sharded.py (ppermute halos, psum norm,
gather-to-replicated coarse tail), and the mixed-BC enforcement is
FULLY LOCAL under an i-slab decomposition:

  * y/z face Neumann copies are whole-face column/lane copies within
    each local block;
  * x face copies touch planes (0, 1) and (n-2, n-1), which live on one
    device each (L >= 2), selected by global plane index;
  * the Dirichlet patches sit on the x faces only, pinned by the same
    global-index select;
  * the coarsest level solves the dense mixed-BC matrix (Neumann rows),
    replicated — the same host-factored LU as MixedBCSolver.

Every stage mirrors MixedBCSolver's cycle (post-half-sweep BC
enforcement, zero-pinned correction masks per level), so the sharded
cycle reproduces the single-device cycle to roundoff (tested on the
8-virtual-device CPU mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multigrid_parallel.hierarchy import Hierarchy
from multigrid_parallel.mixed_bc import MixedBCSolver
from multigrid_parallel.ops import stencils_3d as ops3
from multigrid_parallel.parallel.sharded import (
    ShardPlan,
    _global_row,
    _perm_bwd,
    _perm_fwd,
    half_sweep_local,
    norm_sq_local,
    plan_sharding,
    prolong_correct_local,
    residual_local,
    restrict_local,
)


def apply_bcs_local(u, n: int, axis: str, n_dev: int, pin0, pin1,
                    vals0=None, vals1=None):
    """Mixed-BC enforcement on a local (L, n, n) block: whole-face
    Neumann copies in x, y, z order + Dirichlet patch pin. pin0/pin1:
    (n, n) f32 masks for the x=0 / x=end patches; vals*: patch values
    (None = zero pin, correction fields)."""
    L = u.shape[0]
    g = _global_row(axis, L)
    # x faces: the copy source can live on the NEIGHBOR device (global
    # plane n-1 at local row 0 when L divides n-1 — a purely-local shift
    # would read a pad plane there), so build the shifted views with a
    # one-plane ppermute instead of a wrap.
    dn = jnp.concatenate(
        [jax.lax.ppermute(u[-1:], axis, _perm_fwd(n_dev)), u[:-1]], axis=0
    )
    up = jnp.concatenate(
        [u[1:], jax.lax.ppermute(u[:1], axis, _perm_bwd(n_dev))], axis=0
    )
    u = jnp.where(g == 0, up, u)
    u = jnp.where(g == n - 1, dn, u)
    # y faces
    u = u.at[:, 0].set(u[:, 1])
    u = u.at[:, n - 1].set(u[:, n - 2])
    # z faces (priority at edges: applied last)
    u = u.at[:, :, 0].set(u[:, :, 1])
    u = u.at[:, :, n - 1].set(u[:, :, n - 2])
    v0 = jnp.zeros_like(u[0]) if vals0 is None else vals0
    v1 = jnp.zeros_like(u[0]) if vals1 is None else vals1
    u = jnp.where(jnp.logical_and(g == 0, pin0[None] > 0.5), v0[None], u)
    return jnp.where(jnp.logical_and(g == n - 1, pin1[None] > 0.5),
                     v1[None], u)


def _band_mask_local(axis: str, L: int, n: int, w: int):
    """Within-w-of-any-face mask for a local (L, n, n) block, GLOBAL i."""
    g = _global_row(axis, L)
    jj = jax.lax.broadcasted_iota(jnp.int32, (1, n, 1), 1)
    kk = jax.lax.broadcasted_iota(jnp.int32, (1, 1, n), 2)
    return (
        (g <= w) | (g >= n - 1 - w)
        | (jj <= w) | (jj >= n - 1 - w)
        | (kk <= w) | (kk >= n - 1 - w)
    )


def _band_half_sweep_local(u, f, h, color, n, axis, n_dev, w):
    from multigrid_parallel.parallel.sharded import (
        _halo_extend,
        _masks,
        _neighbor_sum_local,
    )

    ext = _halo_extend(u, axis, n_dev)
    upd = (_neighbor_sum_local(ext, u) - (h * h) * f) * (1.0 / 6.0)
    mask = _masks(axis, u.shape[0], n, color)
    near = _band_mask_local(axis, u.shape[0], n, w)
    return jnp.where(jnp.logical_and(mask, near), upd, u)


def _mixed_smooth_local(u, f, h, n_iter, n, axis, n_dev, pin0, pin1,
                        red_first=True, vals0=None, vals1=None,
                        band_width=0, band_iters=0):
    colors = (ops3.RED, ops3.BLACK) if red_first else (ops3.BLACK, ops3.RED)
    for _ in range(n_iter):
        for c in colors:
            u = half_sweep_local(u, f, h, c, n, axis, n_dev)
            u = apply_bcs_local(u, n, axis, n_dev, pin0, pin1, vals0, vals1)
    # extra boundary-band relaxation (MixedBCSolver._smooth semantics)
    for _ in range(band_iters):
        for c in colors:
            u = _band_half_sweep_local(u, f, h, c, n, axis, n_dev, band_width)
            u = apply_bcs_local(u, n, axis, n_dev, pin0, pin1, vals0, vals1)
    return u


def make_sharded_mixed_bc_cycle(
    solver: MixedBCSolver,
    mesh: Mesh,
    plan: Optional[ShardPlan] = None,
) -> Tuple[Callable, ShardPlan]:
    """jitted cycle(u_global_padded, f_global_padded) -> (u', norm):
    one mixed-BC V-cycle (W-cycle via solver.gamma) sharded along i.
    Matches MixedBCSolver._cycle on a single device to roundoff
    (including solver.gamma and solver.boundary_band_* settings)."""
    hier = solver.hier
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    if plan is None:
        plan = plan_sharding(hier, n_dev, axis)
    problem = solver.problem
    gamma = solver.gamma
    gamma_min_n = solver.gamma_min_n
    n_smooth = solver.n_smooth
    bw, bits = solver.boundary_band_width, solver.boundary_band_iters
    dtype = hier.dtype

    pins = []
    for lvl in range(hier.num_levels):
        nl = hier.sizes[lvl]
        mask, vals = problem.boundary_masks(nl)
        pins.append((
            jnp.asarray(mask[0], jnp.float32),
            jnp.asarray(mask[nl - 1], jnp.float32),
            jnp.asarray(vals[0], dtype),
            jnp.asarray(vals[nl - 1], dtype),
        ))

    lu_d = jnp.asarray(solver._lu_host, dtype=dtype)
    piv_d = jnp.asarray(solver._piv_host, dtype=jnp.int32)
    n0 = hier.sizes[0]
    p0, p1, _, _ = pins[0]

    def coarse_corr(fc):
        x = jax.scipy.linalg.lu_solve((lu_d, piv_d), fc.reshape(-1))
        x = x.reshape(fc.shape)
        x = x.at[0].set(jnp.where(p0 > 0.5, 0.0, x[0]))
        return x.at[n0 - 1].set(jnp.where(p1 > 0.5, 0.0, x[n0 - 1]))

    def correction(f_local, level, depth, e_init=None):
        nl = hier.sizes[level]
        h = hier.spacing(level)
        pin0, pin1, _, _ = pins[level]

        if depth == plan.n_sharded:
            f_rep = jax.lax.all_gather(f_local, axis, axis=0, tiled=True)
            f_rep = f_rep[:nl]
            if e_init is None:
                e0 = jnp.zeros_like(f_rep)
            else:
                e0 = jax.lax.all_gather(e_init, axis, axis=0, tiled=True)[:nl]
            e_rep = _descend_rep(e0, f_rep, level)
            L = plan.local_planes(depth)
            pad = plan.padded_planes(depth) - nl
            e_pad = jnp.pad(e_rep, ((0, pad), (0, 0), (0, 0)))
            g0 = jax.lax.axis_index(axis) * L
            zero = jnp.zeros((), dtype=g0.dtype)
            return jax.lax.dynamic_slice(e_pad, (g0, zero, zero),
                                         (L, nl, nl))

        u = jnp.zeros_like(f_local) if e_init is None else e_init
        u = _mixed_smooth_local(u, f_local, h, n_smooth, nl, axis, n_dev,
                                pin0, pin1, True, band_width=bw,
                                band_iters=bits)
        r = residual_local(u, f_local, h, nl, axis, n_dev)
        fc = restrict_local(r, nl, axis, n_dev)
        ec = correction(fc, level - 1, depth + 1)
        if level - 1 > 0 and hier.sizes[level - 1] >= gamma_min_n:
            for _ in range(gamma - 1):  # W-cycle revisits (depth-capped)
                ec = correction(fc, level - 1, depth + 1, e_init=ec)
        u = prolong_correct_local(ec, u, hier.sizes[level - 1], axis, n_dev)
        u = apply_bcs_local(u, nl, axis, n_dev, pin0, pin1)
        u = _mixed_smooth_local(u, f_local, h, n_smooth, nl, axis, n_dev,
                                pin0, pin1, False, band_width=bw,
                                band_iters=bits)
        return u

    def _descend_rep(e, f, level):
        """Replicated single-device mixed recursion (MixedBCSolver
        semantics) below the sharded depths."""
        nl = hier.sizes[level]
        pin0, pin1, _, _ = pins[level]
        if level == 0:
            return coarse_corr(f)
        h = hier.spacing(level)

        def smooth(u, red_first):
            red, black, _ = ops3._masks_np(nl)
            first, second = (red, black) if red_first else (black, red)

            def bc(u):
                u = ops3.apply_neumann_copy(u)
                u = u.at[0].set(jnp.where(pin0 > 0.5, 0.0, u[0]))
                return u.at[nl - 1].set(jnp.where(pin1 > 0.5, 0.0,
                                                  u[nl - 1]))

            for _ in range(n_smooth):
                for cm in (first, second):
                    u = ops3._half_sweep(u, f, h, jnp.asarray(cm))
                    u = bc(u)
            if bits > 0:
                near = MixedBCSolver._band_mask_np(nl, bw)
                for _ in range(bits):
                    for cm in (first, second):
                        u = ops3._half_sweep(u, f, h, jnp.asarray(cm & near))
                        u = bc(u)
            return u

        e = smooth(e, True)
        r = ops3.residual(e, f, h)
        fc = ops3.restrict_full_weighting(r)
        ec = _descend_rep(jnp.zeros((hier.sizes[level - 1],) * 3, e.dtype),
                          fc, level - 1)
        if level - 1 > 0 and hier.sizes[level - 1] >= gamma_min_n:
            for _ in range(gamma - 1):  # W-cycle revisits (depth-capped)
                ec = _descend_rep(ec, fc, level - 1)
        e = ops3.prolong_correct(ec, e)
        e = ops3.apply_neumann_copy(e)
        e = e.at[0].set(jnp.where(pin0 > 0.5, 0.0, e[0]))
        e = e.at[nl - 1].set(jnp.where(pin1 > 0.5, 0.0, e[nl - 1]))
        return smooth(e, False)

    level = hier.num_levels - 1
    n = hier.sizes[level]
    h = hier.spacing(level)
    pin0, pin1, vals0, vals1 = pins[level]

    def local_fn(u, f):
        u = _mixed_smooth_local(u, f, h, n_smooth, n, axis, n_dev,
                                pin0, pin1, True, vals0, vals1,
                                band_width=bw, band_iters=bits)
        r = residual_local(u, f, h, n, axis, n_dev)
        fc = restrict_local(r, n, axis, n_dev)
        ec = correction(fc, level - 1, 1)
        if level - 1 > 0 and hier.sizes[level - 1] >= gamma_min_n:
            for _ in range(gamma - 1):  # W-cycle revisits (depth-capped)
                ec = correction(fc, level - 1, 1, e_init=ec)
        u = prolong_correct_local(ec, u, hier.sizes[level - 1], axis, n_dev)
        u = apply_bcs_local(u, n, axis, n_dev, pin0, pin1, vals0, vals1)
        u = _mixed_smooth_local(u, f, h, n_smooth, n, axis, n_dev,
                                pin0, pin1, False, vals0, vals1,
                                band_width=bw, band_iters=bits)
        r = residual_local(u, f, h, n, axis, n_dev)
        return u, jnp.sqrt(norm_sq_local(r, axis))

    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    return jax.jit(mapped), plan


def setup_mixed_problem_sharded(solver: MixedBCSolver, mesh: Mesh,
                                plan: ShardPlan):
    """(u0, f) padded to the plan and placed over the mesh."""
    u0, f = solver.initial_state()
    pad = plan.padded_planes(0) - solver.hier.finest_n
    u0 = jnp.pad(u0, ((0, pad), (0, 0), (0, 0)))
    f = jnp.pad(f, ((0, pad), (0, 0), (0, 0)))
    sh = NamedSharding(mesh, P(plan.axis))
    return jax.device_put(u0, sh), jax.device_put(f, sh)
