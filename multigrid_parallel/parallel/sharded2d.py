"""2D-mesh domain decomposition: shard_map over (i, j) device axes.

The 1D i-axis decomposition (sharded.py) runs out of planes as the mesh
grows (1025 planes / 64 devices = 16, and coarser levels vanish). This
module shards BOTH i and j over a 2D `Mesh(('x','y'))`:

  * halo exchange: one i-plane over 'x', one j-column over 'y', via
    `lax.ppermute` (the 7-point stencil needs no corner halos);
  * parity masks from global (i, j) offsets — both local extents are
    kept even, so shard origins preserve global red/black coloring;
  * coarsening halves both local extents (plane/column-aligned parents:
    local + 1 halo each, as in the 1D plan);
  * the k axis stays unsharded (the contiguous axis: transfer
    operators apply there as local matmuls);
  * below a local-extent threshold, all_gather over both axes and run
    the replicated single-device recursion (the `omp single` analogue).

Everything is validated against the single-device cycle on a virtual
(4, 2) CPU mesh (tests/test_sharded2d.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multigrid_parallel.cycles import CycleConfig, _descend
from multigrid_parallel.hierarchy import Hierarchy
from multigrid_parallel.ops import coarse as coarse_ops
from multigrid_parallel.ops import df as dfo
from multigrid_parallel.ops import stencils_3d as ops3


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ShardPlan2D:
    """Static 2D sharding description (see sharded.ShardPlan)."""

    nx: int
    ny: int
    axes: Tuple[str, str]
    n_sharded: int
    fine_local_i: int
    fine_local_j: int

    def local_i(self, depth: int) -> int:
        return self.fine_local_i >> depth

    def local_j(self, depth: int) -> int:
        return self.fine_local_j >> depth

    def padded_i(self, depth: int) -> int:
        return self.nx * self.local_i(depth)

    def padded_j(self, depth: int) -> int:
        return self.ny * self.local_j(depth)


def plan_sharding_2d(
    hier: Hierarchy, nx: int, ny: int, axes=("x", "y"), min_local: int = 4
) -> ShardPlan2D:
    n_sharded = 1
    while n_sharded < hier.num_levels - 1 and (
        min(
            hier.sizes[hier.num_levels - 1 - n_sharded] // nx,
            hier.sizes[hier.num_levels - 1 - n_sharded] // ny,
        )
        >= min_local
    ):
        n_sharded += 1
    align = 1 << n_sharded
    fi = _round_up(-(-hier.finest_n // nx), align)
    fj = _round_up(-(-hier.finest_n // ny), align)
    return ShardPlan2D(
        nx=nx, ny=ny, axes=tuple(axes), n_sharded=n_sharded,
        fine_local_i=fi, fine_local_j=fj,
    )


def make_mesh_2d(nx: int, ny: int, axes=("x", "y")) -> Mesh:
    """(nx, ny) mesh over the first nx*ny devices; raises if there are fewer."""
    devs = jax.devices()
    if len(devs) < nx * ny:
        raise ValueError(f"mesh needs {nx * ny} devices, found {len(devs)}")
    return Mesh(np.asarray(devs[: nx * ny]).reshape(nx, ny), tuple(axes))


# ---------------------------------------------------------------- helpers


def _perm_fwd(nd):
    return [(i, i + 1) for i in range(nd - 1)]


def _perm_bwd(nd):
    return [(i, i - 1) for i in range(1, nd)]


def _halo_i(x, axis: str, nd: int):
    lo = jax.lax.ppermute(x[-1:], axis, _perm_fwd(nd))
    hi = jax.lax.ppermute(x[:1], axis, _perm_bwd(nd))
    return jnp.concatenate([lo, x, hi], axis=0)


def _halo_j(x, axis: str, nd: int):
    lo = jax.lax.ppermute(x[:, -1:], axis, _perm_fwd(nd))
    hi = jax.lax.ppermute(x[:, :1], axis, _perm_bwd(nd))
    return jnp.concatenate([lo, x, hi], axis=1)


def _gij(plan: ShardPlan2D, depth: int):
    gi0 = jax.lax.axis_index(plan.axes[0]) * plan.local_i(depth)
    gj0 = jax.lax.axis_index(plan.axes[1]) * plan.local_j(depth)
    return gi0, gj0


def _masks2d(plan, depth, li, lj, n_valid, color):
    gi0, gj0 = _gij(plan, depth)
    ii = jax.lax.broadcasted_iota(jnp.int32, (li, 1, 1), 0) + gi0
    jj = jax.lax.broadcasted_iota(jnp.int32, (1, lj, 1), 1) + gj0
    kk = jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_valid), 2)
    interior = (
        (ii >= 1) & (ii <= n_valid - 2) & (jj >= 1) & (jj <= n_valid - 2)
        & (kk >= 1) & (kk <= n_valid - 2)
    )
    if color is None:
        return interior
    return interior & (((ii + jj + kk) % 2) == color)


def _nbr_sum2d(u, plan):
    ax_i, ax_j = plan.axes
    ei = _halo_i(u, ax_i, plan.nx)
    ej = _halo_j(u, ax_j, plan.ny)
    return (
        ei[:-2]
        + ei[2:]
        + ej[:, :-2]
        + ej[:, 2:]
        + jnp.roll(u, 1, 2)
        + jnp.roll(u, -1, 2)
    )


def rb_smooth_local2d(u, f, h, n_iter, n_valid, plan, depth, red_first=True):
    h2 = h * h
    colors = (ops3.RED, ops3.BLACK) if red_first else (ops3.BLACK, ops3.RED)
    li, lj = u.shape[0], u.shape[1]
    masks = {
        c: _masks2d(plan, depth, li, lj, n_valid, c) for c in set(colors)
    }
    for _ in range(n_iter):
        for c in colors:
            upd = (_nbr_sum2d(u, plan) - h2 * f) * (1.0 / 6.0)
            u = jnp.where(masks[c], upd, u)
    return u


def residual_local2d(u, f, h, n_valid, plan, depth):
    inv_h2 = 1.0 / (h * h)
    r = f - inv_h2 * (_nbr_sum2d(u, plan) - 6.0 * u)
    mask = _masks2d(plan, depth, u.shape[0], u.shape[1], n_valid, None)
    return jnp.where(mask, r, jnp.zeros_like(r))


@functools.lru_cache(maxsize=None)
def _restrict_band_local_np(L: int):
    """(L/2, L+2) 3-tap local restriction band onto a 1-halo-extended
    axis: coarse local row c <- 0.25/0.5/0.25 of ext rows 2c, 2c+1,
    2c+2 (shard offsets stay even across coarsenings, so parents are
    always ext-local)."""
    lc = L // 2
    m = np.zeros((lc, L + 2))
    for c in range(lc):
        m[c, 2 * c : 2 * c + 3] = (0.25, 0.5, 0.25)
    return m


@functools.lru_cache(maxsize=None)
def _prolong_band_local_np(L: int):
    """(L, L/2+1) local interpolation band onto a right-halo-extended
    coarse axis: even local rows copy coarse row g/2, odd rows average."""
    lc = L // 2
    m = np.zeros((L, lc + 1))
    for g in range(L):
        if g % 2 == 0:
            m[g, g // 2] = 1.0
        else:
            m[g, g // 2] = 0.5
            m[g, g // 2 + 1] = 0.5
    return m


def restrict_local2d(r, n_valid_f, plan, depth):
    """(Li, Lj, nf) -> (Li/2, Lj/2, nc): all three axes as band matmuls
    (k full-width, i and j local bands over 1-halo exchanges), with no
    stride-2 slicing."""
    nc = (n_valid_f + 1) // 2
    sk = jnp.asarray(ops3._restrict_matrix_np(n_valid_f), dtype=r.dtype)
    t = jnp.einsum("ck,ijk->ijc", sk, r, precision=ops3._HIGHEST)
    # j axis: local band matmul over a 1-column halo
    ej = _halo_j(t, plan.axes[1], plan.ny)
    bj = jnp.asarray(_restrict_band_local_np(t.shape[1]), dtype=r.dtype)
    t = jnp.einsum("cj,ijk->ick", bj, ej, precision=ops3._HIGHEST)
    # i axis: local band matmul over a 1-plane halo
    ei = _halo_i(t, plan.axes[0], plan.nx)
    bi = jnp.asarray(_restrict_band_local_np(r.shape[0]), dtype=r.dtype)
    t = jnp.einsum("ci,ijk->cjk", bi, ei, precision=ops3._HIGHEST)
    mask = _masks2d(plan, depth + 1, t.shape[0], t.shape[1], nc, None)
    return jnp.where(mask, t, jnp.zeros_like(t))


def prolong_correct_local2d(ec, ef, n_valid_c, plan, depth):
    """Coarse (Li/2, Lj/2, nc) correction added into fine (Li, Lj, nf):
    k full-width matmul, i and j local interpolation-band matmuls over
    right halos (no stack/reshape interleave, which relayouts)."""
    nf = 2 * n_valid_c - 1
    pkm = jnp.asarray(ops3._prolong_matrix_np(n_valid_c), dtype=ec.dtype)
    t = jnp.einsum("kc,ijc->ijk", pkm, ec, precision=ops3._HIGHEST)
    # j axis: right halo + interpolation band
    ej = jnp.concatenate(
        [t, jax.lax.ppermute(t[:, :1], plan.axes[1], _perm_bwd(plan.ny))], axis=1
    )
    bj = jnp.asarray(_prolong_band_local_np(2 * t.shape[1]), dtype=ec.dtype)
    t = jnp.einsum("fj,ijk->ifk", bj, ej, precision=ops3._HIGHEST)
    # i axis
    ei = jnp.concatenate(
        [t, jax.lax.ppermute(t[:1], plan.axes[0], _perm_bwd(plan.nx))], axis=0
    )
    bi = jnp.asarray(_prolong_band_local_np(2 * t.shape[0]), dtype=ec.dtype)
    fine = jnp.einsum("fi,ijk->fjk", bi, ei, precision=ops3._HIGHEST)
    # zero contributions beyond the valid global extent (pad regions)
    gi0, gj0 = _gij(plan, depth)
    ii = jax.lax.broadcasted_iota(jnp.int32, (fine.shape[0], 1, 1), 0) + gi0
    jj = jax.lax.broadcasted_iota(jnp.int32, (1, fine.shape[1], 1), 1) + gj0
    valid = (ii <= nf - 1) & (jj <= nf - 1)
    fine = jnp.where(valid, fine, jnp.zeros_like(fine))
    return ef + fine


def _correction2d(f_local, hier, cfg, plan, coarse_solve, level, depth,
                  e_init=None):
    n_valid = hier.sizes[level]
    h = hier.spacing(level)
    ax_i, ax_j = plan.axes

    if depth == plan.n_sharded:
        f_rep = jax.lax.all_gather(f_local, ax_i, axis=0, tiled=True)
        f_rep = jax.lax.all_gather(f_rep, ax_j, axis=1, tiled=True)
        f_rep = f_rep[:n_valid, :n_valid]
        if e_init is None:
            e0 = jnp.zeros_like(f_rep)
        else:
            e0 = jax.lax.all_gather(e_init, ax_i, axis=0, tiled=True)
            e0 = jax.lax.all_gather(e0, ax_j, axis=1, tiled=True)
            e0 = e0[:n_valid, :n_valid]
        sub = dataclasses.replace(hier, num_levels=level + 1)
        e_rep = _descend(
            ops3, sub, cfg, coarse_solve, e0, f_rep, level, correction=True,
        )
        li, lj = plan.local_i(depth), plan.local_j(depth)
        pad_i = plan.padded_i(depth) - n_valid
        pad_j = plan.padded_j(depth) - n_valid
        e_pad = jnp.pad(e_rep, ((0, pad_i), (0, pad_j), (0, 0)))
        gi0, gj0 = _gij(plan, depth)
        zero = jnp.zeros((), dtype=gi0.dtype)
        return jax.lax.dynamic_slice(e_pad, (gi0, gj0, zero), (li, lj, n_valid))

    u = jnp.zeros_like(f_local) if e_init is None else e_init
    u = rb_smooth_local2d(u, f_local, h, cfg.n_smooth, n_valid, plan, depth, True)
    r = residual_local2d(u, f_local, h, n_valid, plan, depth)
    fc = restrict_local2d(r, n_valid, plan, depth)
    ec = _recurse2d(fc, hier, cfg, plan, coarse_solve, level - 1, depth + 1)
    u = prolong_correct_local2d(ec, u, hier.sizes[level - 1], plan, depth)
    u = rb_smooth_local2d(u, f_local, h, cfg.n_smooth, n_valid, plan, depth, False)
    return u


def _recurse2d(fc, hier, cfg, plan, coarse_solve, level, depth):
    """gamma visits of the coarse correction (W-cycle when gamma > 1)."""
    ec = _correction2d(fc, hier, cfg, plan, coarse_solve, level, depth)
    if level > 0 and hier.sizes[level] >= cfg.gamma_min_n:
        for _ in range(cfg.gamma - 1):
            ec = _correction2d(
                fc, hier, cfg, plan, coarse_solve, level, depth, e_init=ec
            )
    return ec


def make_sharded2d_cycle(
    hier: Hierarchy,
    cfg: CycleConfig,
    mesh: Mesh,
    plan: Optional[ShardPlan2D] = None,
) -> Tuple[Callable, ShardPlan2D]:
    """cycle(u, f) -> (u', norm) with u, f sharded over (i, j)."""
    ax_i, ax_j = mesh.axis_names
    if plan is None:
        plan = plan_sharding_2d(
            hier, mesh.devices.shape[0], mesh.devices.shape[1], (ax_i, ax_j)
        )
    coarse_solve = coarse_ops.make_coarse_solver(
        hier.coarse_n, hier.spacing(0), hier.ndim, hier.dtype, cfg.coarse_method
    )
    level = hier.num_levels - 1
    n_valid = hier.sizes[level]
    h = hier.spacing(level)

    def local_fn(u, f):
        u = rb_smooth_local2d(u, f, h, cfg.n_smooth, n_valid, plan, 0, True)
        r = residual_local2d(u, f, h, n_valid, plan, 0)
        fc = restrict_local2d(r, n_valid, plan, 0)
        ec = _recurse2d(fc, hier, cfg, plan, coarse_solve, level - 1, 1)
        u = prolong_correct_local2d(ec, u, hier.sizes[level - 1], plan, 0)
        u = rb_smooth_local2d(u, f, h, cfg.n_smooth, n_valid, plan, 0, False)
        r = residual_local2d(u, f, h, n_valid, plan, 0)
        # one reduction over both mesh axes, not two sequential psums
        norm_sq = jax.lax.psum(jnp.sum(r * r), (ax_i, ax_j))
        return u, jnp.sqrt(norm_sq)

    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(ax_i, ax_j), P(ax_i, ax_j)),
        out_specs=(P(ax_i, ax_j), P()),
        check_vma=False,
    )
    return jax.jit(mapped), plan


def _build_df_locals(hier, cfg, plan):
    """Shared pieces of the 2D double-float drivers: returns
    (residual_df_local, inner_vcycle) operating on local blocks."""
    f32 = jnp.float32
    hier32 = dataclasses.replace(hier, dtype=f32)
    coarse32 = coarse_ops.make_coarse_solver(
        hier.coarse_n, hier.spacing(0), hier.ndim, f32, cfg.coarse_method
    )
    level = hier.num_levels - 1
    n_valid = hier.sizes[level]
    h = hier.spacing(level)
    inv_h2 = 1.0 / (h * h)

    def residual_df_local(u_hi, u_lo, f_hi, f_lo):
        def halo_nbrs(u):
            ei = _halo_i(u, plan.axes[0], plan.nx)
            ej = _halo_j(u, plan.axes[1], plan.ny)
            return [
                ei[:-2], ei[2:],
                ej[:, :-2], ej[:, 2:],
                jnp.roll(u, 1, 2), jnp.roll(u, -1, 2),
            ]

        r = dfo._eft_residual(
            f_hi, f_lo, u_hi, halo_nbrs(u_hi), u_lo, halo_nbrs(u_lo), inv_h2
        )
        mask = _masks2d(plan, 0, u_hi.shape[0], u_hi.shape[1], n_valid, None)
        return jnp.where(mask, r, jnp.zeros_like(r))

    def inner_vcycle(e, r32):
        e = rb_smooth_local2d(e, r32, h, cfg.n_smooth, n_valid, plan, 0, True)
        rr = residual_local2d(e, r32, h, n_valid, plan, 0)
        fc = restrict_local2d(rr, n_valid, plan, 0)
        ec = _recurse2d(fc, hier32, cfg, plan, coarse32, level - 1, 1)
        e = prolong_correct_local2d(ec, e, hier.sizes[level - 1], plan, 0)
        return rb_smooth_local2d(e, r32, h, cfg.n_smooth, n_valid, plan, 0,
                                 False)

    return residual_df_local, inner_vcycle


def make_sharded2d_df_cycle(
    hier: Hierarchy,
    cfg: CycleConfig,
    mesh: Mesh,
    plan: Optional[ShardPlan2D] = None,
    inner_cycles: int = 1,
) -> Tuple[Callable, ShardPlan2D]:
    """All-f32 double-float cycle on the 2D mesh: the solution is a
    (hi, lo) f32 pair, the outer residual is the compensated EFT form
    (dfo._eft_residual — shared with the 1D-sharded path), and the
    inner correction V-cycle runs in plain f32.
    ``inner_cycles`` f32 V-cycles run on the same normalized defect
    before the double-float update (the 1D path's amortization knob).

    cycle(u_hi, u_lo, f_hi, f_lo) -> (u_hi', u_lo', norm).
    """
    ax_i, ax_j = mesh.axis_names
    if plan is None:
        plan = plan_sharding_2d(
            hier, mesh.devices.shape[0], mesh.devices.shape[1], (ax_i, ax_j)
        )
    residual_df_local, inner_vcycle = _build_df_locals(hier, cfg, plan)

    def local_fn(u_hi, u_lo, f_hi, f_lo):
        r = residual_df_local(u_hi, u_lo, f_hi, f_lo)
        nrm = jnp.sqrt(jax.lax.psum(jnp.sum(r * r), (ax_i, ax_j)))
        safe = jnp.maximum(nrm, jnp.asarray(1e-30, dtype=nrm.dtype))
        r32 = r / safe
        e = jnp.zeros_like(r32)
        for _ in range(inner_cycles):  # static unroll
            e = inner_vcycle(e, r32)
        u_hi, u_lo = dfo.df_add(u_hi, u_lo, safe * e)
        r_after = residual_df_local(u_hi, u_lo, f_hi, f_lo)
        norm_sq = jax.lax.psum(jnp.sum(r_after * r_after), (ax_i, ax_j))
        return u_hi, u_lo, jnp.sqrt(norm_sq)

    spec = P(*plan.axes)
    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec, spec, P()),
        check_vma=False,
    )
    return jax.jit(mapped), plan


def make_sharded2d_df_solver(
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    mesh: Optional[Mesh] = None,
    plan: Optional[ShardPlan2D] = None,
    rel_tol: float = 1e-8,
    max_cycles: int = 40,
    inner_cycles: int = 4,
) -> Tuple[Callable, ShardPlan2D]:
    """run(u_hi, u_lo, f_hi, f_lo) -> (u_hi, u_lo, norm, n_outer): the
    whole solve-to-tolerance as ONE jitted lax.while_loop under
    shard_map on the (i, j) 2D mesh (driver shape: test_mg_3d.c:37-67).
    Double-float solution, EFT outer residual with a single two-axis
    psum, ``inner_cycles`` f32 V-cycles per outer defect step."""
    if mesh is None:
        raise ValueError("mesh is required")
    ax_i, ax_j = mesh.axis_names
    if plan is None:
        plan = plan_sharding_2d(
            hier, mesh.devices.shape[0], mesh.devices.shape[1], (ax_i, ax_j)
        )
    residual_df_local, inner_vcycle = _build_df_locals(hier, cfg, plan)
    f32 = jnp.float32

    def local_fn(u_hi, u_lo, f_hi, f_lo):
        init = jnp.sqrt(jax.lax.psum(jnp.sum(f_hi * f_hi), (ax_i, ax_j)))
        tol = jnp.asarray(rel_tol, f32) * init

        def residual_norm(u_hi, u_lo, f_hi, f_lo):
            r = residual_df_local(u_hi, u_lo, f_hi, f_lo)
            return r, jnp.sqrt(jax.lax.psum(jnp.sum(r * r), (ax_i, ax_j)))

        def body(state):
            u_hi, u_lo, r, nrm, it, f_hi, f_lo = state
            # no normalize/scale-back: the V-cycle is linear in r and f32
            # relative precision is scale-invariant
            e = jnp.zeros_like(r)
            for _ in range(inner_cycles):  # static unroll
                e = inner_vcycle(e, r)
            u_hi, u_lo = dfo.df_add(u_hi, u_lo, e)
            r, nrm = residual_norm(u_hi, u_lo, f_hi, f_lo)
            return u_hi, u_lo, r, nrm, it + 1, f_hi, f_lo

        def cond(state):
            nrm, it = state[3], state[4]
            return jnp.logical_and(nrm > tol, it < max_cycles)

        r0, n0 = residual_norm(u_hi, u_lo, f_hi, f_lo)
        out = jax.lax.while_loop(
            cond, body, (u_hi, u_lo, r0, n0, jnp.asarray(0), f_hi, f_lo)
        )
        return out[0], out[1], out[3], out[4]

    spec = P(*plan.axes)
    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec,) * 4,
        out_specs=(spec, spec, P(), P()),
        check_vma=False,
    )
    return jax.jit(mapped), plan


def setup_df_problem_sharded2d(problem, hier: Hierarchy, mesh: Mesh, plan: ShardPlan2D):
    """Double-float (hi, lo) 2D-sharded setup: (u_hi, u_lo, f_hi, f_lo)."""
    from multigrid_parallel.cycles import setup_problem
    u64, f64 = setup_problem(problem, hier)
    pad_i = plan.padded_i(0) - hier.finest_n
    pad_j = plan.padded_j(0) - hier.finest_n
    pad = ((0, pad_i), (0, pad_j), (0, 0))
    sh = NamedSharding(mesh, P(*plan.axes))

    def prep(x64):
        hi, lo = dfo.df_split(x64)
        return (
            jax.device_put(jnp.pad(hi, pad), sh),
            jax.device_put(jnp.pad(lo, pad), sh),
        )

    u_hi, u_lo = prep(u64)
    f_hi, f_lo = prep(f64)
    return u_hi, u_lo, f_hi, f_lo


def setup_problem_sharded2d(problem, hier: Hierarchy, mesh: Mesh, plan: ShardPlan2D):
    from multigrid_parallel.cycles import setup_problem

    u0, f = setup_problem(problem, hier)
    pad_i = plan.padded_i(0) - hier.finest_n
    pad_j = plan.padded_j(0) - hier.finest_n
    pad = ((0, pad_i), (0, pad_j), (0, 0))
    sh = NamedSharding(mesh, P(*plan.axes))
    return (
        jax.device_put(jnp.pad(u0, pad), sh),
        jax.device_put(jnp.pad(f, pad), sh),
    )


def unpad2d(u, hier: Hierarchy):
    return u[: hier.finest_n, : hier.finest_n]
