"""Sharded multigrid: shard_map over a 1D device mesh with halo exchange.

The replacement for the reference's OpenMP i-slab decomposition
(SURVEY.md §2.8): every stencil kernel there is worksharing over the outer
i loop (`#pragma omp for` at mg_3d.h:658, 681, 807, ...), with halos
implicit in shared memory. Here the i axis is sharded over a
`jax.sharding.Mesh`, halos are one-plane `lax.ppermute` exchanges between
devices, the norm reduction is a `lax.psum` (replacing the barrier+single
combine of test_mg_3d.c:47-59), and the shrinking coarse levels gather to
replicated compute — the analogue of the reference's serial-under-
`omp single` coarsest solve (mg_3d.h:1262-1277).

Layout contract:
  * A level with N valid planes is stored padded to ``n_dev * L`` planes
    (pad planes are kept at zero and masked out of every update).
  * ``L`` (local planes per device at the finest level) is a multiple of
    ``2**s`` where s = number of sharded coarsenings, so every sharded
    coarsening exactly halves the local plane count and shard boundaries
    stay aligned to even global indices (parents of a coarse plane are
    always local + 1-plane halo).
  * j and k stay unsharded: transfer operators apply there as on-device
    separable matmuls, and along i as plane arithmetic over the halo.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multigrid_parallel.hierarchy import Hierarchy
from multigrid_parallel.ops import coarse as coarse_ops
from multigrid_parallel.ops import df as dfo
from multigrid_parallel.ops import stencils_3d as ops3
from multigrid_parallel.cycles import CycleConfig, _descend


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static description of the i-axis sharding across the hierarchy.

    Depths 0..n_sharded-1 (finest first) run with sharded kernels; the
    restriction out of depth n_sharded-1 lands on depth n_sharded, which
    is gathered to replicated (and everything coarser stays replicated).
    ``fine_local`` is a multiple of 2**n_sharded so every sharded
    coarsening halves the local plane count exactly.
    """

    n_dev: int
    axis: str
    n_sharded: int  # how many of the finest levels run with sharded kernels
    fine_local: int  # L at the finest level (multiple of 2**n_sharded)

    def local_planes(self, depth: int) -> int:
        """L at `depth` sharded coarsenings below the finest level."""
        return self.fine_local >> depth

    def padded_planes(self, depth: int) -> int:
        return self.n_dev * self.local_planes(depth)


def plan_sharding(
    hier: Hierarchy, n_dev: int, axis: str = "x", min_local: int = 4
) -> ShardPlan:
    """Shard as many fine levels as keep >= min_local planes per device.

    The coarsest level is always replicated (it holds the dense direct
    solve — the analogue of the reference's `omp single` section)."""
    n_sharded = 1
    while (
        n_sharded < hier.num_levels - 1
        and (hier.sizes[hier.num_levels - 1 - n_sharded] // n_dev) >= min_local
    ):
        n_sharded += 1
    fine_local = _round_up(-(-hier.finest_n // n_dev), 1 << n_sharded)
    return ShardPlan(n_dev=n_dev, axis=axis, n_sharded=n_sharded, fine_local=fine_local)


def make_mesh(n_dev: int, axis: str = "x") -> Mesh:
    """1D mesh over the first ``n_dev`` devices; raises if there are fewer."""
    devs = jax.devices()
    if len(devs) < n_dev:
        raise ValueError(f"mesh needs {n_dev} devices, found {len(devs)}")
    return Mesh(np.asarray(devs[:n_dev]), (axis,))


# ---------------------------------------------------------------- local ops


def _perm_fwd(n_dev):  # send my last plane to the right neighbor
    return [(i, i + 1) for i in range(n_dev - 1)]


def _perm_bwd(n_dev):  # send my first plane to the left neighbor
    return [(i, i - 1) for i in range(1, n_dev)]


def _halo_extend(x, axis: str, n_dev: int):
    """(L, n, n) -> (L+2, n, n) with one neighbor plane on each side.

    Devices at the chain ends receive zeros — harmless, because the global
    boundary planes there are Dirichlet (never updated) or padding
    (masked).
    """
    from_left = jax.lax.ppermute(x[-1:], axis, _perm_fwd(n_dev))
    from_right = jax.lax.ppermute(x[:1], axis, _perm_bwd(n_dev))
    return jnp.concatenate([from_left, x, from_right], axis=0)


def _global_row(axis: str, local: int):
    """iota of global plane indices for this shard, shape (local, 1, 1)."""
    g0 = jax.lax.axis_index(axis) * local
    ii = jax.lax.broadcasted_iota(jnp.int32, (local, 1, 1), 0)
    return ii + g0


def _masks(axis: str, local: int, n_valid: int, color: Optional[int]):
    """Interior (and optional color) mask for a (local, n, n) block.

    Interior = global plane in [1, n_valid-2] x j,k in [1, n_valid-2];
    pad planes (g >= n_valid) excluded. Parity is on GLOBAL (i+j+k)
    (mg_3d.h:669/693) — shard offsets are even by construction but we use
    the global index anyway for safety.
    """
    g = _global_row(axis, local)
    jj = jax.lax.broadcasted_iota(jnp.int32, (1, n_valid, 1), 1)
    kk = jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_valid), 2)
    interior = (
        (g >= 1)
        & (g <= n_valid - 2)
        & (jj >= 1)
        & (jj <= n_valid - 2)
        & (kk >= 1)
        & (kk <= n_valid - 2)
    )
    if color is None:
        return interior
    parity = (g + jj + kk) % 2
    return interior & (parity == color)


def _valid_row_mask(axis: str, local: int, n_valid: int):
    g = _global_row(axis, local)
    return g <= n_valid - 1


def _neighbor_sum_local(ext, u):
    # i neighbors from the halo-extended block, j/k neighbors local.
    return (
        ext[:-2]
        + ext[2:]
        + jnp.roll(u, 1, 1)
        + jnp.roll(u, -1, 1)
        + jnp.roll(u, 1, 2)
        + jnp.roll(u, -1, 2)
    )


def half_sweep_local(u, f, h: float, color: int, n_valid: int, axis: str, n_dev: int):
    """One RB color sweep on the local block (smoothenAtIndex semantics,
    mg_3d.h:438-443), with ppermute halo exchange replacing shared memory."""
    ext = _halo_extend(u, axis, n_dev)
    upd = (_neighbor_sum_local(ext, u) - (h * h) * f) * (1.0 / 6.0)
    mask = _masks(axis, u.shape[0], n_valid, color)
    return jnp.where(mask, upd, u)


def rb_smooth_local(u, f, h, n_iter, n_valid, axis, n_dev, red_first=True):
    colors = (ops3.RED, ops3.BLACK) if red_first else (ops3.BLACK, ops3.RED)
    for _ in range(n_iter):
        for c in colors:
            u = half_sweep_local(u, f, h, c, n_valid, axis, n_dev)
    return u


def residual_local(u, f, h: float, n_valid: int, axis: str, n_dev: int):
    """Interior residual on the local block (mg_3d.h:794-842), zero
    elsewhere (including pad planes)."""
    ext = _halo_extend(u, axis, n_dev)
    r = f - (1.0 / (h * h)) * (_neighbor_sum_local(ext, u) - 6.0 * u)
    mask = _masks(axis, u.shape[0], n_valid, None)
    return jnp.where(mask, r, jnp.zeros_like(r))


def norm_sq_local(r, axis: str):
    return jax.lax.psum(jnp.sum(r * r), axis)


def restrict_local(r, n_valid_f: int, axis: str, n_dev: int):
    """(L, nf, nf) -> (L/2, nc, nc) full-weighting restriction.

    j/k: separable 3-tap matmul (ops.stencils_3d._restrict_matrix_np);
    i: plane combination over a 1-plane halo. Coarse boundary/pad entries
    zeroed — the restriction input is always a residual (zero boundary),
    so this matches the reference's injection faces (mg_3d.h:879-958).
    """
    nc = (n_valid_f + 1) // 2
    s = jnp.asarray(ops3._restrict_matrix_np(n_valid_f), dtype=r.dtype)
    t = jnp.einsum("bj,tjk->tbk", s, r, precision=ops3._HIGHEST)
    t = jnp.einsum("ck,tbk->tbc", s, t, precision=ops3._HIGHEST)
    ext = _halo_extend(t, axis, n_dev)  # (L+2, nc, nc)
    coarse = 0.25 * ext[0:-2:2] + 0.5 * ext[1:-1:2] + 0.25 * ext[2::2]
    lc = coarse.shape[0]
    mask = _masks(axis, lc, nc, None)
    return jnp.where(mask, coarse, jnp.zeros_like(coarse))


def prolong_correct_local(ec, ef, n_valid_c: int, axis: str, n_dev: int):
    """(Lc, nc, nc) coarse correction -> added into (L=2Lc, nf, nf) fine.

    j/k: separable interpolation matmul; i: even planes copy the
    coincident coarse plane, odd planes average (coarse right-halo via
    ppermute). Trilinear semantics of mg_3d.h:1000-1145.
    """
    nf = 2 * n_valid_c - 1
    p = jnp.asarray(ops3._prolong_matrix_np(n_valid_c), dtype=ec.dtype)
    t = jnp.einsum("jb,tbc->tjc", p, ec, precision=ops3._HIGHEST)
    t = jnp.einsum("kc,tjc->tjk", p, t, precision=ops3._HIGHEST)
    from_right = jax.lax.ppermute(t[:1], axis, _perm_bwd(n_dev))
    ext = jnp.concatenate([t, from_right], axis=0)  # (Lc+1, nf, nf)
    even = ext[:-1]
    odd = 0.5 * (ext[:-1] + ext[1:])
    fine = jnp.stack([even, odd], axis=1).reshape(-1, *t.shape[1:])
    # Zero contributions to pad planes so they stay exactly zero.
    mask = _valid_row_mask(axis, fine.shape[0], nf)
    fine = jnp.where(mask, fine, jnp.zeros_like(fine))
    return ef + fine


# ------------------------------------------------------------- the cycle


def _sharded_correction(
    f_local,
    hier: Hierarchy,
    cfg: CycleConfig,
    plan: ShardPlan,
    coarse_solve,
    level: int,
    depth: int,
    e_init=None,
):
    """Solve the correction equation at `level` (zero initial guess, or
    ``e_init`` on a gamma/W-cycle revisit) with the finest
    `plan.n_sharded` levels sharded; deeper levels replicated.

    Stage order matches vcycle (mg_3d.h:1242-1362).
    """
    axis, n_dev = plan.axis, plan.n_dev
    n_valid = hier.sizes[level]
    h = hier.spacing(level)

    if depth == plan.n_sharded:
        # Gather to replicated and run the single-device recursion — the
        # analogue of the reference's `omp single` coarse section.
        f_rep = jax.lax.all_gather(f_local, axis, axis=0, tiled=True)
        f_rep = f_rep[:n_valid]
        sub = dataclasses.replace(hier, num_levels=level + 1)
        if e_init is None:
            e0 = jnp.zeros_like(f_rep)
        else:
            e0 = jax.lax.all_gather(e_init, axis, axis=0, tiled=True)[:n_valid]
        e_rep = _descend(ops3, sub, cfg, coarse_solve, e0, f_rep, level, correction=True)
        # Back to sharded: each device takes its plane slice.
        local = plan.local_planes(depth)
        pad = plan.padded_planes(depth) - n_valid
        e_pad = jnp.pad(e_rep, ((0, pad), (0, 0), (0, 0)))
        g0 = jax.lax.axis_index(axis) * local
        zero = jnp.zeros((), dtype=g0.dtype)
        return jax.lax.dynamic_slice(
            e_pad, (g0, zero, zero), (local, n_valid, n_valid)
        )

    u = jnp.zeros_like(f_local) if e_init is None else e_init
    u = rb_smooth_local(u, f_local, h, cfg.n_smooth, n_valid, axis, n_dev, True)
    r = residual_local(u, f_local, h, n_valid, axis, n_dev)
    fc = restrict_local(r, n_valid, axis, n_dev)
    ec = _recurse_sharded(fc, hier, cfg, plan, coarse_solve, level - 1, depth + 1)
    u = prolong_correct_local(ec, u, hier.sizes[level - 1], axis, n_dev)
    u = rb_smooth_local(u, f_local, h, cfg.n_smooth, n_valid, axis, n_dev, False)
    return u


def _recurse_sharded(fc, hier, cfg, plan, coarse_solve, level, depth):
    """gamma visits of the coarse correction (W-cycle when gamma > 1);
    the coarsest level is always visited once (direct solve is exact)."""
    ec = _sharded_correction(fc, hier, cfg, plan, coarse_solve, level, depth)
    if level > 0 and hier.sizes[level] >= cfg.gamma_min_n:
        for _ in range(cfg.gamma - 1):
            ec = _sharded_correction(
                fc, hier, cfg, plan, coarse_solve, level, depth, e_init=ec
            )
    return ec


def sharded_v_cycle_local(
    u_local,
    f_local,
    hier: Hierarchy,
    cfg: CycleConfig,
    plan: ShardPlan,
    coarse_solve,
):
    """One V-cycle on the sharded finest level (u carries the BCs).

    Returns (u_local', residual 2-norm replicated scalar)."""
    axis, n_dev = plan.axis, plan.n_dev
    level = hier.num_levels - 1
    n_valid = hier.sizes[level]
    h = hier.spacing(level)

    u = rb_smooth_local(u_local, f_local, h, cfg.n_smooth, n_valid, axis, n_dev, True)
    r = residual_local(u, f_local, h, n_valid, axis, n_dev)
    fc = restrict_local(r, n_valid, axis, n_dev)
    ec = _recurse_sharded(fc, hier, cfg, plan, coarse_solve, level - 1, 1)
    u = prolong_correct_local(ec, u, hier.sizes[level - 1], axis, n_dev)
    u = rb_smooth_local(u, f_local, h, cfg.n_smooth, n_valid, axis, n_dev, False)
    r = residual_local(u, f_local, h, n_valid, axis, n_dev)
    norm = jnp.sqrt(norm_sq_local(r, axis))
    return u, norm


def make_sharded_cycle(
    hier: Hierarchy,
    cfg: CycleConfig,
    mesh: Mesh,
    plan: Optional[ShardPlan] = None,
) -> Tuple[Callable, ShardPlan]:
    """Build jitted cycle(u_global_padded, f_global_padded) -> (u', norm),
    shard_mapped over `mesh` along the i axis."""
    axis = mesh.axis_names[0]
    if plan is None:
        plan = plan_sharding(hier, mesh.devices.size, axis)
    coarse_solve = coarse_ops.make_coarse_solver(
        hier.coarse_n, hier.spacing(0), hier.ndim, hier.dtype, cfg.coarse_method
    )

    local_fn = functools.partial(
        sharded_v_cycle_local,
        hier=hier,
        cfg=cfg,
        plan=plan,
        coarse_solve=coarse_solve,
    )
    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    return jax.jit(mapped), plan


def make_sharded_mixed_cycle(
    hier: Hierarchy,
    cfg: CycleConfig,
    mesh: Mesh,
    plan: Optional[ShardPlan] = None,
) -> Tuple[Callable, ShardPlan]:
    """Mixed-precision sharded cycle: f64 state/residual, f32 V-cycle
    (see cycles.make_mixed_cycle), all inside one shard_map."""
    axis = mesh.axis_names[0]
    if plan is None:
        plan = plan_sharding(hier, mesh.devices.size, axis)
    f32 = jnp.float32
    hier32 = dataclasses.replace(hier, dtype=f32)
    coarse32 = coarse_ops.make_coarse_solver(
        hier.coarse_n, hier.spacing(0), hier.ndim, f32, cfg.coarse_method
    )
    level = hier.num_levels - 1
    n_valid = hier.sizes[level]
    h = hier.spacing(level)

    def local_fn(u, f):
        axisn, n_dev = plan.axis, plan.n_dev
        r = residual_local(u, f, h, n_valid, axisn, n_dev)
        nrm = jnp.sqrt(norm_sq_local(r, axisn))
        safe = jnp.maximum(nrm, jnp.asarray(1e-300, dtype=u.dtype))
        r32 = (r / safe).astype(f32)
        u32 = rb_smooth_local(
            jnp.zeros_like(r32), r32, h, cfg.n_smooth, n_valid, axisn, n_dev, True
        )
        rr = residual_local(u32, r32, h, n_valid, axisn, n_dev)
        fc = restrict_local(rr, n_valid, axisn, n_dev)
        ec = _recurse_sharded(fc, hier32, cfg, plan, coarse32, level - 1, 1)
        u32 = prolong_correct_local(ec, u32, hier.sizes[level - 1], axisn, n_dev)
        u32 = rb_smooth_local(u32, r32, h, cfg.n_smooth, n_valid, axisn, n_dev, False)
        u = u + safe * u32.astype(u.dtype)
        r_after = residual_local(u, f, h, n_valid, axisn, n_dev)
        norm = jnp.sqrt(norm_sq_local(r_after, axisn))
        return u, norm

    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    return jax.jit(mapped), plan


def make_sharded_df_cycle(
    hier: Hierarchy,
    cfg: CycleConfig,
    mesh: Mesh,
    plan: Optional[ShardPlan] = None,
    inner_cycles: int = 1,
) -> Tuple[Callable, ShardPlan]:
    """Sharded all-f32 double-float cycle: like make_sharded_mixed_cycle
    but with no f64 anywhere — the solution is a (hi, lo) f32 pair and
    the outer residual is the compensated EFT evaluation (ops.df), which
    shard_map partitions like any other stencil.

    ``inner_cycles`` runs several f32 correction V-cycles on the same
    normalized defect before the double-float update, amortizing the
    EFT residual + psum over more smoothing work.

    cycle((u_hi, u_lo), (f_hi, f_lo)) -> ((u_hi', u_lo'), norm).
    """
    axis = mesh.axis_names[0]
    if plan is None:
        plan = plan_sharding(hier, mesh.devices.size, axis)
    f32 = jnp.float32
    hier32 = dataclasses.replace(hier, dtype=f32)
    coarse32 = coarse_ops.make_coarse_solver(
        hier.coarse_n, hier.spacing(0), hier.ndim, f32, cfg.coarse_method
    )
    level = hier.num_levels - 1
    n_valid = hier.sizes[level]
    h = hier.spacing(level)
    inv_h2 = 1.0 / (h * h)

    def residual_df_local(u_hi, u_lo, f_hi, f_lo, axisn, n_dev):
        """Compensated local residual (halo-extended i neighbors); the
        EFT math is shared with the 2D mesh (dfo._eft_residual)."""

        def halo_nbrs(u):
            ext = _halo_extend(u, axisn, n_dev)
            return [
                ext[:-2], ext[2:],
                jnp.roll(u, 1, 1), jnp.roll(u, -1, 1),
                jnp.roll(u, 1, 2), jnp.roll(u, -1, 2),
            ]

        r = dfo._eft_residual(
            f_hi, f_lo, u_hi, halo_nbrs(u_hi), u_lo, halo_nbrs(u_lo), inv_h2
        )
        mask = _masks(axisn, u_hi.shape[0], n_valid, None)
        return jnp.where(mask, r, jnp.zeros_like(r))

    def inner_vcycle(e, r32, axisn, n_dev):
        e = rb_smooth_local(e, r32, h, cfg.n_smooth, n_valid, axisn, n_dev, True)
        rr = residual_local(e, r32, h, n_valid, axisn, n_dev)
        fc = restrict_local(rr, n_valid, axisn, n_dev)
        ec = _recurse_sharded(fc, hier32, cfg, plan, coarse32, level - 1, 1)
        e = prolong_correct_local(ec, e, hier.sizes[level - 1], axisn, n_dev)
        return rb_smooth_local(e, r32, h, cfg.n_smooth, n_valid, axisn, n_dev, False)

    def local_fn(u_hi, u_lo, f_hi, f_lo):
        axisn, n_dev = plan.axis, plan.n_dev
        r = residual_df_local(u_hi, u_lo, f_hi, f_lo, axisn, n_dev)
        nrm = jnp.sqrt(norm_sq_local(r, axisn))
        safe = jnp.maximum(nrm, jnp.asarray(1e-30, dtype=nrm.dtype))
        r32 = r / safe
        e = jnp.zeros_like(r32)
        for _ in range(inner_cycles):  # static unroll
            e = inner_vcycle(e, r32, axisn, n_dev)
        u_hi, u_lo = dfo.df_add(u_hi, u_lo, safe * e)
        r_after = residual_df_local(u_hi, u_lo, f_hi, f_lo, axisn, n_dev)
        norm = jnp.sqrt(norm_sq_local(r_after, axisn))
        return u_hi, u_lo, norm

    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P()),
        check_vma=False,
    )
    return jax.jit(mapped), plan


# ------------------------------------------------------------------ setup


def setup_problem_sharded(problem, hier: Hierarchy, mesh: Mesh, plan: ShardPlan):
    """Build (u0, f) padded to plan.padded_planes(0) and placed with a
    NamedSharding over the mesh (reference setup semantics — see
    cycles.setup_problem)."""
    from multigrid_parallel.cycles import setup_problem

    u0, f = setup_problem(problem, hier)
    pad = plan.padded_planes(0) - hier.finest_n
    u0 = jnp.pad(u0, ((0, pad), (0, 0), (0, 0)))
    f = jnp.pad(f, ((0, pad), (0, 0), (0, 0)))
    sh = NamedSharding(mesh, P(plan.axis))
    return jax.device_put(u0, sh), jax.device_put(f, sh)


def setup_df_problem_sharded(problem, hier: Hierarchy, mesh: Mesh, plan: ShardPlan):
    """Double-float (hi, lo) sharded setup: (u_hi, u_lo, f_hi, f_lo)."""
    from multigrid_parallel.cycles import setup_problem
    u64, f64 = setup_problem(problem, hier)
    pad = plan.padded_planes(0) - hier.finest_n
    sh = NamedSharding(mesh, P(plan.axis))

    def prep(x64):
        hi, lo = dfo.df_split(x64)
        hi = jnp.pad(hi, ((0, pad), (0, 0), (0, 0)))
        lo = jnp.pad(lo, ((0, pad), (0, 0), (0, 0)))
        return jax.device_put(hi, sh), jax.device_put(lo, sh)

    u_hi, u_lo = prep(u64)
    f_hi, f_lo = prep(f64)
    return u_hi, u_lo, f_hi, f_lo


def unpad(u_padded, hier: Hierarchy):
    return u_padded[: hier.finest_n]
