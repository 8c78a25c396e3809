"""Mixed Dirichlet/Neumann multigrid: the electrospray capability.

The reference's original physics target (mg_3d_bkup.c) solves the
electrostatic potential with *mixed* boundary conditions: a few boundary
patches pinned (capillary disk, extractor annulus) and homogeneous
Neumann everywhere else, enforced inside the smoother by copying the
updated adjacent interior value onto the boundary node ("this way we
ensure residual is zero on boundary node", mg_3d_bkup.c:84-133).

Design:
  * the smoother is the standard masked RB-GS half-sweep followed by a
    vectorized Neumann face copy + Dirichlet re-pin (ops.stencils_3d.
    apply_neumann_copy); the sequential in-sweep copies of the C code
    and this post-sweep form share the same fixed point (zero boundary
    residual + pinned Dirichlet nodes);
  * the correction equation inherits the same BC structure with zero
    Dirichlet values, so every coarse level uses zero-pinned masks
    evaluated at that level's resolution;
  * the coarsest level solves a dense mixed-BC matrix: interior rows the
    1/h^2 7-point Laplacian, Dirichlet rows identity, Neumann rows
    u[b] - u[src] = 0 where src is the face-copy source with the same
    z > y > x face priority as apply_neumann_copy (matching the
    commented constructCoarseMatrixA Neumann block, mg_3d.h:187-252).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multigrid_parallel.hierarchy import Hierarchy
from multigrid_parallel.models.electrospray import ElectrosprayProblem
from multigrid_parallel.ops import stencils_3d as ops3


def _neumann_source_index(i, j, k, n):
    """Copy-source of a boundary node, matching apply_neumann_copy's
    face application order (x, then y, then z faces — later overwrites
    win, so z has priority at edges/corners)."""
    if k == 0:
        return (i, j, 1)
    if k == n - 1:
        return (i, j, n - 2)
    if j == 0:
        return (i, 1, k)
    if j == n - 1:
        return (i, n - 2, k)
    if i == 0:
        return (1, j, k)
    return (n - 2, j, k)


def build_mixed_coarse_matrix(
    n: int, h: float, dirichlet_mask: np.ndarray
) -> np.ndarray:
    """Dense (n^3, n^3) mixed-BC operator (see module docstring)."""
    nn = n * n
    total = n**3
    a = np.zeros((total, total))
    inv_h2 = 1.0 / (h * h)
    for i in range(n):
        for j in range(n):
            for k in range(n):
                p = nn * i + n * j + k
                on_boundary = i in (0, n - 1) or j in (0, n - 1) or k in (0, n - 1)
                if not on_boundary:
                    a[p, p] = -6.0 * inv_h2
                    for off in (nn, -nn, n, -n, 1, -1):
                        a[p, p + off] = inv_h2
                elif dirichlet_mask[i, j, k]:
                    a[p, p] = 1.0
                else:
                    si, sj, sk = _neumann_source_index(i, j, k, n)
                    q = nn * si + n * sj + sk
                    a[p, p] = 1.0
                    a[p, q] = -1.0
    return a


@dataclasses.dataclass
class MixedBCSolver:
    """Multigrid solver for the electrospray mixed-BC Poisson problem.

    Mirrors the mg_3d_bkup.c driver: V-cycles with RB-GS smoothing and
    in-smoother BC enforcement, converging the interior residual.
    """

    problem: ElectrosprayProblem
    hier: Hierarchy
    n_smooth: int = 2
    gamma: int = 1  # W-cycle when 2 (coarse corrections revisited)
    # Extra RB relaxation restricted to the planes within
    # ``boundary_band_width`` of any face, applied after each smoothing
    # stage. The copy-BC (first-order Neumann) discretization leaves a
    # boundary error layer the coarse grids cannot represent, which
    # caps the V-cycle at ~0.59/cycle; band sweeps kill the layer for
    # O(n^2) extra work (4.6% of a sweep at 257^3). Measured at 33^3:
    # V 29 cycles -> band(2,2) 17 -> band(2,4) 13; W-cycle + band(2,2)
    # 11 cycles at 0.22/cycle (docs/MIXED_BC.md). The band shares the
    # smoother's fixed point, so the converged solution is unchanged
    # (0 = off = the reference-shaped cycle).
    boundary_band_width: int = 0
    boundary_band_iters: int = 0
    # W-cycle depth cap: gamma revisits apply only to sub-levels of size
    # >= gamma_min_n. At gamma=2 the visit count doubles per depth down
    # to level 1 (level 0 itself is never revisited — the `lvl - 1 > 0`
    # guard): 8+16+32+32 = 88 visits to the <=33^3 levels per W-cycle at
    # 257^3, each a handful of tiny launches, not bandwidth-bound; the copy-BC
    # boundary-layer mode the W-cycle fights is attacked by the FINE
    # levels' revisits. 0 = full W-cycle (unchanged default).
    gamma_min_n: int = 0

    def __post_init__(self):
        self._masks: List[Tuple[jnp.ndarray, jnp.ndarray]] = []
        for lvl in range(self.hier.num_levels):
            n = self.hier.sizes[lvl]
            mask, vals = self.problem.boundary_masks(n)
            self._masks.append(
                (jnp.asarray(mask), jnp.asarray(vals, dtype=self.hier.dtype))
            )
        # Coarsest mixed-BC dense solve, factorized once on the host.
        import scipy.linalg

        n0 = self.hier.sizes[0]
        mask0, _ = self.problem.boundary_masks(n0)
        a = build_mixed_coarse_matrix(n0, self.hier.spacing(0), mask0)
        lu, piv = scipy.linalg.lu_factor(a)
        self._lu_host = lu
        self._piv_host = piv
        lu_d = jnp.asarray(lu, dtype=self.hier.dtype)
        piv_d = jnp.asarray(piv, dtype=jnp.int32)

        def coarse_solve(f):
            x = jax.scipy.linalg.lu_solve((lu_d, piv_d), f.reshape(-1))
            return x.reshape(f.shape)

        self._coarse_solve = coarse_solve
        self._cycle = jax.jit(self._v_cycle)

    # -- BC application ------------------------------------------------

    def _apply_bcs(self, u, lvl: int, zero_dirichlet: bool):
        mask, vals = self._masks[lvl]
        u = ops3.apply_neumann_copy(u)
        pin = jnp.zeros_like(u) if zero_dirichlet else vals
        return jnp.where(mask, pin, u)

    @staticmethod
    def _band_mask_np(n: int, w: int):
        idx = np.arange(n)
        return (
            (idx[:, None, None] <= w) | (idx[:, None, None] >= n - 1 - w)
            | (idx[None, :, None] <= w) | (idx[None, :, None] >= n - 1 - w)
            | (idx[None, None, :] <= w) | (idx[None, None, :] >= n - 1 - w)
        )

    def _smooth(self, u, f, lvl: int, n_iter: int, red_first, zero_dirichlet):
        h = self.hier.spacing(lvl)
        colors = (ops3.RED, ops3.BLACK) if red_first else (ops3.BLACK, ops3.RED)
        red, black, _ = ops3._masks_np(u.shape[0])
        cmask = {ops3.RED: jnp.asarray(red), ops3.BLACK: jnp.asarray(black)}
        for _ in range(n_iter):
            for c in colors:
                u = ops3._half_sweep(u, f, h, cmask[c])
                u = self._apply_bcs(u, lvl, zero_dirichlet)
        if self.boundary_band_iters > 0:
            n = u.shape[0]
            near = self._band_mask_np(n, self.boundary_band_width)
            bmask = {
                ops3.RED: jnp.asarray(red & near),
                ops3.BLACK: jnp.asarray(black & near),
            }
            for _ in range(self.boundary_band_iters):
                for c in colors:
                    u = ops3._half_sweep(u, f, h, bmask[c])
                    u = self._apply_bcs(u, lvl, zero_dirichlet)
        return u

    # -- cycle ----------------------------------------------------------

    def _descend(self, u, f, lvl: int, zero_dirichlet: bool):
        if lvl == 0:
            x = self._coarse_solve(f)
            # correction solves pin Dirichlet nodes to zero exactly
            mask, _ = self._masks[0]
            return jnp.where(mask, jnp.zeros_like(x), x) if zero_dirichlet else x
        h = self.hier.spacing(lvl)
        u = self._smooth(u, f, lvl, self.n_smooth, True, zero_dirichlet)
        r = ops3.residual(u, f, h)
        fc = ops3.restrict_full_weighting(r)
        ec0 = jnp.zeros((self.hier.sizes[lvl - 1],) * 3, dtype=u.dtype)
        ec = self._descend(ec0, fc, lvl - 1, zero_dirichlet=True)
        if lvl - 1 > 0 and self.hier.sizes[lvl - 1] >= self.gamma_min_n:
            for _ in range(self.gamma - 1):  # W-cycle revisits
                ec = self._descend(ec, fc, lvl - 1, zero_dirichlet=True)
        u = ops3.prolong_correct(ec, u)
        u = self._apply_bcs(u, lvl, zero_dirichlet)
        u = self._smooth(u, f, lvl, self.n_smooth, False, zero_dirichlet)
        return u

    def _v_cycle(self, u, f):
        lvl = self.hier.num_levels - 1
        u = self._descend(u, f, lvl, zero_dirichlet=False)
        norm = ops3.residual_norm(u, f, self.hier.spacing(lvl))
        return u, norm

    # -- driver -----------------------------------------------------------

    def initial_state(self):
        lvl = self.hier.num_levels - 1
        n = self.hier.sizes[lvl]
        f = jnp.zeros((n, n, n), dtype=self.hier.dtype)  # charge-free
        u = self._apply_bcs(jnp.zeros_like(f), lvl, zero_dirichlet=False)
        return u, f

    def solve(self, rel_tol: float = 1e-8, max_cycles: int = 60, verbose=False):
        u, f = self.initial_state()
        lvl = self.hier.num_levels - 1
        init = float(ops3.residual_norm(u, f, self.hier.spacing(lvl)))
        norms = []
        for it in range(max_cycles):
            u, norm = self._cycle(u, f)
            n = float(norm)
            norms.append(n)
            if verbose:
                print(f"cycle {it:3d}  resid {n:.6e}")
            if n <= rel_tol * init:
                break
        return u, norms, init

    # -- performance path -------------------------------------------------

    def make_on_device_solver(
        self,
        rel_tol: float = 1e-8,
        max_cycles: int = 100,
        inner_cycles: int = 1,
    ):
        """Build ``run(u0, f) -> (u, norm, n_outer)``: the whole mixed-BC
        solve as ONE jitted ``lax.while_loop`` (no host round-trips) —
        the jit-fused performance path for the electrospray problem,
        mirroring ``cycles.make_on_device_mixed_solver``.

        Structure: f64 solution + defect residual outer loop; each outer
        step runs ``inner_cycles`` f32 correction V-cycles on the
        normalized defect equation (zero-Dirichlet masks at every level,
        Neumann copies after each half-sweep — the BC structure the
        correction equation inherits from mg_3d_bkup.c's smoother).
        Normalizing the defect by its norm keeps the f32 inner solve
        scale-invariant, so rel_tol down to ~1e-10 is reachable even
        though the electrode voltages span 1350 V.
        """
        f32 = jnp.float32
        lvl_top = self.hier.num_levels - 1
        h_top = self.hier.spacing(lvl_top)
        masks32 = [
            (m, vals.astype(f32)) for (m, vals) in self._masks
        ]
        lu32 = jnp.asarray(self._lu_host, dtype=f32)
        piv32 = jnp.asarray(self._piv_host, dtype=jnp.int32)
        mask0 = masks32[0][0]

        def coarse32(fc):
            x = jax.scipy.linalg.lu_solve((lu32, piv32), fc.reshape(-1))
            x = x.reshape(fc.shape)
            return jnp.where(mask0, jnp.zeros_like(x), x)

        def apply_bcs32(e, lvl):
            mask, _ = masks32[lvl]
            e = ops3.apply_neumann_copy(e)
            return jnp.where(mask, jnp.zeros_like(e), e)

        def smooth32(e, fdef, lvl, red_first):
            h = self.hier.spacing(lvl)
            n = e.shape[0]
            red, black, _ = ops3._masks_np(n)
            first, second = (red, black) if red_first else (black, red)
            for _ in range(self.n_smooth):
                e = ops3._half_sweep(e, fdef, h, jnp.asarray(first))
                e = apply_bcs32(e, lvl)
                e = ops3._half_sweep(e, fdef, h, jnp.asarray(second))
                e = apply_bcs32(e, lvl)
            if self.boundary_band_iters > 0:
                near = self._band_mask_np(n, self.boundary_band_width)
                for _ in range(self.boundary_band_iters):
                    e = ops3._half_sweep(e, fdef, h, jnp.asarray(first & near))
                    e = apply_bcs32(e, lvl)
                    e = ops3._half_sweep(e, fdef, h, jnp.asarray(second & near))
                    e = apply_bcs32(e, lvl)
            return e

        def descend32(e, fdef, lvl):
            if lvl == 0:
                return coarse32(fdef)
            h = self.hier.spacing(lvl)
            e = smooth32(e, fdef, lvl, red_first=True)
            r = ops3.residual(e, fdef, h)
            fc = ops3.restrict_full_weighting(r)
            ec0 = jnp.zeros((self.hier.sizes[lvl - 1],) * 3, dtype=e.dtype)
            ec = descend32(ec0, fc, lvl - 1)
            if lvl - 1 > 0 and self.hier.sizes[lvl - 1] >= self.gamma_min_n:
                for _ in range(self.gamma - 1):  # W-cycle revisits
                    ec = descend32(ec, fc, lvl - 1)
            e = ops3.prolong_correct(ec, e)
            e = apply_bcs32(e, lvl)
            e = smooth32(e, fdef, lvl, red_first=False)
            return e

        mask_top, vals_top = self._masks[lvl_top]

        def body(state):
            u, r, nrm, it, f = state
            safe = jnp.maximum(nrm, jnp.asarray(1e-300, dtype=u.dtype))
            r32 = (r / safe).astype(f32)
            e = jnp.zeros_like(r32)
            for _ in range(inner_cycles):
                e = descend32(e, r32, lvl_top)
            u = u + safe * e.astype(u.dtype)
            # re-enforce BCs exactly in the outer precision
            u = ops3.apply_neumann_copy(u)
            u = jnp.where(mask_top, vals_top, u)
            r = ops3.residual(u, f, h_top)
            nrm = jnp.sqrt(jnp.sum(r * r))
            return u, r, nrm, it + 1, f

        @jax.jit
        def run(u0, f):
            r0 = ops3.residual(u0, f, h_top)
            n0 = jnp.sqrt(jnp.sum(r0 * r0))
            tol = rel_tol * n0

            def cond(state):
                _, _, nrm, it, _ = state
                return jnp.logical_and(nrm > tol, it < max_cycles)

            u, _, nrm, it, _ = jax.lax.while_loop(
                cond, body, (u0, r0, n0, jnp.asarray(0), f)
            )
            return u, nrm, it

        return run

    def solve_on_device(
        self, rel_tol: float = 1e-8, max_cycles: int = 100, inner_cycles: int = 1
    ):
        """Whole solve in one jit. Returns (u, final_norm, n_outer, init)."""
        run = self.make_on_device_solver(rel_tol, max_cycles, inner_cycles)
        u0, f = self.initial_state()
        lvl = self.hier.num_levels - 1
        init = float(ops3.residual_norm(u0, f, self.hier.spacing(lvl)))
        u, norm, n_outer = run(u0, f)
        return u, float(norm), int(n_outer), init
