"""Cascadic (non-recursive, one-pass down/up) 1D multigrid.

Port of the reference's legacy driver mg_1d_old.c:63-144 — a single
fine-to-coarse leg (smooth, residual, restrict-into-f, all on strided
views of ONE flat fine-grid array), a direct tridiagonal solve on the
coarsest stride, then a coarse-to-fine leg (midpoint interpolation-add
+ smoothing against the ORIGINAL equation's RHS, mg_1d_old.c:123-144).
Unlike the recursive V-cycle (mg_1d.c / cycles.v_cycle) this is not a
correction scheme: the same array holds solution values at every level
and the up-leg re-smooths the original problem, so it behaves as a
cascadic / nested-iteration method.

Two reference quirks are reproduced under ``faithful=True`` (default),
because this module exists for parity:

  * the coarse-solve RHS vector ``b`` is never filled from the restricted
    residuals (mg_1d_old.c:99-110 allocates it with calloc and only
    re-zeroes the endpoints), so the direct solve returns x == 0 and the
    coarse strided points are overwritten with zero;
  * the coarse boundary rows use b = 0 even when the boundary values are
    nonzero (func(1) = 1 in the shipped driver).

``faithful=False`` fills ``b`` with the coarse problem consistent with
the overwrite semantics — the ORIGINAL equation on the coarse grid
(b[i] = -h_c^2 rhs(x_i) interior, true boundary values at the ends).
Note: this helps at shallow hierarchies (num_levels == 2) but can
OVERSHOOT at deeper ones, because the up-leg's midpoint interpolation
ADDS the interpolant onto already-smoothed values (mg_1d_old.c:129-130)
— with a nonzero coarse solution planted, midpoints double-count. That
is a structural quirk of the reference scheme itself, which its
never-filled (zero) coarse solve happens to sidestep.

The strided sequential Gauss-Seidel sweeps are lax.scan loops (this is
a legacy-parity driver, not a performance path — the parallel 1D path
is cycles.solve with red-black smoothing, see stencils_1d.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp


def _default_func(x):
    # mg_1d_old.c:17-18: exact solution / BC generator func(x) = x
    return x


def _default_rhs(x):
    # mg_1d_old.c:23-24: rhsFunc(x) = 0
    return jnp.zeros_like(x)


@dataclasses.dataclass
class CascadeResult:
    v: jnp.ndarray
    error_sq: float  # sum of squared error vs func (mg_1d_old.c:148-157)
    finest_n: int


def _strided_gs(v, f, h2: float, m: int, n_level: int, gs_iters: int):
    """gs_iters sequential GS sweeps over the strided interior
    j = m, 2m, ..., (n_level-2)*m (mg_1d_old.c:69-76)."""
    idx = jnp.arange(1, n_level - 1) * m

    def body(carry, j):
        vv = carry
        val = (vv[j - m] + vv[j + m] - h2 * f[j]) * 0.5
        return vv.at[j].set(val), None

    for _ in range(gs_iters):
        v, _ = jax.lax.scan(body, v, idx)
    return v


def cascade_solve_1d(
    coarse_n: int,
    num_levels: int,
    gs_iters: int,
    func: Callable = _default_func,
    rhs_func: Callable = _default_rhs,
    faithful: bool = True,
) -> CascadeResult:
    """Run the full mg_1d_old.c main() pipeline (lines 27-158).

    coarse_n / num_levels / gs_iters mirror the reference's argv triple.
    """
    if coarse_n < 3:
        raise ValueError("coarse grid needs at least 3 points")
    if num_levels < 1:
        raise ValueError("num_levels must be >= 1")

    nf = (coarse_n - 1) * (1 << (num_levels - 1)) + 1
    h_fine = 1.0 / (nf - 1)
    x = jnp.arange(nf, dtype=jnp.float64) * h_fine

    v = jnp.zeros(nf, dtype=jnp.float64)
    # enforce bcs (mg_1d_old.c:48)
    v = v.at[0].set(func(jnp.float64(0.0)))
    v = v.at[-1].set(func(jnp.float64(1.0)))
    f = jnp.asarray(rhs_func(x), dtype=jnp.float64)
    r = jnp.zeros_like(v)

    # ---- down leg (mg_1d_old.c:62-90) ----
    h, m, n_level = h_fine, 1, nf
    interior = jnp.arange(nf)
    for _ in range(num_levels - 1):
        h2 = h * h
        v = _strided_gs(v, f, h2, m, n_level, gs_iters)
        # residual on the strided interior (mg_1d_old.c:80-81)
        on_level = (interior % m == 0) & (interior > 0) & (interior < nf - 1)
        res = f - (jnp.roll(v, m) + jnp.roll(v, -m) - 2.0 * v) / h2
        r = jnp.where(on_level, res, r)
        # restrict into f at even strided points (mg_1d_old.c:84-85)
        on_coarse = (interior % (2 * m) == 0) & (interior > 0) & (interior < nf - 1)
        rest = 0.25 * (jnp.roll(r, m) + jnp.roll(r, -m)) + 0.5 * r
        f = jnp.where(on_coarse, rest, f)
        h *= 2.0
        m *= 2
        n_level = (n_level + 1) // 2

    # ---- coarse direct solve (mg_1d_old.c:92-119) ----
    nc = n_level
    diag = jnp.full(nc, 2.0, dtype=jnp.float64).at[0].set(1.0).at[-1].set(1.0)
    # Boundary rows are identities: only the BOUNDARY rows' off-diagonal
    # entries vanish (A[0,1] on the super-diagonal, A[nc-1,nc-2] on the
    # sub-diagonal). Interior rows adjacent to the boundary keep their
    # -1 coupling (mg_1d_old.c fills A[nii-1] for i=1 and A[nii+1] for
    # i=N-2), so the two off-diagonals zero DIFFERENT ends.
    sup = jnp.full(nc - 1, -1.0, dtype=jnp.float64).at[0].set(0.0)
    sub = jnp.full(nc - 1, -1.0, dtype=jnp.float64).at[-1].set(0.0)
    a_mat = jnp.diag(diag) + jnp.diag(sup, 1) + jnp.diag(sub, -1)
    if faithful:
        b = jnp.zeros(nc, dtype=jnp.float64)  # never filled: mg_1d_old.c:99
    else:
        # The coarse solution OVERWRITES v (mg_1d_old.c:113-114, not a
        # correction), so the consistent coarse problem is the original
        # equation on the coarse grid: -x_{i-1}+2x_i-x_{i+1} = -h_c^2
        # rhs(x_i) with the true boundary values in the identity rows.
        xc_coords = jnp.arange(nc, dtype=jnp.float64) * h
        b = (-(h * h)) * jnp.asarray(rhs_func(xc_coords), dtype=jnp.float64)
        b = b.at[0].set(v[0]).at[-1].set(v[-1])
    # Host solve: the system is tiny and concrete (this driver is eager).
    import numpy as np

    xc = jnp.asarray(
        np.linalg.solve(np.asarray(a_mat, dtype=np.float64),
                        np.asarray(b, dtype=np.float64))
    )
    # map interior coarse solution back (mg_1d_old.c:113-114)
    on_coarse_int = (interior % m == 0) & (interior > 0) & (interior < nf - 1)
    v = jnp.where(on_coarse_int, xc[jnp.minimum(interior // m, nc - 1)], v)

    # ---- up leg (mg_1d_old.c:122-144) ----
    for _ in range(num_levels - 1):
        h /= 2.0
        n_level = 2 * n_level - 1
        m //= 2
        # midpoint interpolation-add at odd strided multiples
        # (mg_1d_old.c:129-130: j = m, 3m, 5m, ...)
        on_mid = (interior % (2 * m) == m) & (interior < (n_level - 1) * m)
        v = jnp.where(on_mid, v + 0.5 * (jnp.roll(v, m) + jnp.roll(v, -m)), v)
        # smooth against the ORIGINAL RHS re-evaluated at the points
        # (mg_1d_old.c:140-141), not the restricted f. Faithful mode
        # reproduces the reference's coordinate quirk: rhsFunc(j*h) uses
        # the flat index times the LEVEL spacing, which is only the
        # physical coordinate on the finest level (invisible for the
        # shipped rhs == 0, wrong for any nonzero rhs).
        coords = jnp.arange(nf, dtype=jnp.float64) * (h if faithful else h_fine)
        f_orig = jnp.asarray(rhs_func(coords), dtype=jnp.float64)
        v = _strided_gs(v, f_orig, h * h, m, n_level, gs_iters)

    diff = v - func(x)
    return CascadeResult(v=v, error_sq=float(jnp.sum(diff * diff)), finest_n=nf)
