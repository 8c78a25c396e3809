"""1D multigrid stencil ops, pure jnp.

Functional port of mg_1d.c's kernels, with two deliberate parallel-first
deviations (both documented in tests):

  * The default smoother is red-black (odd/even) Gauss-Seidel or weighted
    Jacobi instead of the reference's sequential lexicographic GS
    (mg_1d.c:58-68) — the same parallelization the reference itself
    applies in 3D (mg_3d.h:640-781). The sequential version is kept as
    ``gauss_seidel_lex`` (a lax.scan) for oracle comparisons.
  * The residual uses the unscaled form r = f - (1/h^2)(u[j-1]+u[j+1]-2u)
    consistent with the 3D solver (mg_3d.h:819-821), not the h^2-scaled
    form of mg_1d.c:105-106 (which the reference itself mixes with a
    1/h^2-scaled convergence check, mg_1d.c:37-56 — a scale mismatch we
    do not reproduce).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

RED, BLACK = 1, 0


@functools.lru_cache(maxsize=None)
def _masks_np(n: int, offset: int = 0):
    idx = np.arange(n) + offset
    par = idx % 2
    interior = np.zeros(n, dtype=bool)
    interior[1:-1] = True
    return (par == RED) & interior, (par == BLACK) & interior, interior


def zero_boundary(x: jnp.ndarray) -> jnp.ndarray:
    """Zero the two endpoint nodes (see stencils_3d.zero_boundary)."""
    _, _, interior = _masks_np(x.shape[0])
    return jnp.where(jnp.asarray(interior), x, jnp.zeros_like(x))


def neighbor_sum(u: jnp.ndarray) -> jnp.ndarray:
    return jnp.roll(u, 1) + jnp.roll(u, -1)


def _half_sweep(u, f, h: float, mask):
    # v[j] = (v[j-1] + v[j+1] - h^2 f[j]) / 2 (mg_1d.c:66-67)
    upd = (neighbor_sum(u) - (h * h) * f) * 0.5
    return jnp.where(mask, upd, u)


def rb_smooth(u, f, h: float, n_iter: int, red_first: bool = True, i_offset: int = 0):
    red, black, _ = _masks_np(u.shape[0], i_offset)
    red, black = jnp.asarray(red), jnp.asarray(black)
    first, second = (red, black) if red_first else (black, red)
    for _ in range(n_iter):
        u = _half_sweep(u, f, h, first)
        u = _half_sweep(u, f, h, second)
    return u


def jacobi_smooth(u, f, h: float, n_iter: int, omega: float = 2.0 / 3.0):
    _, _, interior = _masks_np(u.shape[0])
    interior = jnp.asarray(interior)
    for _ in range(n_iter):
        upd = (neighbor_sum(u) - (h * h) * f) * 0.5
        u = jnp.where(interior, (1.0 - omega) * u + omega * upd, u)
    return u


def gauss_seidel_lex(u, f, h: float, n_iter: int):
    """Sequential GS sweep (mg_1d.c:58-68) as a lax.scan — CPU oracle only."""
    n = u.shape[0]
    h2 = h * h

    def sweep(u):
        def body(carry, j):
            u = carry
            val = (u[j - 1] + u[j + 1] - h2 * f[j]) * 0.5
            return u.at[j].set(val), None

        u, _ = jax.lax.scan(body, u, jnp.arange(1, n - 1))
        return u

    for _ in range(n_iter):
        u = sweep(u)
    return u


def residual(u, f, h: float):
    _, _, interior = _masks_np(u.shape[0])
    inv_h2 = 1.0 / (h * h)
    r = f - inv_h2 * (neighbor_sum(u) - 2.0 * u)
    return jnp.where(jnp.asarray(interior), r, jnp.zeros_like(r))


def residual_norm(u, f, h: float):
    r = residual(u, f, h)
    return jnp.sqrt(jnp.sum(r * r))


def restrict_full_weighting(r):
    """[1/4, 1/2, 1/4] restriction (mg_1d.c:112-114), boundary injection."""
    nf = r.shape[0]
    out = r[::2]
    core = 0.25 * r[1 : nf - 3 : 2] + 0.5 * r[2 : nf - 2 : 2] + 0.25 * r[3 : nf - 1 : 2]
    return out.at[1:-1].set(core)


def prolong_correct(ec, ef):
    """ef += linear_interp(ec): coincident copy + midpoint averaging
    (mg_1d.c:124-135)."""
    ef = ef.at[::2].add(ec)
    ef = ef.at[1::2].add(0.5 * (ec[:-1] + ec[1:]))
    return ef
