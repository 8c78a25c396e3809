"""Coarsest-grid direct solve.

The reference builds a dense (N^3)^2 matrix — interior rows the 7-point
Laplacian scaled by 1/h^2, boundary rows identity (constructCoarseMatrixA,
mg_3d.h:147-273) — Doolittle-LU-factorizes it once at setup
(convertToLU_InPlace, gauss_elim.h:9-29; called at mg_3d.h:289) and
back-substitutes per V-cycle (solveWithLU, gauss_elim.h:31-60).

Here the matrix is built and factorized ON THE HOST in f64 at setup (it
is tiny — 125x125 for coarseN=5 — and built once), and the per-cycle
solve runs on device either as

  * ``method="lu"``: jax.scipy lu_solve (two triangular solves), or
  * ``method="inverse"``: a single (n^d x n^d) matvec with the
    precomputed inverse (one matmul instead of two dependent
    triangular solves).

Both give the exact direct solve the reference gets, because the RHS the
V-cycle feeds in is the restricted residual whose boundary entries are
zero and the boundary rows are identity.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg


def build_coarse_matrix_3d(n: int, h: float) -> np.ndarray:
    """Dense (n^3, n^3) matrix, matching constructCoarseMatrixA
    (mg_3d.h:147-273): interior rows off-diag +1/h^2 and diag -6/h^2,
    boundary rows identity (mg_3d.h:158-159, 185, 259-267)."""
    nn = n * n
    total = n * n * n
    a = np.zeros((total, total), dtype=np.float64)
    inv_h2 = 1.0 / (h * h)
    idx = np.arange(total)
    i, rem = np.divmod(idx, nn)
    j, k = np.divmod(rem, n)
    boundary = (i == 0) | (i == n - 1) | (j == 0) | (j == n - 1) | (k == 0) | (k == n - 1)
    a[idx[boundary], idx[boundary]] = 1.0
    interior = idx[~boundary]
    a[interior, interior] = -6.0 * inv_h2
    for off in (nn, -nn, n, -n, 1, -1):
        a[interior, interior + off] = inv_h2
    return a


def build_coarse_matrix_1d(n: int, h: float) -> np.ndarray:
    """Tridiagonal {1, -2, 1}/h^2 with identity end rows (mg_1d.c:77-86,
    which builds the unscaled {1,-2,1} form; we keep the 1/h^2 scaling
    consistent with the 3D matrix)."""
    a = np.zeros((n, n), dtype=np.float64)
    inv_h2 = 1.0 / (h * h)
    a[0, 0] = 1.0
    a[n - 1, n - 1] = 1.0
    for j in range(1, n - 1):
        a[j, j - 1] = inv_h2
        a[j, j] = -2.0 * inv_h2
        a[j, j + 1] = inv_h2
    return a


def make_coarse_solver(
    n: int, h: float, ndim: int, dtype, method: str = "lu"
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Return solve(f_grid) -> u_grid for the coarsest level.

    Factorization happens once here, on the host in f64 (the analogue of
    the one-time convertToLU_InPlace call at mg_3d.h:289); the returned
    closure is pure and jittable.
    """
    a = build_coarse_matrix_3d(n, h) if ndim == 3 else build_coarse_matrix_1d(n, h)
    shape = (n,) * ndim

    if method == "lu":
        lu, piv = scipy.linalg.lu_factor(a)
        lu_d = jnp.asarray(lu, dtype=dtype)
        piv_d = jnp.asarray(piv, dtype=jnp.int32)

        def solve(f: jnp.ndarray) -> jnp.ndarray:
            x = jax.scipy.linalg.lu_solve((lu_d, piv_d), f.reshape(-1).astype(dtype))
            return x.reshape(shape).astype(f.dtype)

    elif method == "inverse":
        a_inv = jnp.asarray(np.linalg.inv(a), dtype=dtype)

        def solve(f: jnp.ndarray) -> jnp.ndarray:
            # HIGHEST: an f32 matvec may otherwise run in TF32 on the GPU.
            x = jnp.matmul(a_inv, f.reshape(-1).astype(dtype),
                           precision=jax.lax.Precision.HIGHEST)
            return x.reshape(shape).astype(f.dtype)

    else:
        raise ValueError(f"unknown coarse method {method!r}")

    return solve


def direct_solve_poisson(f: jnp.ndarray, h: float) -> jnp.ndarray:
    """One-shot dense direct solve of the FULL n^d Poisson system with
    Dirichlet boundary values read from f's boundary entries — the
    capability of test_lu.c:23-43 (practical only for small n)."""
    n = f.shape[0]
    ndim = f.ndim
    a = build_coarse_matrix_3d(n, h) if ndim == 3 else build_coarse_matrix_1d(n, h)
    lu, piv = scipy.linalg.lu_factor(a)
    x = scipy.linalg.lu_solve((lu, piv), np.asarray(f, dtype=np.float64).reshape(-1))
    return jnp.asarray(x.reshape(f.shape), dtype=f.dtype)
