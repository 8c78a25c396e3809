"""3D multigrid stencil ops, pure jnp (the reference implementation).

Each op reproduces the exact arithmetic of the corresponding C kernel in
the reference's mg_3d.h, re-expressed as whole-array tensor
ops instead of triple loops:

  * red-black Gauss-Seidel half-sweeps -> masked whole-array updates.
    Within one color sweep every update reads only opposite-color
    neighbors, so the masked vectorized update is *exactly* equivalent
    (same floating-point ops in the same order per point) to the
    sequential C loop (mg_3d.h:640-781).
  * residual -> one fused stencil pass (mg_3d.h:794-842).
  * full-weighting restriction -> 27 strided slices x constant weights,
    injection on boundary faces (mg_3d.h:844-998); a separable-matmul
    form is kept as a cross-check.
  * trilinear prolongate-and-correct -> 8 parity-class slice updates
    (mg_3d.h:1000-1145); likewise with a separable-matmul form.

All ops are shape-polymorphic in N but assume cubic grids with N = 2^k+1.
Scalars (h, omega) are python floats so they adopt the array dtype under
JAX weak-typing — the same code runs the f32 inner cycle and the f64
parity path.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# Color convention (mg_3d.h:669, 693): RED = nodes with (i+j+k) odd
# (the red loop starts k at 1+(i+j)%2), BLACK = (i+j+k) even.
RED, BLACK = 1, 0


@functools.lru_cache(maxsize=None)
def _masks_np(n: int, i_offset: int = 0):
    """(red_interior, black_interior, interior) boolean masks for an n^3 grid.

    ``i_offset`` shifts the global i index — used by sharded kernels where
    the local block starts at global row i_offset (parity must be global).
    For the interior test the i-range is still local [1, n-2]; sharded
    callers pass their own interior masks instead.
    """
    idx = np.arange(n)
    par = ((idx[:, None, None] + i_offset) + idx[None, :, None] + idx[None, None, :]) % 2
    interior = np.zeros((n, n, n), dtype=bool)
    interior[1:-1, 1:-1, 1:-1] = True
    red = (par == RED) & interior
    black = (par == BLACK) & interior
    return red, black, interior


def zero_boundary(x: jnp.ndarray) -> jnp.ndarray:
    """Zero all boundary nodes. Used on coarse-level *corrections*, whose
    boundary is exactly zero in exact arithmetic (identity boundary rows x
    zero RHS, mg_3d.h:185) but picks up O(eps) noise from the pivoted
    coarse solve — which the interior-only outer residual could never
    correct."""
    _, _, interior = _masks_np(x.shape[0])
    return jnp.where(jnp.asarray(interior), x, jnp.zeros_like(x))


def neighbor_sum(u: jnp.ndarray) -> jnp.ndarray:
    """Sum of the 6 face neighbors, in the reference's addition order
    (i-1)+(i+1)+(j-1)+(j+1)+(k-1)+(k+1) (mg_3d.h:439-441).

    Uses jnp.roll (wrap-around); wrapped values only land on boundary rows,
    which no caller ever uses (updates/residuals are interior-masked).
    """
    return (
        jnp.roll(u, 1, 0)
        + jnp.roll(u, -1, 0)
        + jnp.roll(u, 1, 1)
        + jnp.roll(u, -1, 1)
        + jnp.roll(u, 1, 2)
        + jnp.roll(u, -1, 2)
    )


def _half_sweep(u, f, h: float, color_mask) -> jnp.ndarray:
    """One RB-GS color sweep: u <- (nbr_sum - h^2 f)/6 on `color_mask`.

    Matches smoothenAtIndex (mg_3d.h:438-443): multFact*(sum - hSq*d) with
    multFact = 1/6.
    """
    h2 = h * h
    upd = (neighbor_sum(u) - h2 * f) * (1.0 / 6.0)
    return jnp.where(color_mask, upd, u)


def rb_smooth(
    u: jnp.ndarray,
    f: jnp.ndarray,
    h: float,
    n_iter: int,
    red_first: bool = True,
    i_offset: int = 0,
) -> jnp.ndarray:
    """Red-black Gauss-Seidel smoothing sweeps.

    ``red_first=True`` is the reference preSmoother (RED then BLACK,
    mg_3d.h:640-709); ``False`` is the postSmoother (BLACK then RED,
    mg_3d.h:711-781) — symmetrized ordering across the V-cycle.
    """
    red, black, _ = _masks_np(u.shape[0], i_offset)
    red = jnp.asarray(red)
    black = jnp.asarray(black)
    first, second = (red, black) if red_first else (black, red)
    for _ in range(n_iter):  # static unroll: n_iter is a compile-time constant
        u = _half_sweep(u, f, h, first)
        u = _half_sweep(u, f, h, second)
    return u


def jacobi_smooth(u, f, h: float, n_iter: int, omega: float = 2.0 / 3.0):
    """Weighted-Jacobi smoother (the parallel-trivial alternative;
    BASELINE.json config 1 pairs it with the 1D port)."""
    _, _, interior = _masks_np(u.shape[0])
    interior = jnp.asarray(interior)
    h2 = h * h
    for _ in range(n_iter):
        upd = (neighbor_sum(u) - h2 * f) * (1.0 / 6.0)
        u = jnp.where(interior, (1.0 - omega) * u + omega * upd, u)
    return u


def residual(u: jnp.ndarray, f: jnp.ndarray, h: float) -> jnp.ndarray:
    """r = f - (1/h^2)(nbr_sum - 6 u) on the interior, 0 on the boundary.

    Matches calculateResidual (mg_3d.h:794-842) including the untouched
    (calloc-zero) boundary entries of the residual field.
    """
    _, _, interior = _masks_np(u.shape[0])
    inv_h2 = 1.0 / (h * h)
    r = f - inv_h2 * (neighbor_sum(u) - 6.0 * u)
    return jnp.where(jnp.asarray(interior), r, jnp.zeros_like(r))


def residual_norm(u: jnp.ndarray, f: jnp.ndarray, h: float) -> jnp.ndarray:
    """||r||_2 over the interior (the vcycle return value, mg_3d.h:1354)."""
    r = residual(u, f, h)
    return jnp.sqrt(jnp.sum(r * r))


# Full-weighting nodal weights (mg_3d.h:851-872): 1/8 center, 1/16 faces,
# 1/32 edges, 1/64 corners, indexed by offset (di, dj, dk) in {-1,0,1}^3.
_FW_WEIGHTS = {
    (di, dj, dk): (1.0 / 8.0) * (0.5 ** (abs(di) + abs(dj) + abs(dk)))
    for di in (-1, 0, 1)
    for dj in (-1, 0, 1)
    for dk in (-1, 0, 1)
}


@functools.lru_cache(maxsize=None)
def _restrict_matrix_np(nf: int) -> np.ndarray:
    """(nc, nf) separable full-weighting matrix: interior rows the 3-tap
    [1/4, 1/2, 1/4] stencil at stride 2, end rows injection. The 27-point
    table of mg_3d.h:851-872 is exactly the tensor product of three of
    these ((1/2)^3 = 1/8 center, ..., (1/4)^3 = 1/64 corners)."""
    nc = (nf + 1) // 2
    s = np.zeros((nc, nf))
    s[0, 0] = 1.0
    s[nc - 1, nf - 1] = 1.0
    for ic in range(1, nc - 1):
        s[ic, 2 * ic - 1 : 2 * ic + 2] = (0.25, 0.5, 0.25)
    return s


@functools.lru_cache(maxsize=None)
def _inject_matrix_np(nf: int) -> np.ndarray:
    """(nc, nf) pure-injection selection matrix (coincident fine point)."""
    nc = (nf + 1) // 2
    j = np.zeros((nc, nf))
    j[np.arange(nc), 2 * np.arange(nc)] = 1.0
    return j


@functools.lru_cache(maxsize=None)
def _prolong_matrix_np(nc: int) -> np.ndarray:
    """(nf, nc) linear-interpolation matrix: even fine rows copy the
    coincident coarse point, odd rows average the two neighbors. The
    tensor product of three of these is exactly the 4-parity-case
    trilinear kernel of mg_3d.h:1000-1145."""
    nf = 2 * nc - 1
    p = np.zeros((nf, nc))
    p[2 * np.arange(nc), np.arange(nc)] = 1.0
    p[2 * np.arange(nc - 1) + 1, np.arange(nc - 1)] = 0.5
    p[2 * np.arange(nc - 1) + 1, np.arange(nc - 1) + 1] = 0.5
    return p


# Full-precision matmul passes: without it an f32 product may run in TF32.
_HIGHEST = jax.lax.Precision.HIGHEST


def restrict_full_weighting_matmul(r: jnp.ndarray) -> jnp.ndarray:
    """Fine (Nf^3) -> coarse (Nc^3), Nc = (Nf+1)/2.

    Interior: 27-point full weighting (mg_3d.h:961-995). Boundary faces:
    injection of the coincident fine value (mg_3d.h:879-958) — for the
    residual (zero boundary) this keeps the coarse RHS boundary zero,
    which together with the identity boundary rows of the coarse matrix
    (mg_3d.h:185) pins the coarse error to zero on the boundary.

    Separable-matmul form: the stencil runs as three dense matmuls (one
    per axis) with the (Nc, Nf) 3-tap matrix; boundary injection is the
    same trick with a selection matrix on the six faces.
    """
    nf = r.shape[0]
    s = jnp.asarray(_restrict_matrix_np(nf), dtype=r.dtype)
    t = jnp.einsum("ai,ijk->ajk", s, r, precision=_HIGHEST)
    t = jnp.einsum("bj,ajk->abk", s, t, precision=_HIGHEST)
    t = jnp.einsum("ck,abk->abc", s, t, precision=_HIGHEST)
    # Overwrite the six faces with pure injection (mg_3d.h:879-958); the
    # separable end rows alone would 2D-filter the tangential directions.
    j = jnp.asarray(_inject_matrix_np(nf), dtype=r.dtype)

    def inject2d(face):  # (nf, nf) -> (nc, nc)
        return jnp.einsum(
            "bj,ck,jk->bc", j, j, face, precision=_HIGHEST
        )

    t = t.at[0].set(inject2d(r[0]))
    t = t.at[-1].set(inject2d(r[-1]))
    t = t.at[:, 0].set(inject2d(r[:, 0]))
    t = t.at[:, -1].set(inject2d(r[:, -1]))
    t = t.at[:, :, 0].set(inject2d(r[:, :, 0]))
    t = t.at[:, :, -1].set(inject2d(r[:, :, -1]))
    return t


def prolong_correct_matmul(ec: jnp.ndarray, ef: jnp.ndarray) -> jnp.ndarray:
    """ef += trilinear_interp(ec), all fine nodes (mg_3d.h:1000-1145).

    Separable-matmul form: trilinear interpolation as three (Nf, Nc)
    interpolation matmuls, one per axis.
    """
    nc = ec.shape[0]
    p = jnp.asarray(_prolong_matrix_np(nc), dtype=ec.dtype)
    t = jnp.einsum("ia,abc->ibc", p, ec, precision=_HIGHEST)
    t = jnp.einsum("jb,ibc->ijc", p, t, precision=_HIGHEST)
    t = jnp.einsum("kc,ijc->ijk", p, t, precision=_HIGHEST)
    return ef + t


def restrict_full_weighting_slices(r: jnp.ndarray) -> jnp.ndarray:
    """Strided-slice form of the full-weighting restriction: the direct
    transcription of the C loops (27 weighted strided slices)."""
    nf = r.shape[0]
    out = r[::2, ::2, ::2]
    core = None
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                w = _FW_WEIGHTS[(di, dj, dk)]
                sl = r[
                    2 + di : nf - 2 + di : 2,
                    2 + dj : nf - 2 + dj : 2,
                    2 + dk : nf - 2 + dk : 2,
                ]
                term = w * sl
                core = term if core is None else core + term
    return out.at[1:-1, 1:-1, 1:-1].set(core)


def prolong_correct_slices(ec: jnp.ndarray, ef: jnp.ndarray) -> jnp.ndarray:
    """Parity-class strided-slice form of prolongate-and-correct (the
    addition order per point matches the C corner tables)."""
    # Shorthands: e = even fine index (coincident with coarse), o = odd.
    c = ec
    # (even, even, even): coincident copy (mg_3d.h:1137-1138).
    ef = ef.at[::2, ::2, ::2].add(c)
    # One odd axis: midpoint of 2 coarse neighbors (mg_3d.h:1101-1134).
    ef = ef.at[1::2, ::2, ::2].add(0.5 * (c[:-1, :, :] + c[1:, :, :]))
    ef = ef.at[::2, 1::2, ::2].add(0.5 * (c[:, :-1, :] + c[:, 1:, :]))
    ef = ef.at[::2, ::2, 1::2].add(0.5 * (c[:, :, :-1] + c[:, :, 1:]))
    # Two odd axes: face-center average of 4 (mg_3d.h:1053-1097), corner
    # order per the C tables.
    ef = ef.at[::2, 1::2, 1::2].add(
        0.25
        * (
            c[:, :-1, :-1] + c[:, 1:, :-1] + c[:, :-1, 1:] + c[:, 1:, 1:]
        )
    )
    ef = ef.at[1::2, ::2, 1::2].add(
        0.25
        * (
            c[:-1, :, :-1] + c[1:, :, :-1] + c[:-1, :, 1:] + c[1:, :, 1:]
        )
    )
    ef = ef.at[1::2, 1::2, ::2].add(
        0.25
        * (
            c[:-1, :-1, :] + c[:-1, 1:, :] + c[1:, :-1, :] + c[1:, 1:, :]
        )
    )
    # Three odd axes: cube-center average of 8 (mg_3d.h:1023-1049).
    ef = ef.at[1::2, 1::2, 1::2].add(
        0.125
        * (
            c[:-1, :-1, :-1]
            + c[:-1, :-1, 1:]
            + c[:-1, 1:, :-1]
            + c[:-1, 1:, 1:]
            + c[1:, :-1, :-1]
            + c[1:, :-1, 1:]
            + c[1:, 1:, :-1]
            + c[1:, 1:, 1:]
        )
    )
    return ef


# The transfer operators every cycle calls: the strided-slice forms. The
# whole 513^3 mixed solve takes 0.180 s with them against 0.301 s with the
# matmul forms on an H100 at 700 W (PERF.md); the matmul forms stay as
# test oracles.
restrict_full_weighting = restrict_full_weighting_slices
prolong_correct = prolong_correct_slices


def gauss_seidel_lex(u, f, h: float, n_iter: int):
    """Lexicographic Gauss-Seidel (mg_3d.h:546-637), as a lax.scan over
    i-planes with an inner scan over j-rows.

    Inherently sequential — kept only as a small CPU oracle for the
    smoother-comparison study (test_gs_3d.c); RB is the parallel default,
    as in the reference's own active path.
    """
    n = u.shape[0]
    h2 = h * h

    def row_update(u_flat):
        # One full sweep via fori_loop over interior points in lex order.
        def body(p, u):
            i = p // ((n - 2) * (n - 2)) + 1
            rem = p % ((n - 2) * (n - 2))
            j = rem // (n - 2) + 1
            k = rem % (n - 2) + 1
            s = (
                u[i - 1, j, k]
                + u[i + 1, j, k]
                + u[i, j - 1, k]
                + u[i, j + 1, k]
                + u[i, j, k - 1]
                + u[i, j, k + 1]
            )
            return u.at[i, j, k].set((s - h2 * f[i, j, k]) * (1.0 / 6.0))

        return jax.lax.fori_loop(0, (n - 2) ** 3, body, u_flat)

    for _ in range(n_iter):
        u = row_update(u)
    return u


def update_edge_values(u: jnp.ndarray) -> jnp.ndarray:
    """Cosmetic smoothing of the cube's 12 edges and 8 corners
    (mg_3d.h:304-429): edges = average of the 2 adjacent face neighbors,
    corners = average of the 3 adjacent edge neighbors. Only used with the
    lexicographic smoother path, as in the reference (mg_3d.h:635, 1423).
    """
    n = u.shape[0]
    s = slice(1, n - 1)

    def avg2(a, b):
        return 0.5 * (a + b)

    # 12 edges. Edge along k at (i in {0,n-1}, j in {0,n-1}) etc.
    for i in (0, n - 1):
        ii = 1 if i == 0 else n - 2
        for j in (0, n - 1):
            jj = 1 if j == 0 else n - 2
            u = u.at[i, j, s].set(avg2(u[ii, j, s], u[i, jj, s]))
        for k in (0, n - 1):
            kk = 1 if k == 0 else n - 2
            u = u.at[i, s, k].set(avg2(u[ii, s, k], u[i, s, kk]))
    for j in (0, n - 1):
        jj = 1 if j == 0 else n - 2
        for k in (0, n - 1):
            kk = 1 if k == 0 else n - 2
            u = u.at[s, j, k].set(avg2(u[s, jj, k], u[s, j, kk]))
    # 8 corners: average of the 3 axis neighbors (mg_3d.h:394-429).
    for i in (0, n - 1):
        ii = 1 if i == 0 else n - 2
        for j in (0, n - 1):
            jj = 1 if j == 0 else n - 2
            for k in (0, n - 1):
                kk = 1 if k == 0 else n - 2
                u = u.at[i, j, k].set(
                    (u[ii, j, k] + u[i, jj, k] + u[i, j, kk]) / 3.0
                )
    return u


def apply_neumann_copy(
    u: jnp.ndarray, neumann_masks: Optional[dict] = None
) -> jnp.ndarray:
    """Homogeneous-Neumann enforcement by copying the adjacent interior
    plane onto boundary nodes (the mg_3d_bkup.c:84-133 rule), vectorized.

    ``neumann_masks`` maps face name ('x0','x1','y0','y1','z0','z1') to a
    2D bool mask over that face; None means the whole face is Neumann.
    """
    n = u.shape[0]
    full = jnp.ones((n, n), dtype=bool)

    def face(mask):
        return full if mask is None else jnp.asarray(mask)

    nm = neumann_masks or {}
    u = u.at[0].set(jnp.where(face(nm.get("x0")), u[1], u[0]))
    u = u.at[n - 1].set(jnp.where(face(nm.get("x1")), u[n - 2], u[n - 1]))
    u = u.at[:, 0].set(jnp.where(face(nm.get("y0")), u[:, 1], u[:, 0]))
    u = u.at[:, n - 1].set(jnp.where(face(nm.get("y1")), u[:, n - 2], u[:, n - 1]))
    u = u.at[:, :, 0].set(jnp.where(face(nm.get("z0")), u[:, :, 1], u[:, :, 0]))
    u = u.at[:, :, n - 1].set(
        jnp.where(face(nm.get("z1")), u[:, :, n - 2], u[:, :, n - 1])
    )
    return u
