"""Unit tests: vectorized jnp 3D ops vs loop-level golden semantics.

The golden module replays the reference C kernels (mg_3d.h:640-1145) as
sequential numpy loops; the vectorized ops must agree to f64 roundoff
(bitwise for the masked RB sweep, which performs the identical
floating-point ops per point).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import golden3d
from multigrid_parallel.ops import stencils_3d as ops

N = 9
H = 1.0 / (N - 1)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def uf(rng):
    u = rng.standard_normal((N, N, N))
    f = rng.standard_normal((N, N, N))
    return u, f


def test_rb_smooth_red_first_matches_sequential_c_semantics(uf):
    u, f = uf
    want = golden3d.rb_sweep(u.copy(), f, H, n_iter=2, red_first=True)
    got = np.asarray(ops.rb_smooth(jnp.asarray(u), jnp.asarray(f), H, 2, red_first=True))
    # same op order per point; ulp tolerance for compiler FMA contraction
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)


def test_rb_smooth_black_first_matches(uf):
    u, f = uf
    want = golden3d.rb_sweep(u.copy(), f, H, n_iter=1, red_first=False)
    got = np.asarray(
        ops.rb_smooth(jnp.asarray(u), jnp.asarray(f), H, 1, red_first=False)
    )
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)


def test_rb_smooth_leaves_boundary_untouched(uf):
    u, f = uf
    got = np.asarray(ops.rb_smooth(jnp.asarray(u), jnp.asarray(f), H, 3))
    for ax in range(3):
        for side in (0, -1):
            idx = [slice(None)] * 3
            idx[ax] = side
            np.testing.assert_array_equal(got[tuple(idx)], u[tuple(idx)])


def test_residual_matches_golden(uf):
    u, f = uf
    want = golden3d.residual(u, f, H)
    got = np.asarray(ops.residual(jnp.asarray(u), jnp.asarray(f), H))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    # boundary is exactly zero (calloc semantics, mg_3d.h:824-825)
    assert np.all(got[0] == 0) and np.all(got[:, :, -1] == 0)


def test_residual_zero_for_exact_solution():
    # u = x^2 - 2y^2 + z^2 is harmonic and the 7-point stencil is exact
    # on quadratics, so the interior residual of the analytic field is 0.
    c = np.arange(N) * H
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    u = x * x - 2 * y * y + z * z
    f = np.zeros_like(u)
    r = np.asarray(ops.residual(jnp.asarray(u), jnp.asarray(f), H))
    np.testing.assert_allclose(r, 0, atol=1e-10)


def test_restrict_matches_golden(rng):
    nf, nc = 9, 5
    r = rng.standard_normal((nf, nf, nf))
    want = golden3d.restrict(r, nc)
    got = np.asarray(ops.restrict_full_weighting(jnp.asarray(r)))
    assert got.shape == (nc, nc, nc)
    # separable-matmul formulation reassociates the 27-term sum
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    # the strided-slice oracle matches the golden more tightly
    got_sl = np.asarray(ops.restrict_full_weighting_slices(jnp.asarray(r)))
    np.testing.assert_allclose(got_sl, want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(got, got_sl, rtol=0, atol=1e-13)


def test_restrict_weights_sum_to_one(rng):
    # full weighting preserves constants on the interior
    r = np.ones((9, 9, 9))
    got = np.asarray(ops.restrict_full_weighting(jnp.asarray(r)))
    np.testing.assert_allclose(got, 1.0, atol=1e-15)


def test_prolong_correct_matches_golden(rng):
    nc, nf = 5, 9
    ec = rng.standard_normal((nc, nc, nc))
    ef = rng.standard_normal((nf, nf, nf))
    want = golden3d.prolong_correct(ec, ef.copy())
    got = np.asarray(ops.prolong_correct(jnp.asarray(ec), jnp.asarray(ef)))
    # separable-matmul formulation reassociates the corner sums
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    got_sl = np.asarray(ops.prolong_correct_slices(jnp.asarray(ec), jnp.asarray(ef)))
    np.testing.assert_allclose(got_sl, want, rtol=1e-13, atol=1e-14)


def test_prolong_exact_on_trilinear_fields():
    # interpolation reproduces trilinear functions exactly
    nc, nf = 5, 9
    hc, hf = 1.0 / (nc - 1), 1.0 / (nf - 1)
    cc = np.arange(nc) * hc
    cf = np.arange(nf) * hf
    xc, yc, zc = np.meshgrid(cc, cc, cc, indexing="ij")
    xf, yf, zf = np.meshgrid(cf, cf, cf, indexing="ij")
    fn = lambda x, y, z: 2 * x - 3 * y + z + x * y - 2 * y * z + x * y * z
    got = np.asarray(
        ops.prolong_correct(jnp.asarray(fn(xc, yc, zc)), jnp.zeros((nf, nf, nf)))
    )
    np.testing.assert_allclose(got, fn(xf, yf, zf), atol=1e-14)


def test_jacobi_smoother_reduces_error():
    n = 17
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(0)
    u = np.zeros((n, n, n))
    u[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3)
    f = np.zeros_like(u)
    r0 = float(ops.residual_norm(jnp.asarray(u), jnp.asarray(f), h))
    u2 = ops.jacobi_smooth(jnp.asarray(u), jnp.asarray(f), h, 10)
    r1 = float(ops.residual_norm(u2, jnp.asarray(f), h))
    assert r1 < 0.5 * r0


def test_lex_gs_matches_golden_like_update(uf):
    # lexicographic GS: compare against an explicit sequential loop
    u, f = uf
    n = N
    h2 = H * H
    want = u.copy()
    for i in range(1, n - 1):
        for j in range(1, n - 1):
            for k in range(1, n - 1):
                golden3d.smooth_at(want, f, h2, i, j, k)
    got = np.asarray(ops.gauss_seidel_lex(jnp.asarray(u), jnp.asarray(f), H, 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
