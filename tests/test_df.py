"""Double-float (hi, lo) helpers of ops.df: exactness of the error-free
transformations and accuracy of the compensated residual."""

import numpy as np
import jax.numpy as jnp
import pytest

from multigrid_parallel.ops import df as dfo
from multigrid_parallel.ops import stencils_3d as ops3


def _roll_nbrs(u):
    return [
        jnp.roll(u, 1, 0), jnp.roll(u, -1, 0),
        jnp.roll(u, 1, 1), jnp.roll(u, -1, 1),
        jnp.roll(u, 1, 2), jnp.roll(u, -1, 2),
    ]


def _residual_df(u64, f64, h):
    """The df residual on one device, interior-masked like ops3.residual."""
    u_hi, u_lo = dfo.df_split(u64)
    f_hi, f_lo = dfo.df_split(f64)
    r = dfo._eft_residual(f_hi, f_lo, u_hi, _roll_nbrs(u_hi), u_lo,
                          _roll_nbrs(u_lo), 1.0 / (h * h))
    _, _, interior = ops3._masks_np(u64.shape[0])
    return np.where(interior, np.asarray(r, np.float64), 0.0)


@pytest.mark.parametrize("scale", (1e-8, 1.0, 1e8))
def test_two_sum_is_exact(scale):
    rng = np.random.default_rng(0)
    a = jnp.asarray((rng.standard_normal(4096) * scale).astype(np.float32))
    b = jnp.asarray((rng.standard_normal(4096) * scale * 1e-3).astype(np.float32))
    s, err = dfo._two_sum(a, b)
    assert s.dtype == jnp.float32 and err.dtype == jnp.float32
    want = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    got = np.asarray(s, np.float64) + np.asarray(err, np.float64)
    np.testing.assert_array_equal(got, want)


def test_comp_sum_recovers_cancelled_terms():
    terms = [jnp.float32(1e8), jnp.float32(1.0), jnp.float32(-1e8),
             jnp.float32(1e-3)]
    s, c = dfo._comp_sum(terms)
    assert float(s) + float(c) == pytest.approx(1.0 + 1e-3, rel=1e-6)


def test_df_split_add_roundtrip():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(1000) * 100)
    hi, lo = dfo.df_split(x)
    assert hi.dtype == jnp.float32 and lo.dtype == jnp.float32
    # the pair resolves ~2^-48 relative (lo itself is f32-rounded)
    np.testing.assert_allclose(np.asarray(dfo.df_to_f64(hi, lo)), np.asarray(x),
                               rtol=5e-15)
    # hi is the f32 rounding of x
    np.testing.assert_array_equal(np.asarray(hi), np.asarray(x).astype(np.float32))
    d = jnp.asarray(rng.standard_normal(1000).astype(np.float32) * 1e-5)
    hi2, lo2 = dfo.df_add(hi, lo, d)
    want = np.asarray(x) + np.asarray(d, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(dfo.df_to_f64(hi2, lo2)), want,
                               rtol=1e-13, atol=1e-12)


@pytest.mark.parametrize("steps", (10, 1000))
def test_df_add_accumulates_without_f32_drift(steps):
    hi, lo = dfo.df_split(jnp.asarray(np.full(64, 1.0)))
    d = jnp.full(64, 1e-7, jnp.float32)
    for _ in range(steps):
        hi, lo = dfo.df_add(hi, lo, d)
    want = 1.0 + steps * float(np.float32(1e-7))
    np.testing.assert_allclose(np.asarray(dfo.df_to_f64(hi, lo)), want,
                               rtol=1e-12)


@pytest.mark.parametrize("n", (9, 17, 33))
def test_df_residual_matches_f64(n):
    h = 1.0 / (n - 1)
    c = np.arange(n) * h
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    u64 = jnp.asarray(x * x - 2 * y * y + z * z
                      + 1e-4 * np.sin(9 * x) * np.cos(7 * y) * np.sin(5 * z))
    f64 = jnp.asarray(np.sin(x + y + z))
    want = np.asarray(ops3.residual(u64, f64, h))
    got = _residual_df(u64, f64, h)
    # r_hi is one f32, so its error is ~ulp-RELATIVE to |r|
    err = np.abs(got - want)
    assert err.max() < 2e-7 * np.abs(want).max() + 1e-10, err.max()


def test_df_residual_error_scales_with_residual():
    # near convergence the true residual is tiny; the df evaluation must
    # track it while naive f32 is stuck at its cancellation floor.
    n = 17
    h = 1.0 / (n - 1)
    c = np.arange(n) * h
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    # harmonic and not f32-representable (scaled by 1/3)
    u64 = jnp.asarray((x * x - 2 * y * y + z * z) / 3.0)
    pert = np.zeros((n, n, n))
    pert[8, 8, 8] = 1e-9
    u64 = u64 + jnp.asarray(pert)
    f64 = jnp.zeros((n, n, n), jnp.float64)
    want = np.asarray(ops3.residual(u64, f64, h))
    true_norm = np.sqrt((want ** 2).sum())
    assert true_norm < 1e-5
    df_norm = np.sqrt((_residual_df(u64, f64, h) ** 2).sum())
    naive = np.asarray(
        ops3.residual(u64.astype(jnp.float32), f64.astype(jnp.float32), h)
    ).astype(np.float64)
    naive_norm = np.sqrt((naive ** 2).sum())
    assert abs(df_norm - true_norm) < 2e-3 * true_norm + 1e-12
    assert naive_norm > 100 * true_norm
