"""The jnp 3D ops against the loop-level goldens across sizes, colour
orders, sweep counts and dtypes, and the two transfer-operator forms
against each other.

f64 runs must agree with the goldens to roundoff. f32 runs replay the
goldens in f32 (numpy keeps f32 scalars in f32), so they agree to f32
roundoff; the tolerance allows FMA contraction and, for the transfer
forms, the reassociated weighted sums.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import golden3d
from multigrid_parallel.ops import stencils_3d as ops

SIZES = (5, 9, 17, 33)
DTYPES = (np.float32, np.float64)
TOL = {np.float32: dict(rtol=2e-5, atol=2e-5), np.float64: dict(rtol=1e-12, atol=1e-13)}
FORMS = ("matmul", "slices")


def _fields(n, dtype, seed=0):
    rng = np.random.default_rng(seed + n)
    return (rng.standard_normal((n, n, n)).astype(dtype),
            rng.standard_normal((n, n, n)).astype(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_iter", (1, 2, 3))
@pytest.mark.parametrize("red_first", (True, False))
@pytest.mark.parametrize("n", SIZES)
def test_rb_smooth_matches_golden(n, red_first, n_iter, dtype):
    u, f = _fields(n, dtype)
    h = 1.0 / (n - 1)
    want = golden3d.rb_sweep(u.copy(), f, h, n_iter=n_iter, red_first=red_first)
    got = np.asarray(ops.rb_smooth(jnp.asarray(u), jnp.asarray(f), h, n_iter,
                                   red_first=red_first))
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_residual_matches_golden_sizes(n, dtype):
    u, f = _fields(n, dtype, seed=1)
    h = 1.0 / (n - 1)
    want = golden3d.residual(u, f, h)
    got = np.asarray(ops.residual(jnp.asarray(u), jnp.asarray(f), h))
    # 1/h^2 scales the stencil sum, so compare relative to the field
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nf", SIZES)
def test_restrict_forms_match_golden(nf, form, dtype):
    r, _ = _fields(nf, dtype, seed=2)
    nc = (nf + 1) // 2
    want = golden3d.restrict(r, nc)
    fn = getattr(ops, f"restrict_full_weighting_{form}")
    got = np.asarray(fn(jnp.asarray(r)))
    assert got.shape == (nc, nc, nc) and got.dtype == dtype
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nc", (3, 5, 9, 17))
def test_prolong_forms_match_golden(nc, form, dtype):
    nf = 2 * nc - 1
    rng = np.random.default_rng(3 + nc)
    ec = rng.standard_normal((nc, nc, nc)).astype(dtype)
    ef = rng.standard_normal((nf, nf, nf)).astype(dtype)
    want = golden3d.prolong_correct(ec, ef.copy())
    fn = getattr(ops, f"prolong_correct_{form}")
    got = np.asarray(fn(jnp.asarray(ec), jnp.asarray(ef)))
    assert got.shape == (nf, nf, nf) and got.dtype == dtype
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("op", ("restrict", "prolong"))
@pytest.mark.parametrize("nf", (5, 9, 17, 33, 65))
def test_matmul_and_slice_transfers_agree(nf, op):
    rng = np.random.default_rng(4 + nf)
    nc = (nf + 1) // 2
    if op == "restrict":
        args = (jnp.asarray(rng.standard_normal((nf, nf, nf))),)
        a = ops.restrict_full_weighting_matmul(*args)
        b = ops.restrict_full_weighting_slices(*args)
    else:
        args = (jnp.asarray(rng.standard_normal((nc, nc, nc))),
                jnp.asarray(rng.standard_normal((nf, nf, nf))))
        a = ops.prolong_correct_matmul(*args)
        b = ops.prolong_correct_slices(*args)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-13)


def test_cycle_transfer_operators_are_one_of_the_forms():
    assert ops.restrict_full_weighting in (
        ops.restrict_full_weighting_matmul, ops.restrict_full_weighting_slices)
    assert ops.prolong_correct in (
        ops.prolong_correct_matmul, ops.prolong_correct_slices)
    # both picked from the same form
    assert (ops.restrict_full_weighting is ops.restrict_full_weighting_slices) == (
        ops.prolong_correct is ops.prolong_correct_slices)
