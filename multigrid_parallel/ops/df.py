"""Double-float (hi, lo) f32 arithmetic for the all-f32 defect loops.

A value is carried as an unevaluated sum ``hi + lo`` of two f32 arrays,
which resolves ~2^-48 relative. The sharded double-float cycles
(parallel/sharded.py, parallel/sharded2d.py) keep their solution in this
form and evaluate the outer residual with the compensated stencil below,
so no f64 operation runs inside them. Everything here is plain jnp:
XLA fuses it like any other elementwise stencil.
"""

from __future__ import annotations

import jax.numpy as jnp


def _two_sum(a, b):
    """Knuth's error-free transformation: a + b = s + err exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _comp_sum(terms):
    """Compensated chain sum: s + c represents sum(terms) to ~eps^2."""
    s = terms[0]
    c = jnp.zeros_like(s)
    for t in terms[1:]:
        s, err = _two_sum(s, t)
        c = c + err
    return s, c


def _stencil_terms(center, nbrs):
    """The 8-term EFT stencil decomposition: six neighbors plus the
    exact split -6u = -4u + -2u (powers of two multiply exactly)."""
    return list(nbrs) + [-4.0 * center, -2.0 * center]


def _eft_residual(f_hi, f_lo, hi_center, hi_nbrs, lo_center, lo_nbrs, inv_h2):
    """Double-float residual combine: r_hi ~= f - inv_h2 * (sum6(u) - 6u)
    with u = u_hi + u_lo, accurate to ~ulp-relative. ``inv_h2`` must be
    an exact power of two (h = 2^-k grids).

    Callers differ only in how they obtain the six neighbors (rolls on
    one device, halo-extended blocks under shard_map).

    The LO stencil sum is a plain sum: its terms are already ~2^-24
    relative to the hi terms, so its rounding errors sit at ~2^-48
    relative, below the compensation the hi sum's c_hi retains."""
    s_hi, c_hi = _comp_sum(_stencil_terms(hi_center, hi_nbrs))
    terms_lo = _stencil_terms(lo_center, lo_nbrs)
    s_lo = terms_lo[0]
    for t in terms_lo[1:]:
        s_lo = s_lo + t
    r, e1 = _two_sum(f_hi, -inv_h2 * s_hi)
    return r + (f_lo - inv_h2 * (c_hi + s_lo) + e1)


def df_split(x64):
    """f64 array -> (hi, lo) f32 double-float pair."""
    hi = x64.astype(jnp.float32)
    lo = (x64 - hi.astype(x64.dtype)).astype(jnp.float32)
    return hi, lo


def df_add(hi, lo, delta):
    """(hi, lo) + delta (f32), renormalized via two_sum."""
    s, e = _two_sum(hi, delta)
    lo = lo + e
    s, e = _two_sum(s, lo)
    return s, e


def df_to_f64(hi, lo):
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)
