"""Pure compute ops, all plain jnp/lax that XLA compiles for any backend.

  * ``stencils_3d`` / ``stencils_1d`` — smoothers, residual and transfer
    operators, each reproducing the arithmetic of a C kernel of the
    reference (tests/golden3d.py holds the loop-level goldens).
  * ``coarse`` — the coarsest-level direct solve.
  * ``df`` — double-float (hi, lo) f32 arithmetic for the all-f32
    sharded defect loops.
"""
