"""Distributed layer: mesh construction, halo exchange, sharded cycles.

The replacement for the reference's OpenMP i-slab domain decomposition
(SURVEY.md §2.8): `shard_map` over a `jax.sharding.Mesh` with one-plane
halo exchange via `lax.ppermute` between devices, `psum` for the norm
reductions, and a gather-to-replicated strategy for the shrinking coarse
levels (the analogue of the reference's serial-under-`omp single` coarse
solve, mg_3d.h:1262-1277).
"""
