"""Geometric multigrid framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the C/OpenMP
reference solver ``knram06/multigrid_parallel``: 1D and 3D Poisson solvers
(Dirichlet BCs, uniform grids), V-cycle and FMG drivers with red-black
Gauss-Seidel / weighted-Jacobi smoothers, full-weighting restriction,
trilinear prolongation-and-correct, and a dense direct solve on the
coarsest grid.

Design stance (see SURVEY.md §7): functional, not global-state. A
:class:`~multigrid_parallel.models.Problem` describes the PDE, a
:class:`~multigrid_parallel.hierarchy.Hierarchy` describes the grid
levels, pure ops implement smooth/residual/restrict/prolong/coarse-solve,
and a jit-compiled V-cycle (levels statically unrolled) drives the solve.
Parallelism is `shard_map` over a device mesh with `lax.ppermute` halo
exchange (the replacement for the reference's OpenMP i-slab
decomposition, mg_3d.h:658+).
"""

from multigrid_parallel.hierarchy import Hierarchy, level_sizes
from multigrid_parallel.models import (
    Problem,
    poisson_1d_cos,
    poisson_3d_quadratic,
    poisson_3d_trig,
)
from multigrid_parallel.cycles import (
    CycleConfig,
    v_cycle,
    fmg_initialize,
    solve,
    solve_mixed,
    solve_on_device,
    solve_on_device_mixed,
    SolveResult,
)
from multigrid_parallel.solver import MultigridSolver

# Heavier optional entry points live in submodules (imported lazily by
# users): parallel.sharded / sharded2d / sharded_mixed (multi-device),
# mixed_bc (electrospray), studies (smoother studies), utils.checkpoint
# (save/restore).

__version__ = "0.1.0"

__all__ = [
    "Hierarchy",
    "level_sizes",
    "Problem",
    "poisson_1d_cos",
    "poisson_3d_quadratic",
    "poisson_3d_trig",
    "CycleConfig",
    "v_cycle",
    "fmg_initialize",
    "solve",
    "solve_mixed",
    "solve_on_device",
    "solve_on_device_mixed",
    "SolveResult",
    "MultigridSolver",
]
