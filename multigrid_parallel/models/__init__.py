"""Problem definitions (the "model zoo" of a PDE framework).

The reference hard-codes its problems as compile-time choices: the analytic
Dirichlet problem ``u = x^2 - 2 y^2 + z^2`` (mg_3d.h:89-94), the 1D
``u'' = cos(x)`` problem (mg_1d.c:151-152, 186-192), and the electrospray
mixed-BC potential problem (mg_3d_bkup.c:12-18). Here each is a
:class:`Problem` value.
"""

from multigrid_parallel.models.poisson import (
    Problem,
    poisson_1d_cos,
    poisson_3d_quadratic,
    poisson_3d_trig,
)
from multigrid_parallel.models.electrospray import electrospray_problem

__all__ = [
    "Problem",
    "poisson_1d_cos",
    "poisson_3d_quadratic",
    "poisson_3d_trig",
    "electrospray_problem",
]
