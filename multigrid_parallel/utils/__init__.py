"""Auxiliary subsystems: instrumentation, postprocessing, norms."""

from multigrid_parallel.utils.timing import TimingInfo, STAGE_NAMES
from multigrid_parallel.utils.vtk import write_vtk

__all__ = ["TimingInfo", "STAGE_NAMES", "write_vtk"]
