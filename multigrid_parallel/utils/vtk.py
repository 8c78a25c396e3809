"""Legacy ASCII VTK structured-grid writer (postprocess.h:5-47 parity).

Writes the same file layout the reference produces for ParaView: header,
explicit DATASET STRUCTURED_GRID point coordinates, then POINT_DATA
scalars. Two backends:

  * a native C++ writer (native/vtk_writer.cpp, loaded via ctypes) — the
    reference's postprocess.h is C; ours keeps IO native for speed on
    large grids;
  * a pure-Python fallback (always available).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_NATIVE = None


def _load_native():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    lib = Path(__file__).resolve().parents[2] / "native" / "build" / "libmg_native.so"
    if lib.exists():
        try:
            dll = ctypes.CDLL(str(lib))
            dll.mg_write_vtk.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_double,
                ctypes.c_int,
            ]
            dll.mg_write_vtk.restype = ctypes.c_int
            _NATIVE = dll
        except OSError:
            _NATIVE = False
    else:
        _NATIVE = False
    return _NATIVE


def write_vtk(file_name: str, grid, h: float, n: int | None = None) -> None:
    """Write an n^3 scalar field as legacy ASCII VTK (postprocess.h:5-47).

    ``grid`` is any array-like of shape (n, n, n); ``h`` the grid spacing.
    """
    data = np.asarray(grid, dtype=np.float64)
    if n is None:
        n = data.shape[0]
    assert data.shape == (n, n, n), f"expected cube ({n},)*3, got {data.shape}"

    native = _load_native()
    if native:
        flat = np.ascontiguousarray(data.reshape(-1))
        rc = native.mg_write_vtk(
            os.fsencode(file_name),
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_double(h),
            ctypes.c_int(n),
        )
        if rc == 0:
            return
        # fall through to Python writer on failure

    with open(file_name, "w") as fh:
        # Header block (postprocess.h:13-21)
        fh.write("# vtk DataFile Version 2.0\n")
        fh.write("Multigrid output data\n")
        fh.write("ASCII\n")
        fh.write("DATASET STRUCTURED_GRID\n")
        fh.write(f"DIMENSIONS {n} {n} {n}\n")
        fh.write(f"POINTS {n * n * n} double\n")
        # Point coordinates, k fastest (postprocess.h:22-34; the reference
        # loops i outer, j, k inner and prints x=i*h y=j*h z=k*h).
        coords = np.arange(n) * h
        x = np.repeat(coords, n * n)
        y = np.tile(np.repeat(coords, n), n)
        z = np.tile(coords, n * n)
        np.savetxt(fh, np.column_stack([x, y, z]), fmt="%.10g %.10g %.10g")
        # Scalars (postprocess.h:37-44)
        fh.write(f"POINT_DATA {n * n * n}\n")
        fh.write("SCALARS OutputData double 1\n")
        fh.write("LOOKUP_TABLE default\n")
        np.savetxt(fh, data.reshape(-1), fmt="%.10g")
