"""Tests for auxiliary subsystems: hierarchy, VTK writer, edge smoothing."""

import numpy as np
import jax.numpy as jnp
import pytest

from multigrid_parallel.hierarchy import (
    Hierarchy,
    apply_boundary,
    boundary_mask,
    evaluate_on_grid,
    is_power_of_two,
    level_sizes,
)
from multigrid_parallel.models.electrospray import electrospray_problem
from multigrid_parallel.ops import stencils_3d as ops
from multigrid_parallel.utils.vtk import write_vtk


def test_level_sizes_matches_reference_formula():
    # finestOneSideNum = (coarseN-1)*2^(levels-1)+1 (mg_3d.h:127)
    assert level_sizes(5, 4) == (5, 9, 17, 33)
    assert level_sizes(3, 7) == (3, 5, 9, 17, 33, 65, 129)
    with pytest.raises(ValueError):
        level_sizes(6, 3)  # 5 not a power of two


def test_is_power_of_two():
    assert all(is_power_of_two(1 << k) for k in range(10))
    assert not any(is_power_of_two(v) for v in (0, 3, 6, 12, -4))


def test_hierarchy_spacings():
    h = Hierarchy(ndim=3, coarse_n=5, num_levels=3, length=2.0)
    assert h.finest_n == 17
    assert h.finest_spacing == pytest.approx(2.0 / 16)
    assert h.spacing(0) == pytest.approx(2.0 / 4)  # doubles per level


def test_apply_boundary_only_touches_boundary():
    n = 7
    arr = jnp.zeros((n, n, n))
    vals = jnp.ones((n, n, n))
    out = np.asarray(apply_boundary(arr, vals))
    m = boundary_mask(n, 3)
    assert np.all(out[m] == 1.0) and np.all(out[~m] == 0.0)


def test_evaluate_on_grid_3d():
    h = Hierarchy(ndim=3, coarse_n=5, num_levels=1, length=1.0)
    g = np.asarray(evaluate_on_grid(lambda x, y, z: x + 10 * y + 100 * z, h, 0))
    assert g[1, 2, 3] == pytest.approx(0.25 + 10 * 0.5 + 100 * 0.75)


def test_vtk_writer_roundtrip(tmp_path):
    n, h = 5, 0.25
    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, n, n))
    path = tmp_path / "out.vtk"
    write_vtk(str(path), data, h, n)
    text = path.read_text().splitlines()
    assert text[0].startswith("# vtk DataFile")
    assert f"DIMENSIONS {n} {n} {n}" in text
    assert f"POINTS {n**3} double" in text
    # scalars round-trip
    idx = text.index("LOOKUP_TABLE default") + 1
    vals = np.array([float(v) for v in text[idx : idx + n**3]])
    np.testing.assert_allclose(vals, data.reshape(-1), rtol=1e-9)
    # point coordinates: first point is origin, second increments z
    first = [float(v) for v in text[6].split()]
    second = [float(v) for v in text[7].split()]
    assert first == [0.0, 0.0, 0.0]
    assert second == [0.0, 0.0, h]


def test_update_edge_values_averages_neighbors():
    n = 5
    rng = np.random.default_rng(1)
    u = rng.standard_normal((n, n, n))
    out = np.asarray(ops.update_edge_values(jnp.asarray(u)))
    # interior untouched
    np.testing.assert_array_equal(out[1:-1, 1:-1, 1:-1], u[1:-1, 1:-1, 1:-1])
    # an edge point (0,0,k) = avg of (1,0,k) and (0,1,k) (mg_3d.h:304-392)
    k = 2
    assert out[0, 0, k] == pytest.approx(0.5 * (u[1, 0, k] + u[0, 1, k]))


def test_electrospray_masks_geometry():
    p = electrospray_problem()
    n = 33
    mask, vals = p.boundary_masks(n)
    # capillary disk on X=0 face around the center, at 0 V
    assert mask[0, n // 2, n // 2]
    assert vals[0, n // 2, n // 2] == 0.0
    # extractor annulus on X=N-1: center NOT pinned, ring pinned at -1350
    assert not mask[n - 1, n // 2, n // 2]
    ring_j = n // 2 + int(round(1.2e-4 / (p.length / (n - 1))))
    assert mask[n - 1, ring_j, n // 2]
    assert vals[n - 1, ring_j, n // 2] == -1350.0
    # nothing pinned on interior slabs
    assert not mask[1:-1].any()


def test_apply_neumann_copy_full_faces():
    n = 5
    rng = np.random.default_rng(2)
    u = rng.standard_normal((n, n, n))
    out = np.asarray(ops.apply_neumann_copy(jnp.asarray(u)))
    # face interiors equal the adjacent interior plane (later faces
    # overwrite the shared edges, so compare interiors only)
    s = slice(1, -1)
    np.testing.assert_array_equal(out[0, s, s], u[1, s, s])
    np.testing.assert_array_equal(out[-1, s, s], u[-2, s, s])
    np.testing.assert_array_equal(out[s, 0, s], u[s, 1, s])
    np.testing.assert_array_equal(out[s, s, 0], u[s, s, 1])
