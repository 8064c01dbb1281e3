import numpy as np
import pytest

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.constraints import (
    build_constraints,
    decompress_mask,
)
from dealii_matrixfree_hanging_nodes.dof_handler import DoFHandler


CASES = [
    (2, "quadrant", 3),
    (2, "step", 3),
    (3, "quadrant", 3),
    (3, "step", 2),
    (3, "annulus", 5),
]


@pytest.mark.parametrize("dim,geo,nref", CASES)
@pytest.mark.parametrize("p", [1, 2, 4, 6])
def test_polynomial_reproduction(dim, geo, nref, p):
    """Hanging-node rows must be exact for any tensor polynomial of degree p
    (FE space continuity) — oracle for both weights and detection."""
    t = mfhn.create_geometry(geo, dim, nref)
    dh = DoFHandler(t, p)
    ci = build_constraints(dh)
    pts = dh.support_points()
    rng = np.random.default_rng(1)
    coef = rng.standard_normal((dim, p + 1))
    u = np.ones(len(pts))
    for d in range(dim):
        u *= np.polyval(coef[d], pts[:, d])
    v = ci.distribute(u)
    assert np.abs(v - u).max() < 1e-10 * max(1.0, np.abs(u).max())


@pytest.mark.parametrize("dim,geo,nref", CASES)
def test_census_consistency(dim, geo, nref):
    """n_cells_n + n_cells_hn == n_cells (benchmark_01.h:407-411 invariant)."""
    t = mfhn.create_geometry(geo, dim, nref)
    dh = DoFHandler(t, 1)
    ci = build_constraints(dh)
    n_hn = ci.n_constrained_cells
    assert 0 <= n_hn <= t.n_active_cells
    sub, face, edge = decompress_mask(ci.masks, dim)
    constrained = (face | edge) != 0
    assert constrained.sum() == n_hn
    # subcell bits match coordinate parity for constrained cells
    for d in range(dim):
        sd = (t.coord[:, d] & 1).astype(sub.dtype)
        assert np.all(((sub >> d) & 1)[constrained] == sd[constrained])


def test_edge_only_constraints_exist_3d():
    """The quadrant mesh exercises pure edge constraints (the subtle
    constraint_helper.h:10-85 case)."""
    t = mfhn.create_quadrant(3, 3)
    dh = DoFHandler(t, 2)
    ci = build_constraints(dh)
    _, face, edge = decompress_mask(ci.masks, 3)
    assert np.count_nonzero(edge) > 0


def test_masters_unconstrained():
    """2:1 balance invariant: no constraint chains, fast map never references
    a hanging DoF (asserted in build, re-checked here)."""
    t = mfhn.create_quadrant(3, 3)
    dh = DoFHandler(t, 3)
    ci = build_constraints(dh)
    hanging = np.zeros(dh.n_dofs, bool)
    hanging[ci.slave_dofs] = True
    assert not hanging[ci.col].any()
    assert not hanging[ci.cell_dofs_fast.ravel()].any()


def test_mask_memory_consumption():
    """Compressed masks are far smaller than the row representation
    (info_01.cc comparison)."""
    t = mfhn.create_quadrant(3, 4)
    dh = DoFHandler(t, 4)
    ci = build_constraints(dh)
    assert ci.memory_consumption_masks() < ci.memory_consumption_matrix()


def test_error_paths():
    import pytest as _pt
    from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
    from dealii_matrixfree_hanging_nodes.bricks import BrickStructure

    t = mfhn.create_quadrant(3, 2)
    with _pt.raises(ValueError):
        MatrixFree(t, 2, hn_mode="bogus")
    with _pt.raises(ValueError):
        mfhn.create_geometry("bogus", 3, 2)
    mf = MatrixFree(t, 2, dtype=np.float64, categorize=True)
    with _pt.raises(ValueError):
        BrickStructure(mf)


def test_2d_annulus_constraints():
    t = mfhn.create_annulus(2, 5)
    assert t.n_global_levels >= 3
    dh = DoFHandler(t, 4)
    ci = build_constraints(dh)
    pts = dh.support_points()
    rng = np.random.default_rng(9)
    coef = rng.standard_normal((2, 5))
    u = np.polyval(coef[0], pts[:, 0]) * np.polyval(coef[1], pts[:, 1])
    v = ci.distribute(u)
    assert np.abs(v - u).max() < 1e-10 * max(1.0, np.abs(u).max())


def test_degree10_entity_markers_unique():
    """Regression: the old marker sz*8+ia aliased across levels for p>=10,
    silently merging distinct nodes into one DoF. Every global DoF must have
    a single consistent support point across all cells writing it."""
    from dealii_matrixfree_hanging_nodes.dof_handler import DoFHandler

    t = mfhn.create_quadrant(2, 2)
    dh = DoFHandler(t, 10)
    pts = dh.support_points()
    nodes = dh.shape.nodes
    h = t.cell_size()
    lower = t.cell_lower()
    loc = nodes[dh._lat]  # [n_loc, dim]
    coords = lower[:, None, :] + h[:, None, None] * loc[None, :, :]
    # every writer of a DoF must agree with the recorded support point
    err = np.abs(pts[dh.cell_dofs.ravel()] - coords.reshape(-1, t.dim)).max()
    assert err < 1e-12


@pytest.mark.parametrize("dim,geo,nref", CASES)
def test_helper_census_matches_masks(dim, geo, nref):
    """Two-oracle redundancy (benchmark_03.h:412-432): the pure-topology
    Helper detector and the compressed-mask builder must agree cell by cell
    on which cells are hanging-node constrained."""
    from dealii_matrixfree_hanging_nodes.constraint_helper import Helper

    t = mfhn.create_geometry(geo, dim, nref)
    dh = DoFHandler(t, 2)
    ci = build_constraints(dh)
    h = Helper(t)
    np.testing.assert_array_equal(h.is_constrained(), ci.masks != 0)
    n_hn, n_n = h.census()
    assert n_hn + n_n == t.n_active_cells
    assert n_hn == ci.n_constrained_cells
