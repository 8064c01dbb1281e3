import numpy as np
import pytest

import dealii_matrixfree_hanging_nodes as mfhn


def test_uniform_counts():
    for dim in (2, 3):
        for r in (0, 1, 2, 3):
            t = mfhn.create_uniform(dim, r)
            assert t.n_active_cells == (2**r) ** dim
            assert t.n_global_levels == r + 1


def test_quadrant_level_count():
    # reference asserts n_global_levels - 1 == n_refinements (benchmark.h:68)
    for dim in (2, 3):
        for r in (1, 2, 3, 4):
            t = mfhn.create_quadrant(dim, r)
            assert t.n_global_levels - 1 == r


def test_quadrant_3d_counts():
    t = mfhn.create_quadrant(3, 2)
    assert t.n_active_cells == 15  # 8 coarse - 1 + 8 children


def test_two_to_one_balance():
    """No two active cells sharing a face (or an edge in 3D) differ by >1 level."""
    for dim, geo, r in ((2, "quadrant", 4), (3, "quadrant", 3), (3, "annulus", 5)):
        t = mfhn.create_geometry(geo, dim, r)
        lmax = int(t.level.max())
        # build occupancy at finest resolution via interval checks per cell pair
        # cheaper: probe every active cell's face/edge-adjacent slots at its own
        # level; covering active ancestor must be >= level-1.
        keys = set(int(k) for k in t.pack(t.level, t.coord))
        offs = t._balance_offsets()
        for i in range(t.n_active_cells):
            l, c = int(t.level[i]), t.coord[i]
            for off in offs:
                nb = c + off
                if np.any(nb < 0) or np.any(nb >= 2**l):
                    continue
                for up in range(2, l + 1):
                    k = int(t.pack(np.array([l - up]), (nb >> up)[None, :])[0])
                    assert k not in keys, (geo, i, l, off)


def test_morton_order_sorted():
    t = mfhn.create_quadrant(3, 3)
    lmax = int(t.level.max())
    anchored = t.coord << (lmax - t.level[:, None])
    from dealii_matrixfree_hanging_nodes.mesh import _interleave_bits

    keys = _interleave_bits(anchored, lmax + 1)
    assert np.all(np.diff(keys.astype(np.int64)) > 0)


def test_cells_tile_domain():
    """Active cells partition the domain: volumes sum to the cube volume."""
    for geo in ("quadrant", "annulus", "step"):
        t = mfhn.create_geometry(geo, 3, 4)
        vol = (t.cell_size() ** 3).sum()
        assert abs(vol - 8.0) < 1e-10


def test_native_fallback_matches_numpy(monkeypatch):
    """The NumPy fallback paths (used on compiler-less hosts) must produce the
    same mesh and DoF numbering as the native setup core."""
    from dealii_matrixfree_hanging_nodes import native
    from dealii_matrixfree_hanging_nodes.dof_handler import DoFHandler

    if not native.available():
        pytest.skip("native core not built; fallback is the only path")

    cases = [("quadrant", 2, 3), ("quadrant", 3, 2), ("annulus", 3, 4),
             ("step", 2, 3)]
    ref = {}
    for geo, dim, r in cases:
        t = mfhn.create_geometry(geo, dim, r)
        dh = DoFHandler(t, 3)
        ref[(geo, dim, r)] = (t.level.copy(), t.coord.copy(),
                              dh.cell_dofs.copy(), dh.n_dofs)

    monkeypatch.setattr(native, "balance_flags", lambda *a, **k: None)
    monkeypatch.setattr(native, "dof_unique", lambda *a, **k: None)
    monkeypatch.setattr(native, "distribute_dofs", lambda *a, **k: None)
    for geo, dim, r in cases:
        t = mfhn.create_geometry(geo, dim, r)
        dh = DoFHandler(t, 3)
        lv, co, cd, nd = ref[(geo, dim, r)]
        np.testing.assert_array_equal(t.level, lv)
        np.testing.assert_array_equal(t.coord, co)
        np.testing.assert_array_equal(dh.cell_dofs, cd)
        assert dh.n_dofs == nd


def test_level_cap_enforced():
    t = mfhn.create_uniform(2, 1)
    with pytest.raises(ValueError, match="15"):
        t.pack(np.array([16]), np.array([[0, 0]]))
