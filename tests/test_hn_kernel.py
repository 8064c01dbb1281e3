import numpy as np
import jax.numpy as jnp
import pytest

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.constraints import build_constraints
from dealii_matrixfree_hanging_nodes.dof_handler import DoFHandler
from dealii_matrixfree_hanging_nodes.elements import shape_info
from dealii_matrixfree_hanging_nodes.ops.hanging_nodes import (
    apply_hanging_node_constraints,
)


def test_unconstrained_mask_is_identity():
    si = shape_info(3)
    rng = np.random.default_rng(0)
    for dim in (2, 3):
        v = rng.standard_normal((4, 4**dim))
        out = apply_hanging_node_constraints(
            jnp.asarray(v), jnp.zeros(4, jnp.int32), jnp.asarray(si.P), dim
        )
        assert np.abs(np.asarray(out) - v).max() == 0.0


def test_standalone_synthetic_mask():
    """Meshless factory-style call on one synthetic mask, as in
    benchmark_00_likwid.cc:41-59 (subcell=1, faces=0b111, edges=0)."""
    p, dim = 4, 3
    si = shape_info(p)
    mask = 1 | (0b111 << 3)
    v = np.random.default_rng(2).standard_normal((1, (p + 1) ** 3))
    out = apply_hanging_node_constraints(
        jnp.asarray(v), jnp.asarray([mask], dtype=jnp.int32), jnp.asarray(si.P), dim
    )
    out = np.asarray(out)
    assert np.isfinite(out).all()
    # untouched interior nodes pass through
    lat = np.stack(
        [(np.arange((p + 1) ** 3) // (p + 1) ** a) % (p + 1) for a in range(3)], 1
    )
    interior = np.all((lat != 0) & (lat != p), axis=1)
    # subcell=1 only sets s_0: constrained planes are x==p, y==0, z==0
    untouched = (lat[:, 0] != p) & (lat[:, 1] != 0) & (lat[:, 2] != 0)
    assert np.abs(out[0, untouched] - v[0, untouched]).max() == 0.0
    assert np.abs(out[0, ~untouched] - v[0, ~untouched]).max() > 0


@pytest.mark.parametrize("dim,geo,nref,p", [(2, "quadrant", 3, 2), (3, "quadrant", 3, 2), (3, "quadrant", 3, 3)])
def test_kernel_matches_constraint_rows(dim, geo, nref, p):
    """Gather(fast map) + interpolation == slow-path distribute, per cell."""
    t = mfhn.create_geometry(geo, dim, nref)
    dh = DoFHandler(t, p)
    ci = build_constraints(dh)
    si = shape_info(p)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(dh.n_dofs)
    u_dist = ci.distribute(u)  # conforming values everywhere
    got = apply_hanging_node_constraints(
        jnp.asarray(u_dist[ci.cell_dofs_fast]),
        jnp.asarray(ci.masks.astype(np.int32)),
        jnp.asarray(si.P),
        dim,
    )
    want = u_dist[dh.cell_dofs]
    assert np.abs(np.asarray(got) - want).max() < 1e-12


def test_transpose_is_exact_adjoint():
    p, dim = 3, 3
    t = mfhn.create_quadrant(dim, 3)
    dh = DoFHandler(t, p)
    ci = build_constraints(dh)
    si = shape_info(p)
    rng = np.random.default_rng(4)
    m = t.n_active_cells
    a = rng.standard_normal((m, (p + 1) ** dim))
    b = rng.standard_normal((m, (p + 1) ** dim))
    masks = jnp.asarray(ci.masks.astype(np.int32))
    P = jnp.asarray(si.P)
    Fa = np.asarray(apply_hanging_node_constraints(jnp.asarray(a), masks, P, dim))
    FTb = np.asarray(
        apply_hanging_node_constraints(jnp.asarray(b), masks, P, dim, transpose=True)
    )
    lhs = float((Fa * b).sum())
    rhs = float((a * FTb).sum())
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_multi_component_matches_per_component():
    """n_components>1 (the reference factory's vector-valued signature,
    benchmark_00_likwid.cc:56-59) equals applying the scalar kernel to each
    component block."""
    p, dim, nc = 2, 3, 3
    t = mfhn.create_quadrant(dim, 3)
    dh = DoFHandler(t, p)
    ci = build_constraints(dh)
    si = shape_info(p)
    rng = np.random.default_rng(5)
    m = t.n_active_cells
    n_loc = (p + 1) ** dim
    a = rng.standard_normal((m, nc * n_loc))
    masks = jnp.asarray(ci.masks.astype(np.int32))
    P = jnp.asarray(si.P)
    for tr in (False, True):
        got = np.asarray(apply_hanging_node_constraints(
            jnp.asarray(a), masks, P, dim, transpose=tr, n_components=nc))
        for c in range(nc):
            want = np.asarray(apply_hanging_node_constraints(
                jnp.asarray(a.reshape(m, nc, n_loc)[:, c]), masks, P, dim,
                transpose=tr))
            d = np.abs(got.reshape(m, nc, n_loc)[:, c] - want).max()
            assert d == 0.0
