"""Brick-engine elasticity (coupled Kronecker blocks) vs the index-engine
ElasticityOperator (itself oracle-tested against a dense assembled matrix in
test_elasticity.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.models.elasticity import (
    ElasticityOperator,
)
from dealii_matrixfree_hanging_nodes.models.elasticity_bricks import (
    BrickElasticity,
)


@pytest.mark.parametrize(
    "dim,geo,nref,p",
    [(2, "quadrant", 3, 2), (3, "quadrant", 2, 2), (3, "quadrant", 3, 3),
     (3, "step", 2, 1)],
)
def test_brick_elasticity_matches_index(dim, geo, nref, p):
    t = mfhn.create_geometry(geo, dim, nref)
    mf = MatrixFree(t, p, dtype=np.float64)
    mu, lam = 1.3, 0.7
    op = ElasticityOperator(mf, mu=mu, lam=lam)
    bl = BrickElasticity(mf, mu=mu, lam=lam)
    rng = np.random.default_rng(0)
    src = rng.standard_normal((mf.n_dofs, dim))
    # conforming input (hanging entries interpolated), like the Laplace tests
    for c in range(dim):
        src[:, c] = mf.constraints.distribute(src[:, c])
    ref = np.asarray(op.vmult(jnp.asarray(src)))
    out = bl.vmult(bl.from_dof_vector(src))
    got = bl.to_dof_vector(out, zero_hanging=True)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-12, (dim, geo, err)


def test_brick_elasticity_rigid_body_nullspace():
    t = mfhn.create_quadrant(3, 2)
    mf = MatrixFree(t, 2, dtype=np.float64)
    bl = BrickElasticity(mf)
    pts = mf.dof_handler.support_points()
    u = np.zeros((mf.n_dofs, 3))
    u[:, 0] = 1.0
    r = bl.to_dof_vector(bl.vmult(bl.from_dof_vector(u)), zero_hanging=True)
    assert np.abs(r).max() < 1e-11
    u = np.stack([-pts[:, 1], pts[:, 0], np.zeros(len(pts))], axis=1)
    r = bl.to_dof_vector(bl.vmult(bl.from_dof_vector(u)), zero_hanging=True)
    assert np.abs(r).max() < 1e-10
