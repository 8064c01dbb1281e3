import numpy as np
import pytest

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.models.laplace import LaplaceOperator
from dealii_matrixfree_hanging_nodes.oracle import vmult_oracle


CASES = [
    (2, "quadrant", 3, 2),
    (2, "step", 3, 3),
    (3, "quadrant", 3, 1),
    (3, "quadrant", 3, 2),
    (3, "annulus", 5, 2),
    # degrees 5-6 to 1e-12, 2D+3D (BASELINE row 3; reference dispatches
    # degrees 1..6, benchmark_01.cc:34-116)
    (2, "quadrant", 3, 5),
    (2, "quadrant", 3, 6),
    (3, "quadrant", 2, 4),
    (3, "quadrant", 2, 5),
    (3, "quadrant", 2, 6),
]


@pytest.mark.parametrize("dim,geo,nref,p", CASES)
def test_vmult_matches_oracle(dim, geo, nref, p):
    """Matrix-free fast path == assembled C^T A C to 1e-12 (BASELINE target)."""
    t = mfhn.create_geometry(geo, dim, nref)
    mf = MatrixFree(t, p, dtype=np.float64)
    rng = np.random.default_rng(0)
    src = rng.standard_normal(mf.n_dofs)
    ref = vmult_oracle(t, p, src)
    got = np.asarray(LaplaceOperator(mf).vmult(src))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 1e-12 * scale


def test_fast_equals_slow_and_modes():
    """Fast HN algorithm == legacy AffineConstraints path (t4/t5 vs t6/t7
    redundancy, benchmark_01.cc:222-234), and all hn_mode variants agree."""
    t = mfhn.create_quadrant(3, 3)
    p = 3
    rng = np.random.default_rng(1)
    mf = MatrixFree(t, p, dtype=np.float64)
    src = rng.standard_normal(mf.n_dofs)
    base = np.asarray(LaplaceOperator(mf).vmult(src))
    slow = np.asarray(LaplaceOperator(mf, slow=True).vmult(src))
    scale = np.abs(base).max()
    assert np.abs(base - slow).max() < 1e-12 * scale
    for mode in ("all", "sorted", "matrix"):
        mf2 = MatrixFree(t, p, dtype=np.float64, hn_mode=mode)
        got = np.asarray(LaplaceOperator(mf2).vmult(src))
        assert np.abs(got - base).max() < 1e-12 * scale, mode


def test_operator_symmetric_and_constant_nullspace():
    t = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(t, 2, dtype=np.float64)
    op = LaplaceOperator(mf)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(mf.n_dofs)
    y = rng.standard_normal(mf.n_dofs)
    Ax, Ay = np.asarray(op.vmult(x)), np.asarray(op.vmult(y))
    assert abs((Ax * y).sum() - (x * Ay).sum()) < 1e-10 * abs((Ax * y).sum())
    # constants are in the nullspace (pure Neumann operator)
    ones = np.ones(mf.n_dofs)
    r = np.asarray(op.vmult(ones))
    assert np.abs(r).max() < 1e-11


def test_high_order_mapping_reduces_to_cartesian_when_identity():
    t = mfhn.create_quadrant(2, 3)
    p = 2
    mf_cart = MatrixFree(t, p, dtype=np.float64)
    mf_ho = MatrixFree(t, p, dtype=np.float64, high_order_mapping=True)
    # identity transform: override geometry with the deformed-path computation
    from dealii_matrixfree_hanging_nodes.mapping import deformed_laplace_factors
    import jax.numpy as jnp

    geo = deformed_laplace_factors(t, mf_ho.shape, transform=lambda x: x)
    mf_ho._np["geo"] = geo.astype(mf_ho.dtype)
    mf_ho._staged = None  # re-stage with the overridden geometry
    rng = np.random.default_rng(3)
    src = rng.standard_normal(mf_cart.n_dofs)
    a = np.asarray(LaplaceOperator(mf_cart).vmult(src))
    b = np.asarray(LaplaceOperator(mf_ho).vmult(src))
    assert np.abs(a - b).max() < 1e-10 * np.abs(a).max()


def test_deformed_mapping_symmetric():
    t = mfhn.create_quadrant(2, 3)
    mf = MatrixFree(t, 2, dtype=np.float64, high_order_mapping=True)
    op = LaplaceOperator(mf)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(mf.n_dofs)
    y = rng.standard_normal(mf.n_dofs)
    Ax, Ay = np.asarray(op.vmult(x)), np.asarray(op.vmult(y))
    assert abs((Ax * y).sum() - (x * Ay).sum()) < 1e-10 * abs((Ax * y).sum())
