import numpy as np

from dealii_matrixfree_hanging_nodes.elements import (
    ShapeInfo,
    gauss_lobatto_points,
    gauss_points,
    lagrange_derivatives,
    lagrange_values,
)


def test_gauss_exactness():
    for n in range(1, 8):
        x, w = gauss_points(n)
        # exact for polynomials up to degree 2n-1 on [0,1]
        for k in range(2 * n):
            assert abs((w * x**k).sum() - 1.0 / (k + 1)) < 1e-13


def test_gauss_lobatto_endpoints_and_symmetry():
    for n in range(2, 8):
        x = gauss_lobatto_points(n)
        assert x[0] == 0.0 and x[-1] == 1.0
        assert np.allclose(x + x[::-1], 1.0, atol=1e-14)


def test_lagrange_cardinal():
    nodes = gauss_lobatto_points(5)
    V = lagrange_values(nodes, nodes)
    assert np.allclose(V, np.eye(5), atol=1e-12)


def test_lagrange_derivative_vs_fd():
    nodes = gauss_lobatto_points(4)
    x = np.linspace(0.05, 0.95, 7)
    eps = 1e-6
    d = lagrange_derivatives(nodes, x)
    fd = (lagrange_values(nodes, x + eps) - lagrange_values(nodes, x - eps)) / (2 * eps)
    assert np.abs(d - fd).max() < 1e-8


def test_shape_info_tables():
    for p in range(1, 7):
        si = ShapeInfo(p)
        # partition of unity and derivative-sum zero
        assert np.allclose(si.S.sum(axis=1), 1.0, atol=1e-12)
        assert np.abs(si.D.sum(axis=1)).max() < 1e-10
        assert np.allclose(si.P[0].sum(axis=1), 1.0, atol=1e-12)
        assert np.allclose(si.P[1].sum(axis=1), 1.0, atol=1e-12)
        # subface embedding reproduces polynomials: P0 @ f(nodes) == f(nodes/2)
        f = lambda x: (x + 0.3) ** p
        assert np.allclose(si.P[0] @ f(si.nodes), f(si.nodes / 2), atol=1e-10)
        assert np.allclose(si.P[1] @ f(si.nodes), f((si.nodes + 1) / 2), atol=1e-10)
        # collocation derivative differentiates degree-p polys at quad points
        g = np.polyval(np.arange(p + 1) + 1.0, si.quad_x)
        dg = np.polyval(np.polyder(np.arange(p + 1) + 1.0), si.quad_x)
        assert np.abs(si.Dc @ g - dg).max() < 1e-9
