import numpy as np
import jax.numpy as jnp

from dealii_matrixfree_hanging_nodes.elements import shape_info
from dealii_matrixfree_hanging_nodes.dof_handler import local_lattice
from dealii_matrixfree_hanging_nodes.ops.sum_factorization import (
    evaluate_gradients,
    evaluate_values,
    integrate_gradients,
    integrate_values,
)


def _dense_tables(p, dim):
    """Dense [n_q, n_loc] value and gradient evaluation matrices."""
    si = shape_info(p)
    lat = local_lattice(p, dim)
    n_loc = (p + 1) ** dim
    n_q = n_loc
    V = np.ones((n_q, n_loc))
    G = np.zeros((dim, n_q, n_loc))
    # quad point q has per-axis indices like the lattice
    qlat = local_lattice(p, dim)
    for d in range(dim):
        V = V * si.S[np.ix_(qlat[:, d], lat[:, d])]
    for d in range(dim):
        Gd = np.ones((n_q, n_loc))
        for t in range(dim):
            tab = si.D if t == d else si.S
            Gd = Gd * tab[np.ix_(qlat[:, t], lat[:, t])]
        G[d] = Gd
    return V, G


def test_evaluate_matches_dense():
    rng = np.random.default_rng(0)
    for dim in (2, 3):
        for p in (1, 2, 4):
            si = shape_info(p)
            V, G = _dense_tables(p, dim)
            u = rng.standard_normal((5, (p + 1) ** dim))
            S, Dc = jnp.asarray(si.S), jnp.asarray(si.Dc)
            vals = np.asarray(evaluate_values(jnp.asarray(u), S, dim))
            assert np.abs(vals - u @ V.T).max() < 1e-11
            grads = np.asarray(evaluate_gradients(jnp.asarray(u), S, Dc, dim))
            for d in range(dim):
                assert np.abs(grads[:, d] - u @ G[d].T).max() < 1e-10, (dim, p, d)


def test_integrate_is_adjoint():
    rng = np.random.default_rng(1)
    for dim in (2, 3):
        for p in (1, 3):
            si = shape_info(p)
            S, Dc = jnp.asarray(si.S), jnp.asarray(si.Dc)
            n = (p + 1) ** dim
            u = jnp.asarray(rng.standard_normal((4, n)))
            q = jnp.asarray(rng.standard_normal((4, n)))
            qg = jnp.asarray(rng.standard_normal((4, dim, n)))
            # <Eu, q> == <u, E^T q>
            lhs = float(jnp.vdot(evaluate_values(u, S, dim), q))
            rhs = float(jnp.vdot(u, integrate_values(q, S, dim)))
            assert abs(lhs - rhs) < 1e-10 * max(1, abs(lhs))
            lhs = float(jnp.vdot(evaluate_gradients(u, S, Dc, dim), qg))
            rhs = float(jnp.vdot(u, integrate_gradients(qg, S, Dc, dim)))
            assert abs(lhs - rhs) < 1e-10 * max(1, abs(lhs))
