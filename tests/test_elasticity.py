import numpy as np
import jax.numpy as jnp

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.dof_handler import local_lattice
from dealii_matrixfree_hanging_nodes.elements import shape_info
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.models.elasticity import ElasticityOperator


def _dense_grad_tables(p, dim):
    si = shape_info(p)
    lat = local_lattice(p, dim)
    qlat = local_lattice(p, dim)
    n_loc = (p + 1) ** dim
    G = np.zeros((dim, n_loc, n_loc))  # G[d, q, i] = dN_i/dref_d (x_q)
    for d in range(dim):
        Gd = np.ones((n_loc, n_loc))
        for t in range(dim):
            tab = si.D if t == d else si.S
            Gd = Gd * tab[np.ix_(qlat[:, t], lat[:, t])]
        G[d] = Gd
    w = si.quad_weights_tensor(dim)
    return G, w


def _oracle_elasticity(tria, p, mu, lam, src):
    """Dense-assembled C^T A C for elasticity, component-fastest layout."""
    import scipy.sparse as sp
    from dealii_matrixfree_hanging_nodes.constraints import build_constraints
    from dealii_matrixfree_hanging_nodes.dof_handler import DoFHandler

    dim = tria.dim
    dh = DoFHandler(tria, p)
    ci = build_constraints(dh)
    G, w = _dense_grad_tables(p, dim)
    n_loc = G.shape[1]
    h = tria.cell_size()
    rows, cols, vals = [], [], []
    for c_idx in range(tria.n_active_cells):
        hx = h[c_idx]
        detj = hx**dim
        g = G / hx  # physical gradients
        A_loc = np.zeros((n_loc, dim, n_loc, dim))
        for cc in range(dim):
            for e in range(dim):
                term = np.zeros((n_loc, n_loc))
                if cc == e:
                    for ax in range(dim):
                        term += mu * np.einsum("q,qi,qj->ij", w, g[ax], g[ax])
                term += mu * np.einsum("q,qi,qj->ij", w, g[e], g[cc])
                term += lam * np.einsum("q,qi,qj->ij", w, g[cc], g[e])
                A_loc[:, cc, :, e] = detj * term
        gid = dh.cell_dofs[c_idx]
        big = (gid[:, None] * dim + np.arange(dim)[None, :]).ravel()
        rows.append(np.repeat(big, n_loc * dim))
        cols.append(np.tile(big, n_loc * dim))
        vals.append(A_loc.reshape(n_loc * dim, n_loc * dim).ravel())
    N = dh.n_dofs * dim
    A = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(N, N),
    )
    Cs = ci.expansion_matrix()
    C = sp.kron(Cs, sp.eye(dim), format="csr")
    return (C.T @ (A @ (C @ src.ravel()))).reshape(dh.n_dofs, dim)


def test_elasticity_matches_oracle():
    for dim, geo, nref, p in ((2, "quadrant", 3, 2), (3, "quadrant", 2, 2)):
        t = mfhn.create_geometry(geo, dim, nref)
        mf = MatrixFree(t, p, dtype=np.float64)
        mu, lam = 1.3, 0.7
        op = ElasticityOperator(mf, mu=mu, lam=lam)
        rng = np.random.default_rng(0)
        src = rng.standard_normal((mf.n_dofs, dim))
        ref = _oracle_elasticity(t, p, mu, lam, src)
        got = np.asarray(op.vmult(jnp.asarray(src)))
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err < 1e-12, (dim, geo, err)


def test_elasticity_symmetric():
    t = mfhn.create_quadrant(3, 2)
    mf = MatrixFree(t, 2, dtype=np.float64)
    op = ElasticityOperator(mf)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((mf.n_dofs, 3))
    y = rng.standard_normal((mf.n_dofs, 3))
    Ax = np.asarray(op.vmult(jnp.asarray(x)))
    Ay = np.asarray(op.vmult(jnp.asarray(y)))
    assert abs((Ax * y).sum() - (x * Ay).sum()) < 1e-9 * abs((Ax * y).sum())


def test_elasticity_rigid_body_nullspace():
    """Translations and (linearized) rotations are in the nullspace."""
    t = mfhn.create_quadrant(3, 2)
    mf = MatrixFree(t, 2, dtype=np.float64)
    op = ElasticityOperator(mf)
    pts = mf.dof_handler.support_points()
    # translation
    u = np.zeros((mf.n_dofs, 3))
    u[:, 0] = 1.0
    r = np.asarray(op.vmult(jnp.asarray(u)))
    assert np.abs(r).max() < 1e-11
    # rotation around z: u = (-y, x, 0)
    u = np.stack([-pts[:, 1], pts[:, 0], np.zeros(len(pts))], axis=1)
    r = np.asarray(op.vmult(jnp.asarray(u)))
    assert np.abs(r).max() < 1e-10
