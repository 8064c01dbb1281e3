import numpy as np
import jax.numpy as jnp
import pytest

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.models.multigrid import (
    ChebyshevSmoother,
    DirichletLaplace,
    GMGPreconditioner,
    Transfer,
    operator_diagonal,
    solve_cg,
)


def _dirichlet_setup(nref=3, p=2, dim=3, geo="quadrant"):
    t = mfhn.create_geometry(geo, dim, nref)
    mf = MatrixFree(t, p, dtype=np.float64)
    return mf, DirichletLaplace(mf)


def test_diagonal_matches_oracle():
    from dealii_matrixfree_hanging_nodes.oracle import assemble_laplace

    t = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(t, 2, dtype=np.float64)
    op = DirichletLaplace(mf)
    diag = np.asarray(operator_diagonal(op, mf))
    A, C, dh, ci = assemble_laplace(t, 2)
    ref = np.asarray((C.T @ A @ C).diagonal())
    assert np.abs(diag - ref).max() < 1e-11 * max(1, np.abs(ref).max())


def test_dirichlet_operator_spd():
    mf, op = _dirichlet_setup()
    rng = np.random.default_rng(0)
    hanging = mf.constraints.constrained_dof_marker()
    x = rng.standard_normal(mf.n_dofs)
    x[hanging] = 0.0
    y = rng.standard_normal(mf.n_dofs)
    y[hanging] = 0.0
    Ax = np.asarray(op.vmult(jnp.asarray(x)))
    Ay = np.asarray(op.vmult(jnp.asarray(y)))
    assert abs((Ax * y).sum() - (x * Ay).sum()) < 1e-9 * abs((Ax * y).sum())
    # positive on the constrained-free subspace
    z = x.copy()
    z[np.asarray(op.bdofs)] = 0.0
    Az = np.asarray(op.vmult(jnp.asarray(z)))
    assert (z * Az).sum() >= -1e-10


def test_cg_solves_poisson():
    mf, op = _dirichlet_setup(nref=3, p=2)
    rng = np.random.default_rng(1)
    xstar = rng.standard_normal(mf.n_dofs)
    xstar = mf.constraints.distribute(xstar)  # consistent hanging values
    xstar = np.asarray(jnp.asarray(xstar).at[op.bdofs].set(0.0))
    b = op.vmult(jnp.asarray(xstar))
    x, iters, res = solve_cg(op, b, tol=1e-10, max_iter=2000)
    # compare on the unconstrained dofs (solution unique there)
    free = ~mf.constraints.constrained_dof_marker()
    err = np.abs(np.asarray(x)[free] - xstar[free]).max()
    assert err < 1e-6, (iters, res, err)


def test_chebyshev_smoother_reduces_residual():
    mf, op = _dirichlet_setup(nref=3, p=2)
    diag = operator_diagonal(op, mf).at[op.bdofs].set(1.0)
    sm = ChebyshevSmoother(op, diag, degree=4)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(mf.n_dofs)
    b[mf.constraints.constrained_dof_marker()] = 0.0
    b = np.asarray(op.project_rhs(jnp.asarray(b)))
    x = sm.apply(jnp.asarray(b))
    r = np.linalg.norm(np.asarray(op.vmult(x)) - b)
    assert r < np.linalg.norm(b)


def test_transfer_adjoint_and_poly_reproduction():
    t_c = mfhn.create_quadrant(3, 2)
    t_f = mfhn.create_quadrant(3, 3)
    p = 2
    mfc = MatrixFree(t_c, p, dtype=np.float64)
    mff = MatrixFree(t_f, p, dtype=np.float64)
    tr = Transfer(mfc, mff)
    rng = np.random.default_rng(3)
    # adjointness <P xc, yf> == <xc, R yf>
    xc = rng.standard_normal(mfc.n_dofs)
    yf = rng.standard_normal(mff.n_dofs)
    Pz = np.asarray(tr.prolongate(jnp.asarray(xc)))
    Ry = np.asarray(tr.restrict(jnp.asarray(yf)))
    lhs, rhs = (Pz * yf).sum(), (xc * Ry).sum()
    assert abs(lhs - rhs) < 1e-10 * max(1, abs(lhs))
    # polynomial reproduction: interpolant of a degree-p polynomial prolongates
    # to the fine interpolant of the same polynomial
    pts_c = mfc.dof_handler.support_points()
    pts_f = mff.dof_handler.support_points()
    coef = rng.standard_normal((3, p + 1))
    fc = np.ones(len(pts_c))
    ff = np.ones(len(pts_f))
    for d in range(3):
        fc *= np.polyval(coef[d], pts_c[:, d])
        ff *= np.polyval(coef[d], pts_f[:, d])
    got = np.asarray(tr.prolongate(jnp.asarray(fc)))
    # hanging fine dofs carry distributed (interpolated) values == ff as well
    assert np.abs(got - ff).max() < 1e-9 * max(1.0, np.abs(ff).max())


@pytest.mark.slow
def test_gmg_preconditioned_cg_converges_fast():
    gmg = GMGPreconditioner("quadrant", 3, 3, 2, n_smooth=3)
    op = gmg.fine_op
    mf = gmg.fine_mf
    rng = np.random.default_rng(4)
    xstar = mf.constraints.distribute(rng.standard_normal(mf.n_dofs))
    xstar = np.asarray(jnp.asarray(xstar).at[op.bdofs].set(0.0))
    b = op.vmult(jnp.asarray(xstar))
    x, iters, res = solve_cg(op, b, M=gmg, tol=1e-10, max_iter=100)
    free = ~mf.constraints.constrained_dof_marker()
    err = np.abs(np.asarray(x)[free] - xstar[free]).max()
    assert err < 1e-6
    assert iters < 30, iters  # GMG should converge in O(10) iterations


@pytest.mark.slow
def test_distributed_gmg_cg_matches_single_chip():
    """Multi-chip Chebyshev-GMG-CG (BASELINE row 4): same iteration count and
    solution as the single-chip preconditioner on an 8-device mesh."""
    import jax
    from dealii_matrixfree_hanging_nodes.parallel.multigrid_distributed import (
        DistributedGMGPreconditioner,
    )

    nref, p = 3, 2
    gmg = GMGPreconditioner("quadrant", 3, nref, p)
    op, mf = gmg.fine_op, gmg.fine_mf
    rng = np.random.default_rng(0)
    xstar = mf.constraints.distribute(rng.standard_normal(mf.n_dofs))
    xstar = np.asarray(jnp.asarray(xstar).at[op.bdofs].set(0.0))
    b = op.vmult(jnp.asarray(xstar))
    x, it1, _ = solve_cg(op, b, M=gmg, tol=1e-10, max_iter=100)

    dgmg = DistributedGMGPreconditioner(
        "quadrant", 3, nref, p, devices=jax.devices()[:8]
    )
    dop = dgmg.fine_op
    xd, it2, _ = solve_cg(dop, dop.scatter_vector(np.asarray(b)), M=dgmg,
                          tol=1e-10, max_iter=100)
    assert it2 == it1
    free = ~mf.constraints.constrained_dof_marker()
    err = np.abs(dop.gather_vector(xd)[free] - np.asarray(x)[free]).max()
    assert err < 1e-8


# ---------------------------------------------------------------- brick GMG
def test_laplace_diagonal_host_matches_device_probing():
    from dealii_matrixfree_hanging_nodes.models.multigrid import (
        laplace_diagonal_host,
    )

    mf, op = _dirichlet_setup(nref=3, p=2)
    dev = np.asarray(operator_diagonal(op, mf))
    host = laplace_diagonal_host(mf)
    # rows the smoother actually uses: free (non-hanging) non-Dirichlet.
    # Boundary rows are identity in the device op (set to 1 downstream) and
    # hanging rows are refilled, so only these rows must agree.
    use = ~mf.constraints.constrained_dof_marker()
    use[np.asarray(op.bdofs)] = False
    assert np.abs((dev - host)[use]).max() < 1e-11 * max(1, np.abs(dev).max())


@pytest.mark.slow
def test_brick_refill_restores_invariant():
    """refill recomputes every hanging copy from masters after a pointwise
    mask breaks the invariant (the GMG stack's Dirichlet/diagonal ops)."""
    from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM
    from dealii_matrixfree_hanging_nodes.models.multigrid_bricks import (
        BrickDirichletLaplace,
    )

    for geo, nref, p in [("quadrant", 3, 2), ("annulus", 3, 3)]:
        t = mfhn.create_geometry(geo, 3, nref)
        mf = MatrixFree(t, p, dtype=np.float64)
        mm = BrickLaplaceMM(mf)
        op = BrickDirichletLaplace(mm)
        rng = np.random.default_rng(11)
        u = rng.standard_normal(mf.n_dofs)
        bv = mm.from_dof_vector(u)
        # mask in dof space, re-embed = oracle (from_dof_vector distributes
        # hanging rows from the masked masters)
        bmark = np.zeros(mf.n_dofs, dtype=bool)
        bmark[np.asarray(mf.dof_handler.boundary_dofs())] = True
        u_masked = np.where(bmark, 0.0, mf.constraints.distribute(u))
        ref = np.asarray(mm.from_dof_vector(u_masked))
        got = np.asarray(mm.refill(bv * op.keep))
        assert np.abs(got - ref).max() < 1e-12 * max(1, np.abs(ref).max())


@pytest.mark.slow
def test_brick_transfer_matches_index_transfer():
    from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM
    from dealii_matrixfree_hanging_nodes.models.multigrid_bricks import (
        BrickTransfer,
    )

    p = 2
    mfc = MatrixFree(mfhn.create_quadrant(3, 2), p, dtype=np.float64)
    mff = MatrixFree(mfhn.create_quadrant(3, 3), p, dtype=np.float64)
    mmc, mmf = BrickLaplaceMM(mfc), BrickLaplaceMM(mff)
    tr_i = Transfer(mfc, mff)
    tr_b = BrickTransfer(mmc, mmf)
    rng = np.random.default_rng(12)

    xc = mfc.constraints.distribute(rng.standard_normal(mfc.n_dofs))
    ref = np.asarray(tr_i.prolongate(jnp.asarray(xc)))
    got_b = tr_b.prolongate(mmc.from_dof_vector(xc))
    got = np.asarray(mmf.to_dof_vector(got_b))
    free_f = ~mff.constraints.constrained_dof_marker()
    assert np.abs((got - ref)[free_f]).max() < 1e-11
    # prolongation output satisfies the brick invariant by construction
    refb = np.asarray(mmf.from_dof_vector(np.asarray(got)))
    assert np.abs(np.asarray(got_b) - refb).max() < 1e-11

    # restriction is the exact adjoint in the reduced-space inner product
    yf = mff.constraints.distribute(rng.standard_normal(mff.n_dofs))
    yf_b = mmf.from_dof_vector(yf)
    lhs = float(mmf.dot(got_b, yf_b))
    rc_b = tr_b.restrict(yf_b)
    rhs = float(mmc.dot(mmc.from_dof_vector(xc), rc_b))
    assert abs(lhs - rhs) < 1e-10 * max(1, abs(lhs))


@pytest.mark.slow
def test_brick_gmg_cg_matches_index_gmg():
    """GMG-CG entirely on the brick engine (VERDICT r2 item 6): converges in
    O(10) iterations and reproduces the index-engine GMG solution."""
    from dealii_matrixfree_hanging_nodes.models.multigrid_bricks import (
        BrickGMGPreconditioner,
    )

    nref, p = 3, 2
    gmg_i = GMGPreconditioner("quadrant", 3, nref, p, n_smooth=3)
    op_i, mf = gmg_i.fine_op, gmg_i.fine_mf
    rng = np.random.default_rng(4)
    xstar = mf.constraints.distribute(rng.standard_normal(mf.n_dofs))
    xstar = np.asarray(jnp.asarray(xstar).at[op_i.bdofs].set(0.0))
    b = op_i.vmult(jnp.asarray(xstar))
    x_i, it_i, _ = solve_cg(op_i, b, M=gmg_i, tol=1e-10, max_iter=100)

    gmg_b = BrickGMGPreconditioner("quadrant", 3, nref, p, n_smooth=3)
    op_b, mm = gmg_b.fine_op, gmg_b.fine_mm
    b_b = mm.from_dof_vector(np.asarray(b))
    x_b, it_b, _ = solve_cg(op_b, b_b, M=gmg_b, tol=1e-10, max_iter=100,
                            dot=mm.dot)
    free = ~mf.constraints.constrained_dof_marker()
    got = np.asarray(mm.to_dof_vector(x_b))
    err = np.abs((got - xstar)[free]).max()
    assert err < 1e-6, (it_b, err)
    assert it_b < 30, it_b
    erri = np.abs((got - np.asarray(x_i))[free]).max()
    assert erri < 1e-6, erri

    # device-resident solver (ONE jitted lax.while_loop, VERDICT r4 item 3)
    # reproduces the host-stepping loop: same iteration count, same solution
    solver = gmg_b.make_device_solver(tol=1e-10, max_iter=100)
    x_d, it_d, res_d = solver(b_b)
    assert it_d == it_b, (it_d, it_b)
    got_d = np.asarray(mm.to_dof_vector(x_d))
    assert np.abs((got_d - got)[free]).max() < 1e-9
    assert res_d < 1e-10 * float(jnp.sqrt(mm.dot(b_b, b_b)))
