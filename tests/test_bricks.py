import numpy as np
import jax.numpy as jnp
import pytest

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.models.laplace import LaplaceOperator
from dealii_matrixfree_hanging_nodes.bricks import BrickLaplace, BrickLaplaceMM
from dealii_matrixfree_hanging_nodes.oracle import vmult_oracle


CASES = [
    ("quadrant", 3, 2),
    ("quadrant", 4, 3),
    ("quadrant", 5, 1),  # 5 levels: deep fold/fill chains, B=8 bricks
    ("step", 3, 2),
    ("annulus", 5, 2),
    ("uniform", 2, 2),
    ("quadrant", 2, 5),  # p=5,6: B=2 bricks
    ("quadrant", 2, 6),
]


@pytest.mark.parametrize("engine", [BrickLaplace, BrickLaplaceMM])
@pytest.mark.parametrize("geo,nref,p", CASES)
def test_brick_vmult_matches_operator(engine, geo, nref, p):
    t = mfhn.create_geometry(geo, 3, nref)
    mf = MatrixFree(t, p, dtype=np.float64)
    u = np.random.default_rng(0).standard_normal(mf.n_dofs)
    ref = np.asarray(LaplaceOperator(mf).vmult(jnp.asarray(u)))
    bl = engine(mf)
    out = bl.vmult(bl.from_dof_vector(u))
    got = bl.to_dof_vector(out, zero_hanging=True)
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()
    # output invariant: duplicated/hanging copies are consistent. With the
    # input-fill default (all degrees, bricks.py fill_mode="input") outputs
    # are REDUCED (hanging slots carry no meaning, like the reference's
    # post-distribute vectors), so compare the roundtrip against
    # refill(out) — the invariant-restored vector.
    base = out
    if getattr(bl, "_fill_mode", None) == "input":
        base = bl.refill(out)
    out2 = bl.from_dof_vector(bl.to_dof_vector(out))
    inv = float(jnp.abs(base - out2).max())
    assert inv < 1e-12 * max(1.0, float(jnp.abs(base).max()))


def test_brick_roundtrip_identity():
    t = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(t, 3, dtype=np.float64)
    bl = BrickLaplaceMM(mf)
    u = np.random.default_rng(1).standard_normal(mf.n_dofs)
    v = bl.to_dof_vector(bl.from_dof_vector(u))
    # non-hanging dofs round-trip exactly; hanging carry distributed values
    free = ~mf.constraints.constrained_dof_marker()
    assert np.array_equal(v[free], u[free])


def test_brick_space_cg():
    """CG runs entirely in the brick layout with the reduced-space dot."""
    from dealii_matrixfree_hanging_nodes.models.multigrid import solve_cg

    t = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(t, 2, dtype=np.float64)
    bl = BrickLaplaceMM(mf)
    rng = np.random.default_rng(0)
    xstar = mf.constraints.distribute(rng.standard_normal(mf.n_dofs))
    bx = bl.from_dof_vector(xstar)
    b = bl.vmult(bx)
    x, iters, res = solve_cg(bl, b, tol=1e-9, max_iter=3000, dot=bl.dot)
    # singular Neumann operator: solution unique up to a constant
    got = bl.to_dof_vector(x)
    free = ~mf.constraints.constrained_dof_marker()
    shift = (got[free] - xstar[free]).mean()
    err = np.abs(got[free] - xstar[free] - shift).max()
    assert err < 1e-5, (iters, res, err)


def test_vmult_multi_matches_single():
    for geo, nref, p, nrhs in [("quadrant", 3, 2, 3), ("annulus", 3, 2, 8)]:
        t = mfhn.create_geometry(geo, 3, nref)
        mf = MatrixFree(t, p, dtype=np.float64)
        bl = BrickLaplaceMM(mf, face_planes=False)
        rng = np.random.default_rng(2)
        vs = [
            mf.constraints.distribute(rng.standard_normal(mf.n_dofs))
            for _ in range(nrhs)
        ]
        bvk = jnp.stack([bl.from_dof_vector(v) for v in vs])
        multi = bl.vmult_multi(bvk)
        for k, v in enumerate(vs):
            single = bl.vmult(bl.from_dof_vector(v))
            assert float(jnp.abs(multi[k] - single).max()) < 1e-12, (geo, k)


@pytest.mark.parametrize(
    "geo,dim,nref,p",
    [("quadrant", 3, 4, 2), ("quadrant", 2, 5, 3), ("step", 3, 4, 2),
     ("quadrant", 3, 4, 4)],
)
def test_face_planes_match_oracle(geo, dim, nref, p):
    """The face-plane schedule (node-domain per-interface-pair fill/fold,
    default for the Cartesian input-fill engine) matches the assembled
    oracle AND the per-cell engine exactly, with nonzero plane coverage
    so the fast path is actually exercised."""
    t = mfhn.create_geometry(geo, dim, nref)
    mf = MatrixFree(t, p, dtype=np.float64)
    u = np.random.default_rng(0).standard_normal(mf.n_dofs)
    ref = vmult_oracle(t, p, u)
    s = np.abs(ref).max()
    bl = BrickLaplaceMM(mf, face_planes=True)  # default is ON for p<=2 only
    assert bl._face_planes and bl.bs.plane_covered.sum() > 0
    out = bl.to_dof_vector(bl.vmult(bl.from_dof_vector(u)), zero_hanging=True)
    assert np.abs(out - ref).max() < 1e-12 * s
    # refill restores the invariant through the plane fill + residual chain
    bv = bl.vmult(bl.from_dof_vector(u))
    rf = np.asarray(bl.refill(bv))
    assert np.isfinite(rf).all()
    b0 = BrickLaplaceMM(mf, face_planes=False)
    out0 = b0.to_dof_vector(b0.vmult(b0.from_dof_vector(u)),
                            zero_hanging=True)
    assert np.abs(out - out0).max() < 1e-12 * s


@pytest.mark.parametrize("chain", ["compact", "flat", "seq"])
def test_vmult_multi_chain_modes(monkeypatch, chain):
    """Multi-RHS input-fill matches single-RHS under EVERY chain schedule
    (regression: the flat/sequential schedules used to silently run the
    output-fill path in vmult_multi while single-RHS vmult accepted
    reduced inputs — ADVICE r4 medium)."""
    monkeypatch.setenv("BRICK_CHAIN", chain)
    t = mfhn.create_quadrant(3, 4)
    mf = MatrixFree(t, 2, dtype=np.float64)
    # multi-RHS rides the per-cell chain machinery (face_planes=False,
    # like the engines that consume it — see vmult_multi's guard)
    bl = BrickLaplaceMM(mf, face_planes=False)
    assert bl._fill_mode == "input" and bl._chain_mode == chain
    rng = np.random.default_rng(4)
    vs = [
        mf.constraints.distribute(rng.standard_normal(mf.n_dofs))
        for _ in range(3)
    ]
    bvk = jnp.stack([bl.from_dof_vector(v) for v in vs])
    multi = bl.vmult_multi(bvk)
    for k, v in enumerate(vs):
        single = bl.vmult(bl.from_dof_vector(v))
        assert float(jnp.abs(multi[k] - single).max()) < 1e-12, (chain, k)
    ref = np.asarray(LaplaceOperator(mf).vmult(jnp.asarray(vs[0])))
    got = bl.to_dof_vector(multi[0], zero_hanging=True)
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("geo,nref,p", [("quadrant", 3, 2), ("step", 3, 1),
                                        ("uniform", 2, 2), ("quadrant", 3, 5),
                                        ("quadrant", 2, 6)])
def test_brick_mm_2d(geo, nref, p):
    t = mfhn.create_geometry(geo, 2, nref)
    mf = MatrixFree(t, p, dtype=np.float64)
    u = np.random.default_rng(0).standard_normal(mf.n_dofs)
    ref = np.asarray(LaplaceOperator(mf).vmult(jnp.asarray(u)))
    bl = BrickLaplaceMM(mf)
    out = bl.vmult(bl.from_dof_vector(u))
    got = bl.to_dof_vector(out, zero_hanging=True)
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()
    # roundtrip invariant vs the invariant-restored vector (input-fill
    # outputs are REDUCED, hanging slots carry no meaning)
    base = out
    if getattr(bl, "_fill_mode", None) == "input":
        base = bl.refill(out)
    out2 = bl.from_dof_vector(bl.to_dof_vector(out))
    assert float(jnp.abs(base - out2).max()) < 1e-12 * max(
        1.0, float(jnp.abs(base).max())
    )


def test_vmult_plain_equals_vmult_on_uniform():
    """On a mesh with no hanging nodes the constraints-off brick variant is
    the same operator (hole corrections and DSS still apply)."""
    from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM

    for dim, r, p in ((3, 2, 3), (2, 3, 4)):
        t = mfhn.create_uniform(dim, r)
        mf = MatrixFree(t, p, dtype=np.float64)
        op = BrickLaplaceMM(mf)
        u = np.random.default_rng(3).standard_normal(mf.n_dofs)
        bv = op.from_dof_vector(u)
        a = np.asarray(op.vmult(bv))
        b = np.asarray(op.vmult_plain(bv))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(a).max())


def test_vmult_plain_smoke_constrained():
    from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM

    t = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(t, 2, dtype=np.float64)
    op = BrickLaplaceMM(mf)
    u = np.random.default_rng(4).standard_normal(mf.n_dofs)
    out = np.asarray(op.vmult_plain(op.from_dof_vector(u)))
    assert np.isfinite(out).all()


@pytest.mark.parametrize(
    "dim,geometry,nref,degree",
    [(3, "quadrant", 3, 2), (2, "quadrant", 4, 3), (3, "annulus", 4, 2)],
)
def test_bricks_deformed_mapping(dim, geometry, nref, degree):
    """Deformed (MappingQCache analog) mapping on the brick engine matches
    the index engine to machine precision (TestHighOrderMapping parity,
    benchmark_01.h:227-242)."""
    tria = mfhn.create_geometry(geometry, dim, nref)
    mf = MatrixFree(tria, degree=degree, dtype=np.float64, high_order_mapping=True)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(mf.n_dofs)
    ref = np.asarray(LaplaceOperator(mf).vmult(u)).copy()
    ref[mf.constraints.constrained_dof_marker()] = 0.0
    mm = BrickLaplaceMM(mf)
    out = mm.to_dof_vector(mm.vmult(mm.from_dof_vector(u)), zero_hanging=True)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-12
    # plain (constraints-off) variant runs and differs only at HN couplings
    outp = mm.to_dof_vector(mm.vmult_plain(mm.from_dof_vector(u)),
                            zero_hanging=True)
    assert np.isfinite(outp).all()


@pytest.mark.parametrize("geo,nref,p", [("quadrant", 3, 3), ("annulus", 4, 2)])
def test_dss_pair_mode_matches_pool(geo, nref, p):
    """The gather-only 'pair' DSS (per-slot contributor tables, no XLA
    scatter on the hot path) is bit-identical to the pooled scatter-add
    formulation on both the constrained and plain vmult."""
    tria = mfhn.create_geometry(geo, 3, nref)
    mf = MatrixFree(tria, degree=p, dtype=np.float64)
    rng = np.random.default_rng(7)
    u = rng.standard_normal(mf.n_dofs)
    op_pool = BrickLaplaceMM(mf, matmul_precision="highest", dss_mode="pool")
    op_pair = BrickLaplaceMM(mf, matmul_precision="highest", dss_mode="pair")
    bv = op_pool.from_dof_vector(u)
    for name in ("vmult", "vmult_plain"):
        v1 = np.asarray(getattr(op_pool, name)(bv))
        v2 = np.asarray(getattr(op_pair, name)(bv))
        assert np.abs(v1 - v2).max() <= 1e-13 * np.abs(v1).max(), name


@pytest.mark.parametrize(
    "geo,dim,nref,p",
    [("quadrant", 3, 4, 4), ("quadrant", 3, 4, 2), ("annulus", 3, 4, 3),
     ("quadrant", 2, 5, 3)],
)
def test_fill_volume_mode_matches_exchange(geo, dim, nref, p):
    """The volume-domain fill (conv-patch extract + separable col2im
    scatter-back, fill_mode="volume") is exactly equal to the
    exchange-domain EscX/EFX formulation on vmult AND refill, and the
    separable col2im factorization reproduces the one-hot E scatter."""
    tria = mfhn.create_geometry(geo, dim, nref)
    mf = MatrixFree(tria, degree=p, dtype=np.float64)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(mf.n_dofs)
    ops = {
        "exch": BrickLaplaceMM(mf, matmul_precision="highest",
                               fill_mode="exchange", col2im="onehot"),
        "vol": BrickLaplaceMM(mf, matmul_precision="highest",
                              fill_mode="volume", col2im="sep"),
    }
    bv = ops["exch"].from_dof_vector(u)
    v1 = np.asarray(ops["exch"].vmult(bv))
    v2 = np.asarray(ops["vol"].vmult(bv))
    assert np.abs(v1 - v2).max() <= 1e-13 * np.abs(v1).max()
    r1 = np.asarray(ops["exch"].refill(bv))
    r2 = np.asarray(ops["vol"].refill(bv))
    assert np.abs(r1 - r2).max() <= 1e-13 * max(np.abs(r1).max(), 1.0)


@pytest.mark.parametrize(
    "geo,dim,nref,p",
    [("quadrant", 3, 4, 4), ("quadrant", 3, 4, 2), ("annulus", 3, 4, 3),
     ("step", 3, 3, 3), ("quadrant", 2, 5, 3)],
)
def test_fill_hybrid_and_input_modes(geo, dim, nref, p):
    """fill_mode="hybrid" (volume read, exchange write) equals exchange on
    the full brick vector; fill_mode="input" (read_dof_values analog:
    constraints resolved in the cols domain on gather, reduced output)
    equals it on the reduced image, accepts UNFILLED inputs (chained
    vmult), and its refill restores the invariant."""
    tria = mfhn.create_geometry(geo, dim, nref)
    mf = MatrixFree(tria, degree=p, dtype=np.float64)
    rng = np.random.default_rng(4)
    u = rng.standard_normal(mf.n_dofs)
    ops = {
        m: BrickLaplaceMM(mf, matmul_precision="highest",
                          fill_mode=m, col2im="onehot")
        for m in ("exchange", "hybrid", "input")
    }
    bv = ops["exchange"].from_dof_vector(u)
    v_ex = ops["exchange"].vmult(bv)
    v_hy = ops["hybrid"].vmult(bv)
    assert np.abs(np.asarray(v_ex) - np.asarray(v_hy)).max() <= (
        1e-13 * np.abs(np.asarray(v_ex)).max()
    )
    red_ex = ops["exchange"].to_dof_vector(v_ex, zero_hanging=True)
    v_in = ops["input"].vmult(bv)
    red_in = ops["input"].to_dof_vector(v_in, zero_hanging=True)
    assert np.abs(red_ex - red_in).max() <= 1e-13 * np.abs(red_ex).max()
    # chained: the second input-fill vmult consumes the unfilled output
    red2_ex = ops["exchange"].to_dof_vector(
        ops["exchange"].vmult(v_ex), zero_hanging=True)
    red2_in = ops["input"].to_dof_vector(
        ops["input"].vmult(v_in), zero_hanging=True)
    assert np.abs(red2_ex - red2_in).max() <= 1e-12 * np.abs(red2_ex).max()
    # refill of the unfilled output == from_dof_vector of its reduced image
    rf = np.asarray(ops["input"].refill(v_in))
    fb = np.asarray(ops["input"].from_dof_vector(red_in))
    assert np.abs(rf - fb).max() <= 1e-12 * max(np.abs(fb).max(), 1.0)


@pytest.mark.parametrize(
    "geo,dim,nref,p,fm",
    [("quadrant", 3, 4, 4, "input"),       # tail stages (chained)
     ("quadrant", 3, 4, 3, "exchange"),    # tail stages, output fill
     ("annulus", 3, 5, 2, "input"),        # many pairs, no tails
     ("annulus", 2, 5, 2, "volume")],      # 2D with tails
)
def test_chain_mode_compact_matches_flat(geo, dim, nref, p, fm, monkeypatch):
    """chain_mode="compact" (all fold/lz/delta work in the [n_hn, n_loc]
    space, sparse delta assembly) equals the staged "flat" schedule on
    vmult and refill — including the annulus meshes with genuine
    multi-level constraint chains (tail stages)."""
    tria = mfhn.create_geometry(geo, dim, nref)
    mf = MatrixFree(tria, degree=p, dtype=np.float64)
    rng = np.random.default_rng(7)
    u = rng.standard_normal(mf.n_dofs)
    ops = {}
    for cm in ("flat", "compact"):
        monkeypatch.setenv("BRICK_CHAIN", cm)
        ops[cm] = BrickLaplaceMM(mf, matmul_precision="highest", fill_mode=fm)
    bv = ops["flat"].from_dof_vector(u)
    rf = ops["flat"].to_dof_vector(ops["flat"].vmult(bv), zero_hanging=True)
    rc = ops["compact"].to_dof_vector(
        ops["compact"].vmult(bv), zero_hanging=True)
    assert np.abs(rf - rc).max() <= 1e-13 * np.abs(rf).max()
    ff = np.asarray(ops["flat"].refill(ops["flat"].vmult(bv)))
    fc = np.asarray(ops["compact"].refill(ops["compact"].vmult(bv)))
    assert np.abs(ff - fc).max() <= 1e-13 * max(np.abs(ff).max(), 1.0)
