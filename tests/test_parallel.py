import numpy as np
import jax
import pytest

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.models.laplace import LaplaceOperator
from dealii_matrixfree_hanging_nodes.parallel.distributed import DistributedLaplace
from dealii_matrixfree_hanging_nodes.parallel.partition import (
    dof_owners,
    hanging_nodes_weighting,
    partition_cells,
)


def test_partition_balanced():
    rank = partition_cells(1000, 8)
    counts = np.bincount(rank, minlength=8)
    assert counts.sum() == 1000
    assert counts.max() - counts.min() <= 1
    # weighted: heavy tail cells shrink late ranks' cell counts
    w = np.ones(1000)
    w[900:] = 100.0
    rank_w = partition_cells(1000, 8, w)
    assert np.all(np.diff(rank_w) >= 0)  # contiguous ranges
    counts_w = np.bincount(rank_w, minlength=8)
    assert counts_w[-1] < counts_w[0]


def test_weighting_formula():
    c = np.array([True, False])
    w = hanging_nodes_weighting(c, 3.0)
    assert w[0] == 31.0 and w[1] == 11.0


def test_distributed_matches_single_chip():
    """Multi-device vmult == single-device to machine precision — the
    analog of the reference's -np 1 vs -np 40 redundancy
    (benchmark_01.cc:251-272)."""
    t = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(t, 2, dtype=np.float64)
    op = LaplaceOperator(mf)
    rng = np.random.default_rng(0)
    src = rng.standard_normal(mf.n_dofs)
    ref = np.asarray(op.vmult(src))
    for n_dev in (1, 4, 8):
        dop = DistributedLaplace(mf, devices=jax.devices()[:n_dev])
        got = dop.gather_vector(dop.vmult(dop.scatter_vector(src)))
        assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max(), n_dev


def test_distributed_deformed_matches_single_chip():
    """Deformed (MappingQCache analog) vmult under the same distributed
    stack as Cartesian — the reference runs TestHighOrderMapping
    (benchmark_01.h:227-242) under the identical MPI stack; multi-device
    must equal single-chip to machine precision for both exchanges."""
    t = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(t, 2, dtype=np.float64, high_order_mapping=True)
    op = LaplaceOperator(mf)
    rng = np.random.default_rng(0)
    src = rng.standard_normal(mf.n_dofs)
    ref = np.asarray(op.vmult(src))
    for exchange in ("allgather", "halo"):
        dop = DistributedLaplace(mf, devices=jax.devices()[:8], exchange=exchange)
        got = dop.gather_vector(dop.vmult(dop.scatter_vector(src)))
        assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max(), exchange


def test_distributed_weighted_repartition():
    t = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(t, 2, dtype=np.float64)
    rng = np.random.default_rng(1)
    src = rng.standard_normal(mf.n_dofs)
    ref = np.asarray(LaplaceOperator(mf).vmult(src))
    w = hanging_nodes_weighting(mf.constraints.is_constrained_cell(), 7.5)
    dop = DistributedLaplace(mf, weights=w)
    got = dop.gather_vector(dop.vmult(dop.scatter_vector(src)))
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()
    # ghost/import bookkeeping is self-consistent
    assert dop.n_ghost.sum() > 0
    assert dop.n_import.sum() > 0


def test_dof_owners_cover():
    t = mfhn.create_quadrant(2, 3)
    mf = MatrixFree(t, 2, dtype=np.float64)
    rank = partition_cells(mf.n_cells, 4)
    owner = dof_owners(np.asarray(mf.dofmap_plain), rank, mf.n_dofs)
    assert owner.min() >= 0 and owner.max() < 4


def test_graft_entry_dryrun():
    import sys, pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = fn(*args)
    assert np.isfinite(np.asarray(out)).all()
    ge.dryrun_multichip(8)


def test_distributed_sm_groups():
    """Hierarchical (communicator_sm analog) two-stage ghost exchange over a
    (nodes x chips) mesh matches the flat result exactly."""
    t = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(t, 2, dtype=np.float64)
    rng = np.random.default_rng(5)
    src = rng.standard_normal(mf.n_dofs)
    ref = np.asarray(LaplaceOperator(mf).vmult(src))
    dop = DistributedLaplace(mf, sm_group_size=4)  # 2 nodes x 4 chips
    got = dop.gather_vector(dop.vmult(dop.scatter_vector(src)))
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()


def test_halo_exchange_matches():
    """Halo-minimal all_to_all ghost exchange == single-chip == all_gather
    path; per-pair buffers are much smaller than the vector shard."""
    t = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(t, 2, dtype=np.float64)
    rng = np.random.default_rng(6)
    src = rng.standard_normal(mf.n_dofs)
    ref = np.asarray(LaplaceOperator(mf).vmult(src))
    dop = DistributedLaplace(mf, exchange="halo")
    got = dop.gather_vector(dop.vmult(dop.scatter_vector(src)))
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()
    assert dop.halo_max_pair < dop.n_own_max


# ---------------------------------------------------------------------------
# distributed brick engine (the flagship path, sharded)
from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM
from dealii_matrixfree_hanging_nodes.parallel.bricks_distributed import (
    DistributedBrickLaplace,
)


@pytest.mark.parametrize(
    "dim,geometry,nref,degree",
    [
        (3, "quadrant", 3, 2),
        (3, "quadrant", 3, 4),
        (2, "quadrant", 4, 3),
        (3, "annulus", 4, 1),
        (2, "step", 3, 2),
    ],
)
def test_distributed_bricks_match_single_chip(dim, geometry, nref, degree):
    """1-vs-8-device equivalence of the brick engine (analog of the
    reference's mpirun -np 1 vs -np N check, benchmark_01.cc:251-272)."""
    tria = mfhn.create_geometry(geometry, dim, nref)
    mf = MatrixFree(tria, degree=degree, dtype=np.float64)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(mf.n_dofs)
    mm = BrickLaplaceMM(mf)
    ref = mm.to_dof_vector(mm.vmult(mm.from_dof_vector(u)))
    for R in (1, 8):
        dop = DistributedBrickLaplace(mf, devices=jax.devices()[:R])
        out = dop.to_dof_vector(dop.vmult(dop.from_dof_vector(u)))
        err = np.abs(out - ref).max() / np.abs(ref).max()
        assert err < 1e-12, (R, err)


@pytest.mark.parametrize("exchange", ["halo", "replicated"])
def test_distributed_bricks_deformed_matches_single_chip(exchange):
    """High-order (MappingQCache analog) mapping on the DISTRIBUTED brick
    engine: the slab-sharded per-quad-point metric path equals the
    single-chip deformed engine to machine precision under both exchange
    modes (the reference runs its high-order mapping under the full MPI
    stack, benchmark_01.h:227-242 with benchmark_01.h:255)."""
    tria = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(tria, degree=2, dtype=np.float64,
                    high_order_mapping=True)
    rng = np.random.default_rng(5)
    u = rng.standard_normal(mf.n_dofs)
    mm = BrickLaplaceMM(mf)
    ref = mm.to_dof_vector(mm.vmult(mm.from_dof_vector(u)),
                           zero_hanging=True)
    for R in (1, 8):
        dop = DistributedBrickLaplace(
            mf, devices=jax.devices()[:R], exchange=exchange
        )
        out = dop.to_dof_vector(dop.vmult(dop.from_dof_vector(u)),
                                zero_hanging=True)
        err = np.abs(out - ref).max() / np.abs(ref).max()
        assert err < 1e-12, (exchange, R, err)


def test_distributed_bricks_weighted_repartition():
    """Weighted brick repartition changes the partition but not the result
    (benchmark_02.cc:63-87 analog on the brick engine)."""
    from dealii_matrixfree_hanging_nodes.parallel.partition import (
        hanging_nodes_weighting,
    )

    tria = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(tria, degree=2, dtype=np.float64)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(mf.n_dofs)
    mm = BrickLaplaceMM(mf)
    ref = mm.to_dof_vector(mm.vmult(mm.from_dof_vector(u)))
    w = hanging_nodes_weighting(mf.constraints.is_constrained_cell(), 5.0)
    d1 = DistributedBrickLaplace(mf, devices=jax.devices()[:8])
    d2 = DistributedBrickLaplace(mf, devices=jax.devices()[:8], weights=w)
    assert not np.array_equal(d1.rank_of_brick, d2.rank_of_brick)
    for dop in (d1, d2):
        out = dop.to_dof_vector(dop.vmult(dop.from_dof_vector(u)))
        assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-12
    # ghost/import bookkeeping present
    assert d1.n_ghost.sum() > 0 and d1.n_import.sum() > 0


@pytest.mark.parametrize(
    "geometry,nref,degree",
    [
        ("quadrant", 4, 3),
        # annulus: ~80% constrained cells — the stress case for the
        # chain-halo need sets (multi-level fold/fill across ranks);
        # r4 is a single brick, r5 has 41 over the 8 ranks
        ("annulus", 5, 2),
    ],
)
def test_distributed_bricks_halo_vs_replicated(geometry, nref, degree):
    """The neighbor-wise (pairwise all_to_all) exchange equals the
    replicated psum/all_gather baseline to machine precision, with far
    less traffic (benchmark_02.cc:136-165 ghost-index-list analog)."""
    tria = mfhn.create_geometry(geometry, 3, nref)
    mf = MatrixFree(tria, degree=degree, dtype=np.float64)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(mf.n_dofs)
    d_halo = DistributedBrickLaplace(mf, devices=jax.devices()[:8])
    d_rep = DistributedBrickLaplace(
        mf, devices=jax.devices()[:8], exchange="replicated"
    )
    out_h = d_halo.to_dof_vector(d_halo.vmult(d_halo.from_dof_vector(u)))
    out_r = d_rep.to_dof_vector(d_rep.vmult(d_rep.from_dof_vector(u)))
    assert np.abs(out_h - out_r).max() / np.abs(out_r).max() < 1e-12
    # halo ghost volume must be well below the replicated exchange volume
    assert d_rep.n_ghost.sum() > 0
    assert d_halo.n_ghost.sum() < d_rep.n_ghost.sum() / 3


def test_distributed_bricks_dot_and_cg():
    """Distributed CG on the brick operator converges to the single-chip
    solution (dot products over the reduced space)."""
    import jax.numpy as jnp

    tria = mfhn.create_quadrant(3, 3)
    mf = MatrixFree(tria, degree=2, dtype=np.float64)
    rng = np.random.default_rng(2)
    x_true = rng.standard_normal(mf.n_dofs)
    dop = DistributedBrickLaplace(mf, devices=jax.devices()[:8])
    # manufactured rhs in the operator's range (the pure-Neumann Laplace is
    # singular: constants are in its nullspace)
    b = dop.vmult(dop.from_dof_vector(x_true))
    # deflate the nullspace: keep iterates orthogonal to constants in the
    # reduced dot (fp drift otherwise stalls CG at ~1e-5 on the singular
    # operator)
    ones = dop.from_dof_vector(np.ones(mf.n_dofs))
    nn = dop.dot(ones, ones)

    def deflate(v):
        return v - (dop.dot(ones, v) / nn) * ones

    b = deflate(b)
    x = jnp.zeros_like(b)
    r = b
    p = r
    rs = dop.dot(r, r)
    for _ in range(300):
        Ap = dop.vmult(p)
        alpha = rs / dop.dot(p, Ap)
        x = x + alpha * p
        r = deflate(r - alpha * Ap)
        rs_new = dop.dot(r, r)
        if float(rs_new) < 1e-26:
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    # residual through the single-chip operator agrees to near machine
    # precision (the round-2 1e-5 bound was a deflation artifact)
    mm = BrickLaplaceMM(mf)
    x_dof = dop.to_dof_vector(x)
    r2 = deflate(b - dop.vmult(dop.from_dof_vector(x_dof)))
    assert float(dop.norm(r2)) < 1e-10 * float(dop.norm(b))
    del mm
