"""Geometric multigrid on the brick engine (BASELINE row 4 at benchmark
scale): the Chebyshev-smoothed global-coarsening V-cycle of
models/multigrid.py with every level operator, smoother application, and
transfer running in the flagship brick layout (bricks.BrickLaplaceMM) —
the analog of running the reference's solver stack entirely on its
device matrix-free path (CUDAWrappers, benchmark_03.h:279-358).

Key pieces:

- ``BrickDirichletLaplace`` — homogeneous-Dirichlet Laplace on brick
  vectors. Pointwise masking breaks the hanging-node invariant exactly at
  constrained copies (an interior hanging node may interpolate from
  boundary masters), so every mask is followed by ``BrickLaplaceMM.refill``
  (the standalone fill chain).
- ``BrickTransfer`` — prolongation runs entirely in brick layout:
  cols extraction (conv patches) -> covering-coarse-row gather -> per-cell
  subface embedding chains (batched einsum) -> one-writer-per-brick-node
  scatter (the embedded coarse field is continuous, so every duplicate
  copy receives the same value and fine hanging nodes receive exactly
  their constraint interpolation: the invariant holds by construction, no
  exchange needed). Restriction is the EXACT adjoint on the reduced DoF
  space: jax.linear_transpose of the prolongation chain against the
  owner-copy weights, pulled back to a coarse brick vector through the
  (device-side) dof->brick embedding and its transpose.
- ``BrickChebyshev`` — the diagonal-preconditioned Chebyshev smoother with
  the refill hook after each diagonal scaling.
- ``BrickGMGPreconditioner`` — the V-cycle; per-level diagonals come from
  the index engine's exact probing (operator_diagonal), so iteration
  counts match the index-engine GMG bit-for-bit in exact arithmetic.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..bricks import BrickLaplaceMM
from ..matrix_free import MatrixFree
from ..mesh import create_geometry
from .multigrid import (
    ChebyshevSmoother,
    covering_embedding,
    laplace_diagonal_host,
    solve_cg,
)

__all__ = [
    "BrickDirichletLaplace",
    "BrickTransfer",
    "BrickChebyshev",
    "BrickGMGPreconditioner",
    "DofEmbed",
]


# --------------------------------------------------------------------------
class DofEmbed:
    """Device-side dof-vector <-> brick-vector conversions for one
    BrickLaplaceMM level (the jit-safe analog of from_dof_vector /
    to_dof_vector): ``embed`` distributes hanging rows from masters via the
    CSR tables and places each dof at every covering node copy; ``extract``
    reads the owner copy of each dof. Both are pure linear functions of
    device arrays (usable under jit / linear_transpose)."""

    def __init__(self, mm: BrickLaplaceMM):
        bs, mf = mm.bs, mm.mf
        ci = mf.constraints
        dt = mf.dtype
        valid_idx = np.nonzero(bs.node_valid)[0]
        self.tables = dict(
            valid_idx=jnp.asarray(valid_idx.astype(np.int64)),
            valid_dof=jnp.asarray(bs.node_dof[valid_idx].astype(np.int32)),
            slave=jnp.asarray(ci.slave_dofs.astype(np.int32)),
            row=jnp.asarray(
                np.repeat(
                    np.arange(len(ci.slave_dofs), dtype=np.int32),
                    np.diff(ci.row_ptr),
                )
            ),
            col=jnp.asarray(ci.col.astype(np.int32)),
            w=jnp.asarray(ci.weight.astype(dt)),
            owner=jnp.asarray(bs.owner_node_of_dof.astype(np.int64)),
        )
        self.mm = mm
        self.nnode = bs.n_bricks * bs.NB**bs.dim
        self.n_dofs = mf.n_dofs

    def embed(self, x_dof, sc):
        """dof vector -> brick vector [nb, N3p] (sc = self.tables)."""
        x = x_dof
        if int(sc["slave"].shape[0]):
            upd = jax.ops.segment_sum(
                sc["w"] * jnp.take(x, sc["col"]), sc["row"],
                num_segments=int(sc["slave"].shape[0]),
            )
            # unique_indices: slave rows are distinct — keeps the scatter
            # linear-transposable (jax.linear_transpose in BrickTransfer)
            x = x.at[sc["slave"]].set(upd, unique_indices=True)
        flat = jnp.zeros(self.nnode, x.dtype)
        flat = flat.at[sc["valid_idx"]].set(
            jnp.take(x, sc["valid_dof"]), unique_indices=True
        )
        out = flat.reshape(self.mm.bs.n_bricks, -1)
        return jnp.pad(out, ((0, 0), (0, self.mm.N3p - self.mm.N3)))

    def extract(self, bv, sc):
        """brick vector -> dof vector (owner-copy read)."""
        flat = bv[:, : self.mm.N3].reshape(-1)
        return jnp.take(flat, sc["owner"])


# --------------------------------------------------------------------------
class BrickDirichletLaplace:
    """Laplace with homogeneous Dirichlet rows (identity there) on brick
    vectors; SPD on the reduced space, the brick analog of
    models.multigrid.DirichletLaplace."""

    def __init__(self, mm: BrickLaplaceMM):
        self.mm = mm
        mf = mm.mf
        bs = mm.bs
        bd = mf.dof_handler.boundary_dofs()
        bmark = np.zeros(mf.n_dofs, dtype=bool)
        bmark[bd] = True
        nb = np.zeros((bs.n_bricks, mm.N3p), dtype=mf.dtype)
        nb[:, : mm.N3] = (
            bmark[np.where(bs.node_dof >= 0, bs.node_dof, 0)]
            & bs.node_valid
        ).reshape(bs.n_bricks, mm.N3)
        self.bd_mask = jnp.asarray(nb)
        self.keep = 1.0 - self.bd_mask
        self._bdofs = bd

    def vmult(self, u):
        mm = self.mm
        w = mm.refill(u * self.keep)
        v = mm.vmult(w)
        return mm.refill(v * self.keep + u * self.bd_mask)

    def project_rhs(self, b):
        """Zero Dirichlet rows of a rhs (brick layout)."""
        return self.mm.refill(b * self.keep)

    # vector-space helpers delegate to the brick engine
    def dot(self, u, v):
        return self.mm.dot(u, v)


# --------------------------------------------------------------------------
class BrickTransfer:
    """Brick-layout prolongation + exact-adjoint restriction between two
    global-coarsening levels (each with its own BrickLaplaceMM)."""

    def __init__(self, mm_c: BrickLaplaceMM, mm_f: BrickLaplaceMM):
        self.mm_c, self.mm_f = mm_c, mm_f
        mf_c, mf_f = mm_c.mf, mm_f.mf
        bs_c, bs_f = mm_c.bs, mm_f.bs
        dim = bs_f.dim
        C_f = bs_f.B**dim
        C_c = bs_c.B**dim
        n = mf_f.degree + 1
        n_loc = n**dim
        dt = mf_f.dtype

        cover, E = covering_embedding(mf_c, mf_f)

        # fine (brick, slot) linear rows -> covering coarse linear rows
        nlin_f = bs_f.n_bricks * C_f
        cell_at_f = bs_f.cell_at  # [nlin_f] tria cell or -1
        lin_c_of_cell = bs_c.cell_lin  # [n_cells_c]
        src_lin = np.zeros(nlin_f, dtype=np.int32)
        E_rows = np.broadcast_to(
            np.eye(n, dtype=dt), (nlin_f, dim, n, n)
        ).copy()
        present = cell_at_f >= 0
        fc = cell_at_f[present]
        src_lin[present] = lin_c_of_cell[cover[fc]].astype(np.int32)
        E_rows[present] = E[fc].astype(dt)

        # one writer per fine brick node: (lin, slot) with the smallest
        # linear id among the covering present cells of that node
        nnode_f = bs_f.n_bricks * bs_f.NB**dim
        writer = np.full(nnode_f, -1, dtype=np.int64)
        flat_nodes = (
            bs_f.brick_of_cell.astype(np.int64)[:, None] * (bs_f.NB**dim)
            + bs_f.cell_node_index
        )  # [n_cells_f, n_loc]
        lin_of_cell = bs_f.cell_lin  # [n_cells_f]
        order = np.argsort(-lin_of_cell, kind="stable")
        writer[flat_nodes[order].ravel()] = (
            lin_of_cell[order, None] * n_loc + np.arange(n_loc)[None, :]
        ).ravel()
        own = np.zeros(nlin_f * n_loc, dtype=bool)
        own[writer[writer >= 0]] = True
        own_w = own.reshape(nlin_f, n_loc).astype(dt)

        self._dev = dict(
            src_lin=jnp.asarray(src_lin),
            E_rows=jnp.asarray(E_rows),
            own_w=jnp.asarray(own_w),
        )

        # device-side dof -> coarse-brick embedding (S_c) for the adjoint
        # pull-back; hanging values are re-derived from masters via the CSR
        # distribute tables (small: n_hanging rows)
        self._embed_c = DofEmbed(mm_c)
        self._sc = self._embed_c.tables
        self._n_dofs_c = mf_c.n_dofs
        self._C_f, self._C_c, self._n_loc, self._dim = C_f, C_c, n_loc, dim
        self._dt = dt

        self._jit_prolongate = jax.jit(self._prolongate_impl)
        self._jit_restrict = jax.jit(self._restrict_impl)

    # -------------------------------------------------------------- impls
    def _pb(self, xc_b, d, ac, af):
        """brick_c -> brick_f prolongation chain (pure linear jax fn)."""
        cols_c = self.mm_c._extract_cols(xc_b, ac)  # [nlin_c, n_loc]
        u = jnp.take(cols_c, d["src_lin"], axis=0)  # [nlin_f, n_loc]
        n = self.mm_f.bs.p + 1
        dim = self._dim
        v = u.reshape(u.shape[0], *([n] * dim))
        for t in range(dim):
            ax = v.ndim - 1 - t
            v = jnp.moveaxis(v, ax, -1)
            v = jnp.einsum(
                "mij,m...j->m...i", d["E_rows"][:, t], v,
                preferred_element_type=v.dtype,
            )
            v = jnp.moveaxis(v, -1, ax)
        u = v.reshape(u.shape[0], -1) * d["own_w"]
        return self.mm_f._scatter_cols(u, af)

    def _sc_embed(self, x_dof, sc):
        """dof vector -> coarse brick vector (device from_dof_vector)."""
        return self._embed_c.embed(x_dof, sc)

    def _prolongate_impl(self, xc_b, d, ac, af):
        return self._pb(xc_b, d, ac, af)

    def _restrict_impl(self, rf_b, d, ac, af, sc, wf):
        """Exact adjoint on the reduced space: rc = S_c(S_c^T(P_b^T(W_f r)))."""
        yw = rf_b * wf
        xc_shape = jax.ShapeDtypeStruct(
            (self.mm_c.bs.n_bricks, self.mm_c.N3p), rf_b.dtype
        )
        (z,) = jax.linear_transpose(
            lambda x: self._pb(x, d, ac, af), xc_shape
        )(yw)
        dof_shape = jax.ShapeDtypeStruct((self._n_dofs_c,), rf_b.dtype)
        (rc_dof,) = jax.linear_transpose(
            lambda x: self._sc_embed(x, sc), dof_shape
        )(z)
        return self._sc_embed(rc_dof, sc)

    # ---------------------------------------------------------------- API
    def prolongate(self, xc_b):
        return self._jit_prolongate(
            xc_b, self._dev, self.mm_c._stage(), self.mm_f._stage()
        )

    def restrict(self, rf_b):
        return self._jit_restrict(
            rf_b, self._dev, self.mm_c._stage(), self.mm_f._stage(),
            self._sc, self.mm_f.dot_mask(),
        )


# --------------------------------------------------------------------------
class BrickChebyshev(ChebyshevSmoother):
    """Chebyshev smoother on brick vectors: diagonal scaling breaks the
    hanging invariant pointwise, so each D^{-1} application is refilled.
    The eigenvalue estimate and recurrence are inherited — only the `_prec`
    / `_norm` hooks differ, so brick and index GMG iteration counts stay
    in lock-step by construction."""

    def __init__(self, op: BrickDirichletLaplace, inv_diag_b, degree: int = 3,
                 eig_ratio: float = 1.2, n_power_iters: int = 12):
        mm = op.mm
        self._mm = mm  # needed by the hooks during the base power iteration
        rng = np.random.default_rng(7)
        x0 = mm.from_dof_vector(
            rng.standard_normal(mm.mf.n_dofs).astype(mm.mf.dtype)
        )
        super().__init__(
            op, degree=degree, eig_ratio=eig_ratio,
            n_power_iters=n_power_iters, inv_diag=inv_diag_b, x_init=x0,
        )

    def _prec(self, r):
        return self._mm.refill(self.inv_diag * r)

    def _norm(self, v):
        return jnp.sqrt(self._mm.dot(v, v))


# --------------------------------------------------------------------------
class BrickGMGPreconditioner:
    """Global-coarsening GMG V-cycle with brick-engine level operators."""

    def __init__(self, geometry: str, dim: int, n_refinements: int,
                 degree: int, dtype=np.float64, n_smooth: int = 3,
                 min_level: int = 1, matmul_precision: str = "highest",
                 coarse: str = "direct"):
        self.levels = []
        self.mms = []
        for r in range(min_level, n_refinements + 1):
            tria = create_geometry(geometry, dim, r)
            mf = MatrixFree(tria, degree, dtype=dtype)
            self.levels.append(mf)
            self.mms.append(
                BrickLaplaceMM(mf, matmul_precision=matmul_precision,
                               face_planes=False)
            )
        # ---- host phase: ALL NumPy-heavy setup before the first device
        # array ---------------------------------------------------------------
        self._coarse_direct = coarse == "direct"
        inv_diags = []
        for mf in self.levels:
            # exact probing diagonal (host formula == the index engine's
            # device probing, so iteration counts match the index GMG);
            # Dirichlet rows get diagonal 1
            diag = laplace_diagonal_host(mf)
            diag[mf.dof_handler.boundary_dofs()] = 1.0
            safe = np.where(diag > 0, diag, 1.0)
            inv_diags.append(np.where(diag > 0, 1.0 / safe, 0.0))
        if self._coarse_direct:
            # coarsest-level solver: "direct" applies a host-assembled dense
            # inverse as one device matmul (an iterative coarse solve at f32
            # spins at tight tolerances and dispatches once per CG step);
            # "cg" keeps the iterative host-stepping coarse solve
            from ..oracle import assemble_laplace

            mf0, mm0 = self.levels[0], self.mms[0]
            A, Cm, _, _ = assemble_laplace(mf0.tria, degree)
            M = np.asarray((Cm.T @ A @ Cm).todense())
            fixed = np.zeros(mf0.n_dofs, dtype=bool)
            fixed[mf0.dof_handler.boundary_dofs()] = True
            fixed |= mf0.constraints.constrained_dof_marker()
            M[fixed, :] = 0.0
            M[:, fixed] = 0.0
            M[fixed, fixed] = 1.0
            Minv = np.linalg.inv(M)

        # ---- device phase --------------------------------------------------
        self.ops = [BrickDirichletLaplace(mm) for mm in self.mms]
        if self._coarse_direct:
            self._embed0 = DofEmbed(mm0)
            sc0 = self._embed0.tables
            Minv_d = jnp.asarray(Minv.astype(mf0.dtype))

            def _coarse(b_b, MinvT, sc):
                r = self._embed0.extract(b_b, sc)
                return self._embed0.embed(jnp.dot(r, MinvT), sc)

            self._jit_coarse = jax.jit(_coarse)
            self._coarse_args = (Minv_d.T, sc0)
        self.smoothers = []
        for op, mm, mf, inv in zip(self.ops, self.mms, self.levels,
                                   inv_diags):
            inv_b = mm.from_dof_vector(inv.astype(mf.dtype))
            self.smoothers.append(BrickChebyshev(op, inv_b, degree=n_smooth))
        self.transfers = [
            BrickTransfer(self.mms[i], self.mms[i + 1])
            for i in range(len(self.mms) - 1)
        ]

    def _vcycle(self, lvl: int, b):
        op = self.ops[lvl]
        if lvl == 0:
            if self._coarse_direct:
                return self._jit_coarse(b, *self._coarse_args)
            x, _, _ = solve_cg(
                op, b, tol=1e-10, max_iter=200, dot=op.mm.dot
            )
            return x
        sm = self.smoothers[lvl]
        x = sm.apply(b)
        r = b - op.vmult(x)
        r = op.project_rhs(r)
        rc = self.transfers[lvl - 1].restrict(r)
        rc = self.ops[lvl - 1].project_rhs(rc)
        xc = self._vcycle(lvl - 1, rc)
        x = x + op.project_rhs(self.transfers[lvl - 1].prolongate(xc))
        return sm.apply(b, x0=x)

    def __call__(self, b):
        return self._vcycle(len(self.levels) - 1, b)

    # ------------------------------------------------- device-resident solve
    def _params(self):
        """The whole preconditioner state as ONE jit-argument pytree (large
        closed-over constants would be embedded in the compiled program)."""
        P = dict(
            a=[mm._stage() for mm in self.mms],
            keep=[op.keep for op in self.ops],
            bd=[op.bd_mask for op in self.ops],
            inv=[sm.inv_diag for sm in self.smoothers],
            tr=[
                dict(d=t._dev, sc=t._sc, wf=t.mm_f.dot_mask())
                for t in self.transfers
            ],
            dmask=self.mms[-1].dot_mask(),
        )
        if self._coarse_direct:
            P["coarse"] = self._coarse_args
        return P

    # pure (traceable) building blocks — the un-jitted twins of the host
    # stepping path above, composed into ONE program by make_device_solver
    def _op_vmult_p(self, lvl, u, P):
        mm = self.mms[lvl]
        a, keep, bd = P["a"][lvl], P["keep"][lvl], P["bd"][lvl]
        w = mm._refill_impl(u * keep, a)
        v = mm._vmult_impl(w, a)
        return mm._refill_impl(v * keep + u * bd, a)

    def _prec_p(self, lvl, r, P):
        return self.mms[lvl]._refill_impl(P["inv"][lvl] * r, P["a"][lvl])

    def _project_p(self, lvl, b, P):
        return self.mms[lvl]._refill_impl(b * P["keep"][lvl], P["a"][lvl])

    def _smooth_p(self, lvl, b, x0, P):
        sm = self.smoothers[lvl]
        theta = 0.5 * (sm.lmax + sm.lmin)
        delta = 0.5 * (sm.lmax - sm.lmin)
        if x0 is None:
            x, r = jnp.zeros_like(b), b
        else:
            x, r = x0, b - self._op_vmult_p(lvl, x0, P)
        sigma = theta / delta
        rho = 1.0 / sigma
        d = self._prec_p(lvl, r, P) / theta
        for _ in range(sm.degree):
            x = x + d
            r = b - self._op_vmult_p(lvl, x, P)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + 2.0 * rho_new / delta * self._prec_p(
                lvl, r, P
            )
            rho = rho_new
        return x

    def _vcycle_p(self, lvl, b, P):
        if lvl == 0:
            MinvT, sc = P["coarse"]
            r = self._embed0.extract(b, sc)
            return self._embed0.embed(
                jnp.dot(r, MinvT, preferred_element_type=r.dtype), sc
            )
        t = self.transfers[lvl - 1]
        ti = P["tr"][lvl - 1]
        x = self._smooth_p(lvl, b, None, P)
        r = self._project_p(lvl, b - self._op_vmult_p(lvl, x, P), P)
        rc = t._restrict_impl(
            r, ti["d"], P["a"][lvl - 1], P["a"][lvl], ti["sc"], ti["wf"]
        )
        rc = self._project_p(lvl - 1, rc, P)
        xc = self._vcycle_p(lvl - 1, rc, P)
        x = x + self._project_p(
            lvl,
            t._prolongate_impl(xc, ti["d"], P["a"][lvl - 1], P["a"][lvl]),
            P,
        )
        return self._smooth_p(lvl, b, x, P)

    def make_device_solver(self, tol: float = 1e-5, max_iter: int = 100):
        """Fully device-resident GMG-preconditioned CG: the Krylov
        recurrence, every Chebyshev smoother, every transfer, and the dense
        coarse inverse run inside ONE jitted jax.lax.while_loop with
        on-device residual control; the host fetches only the final
        (iterations, residual) scalars. This removes the per-step dispatch +
        sync chain of the host loop (the reference's timing discipline
        keeps its 100-rep loops free of per-rep host work the same way,
        benchmark_03.h:471-507).

        Returns solve(b) -> (x, n_iters, res_norm); a debug host-stepping
        path stays available through models.multigrid.solve_cg."""
        if not self._coarse_direct:
            raise NotImplementedError(
                "device-resident solve requires coarse='direct'"
            )
        L = len(self.mms) - 1
        max_it = jnp.asarray(max_iter, jnp.int32)

        def solve_impl(b, P):
            dmask = P["dmask"]

            def dot(u, v):
                return jnp.sum(dmask * u * v)

            b2 = dot(b, b)
            tol2 = jnp.asarray(tol, b.dtype) ** 2 * b2
            z0 = self._vcycle_p(L, b, P)
            state = (
                jnp.zeros_like(b), b, z0, z0, dot(b, z0),
                jnp.asarray(0, jnp.int32),
            )

            def cond(s):
                _, r, _, _, _, it = s
                return (dot(r, r) > tol2) & (it < max_it)

            def body(s):
                x, r, z, p, rz, it = s
                Ap = self._op_vmult_p(L, p, P)
                alpha = rz / dot(p, Ap)
                x = x + alpha * p
                r = r - alpha * Ap
                z = self._vcycle_p(L, r, P)
                rz_new = dot(r, z)
                p = z + (rz_new / rz) * p
                return (x, r, z, p, rz_new, it + 1)

            x, r, _, _, _, it = jax.lax.while_loop(cond, body, state)
            return x, it, jnp.sqrt(dot(r, r))

        jitted = jax.jit(solve_impl)
        prec = self.mms[-1]._matmul_precision

        def solve(b):
            with jax.default_matmul_precision(prec):
                x, it, res = jitted(b, self._params())
            return x, int(it), float(res)

        return solve

    @property
    def fine_op(self):
        return self.ops[-1]

    @property
    def fine_mm(self):
        return self.mms[-1]

    @property
    def fine_mf(self):
        return self.levels[-1]
