"""MatrixFree data structure and cell loop (capabilities C4, C6, C7).

Setup (NumPy, trace time) turns (Triangulation, degree) into static device
tensors: the fast per-cell DoF map (hanging slots replaced by coarse
masters), compressed constraint masks, geometry factors, and the slow-path
constraint CSR. Execution is a single jitted program per operator
application: gather → in-register HN interpolation → cell kernel →
transpose HN → segment-sum scatter (the JAX analog of
MatrixFree::cell_loop + FEEvaluation, benchmark_01.h:579-617).

The reference's vectorization knobs map as:
- hn_mode="compact"  — gather the constrained-cell subset, interpolate, write
  back ("index" runner analog; cheap when HN cells are a small fraction).
- hn_mode="all"      — masked interpolation over every cell batch
  ("group"/vectorized runner analog; no gathers, more FLOPs).
- categorize=True    — setup-time stable sort of cells by mask so constrained
  cells form one contiguous tail slice ("sorted" runner /
  cell_vectorization_category analog, benchmark_01.h:258-284).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .constraints import build_constraints
from .dof_handler import DoFHandler
from .elements import shape_info
from .mapping import cartesian_laplace_factors, deformed_laplace_factors
from .mesh import Triangulation
from .ops.hanging_nodes import apply_hanging_node_constraints

__all__ = ["MatrixFree"]


class MatrixFree:
    def __init__(
        self,
        tria: Triangulation,
        degree: int,
        dtype=np.float64,
        hn_mode: str = "compact",
        categorize: bool = False,
        high_order_mapping: bool = False,
    ):
        if hn_mode not in ("compact", "all", "sorted", "matrix"):
            raise ValueError(f"unknown hn_mode {hn_mode!r}")
        if hn_mode == "sorted":
            categorize = True
        self.tria = tria
        self.degree = degree
        self.dim = tria.dim
        self.dtype = np.dtype(dtype)
        self.hn_mode = hn_mode
        self.categorize = categorize
        self.shape = shape_info(degree)
        self.dof_handler = DoFHandler(tria, degree)
        self.constraints = build_constraints(self.dof_handler)
        self.n_dofs = self.dof_handler.n_dofs
        self.n_cells = tria.n_active_cells

        masks = self.constraints.masks.astype(np.int32)
        # asarray, not astype: cell maps are already int32 — a cast would
        # copy 1 GB at nref=8 (host page faults are the setup wall)
        dofmap = np.asarray(self.constraints.cell_dofs_fast, dtype=np.int32)
        dofmap_plain = np.asarray(self.dof_handler.cell_dofs, dtype=np.int32)
        if high_order_mapping:
            geo = deformed_laplace_factors(tria, self.shape)
        else:
            geo = cartesian_laplace_factors(tria)
        self.high_order_mapping = high_order_mapping

        self.cell_permutation = np.arange(self.n_cells)
        if categorize:
            # stable sort by mask: unconstrained cells (mask 0) first, then
            # groups of identical masks — the "sorted"/categorize variant.
            perm = np.argsort(masks, kind="stable")
            self.cell_permutation = perm
            masks, dofmap, dofmap_plain = masks[perm], dofmap[perm], dofmap_plain[perm]
            geo = geo[perm]

        hn_idx = np.nonzero(masks != 0)[0]
        self.n_hn_cells = len(hn_idx)
        self._first_hn = int(hn_idx[0]) if len(hn_idx) else self.n_cells

        # "matrix" runner: per-distinct-mask composite interpolation matrix
        # Q_mask = (sweep_2 ∘ sweep_1 ∘ sweep_0)(I), so the whole in-register
        # interpolation becomes one small matmul per mask group — the
        # dense-composite evolution of the "sorted" runner. Built eagerly
        # (must not run under a jit trace).
        self._hn_matrix_groups = None

        # ---- host tensors; device staging is LAZY, so callers can finish
        # all host setup before the first device use.
        ci = self.constraints
        self._np = dict(
            dofmap=dofmap,
            dofmap_plain=dofmap_plain,
            masks=masks,
            hn_idx=hn_idx.astype(np.int32),
            hn_masks=masks[hn_idx],
            geo=geo.astype(self.dtype),
            S=self.shape.S.astype(self.dtype),
            D=self.shape.D.astype(self.dtype),
            Dc=self.shape.Dc.astype(self.dtype),
            P=self.shape.P.astype(self.dtype),
            quad_w=self.shape.quad_weights_tensor(self.dim).astype(self.dtype),
            slow=dict(
                slave=ci.slave_dofs.astype(np.int32),
                row=np.repeat(
                    np.arange(len(ci.slave_dofs), dtype=np.int32),
                    np.diff(ci.row_ptr),
                ),
                col=ci.col.astype(np.int32),
                w=ci.weight.astype(self.dtype),
            ),
        )
        self._staged = None
        if hn_mode == "matrix":
            self._hn_matrix_data()  # eager: must not build under a jit trace

    # ------------------------------------------------------------------
    def initialize_dof_vector(self, fill=0.0) -> jnp.ndarray:
        return jnp.full((self.n_dofs,), fill, dtype=self.dtype)

    @property
    def arrays(self) -> dict:
        """All device tensors as one pytree, to be passed as jit ARGUMENTS.

        Closing over multi-MB arrays embeds them as constants in the HLO,
        which explodes compile time and can defeat fast gather paths — always
        thread this pytree through jitted entry points instead. Staged to
        device lazily on first access.
        """
        if self._staged is None:
            staged = jax.tree.map(jnp.asarray, self._np)
            if any(
                isinstance(leaf, jax.core.Tracer)
                for leaf in jax.tree.leaves(staged)
            ):
                # first touch happened inside a jit/shard_map trace: the
                # converted values are tracers — use them for this trace but
                # do NOT cache (they would leak out of the transformation)
                return staged
            self._staged = staged
        return self._staged

    def __getattr__(self, name):
        # lazy device views of the setup tensors (dofmap, masks, geo, ...)
        np_store = self.__dict__.get("_np")
        if np_store is not None and name in np_store:
            return self.arrays[name]
        if np_store is not None and name == "_slow":
            return self.arrays["slow"]
        raise AttributeError(name)

    # ---- fast hanging-node application (C2) ---------------------------
    def _hn_matrix_data(self):
        """Per-mask composite matrices for hn_mode="matrix" (built eagerly).

        Scales to meshes with hundreds of distinct masks (annulus-style, 80%
        constrained): only mask groups with > 256 cells get their own
        gather/matmul pair; the long tail of small groups is padded into ONE
        batched [G, m_max] gather + einsum + scatter, so the op count is
        O(1) in the number of distinct masks."""
        if self._hn_matrix_groups is None:
            from .ops.hanging_nodes import apply_hanging_node_constraints as hn

            n_loc = self.shape.n_dofs_per_cell(self.dim)
            masks_np = self._np["masks"]
            hn_idx = self._np["hn_idx"]
            uniq = np.unique(masks_np[hn_idx])
            eye = jnp.eye(n_loc, dtype=self.dtype)
            large, small = [], []
            for mv in uniq:
                # columns of Q: kernel applied to identity basis vectors
                Q = np.asarray(
                    hn(eye, jnp.full((n_loc,), int(mv), jnp.int32),
                       jnp.asarray(self.shape.P, dtype=self.dtype), self.dim)
                ).T  # rows act on cell values: out = u @ Q^T
                cells = hn_idx[masks_np[hn_idx] == mv]
                (large if len(cells) > 256 else small).append((cells, Q))
            groups = [
                dict(
                    cells=jnp.asarray(c.astype(np.int32)),
                    Q=jnp.asarray(Q, dtype=self.dtype),
                )
                for c, Q in large
            ]
            batched = None
            if small:
                m_max = max(len(c) for c, _ in small)
                G = len(small)
                cells_pad = np.empty((G, m_max), dtype=np.int32)
                Qs = np.empty((G, n_loc, n_loc), dtype=self.dtype)
                for i, (c, Q) in enumerate(small):
                    # pad slots repeat the group's first cell: the duplicate
                    # scatter writes carry identical values, so the .set is
                    # deterministic
                    cells_pad[i] = c[0]
                    cells_pad[i, : len(c)] = c
                    Qs[i] = Q
                batched = dict(
                    cells=jnp.asarray(cells_pad), Qs=jnp.asarray(Qs)
                )
            self._hn_matrix_groups = (groups, batched)
        return self._hn_matrix_groups

    def apply_hanging_node_constraints(self, u: jnp.ndarray, transpose: bool, arrays=None):
        """In-register HN interpolation on cell-local values [n_cells, n_loc]."""
        a = arrays if arrays is not None else self.arrays
        if self.n_hn_cells == 0:
            return u
        if self.hn_mode == "matrix":
            groups, batched = self._hn_matrix_data()
            for g in groups:
                rows = jnp.take(u, g["cells"], axis=0)
                Q = g["Q"].T if transpose else g["Q"]
                u = u.at[g["cells"]].set(
                    jnp.dot(rows, Q.T, preferred_element_type=u.dtype)
                )
            if batched is not None:
                rows = jnp.take(u, batched["cells"].reshape(-1), axis=0)
                rows = rows.reshape(batched["cells"].shape + rows.shape[-1:])
                spec = "gmj,gji->gmi" if transpose else "gmj,gij->gmi"
                out = jnp.einsum(spec, rows, batched["Qs"],
                                 preferred_element_type=u.dtype)
                u = u.at[batched["cells"].reshape(-1)].set(
                    out.reshape(-1, out.shape[-1])
                )
            return u
        if self.hn_mode == "all":
            return apply_hanging_node_constraints(
                u, a["masks"], a["P"], self.dim, transpose
            )
        if self.hn_mode == "sorted":
            head, tail = u[: self._first_hn], u[self._first_hn :]
            tail = apply_hanging_node_constraints(
                tail, a["masks"][self._first_hn :], a["P"], self.dim, transpose
            )
            return jnp.concatenate([head, tail], axis=0)
        sub = u[a["hn_idx"]]
        sub = apply_hanging_node_constraints(
            sub, a["hn_masks"], a["P"], self.dim, transpose
        )
        return u.at[a["hn_idx"]].set(sub)

    # ---- slow-path constraint resolution on the global vector (C5) ----
    def distribute_slow(self, src: jnp.ndarray, arrays=None) -> jnp.ndarray:
        """u[slave] <- sum w * u[master] (AffineConstraints::distribute)."""
        s = (arrays or self.arrays)["slow"]
        if s["slave"].shape[0] == 0:
            return src
        vals = jax.ops.segment_sum(
            s["w"] * src[s["col"]], s["row"], num_segments=s["slave"].shape[0]
        )
        return src.at[s["slave"]].set(vals)

    def compress_slow(self, dst: jnp.ndarray, arrays=None) -> jnp.ndarray:
        """Fold slave rows into masters (C^T), zeroing slave entries."""
        s = (arrays or self.arrays)["slow"]
        if s["slave"].shape[0] == 0:
            return dst
        contrib = dst[s["slave"]]
        dst = dst.at[s["slave"]].set(0)
        return dst.at[s["col"]].add(s["w"] * contrib[s["row"]])

    # ---- gather / scatter (C4) ----------------------------------------
    def read_dof_values_plain(self, src: jnp.ndarray, slow: bool = False, arrays=None):
        a = arrays if arrays is not None else self.arrays
        return src[a["dofmap_plain"] if slow else a["dofmap"]]

    def read_dof_values(self, src: jnp.ndarray, slow: bool = False, arrays=None):
        a = arrays if arrays is not None else self.arrays
        if slow:
            return self.distribute_slow(src, a)[a["dofmap_plain"]]
        return self.apply_hanging_node_constraints(src[a["dofmap"]], False, a)

    def distribute_local_to_global_plain(
        self, u: jnp.ndarray, slow: bool = False, arrays=None
    ) -> jnp.ndarray:
        a = arrays if arrays is not None else self.arrays
        dofmap = a["dofmap_plain"] if slow else a["dofmap"]
        dst = jnp.zeros(self.n_dofs, dtype=u.dtype)
        return dst.at[dofmap.reshape(-1)].add(u.reshape(-1))

    def distribute_local_to_global(self, u: jnp.ndarray, slow: bool = False, arrays=None):
        a = arrays if arrays is not None else self.arrays
        if slow:
            dst = jnp.zeros(self.n_dofs, dtype=u.dtype)
            dst = dst.at[a["dofmap_plain"].reshape(-1)].add(u.reshape(-1))
            return self.compress_slow(dst, a)
        u = self.apply_hanging_node_constraints(u, True, a)
        dst = jnp.zeros(self.n_dofs, dtype=u.dtype)
        return dst.at[a["dofmap"].reshape(-1)].add(u.reshape(-1))

    # ---- cell loop (C7) ------------------------------------------------
    def cell_loop(self, cell_kernel, src: jnp.ndarray, *, constraints=True,
                  slow: bool = False, arrays=None) -> jnp.ndarray:
        """dst = scatter(kernel(gather(src))) — one fused jittable program."""
        a = arrays if arrays is not None else self.arrays
        if constraints:
            u = self.read_dof_values(src, slow=slow, arrays=a)
        else:
            u = self.read_dof_values_plain(src, slow=slow, arrays=a)
        v = cell_kernel(u, a)
        if constraints:
            return self.distribute_local_to_global(v, slow=slow, arrays=a)
        return self.distribute_local_to_global_plain(v, slow=slow, arrays=a)
