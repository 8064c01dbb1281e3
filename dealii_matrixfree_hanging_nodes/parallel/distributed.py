"""Distributed matrix-free operator over a jax.sharding.Mesh (capability C9).

Replacement for the reference's MPI stack
(LinearAlgebra::distributed::Vector + partitioner ghost exchange inside
MatrixFree::cell_loop, benchmark_02.cc:122-209):

- cells are partitioned into contiguous Morton ranges per chip (partition.py),
- global DoFs are renumbered owner-major so each chip's owned dofs are one
  contiguous, equal-padded shard,
- vmult runs under shard_map: all_gather of the owned shards (ghost update)
  -> local gather / HN interpolation / cell kernel / transpose HN -> local
  scatter-add -> psum_scatter (the reverse-halo compress(add)).

The collectives run under shard_map; `perform_communication=False` swaps
them for identity ops, reproducing the reference's no-comm ablation
(benchmark_02.cc:204-209). Per-rank ghost/import counts are recorded like the
partitioner statistics dumped to CSV at benchmark_02.cc:136-165.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..matrix_free import MatrixFree
from ..ops.hanging_nodes import apply_hanging_node_constraints
from ..ops.sum_factorization import evaluate_gradients, integrate_gradients
from .partition import dof_owners, partition_cells

__all__ = ["DistributedLaplace"]


class DistributedLaplace:
    """Laplace vmult sharded over a 1D device mesh axis ("cells")."""

    def __init__(
        self,
        mf: MatrixFree,
        devices=None,
        weights=None,
        perform_communication: bool = True,
        axis_name: str = "cells",
        sm_group_size: int | None = None,
        exchange: str = "allgather",
    ):
        """sm_group_size: hierarchical communication analog of the
        reference's MPI-3 shared-memory communicator (communicator_sm,
        benchmark_02.cc:122-123): devices are arranged on a 2D
        (inter-group x intra-group) mesh and the ghost all_gather runs in
        two stages: the inner stage within a group, the outer across
        groups. Off by default; a 1-D mesh suits GPUs joined all to all."""
        if exchange not in ("allgather", "halo"):
            raise ValueError(f"unknown exchange mode {exchange!r}")
        if exchange == "halo" and sm_group_size:
            raise ValueError("halo exchange and sm groups are exclusive")
        self.mf = mf
        self.exchange = exchange
        devices = devices if devices is not None else jax.devices()
        self.n_ranks = len(devices)
        self.axis_name = axis_name
        self.sm_group_size = sm_group_size
        if sm_group_size:
            assert self.n_ranks % sm_group_size == 0
            grid = np.array(devices).reshape(-1, sm_group_size)
            self.mesh = Mesh(grid, ("nodes", axis_name))
        else:
            self.mesh = Mesh(np.array(devices), (axis_name,))
        self.perform_communication = perform_communication
        self._setup(weights)
        self._build_step()

    # ------------------------------------------------------------ setup
    def _setup(self, weights):
        mf, R = self.mf, self.n_ranks
        n_cells, n_dofs = mf.n_cells, mf.n_dofs
        # host copies (avoid triggering device staging during setup)
        dofmap = mf._np["dofmap"]
        masks = mf._np["masks"]
        geo = mf._np["geo"]

        self.rank_of_cell = partition_cells(n_cells, R, weights)
        owner = dof_owners(mf._np["dofmap_plain"], self.rank_of_cell, n_dofs)
        # every dof must be referenced by some cell
        assert owner.max() < R

        # owner-major renumbering with equal padding per rank
        order = np.lexsort((np.arange(n_dofs), owner))
        n_own = np.bincount(owner, minlength=R)
        self.n_own = n_own
        n_own_max = int(n_own.max())
        self.n_own_max = n_own_max
        slot_in_rank = np.concatenate([np.arange(c) for c in n_own])
        padded_id = np.empty(n_dofs, dtype=np.int64)
        padded_id[order] = owner[order] * n_own_max + slot_in_rank
        self.padded_id = padded_id  # old dof id -> padded global id
        self.n_padded = R * n_own_max

        # per-rank padded cell arrays
        counts = np.bincount(self.rank_of_cell, minlength=R)
        n_cell_max = int(counts.max())
        self.n_cell_max = n_cell_max
        n_loc = dofmap.shape[1]
        dm = np.zeros((R, n_cell_max, n_loc), dtype=np.int32)
        mk = np.zeros((R, n_cell_max), dtype=np.int32)
        ge = np.zeros((R, n_cell_max) + geo.shape[1:], dtype=geo.dtype)
        self.local_index_of_cell = np.zeros(n_cells, dtype=np.int64)
        for r in range(R):
            sel = np.nonzero(self.rank_of_cell == r)[0]
            dm[r, : len(sel)] = padded_id[dofmap[sel]]
            mk[r, : len(sel)] = masks[sel]
            ge[r, : len(sel)] = geo[sel]  # pad cells keep geo=0 => no output
            self.local_index_of_cell[sel] = np.arange(len(sel))

        self.dofmap_r = jnp.asarray(dm)
        self.masks_r = jnp.asarray(mk)
        self.geo_r = jnp.asarray(ge)

        # ghost / import statistics (benchmark_02.cc:136-165 analog)
        self.n_ghost = np.zeros(R, dtype=np.int64)
        referenced_by = [set() for _ in range(R)]
        for r in range(R):
            sel = self.rank_of_cell == r
            refs = np.unique(mf._np["dofmap_plain"][sel])
            self.n_ghost[r] = int(np.count_nonzero(owner[refs] != r))
            for rr in np.unique(owner[refs]):
                if rr != r:
                    referenced_by[rr].update(refs[owner[refs] == rr].tolist())
        self.n_import = np.array([len(s) for s in referenced_by], dtype=np.int64)

        if self.exchange == "halo":
            self._build_halo_plan(owner)

    # ------------------------------------------------------- halo plan
    def _build_halo_plan(self, owner):
        """Static halo-exchange plan: per (receiver r, sender s) the padded
        list of s-owned dofs referenced by r's cells. The exchange is ONE
        lax.all_to_all of [R, max_pair] buffers per direction — traffic is
        the actual ghost set (padded), not the whole vector
        (LinearAlgebra::distributed::Vector partitioner semantics)."""
        mf, R = self.mf, self.n_ranks
        dofmap_plain = mf._np["dofmap_plain"]
        dofmap = mf._np["dofmap"]
        n_own_max = self.n_own_max

        ghost = [[np.zeros(0, np.int64)] * R for _ in range(R)]
        for r in range(R):
            refs = np.unique(dofmap[self.rank_of_cell == r])
            for srank in range(R):
                if srank != r:
                    ghost[r][srank] = refs[owner[refs] == srank]
        max_pair = max(
            (len(ghost[r][srank]) for r in range(R) for srank in range(R)), default=1
        )
        max_pair = max(max_pair, 1)
        self.halo_max_pair = max_pair

        # send_idx[r, s, :]: local slots (in r's shard) r sends to s
        send_idx = np.zeros((R, R, max_pair), dtype=np.int32)
        send_valid = np.zeros((R, R, max_pair), dtype=bool)
        for r in range(R):
            for srank in range(R):
                g = ghost[srank][r]  # what srank needs FROM r
                loc = self.padded_id[g] - r * n_own_max
                assert (loc >= 0).all() and (loc < n_own_max).all()
                send_idx[r, srank, : len(loc)] = loc
                send_valid[r, srank, : len(loc)] = True

        # local dofmaps: global padded id -> [own | ghost-blocks] position
        local_size = n_own_max + R * max_pair
        dm_local = np.zeros((R, self.n_cell_max, dofmap.shape[1]), dtype=np.int32)
        for r in range(R):
            lut = {}
            for srank in range(R):
                for j, d in enumerate(ghost[r][srank]):
                    lut[int(self.padded_id[d])] = n_own_max + srank * max_pair + j
            sel = np.nonzero(self.rank_of_cell == r)[0]
            pad_ids = self.padded_id[dofmap[sel]]
            own_lo, own_hi = r * n_own_max, (r + 1) * n_own_max
            local = np.empty_like(pad_ids, dtype=np.int64)
            own_mask = (pad_ids >= own_lo) & (pad_ids < own_hi)
            local[own_mask] = pad_ids[own_mask] - own_lo
            flat = pad_ids[~own_mask]
            local[~own_mask] = np.array([lut[int(x)] for x in flat], dtype=np.int64)
            dm_local[r, : len(sel)] = local
        self.halo = dict(
            send_idx=jnp.asarray(send_idx),
            send_valid=jnp.asarray(send_valid.astype(np.float32)),
            dm_local=jnp.asarray(dm_local),
            local_size=local_size,
        )

    # ------------------------------------------------------------ step
    def _build_step(self):
        mf = self.mf
        dim = mf.dim
        ax = self.axis_name
        comm = self.perform_communication

        sm = self.sm_group_size

        if mf.high_order_mapping:
            # deformed (MappingQCache analog, benchmark_01.h:227-242): geo is
            # the packed per-quad-point symmetric metric [c, n_q, d*(d+1)/2]
            # (quadrature weights folded in), applied exactly as in the
            # single-chip kernel (models/laplace.py)
            pairs = [(x, y) for x in range(dim) for y in range(x, dim)]

            def scale_gradients(g, geo):
                out = [jnp.zeros_like(g[:, 0]) for _ in range(dim)]
                for k, (x, y) in enumerate(pairs):
                    out[x] = out[x] + geo[:, :, k] * g[:, y]
                    if x != y:
                        out[y] = out[y] + geo[:, :, k] * g[:, x]
                return jnp.stack(out, axis=1)
        else:
            # Cartesian: per-axis factors [c, dim] times the quadrature weight
            def scale_gradients(g, geo):
                return g * geo[:, :, None] * mf.quad_w[None, None, :]

        def local_vmult(src_own, dofmap, masks, geo):
            # src_own: [1, n_own_max] local shard; squeeze rank axis
            src_own = src_own[0]
            dofmap, masks, geo = dofmap[0], masks[0], geo[0]
            if comm and sm:
                # two-stage ghost update: intra-group then inter-group
                intra = jax.lax.all_gather(src_own, ax, tiled=True)
                full = jax.lax.all_gather(intra, "nodes", tiled=True)
            elif comm:
                full = jax.lax.all_gather(src_own, ax, tiled=True)
            else:
                # no-comm ablation: pretend the local shard tiles the domain
                full = jnp.tile(src_own, self.n_ranks)
            u = full[dofmap]
            u = apply_hanging_node_constraints(u, masks, mf.P, dim, False)
            g = evaluate_gradients(u, mf.S, mf.Dc, dim)
            g = scale_gradients(g, geo)
            v = integrate_gradients(g, mf.S, mf.Dc, dim)
            v = apply_hanging_node_constraints(v, masks, mf.P, dim, True)
            contrib = jnp.zeros(self.n_padded, dtype=v.dtype)
            contrib = contrib.at[dofmap.reshape(-1)].add(v.reshape(-1))
            if comm and sm:
                # reverse halo in two stages: inter-group reduce first,
                # then scatter within the fast domain
                part = jax.lax.psum_scatter(
                    contrib, "nodes", scatter_dimension=0, tiled=True
                )
                own = jax.lax.psum_scatter(part, ax, scatter_dimension=0, tiled=True)
            elif comm:
                own = jax.lax.psum_scatter(contrib, ax, scatter_dimension=0, tiled=True)
            else:
                own = contrib[: self.n_own_max]
            return own[None, :]

        if self.exchange == "halo":
            halo = self.halo
            n_own_max = self.n_own_max
            R = self.n_ranks

            def local_vmult_halo(src_own, dm_local, masks, geo, send_idx, send_valid):
                src_own = src_own[0]
                dm_local, masks, geo = dm_local[0], masks[0], geo[0]
                send_idx, send_valid = send_idx[0], send_valid[0]
                # forward halo: one all_to_all of the padded ghost buffers
                send = src_own[send_idx] * send_valid
                recv = jax.lax.all_to_all(send, ax, split_axis=0, concat_axis=0, tiled=False)
                local = jnp.concatenate([src_own, recv.reshape(-1)])
                u = local[dm_local]
                u = apply_hanging_node_constraints(u, masks, mf.P, dim, False)
                g = evaluate_gradients(u, mf.S, mf.Dc, dim)
                g = scale_gradients(g, geo)
                v = integrate_gradients(g, mf.S, mf.Dc, dim)
                v = apply_hanging_node_constraints(v, masks, mf.P, dim, True)
                acc = jnp.zeros(halo["local_size"], dtype=v.dtype)
                acc = acc.at[dm_local.reshape(-1)].add(v.reshape(-1))
                own = acc[:n_own_max]
                ghosts = acc[n_own_max:].reshape(R, -1)
                # reverse halo: return contributions to their owners
                back = jax.lax.all_to_all(ghosts, ax, split_axis=0, concat_axis=0, tiled=False)
                own = own.at[send_idx.reshape(-1)].add(
                    (back * send_valid).reshape(-1)
                )
                return own[None, :]

            spec = P(ax)
            self._vmult_halo = jax.jit(
                jax.shard_map(
                    local_vmult_halo,
                    mesh=self.mesh,
                    in_specs=(spec,) * 6,
                    out_specs=spec,
                )
            )

        if self.sm_group_size:
            spec = P(("nodes", ax))
        else:
            spec = P(ax)
        self._vmult = jax.jit(
            jax.shard_map(
                local_vmult,
                mesh=self.mesh,
                in_specs=(spec, spec, spec, spec),
                out_specs=spec,
            )
        )

    # ------------------------------------------------------------ api
    def scatter_vector(self, u: np.ndarray) -> jnp.ndarray:
        """Old-numbering global vector -> sharded padded vector [R, n_own_max]."""
        out = np.zeros(self.n_padded, dtype=self.mf.dtype)
        out[self.padded_id] = u
        arr = out.reshape(self.n_ranks, self.n_own_max)
        spec = (
            P(("nodes", self.axis_name)) if self.sm_group_size else P(self.axis_name)
        )
        return jax.device_put(arr, jax.sharding.NamedSharding(self.mesh, spec))

    def gather_vector(self, v: jnp.ndarray) -> np.ndarray:
        """Sharded padded vector -> old-numbering global vector."""
        return np.asarray(v).reshape(-1)[self.padded_id]

    def vmult(self, src_sharded: jnp.ndarray) -> jnp.ndarray:
        # full f32 products (XLA's GPU default for f32 dots may use TF32)
        with jax.default_matmul_precision("highest"):
            if self.exchange != "halo":
                return self._vmult(
                    src_sharded, self.dofmap_r, self.masks_r, self.geo_r)
            h = self.halo
            if "dm_local_s" not in h:
                sharding = jax.sharding.NamedSharding(
                    self.mesh, P(self.axis_name))
                for k in ("dm_local", "send_idx", "send_valid"):
                    h[k + "_s"] = jax.device_put(h[k], sharding)
            return self._vmult_halo(
                src_sharded, h["dm_local_s"], self.masks_r, self.geo_r,
                h["send_idx_s"], h["send_valid_s"],
            )
