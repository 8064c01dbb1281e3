"""Distributed brick engine — the flagship vmult sharded over a device mesh.

Analog of the reference's distributed cell_loop on the fast
hanging-node path (MatrixFree::cell_loop over parallel::distributed::
Triangulation with ghost exchange, benchmark_02.cc:122-209), built on the
brick layout instead of per-cell gather/scatter:

- bricks (not cells) are partitioned into contiguous weighted ranges along
  the Morton curve of brick origins (the p4est SFC-repartition analog,
  benchmark_02.cc:63-87); each device owns a padded slab [nb_max, N3p];
- the main Kronecker-separable operator and the absent-(hole-)cell
  corrections are embarrassingly brick-local: zero communication;
- cross-brick direct-stiffness summation splits interface pools into
  device-INTERNAL pools (summed locally, no traffic) and BOUNDARY pools
  (only pools whose touching bricks span devices) — the
  partitioner-ghost-exchange analog (LinearAlgebra::distributed::Vector
  semantics, benchmark_02.cc:164-165);
- the hanging-node constraint chain (HN^T, chained coarse-fine folds, fill)
  couples only "chain cells" (constrained cells + their coarse fold
  destinations).

Two exchange modes:

- ``exchange="halo"`` (default): NEIGHBOR-WISE, the analog of the
  reference partitioner's ghost-index-only point-to-point exchange
  (benchmark_02.cc:136-165). Boundary-pool partial sums travel in ONE
  pairwise ``all_to_all`` whose per-pair payload is exactly the interface
  the two ranks share; chain rows travel in a second pairwise
  ``all_to_all`` delivering only the rows each rank actually needs (the
  connected component of the fold/fill transfer graph that touches its
  own cells), and the chain then runs on that per-rank compact subset.
  Traffic per rank = its geometric interface + its chain-component halo.
- ``exchange="replicated"``: boundary pools are psum'd globally and the
  chain block is all_gathered and run redundantly on every device. Kept
  as the round-2 baseline and as a cross-check oracle; it does not scale
  past a few chips (ghost volume grows with the GLOBAL constraint count).

All collectives run under shard_map (NCCL between GPUs); the
`perform_communication=False` ablation elides them like the reference's
no-comm mode (benchmark_02.cc:204-209).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bricks import _EXACT, BrickLaplaceMM
from ..matrix_free import MatrixFree
from ..mesh import _interleave_bits

__all__ = ["DistributedBrickLaplace"]


def _pad_rows(rows: list[np.ndarray], fill, dtype=None) -> np.ndarray:
    """Stack variable-length 1D arrays into [R, max_len] with fill."""
    m = max((len(r) for r in rows), default=0)
    m = max(m, 1)
    out = np.full((len(rows), m), fill, dtype=dtype or np.asarray(rows[0]).dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


class DistributedBrickLaplace:
    """Brick-engine Laplace vmult sharded over a 1D device mesh axis."""

    def __init__(
        self,
        mf: MatrixFree,
        devices=None,
        weights=None,
        brick_size: int | None = None,
        perform_communication: bool = True,
        axis_name: str = "bricks",
        matmul_precision: str = "highest",
        exchange: str = "halo",
    ):
        """weights: optional per-CELL weights (reference's
        hanging_nodes_weighting form); brick weight = sum over its cells.
        exchange: "halo" (neighbor-wise pairwise all_to_all, default) or
        "replicated" (global psum / all_gather baseline)."""
        if exchange not in ("halo", "replicated"):
            raise ValueError(f"unknown exchange mode {exchange!r}")
        self.mf = mf
        self.axis_name = axis_name
        self.exchange = exchange
        self.perform_communication = perform_communication
        devices = devices if devices is not None else jax.devices()
        self.n_ranks = len(devices)
        self.mesh = Mesh(np.array(devices), (axis_name,))
        # single-chip engine: reused for constants (Kb/Mb/Fxy/K/E/Es/P/hn_Q)
        # and the extract/scatter/main-apply/hn-apply building blocks
        # the distributed step drives the per-cell chain machinery; the
        # face-plane schedule needs its own cross-rank pair exchange
        self.mm = BrickLaplaceMM(mf, brick_size, matmul_precision,
                                 face_planes=False)
        self._setup(weights)
        self._build_step()

    # ------------------------------------------------------------- partition
    def _setup(self, weights):
        mm, mf, R = self.mm, self.mf, self.n_ranks
        bs = mm.bs
        B, dim, C = bs.B, bs.dim, bs.B**bs.dim
        N3p = mm.N3p
        nb = bs.n_bricks

        # Morton order of brick origins (level-anchored), the SFC the
        # contiguous partition ranges follow (benchmark_02.cc:63-87 analog)
        lmax = int(bs.brick_level.max())
        anchored = bs.brick_coord << (lmax - bs.brick_level[:, None])
        mkey = _interleave_bits(anchored, lmax + 1)
        order = np.lexsort((bs.brick_level, mkey))
        self.brick_order = order

        # per-brick weight = sum of present-cell weights
        if weights is None:
            cell_w = np.ones(mf.n_cells)
        else:
            cell_w = np.asarray(weights, dtype=np.float64)
        bw = np.zeros(nb)
        np.add.at(bw, bs.brick_of_cell, cell_w)
        cum = np.cumsum(bw[order])
        targets = cum[-1] * (np.arange(1, R) / R)
        cuts = np.searchsorted(cum, targets, side="right")
        rank_of_pos = np.zeros(nb, dtype=np.int32)
        for r, c in enumerate(cuts):
            rank_of_pos[c:] = r + 1
        rank_of_brick = np.empty(nb, dtype=np.int32)
        rank_of_brick[order] = rank_of_pos
        self.rank_of_brick = rank_of_brick
        self.rank_of_cell = rank_of_brick[bs.brick_of_cell]

        bricks_r = [order[rank_of_pos == r] for r in range(R)]
        self.bricks_r = bricks_r
        self.nb_r = np.array([len(b) for b in bricks_r])
        self.nb_max = nb_max = max(int(self.nb_r.max()), 1)
        # global brick id per slab row (pad -> brick 0, masked out everywhere)
        self.slab_brick = _pad_rows(bricks_r, 0, np.int64)  # [R, nb_max]
        slab_valid = _pad_rows(
            [np.ones(len(b), bool) for b in bricks_r], False, bool
        )
        self.slab_valid = slab_valid
        # slab position of each global brick
        self.slabpos_of_brick = np.full(nb, -1, dtype=np.int64)
        for r in range(R):
            self.slabpos_of_brick[bricks_r[r]] = np.arange(len(bricks_r[r]))

        dt = mf.dtype
        np_ = mm._np_arrays
        geo_r = np.zeros((R, nb_max), dtype=dt)
        nv_r = np.zeros((R, nb_max, N3p), dtype=bool)
        dotm_r = np.zeros((R, nb_max, N3p), dtype=dt)
        dot_mask = np.zeros((nb, N3p), dtype=dt)
        dot_mask[:, : mm.N3] = bs.dot_mask.reshape(nb, mm.N3)
        geo_g = np.asarray(np_["geo"])
        nv_g = np.asarray(np_["node_valid"])
        for r in range(R):
            k = len(bricks_r[r])
            geo_r[r, :k] = geo_g[bricks_r[r]]
            nv_r[r, :k] = nv_g[bricks_r[r]]
            dotm_r[r, :k] = dot_mask[bricks_r[r]]

        # ---- DSS pools: internal (local sum) vs boundary (psum) ----------
        def split_pools(pool_id, n_pools):
            """pool_id [nb, k] -> per-rank internal ids + global boundary ids.

            Internal pools (all touching bricks on one rank) get per-rank
            local slots; boundary pools get a shared global numbering whose
            buffer is psum'd — the only cross-device DSS traffic. Boundary
            (and pad-brick) entries carry flag=1 / int slot 0; their internal
            writes and reads are masked by the flag, so no sentinels are
            needed on the internal side."""
            owner_min = np.full(n_pools, R, dtype=np.int64)
            owner_max = np.full(n_pools, -1, dtype=np.int64)
            rk = np.broadcast_to(rank_of_brick[:, None], pool_id.shape)
            np.minimum.at(owner_min, pool_id.reshape(-1), rk.reshape(-1))
            np.maximum.at(owner_max, pool_id.reshape(-1), rk.reshape(-1))
            is_bnd = owner_min != owner_max
            bnd_ids = np.cumsum(is_bnd) - 1  # global boundary slot
            n_bnd = int(is_bnd.sum())
            int_id_r = np.zeros((R, nb_max, pool_id.shape[1]), np.int32)
            bnd_id_r = np.full((R, nb_max, pool_id.shape[1]), n_bnd, np.int32)
            bnd_flag_r = np.ones((R, nb_max, pool_id.shape[1]), dtype=dt)
            n_int_max = 1
            for r in range(R):
                pids = pool_id[bricks_r[r]]  # [nb_r, k]
                internal = ~is_bnd[pids]
                upool, local = np.unique(pids[internal], return_inverse=True)
                n_int_max = max(n_int_max, len(upool))
                li = np.zeros(pids.shape, np.int32)
                li[internal] = local.astype(np.int32)
                k = len(bricks_r[r])
                int_id_r[r, :k] = li
                bi = np.full(pids.shape, n_bnd, np.int32)
                bi[~internal] = bnd_ids[pids[~internal]].astype(np.int32)
                bnd_id_r[r, :k] = bi
                bnd_flag_r[r, :k] = (~internal).astype(dt)
                # pad bricks keep flag=1 / bnd slot n_bnd (trash): their
                # surface values are zero and their read-backs are masked by
                # node_valid downstream
            return dict(
                int_id=int_id_r,
                bnd_id=bnd_id_r,
                bnd_flag=bnd_flag_r,
                n_int=n_int_max,
                n_bnd=n_bnd,
            )

        self.pools_f = split_pools(bs.face_pool_id, bs.n_face_pools)
        self.pools_c = split_pools(bs.corner_pool_id, bs.n_corner_pools)
        if dim == 3:
            self.pools_e = split_pools(bs.edge_pool_id, bs.n_edge_pools)
        else:
            self.pools_e = None
        self.n_bnd_total = (
            self.pools_f["n_bnd"]
            + self.pools_c["n_bnd"]
            + (self.pools_e["n_bnd"] if self.pools_e else 0)
        )

        # ---- exceptional subset per rank ----------------------------------
        # exc bricks of rank r = its bricks containing absent / chain cells
        absent_lin = np.nonzero(~bs.present)[0]
        chain_lin = set(bs.hn_lin.tolist())
        for g in bs.transfer_groups:
            chain_lin.update(g.coarse_cells.tolist())
        exc_bricks_g = sorted(
            set((absent_lin // C).tolist()) | {int(x) // C for x in chain_lin}
        )
        sub_r = [
            np.array(
                [self.slabpos_of_brick[b] for b in exc_bricks_g
                 if rank_of_brick[b] == r],
                dtype=np.int64,
            )
            for r in range(R)
        ]
        # local subset slot of a global brick (for chain/absent indexing)
        sub_slot_of_brick = np.full(nb, -1, dtype=np.int64)
        for r in range(R):
            gb = self.slab_brick[r, sub_r[r]] if len(sub_r[r]) else []
            sub_slot_of_brick[gb] = np.arange(len(sub_r[r]))
        self.n_sub_max = n_sub_max = max(max((len(s) for s in sub_r), default=0), 1)
        self.sub_ids_r = _pad_rows(sub_r, 0, np.int32)  # slab rows
        # one-hot scatter subset -> slab (pad columns all-zero)
        Ssub_r = np.zeros((R, nb_max, n_sub_max), dtype=dt)
        geo_cell_sub_r = np.zeros((R, n_sub_max * C), dtype=dt)
        absent_keep_r = np.ones((R, n_sub_max * C, 1), dtype=dt)
        geo_cell_g = np.repeat(geo_g, C)  # per brick-cell
        for r in range(R):
            for j, slab_row in enumerate(sub_r[r]):
                Ssub_r[r, slab_row, j] = 1.0
                gb = self.slab_brick[r, slab_row]
                geo_cell_sub_r[r, j * C : (j + 1) * C] = geo_cell_g[
                    gb * C : (gb + 1) * C
                ]
                pres = bs.present[gb * C : (gb + 1) * C]
                absent_keep_r[r, j * C : (j + 1) * C, 0] = pres.astype(dt)
        self.Ssub_r = Ssub_r

        # ---- chain rows: global replicated buffer layout ------------------
        # chain cells: xfer cells (mask-sorted, matching mm's hn composite
        # ranges) followed by fold coarse-destinations not already included
        xfer = bs.hn_lin  # mask-sorted brick-cell linear ids
        extra = sorted(chain_lin - set(xfer.tolist()))
        chain_cells_g = np.concatenate([xfer, np.array(extra, dtype=np.int64)])
        rank_of_chain = rank_of_brick[chain_cells_g // C]
        chain_r = [chain_cells_g[rank_of_chain == r] for r in range(R)]
        self.n_chain_max = n_chain_max = max(
            max((len(c) for c in chain_r), default=0), 1
        )
        # buffer gid of each chain cell: device-major [R * n_chain_max]
        gid_of_lin = {}
        for r in range(R):
            for j, lin in enumerate(chain_r[r]):
                gid_of_lin[int(lin)] = r * n_chain_max + j
        # per-rank source rows in the local subset cols numbering
        chain_src_r = np.zeros((R, n_chain_max), dtype=np.int32)
        chain_valid_r = np.zeros((R, n_chain_max, 1), dtype=dt)
        for r in range(R):
            for j, lin in enumerate(chain_r[r]):
                gb, slot = int(lin) // C, int(lin) % C
                chain_src_r[r, j] = sub_slot_of_brick[gb] * C + slot
                chain_valid_r[r, j, 0] = 1.0
        self.chain_src_r = chain_src_r

        # chain structure in buffer gids (replicated, static)
        self.hn_sub_g = np.array(
            [gid_of_lin[int(x)] for x in xfer], dtype=np.int32
        )
        levels = sorted({g.level for g in bs.transfer_groups})
        self._levels = levels
        n = bs.p + 1
        n_loc = n**dim
        groups_g = {lv: [] for lv in levels}
        for g in bs.transfer_groups:
            T = np.zeros((n_loc, n_loc))
            T[g.src_slots, g.dst_slots] = 1.0
            groups_g[g.level].append(
                dict(
                    fine=np.array([gid_of_lin[int(x)] for x in g.fine_cells],
                                  dtype=np.int32),
                    coarse=np.array([gid_of_lin[int(x)] for x in g.coarse_cells],
                                    dtype=np.int32),
                    T=np.asarray(T, dtype=dt),
                )
            )
        xfer_levels = np.asarray(mf.tria.level[bs.xfer_cells])
        level_zero_g = {}
        for lv in levels:
            sel = xfer_levels == lv
            level_zero_g[lv] = dict(
                lin=np.asarray(self.hn_sub_g[sel]),
                keep=np.asarray(
                    1.0 - bs.hn_closure[sel].astype(np.float64), dtype=dt
                ),
            )

        # fill coverage per rank (hn writers among the rank's subset bricks)
        hn_rank = rank_of_brick[(bs.hn_lin // C)]
        fill_invden_r = np.zeros((R, n_sub_max, N3p))
        for r in range(R):
            sel = bs.hn_lin[hn_rank == r]
            den = np.zeros((n_sub_max, N3p))
            for lin in sel:
                gb, slot = int(lin) // C, int(lin) % C
                den[sub_slot_of_brick[gb], mm.slot_idx[slot]] += 1.0
            fill_invden_r[r] = np.where(den > 0, 1.0 / np.maximum(den, 1.0), 0.0)

        self.has_chain = len(chain_cells_g) > 0 and len(xfer) > 0
        self._chain_cells_g = chain_cells_g
        self._chain_r = chain_r
        self._rank_of_chain = rank_of_chain

        # ghost/import statistics (benchmark_02.cc:136-165 analog): per rank,
        # boundary-pool values exchanged with other ranks plus remote chain
        # rows received through the replicated buffer
        fsize = (bs.NB - 2) ** (dim - 1)
        esize = bs.NB - 2 if dim == 3 else 0
        self.n_ghost = np.zeros(R, dtype=np.int64)
        self.n_import = np.zeros(R, dtype=np.int64)
        for pools, size in (
            (self.pools_f, fsize),
            (self.pools_e, esize),
            (self.pools_c, 1),
        ):
            if pools is None:
                continue
            for r in range(R):
                nb_bnd = int((pools["bnd_flag"][r][slab_valid[r]] > 0).sum())
                self.n_ghost[r] += nb_bnd * size
                self.n_import[r] += nb_bnd * size
        # chain rows owned elsewhere arrive via the all_gather
        n_chain_of_rank = np.array([len(c) for c in chain_r], dtype=np.int64)
        self.n_ghost += (len(chain_cells_g) - n_chain_of_rank) * n_loc
        self.n_import += n_chain_of_rank * (R - 1) * n_loc

        self._dev = dict(
            geo=geo_r,
            node_valid=nv_r,
            dot_mask=dotm_r,
            sub_ids=self.sub_ids_r,
            Ssub=Ssub_r,
            geo_cell_sub=geo_cell_sub_r,
            absent_keep=absent_keep_r,
            chain_src=chain_src_r,
            chain_valid=chain_valid_r,
            fill_invden=fill_invden_r.astype(dt),
            fp_int=self.pools_f["int_id"],
            fp_bnd=self.pools_f["bnd_id"],
            fp_flag=self.pools_f["bnd_flag"],
            cp_int=self.pools_c["int_id"],
            cp_bnd=self.pools_c["bnd_id"],
            cp_flag=self.pools_c["bnd_flag"],
        )
        if self.pools_e:
            self._dev.update(
                ep_int=self.pools_e["int_id"],
                ep_bnd=self.pools_e["bnd_id"],
                ep_flag=self.pools_e["bnd_flag"],
            )
        self._rep = dict(
            hn_sub_g=self.hn_sub_g,
            transfers=groups_g,
            level_zero=level_zero_g,
        )

        # deformed (MappingQCache analog) metric, slab-sharded: the
        # per-quad-point packed G_q of each rank's own brick cells
        # (benchmark_01.h:227-242 under the MPI stack; the single-chip
        # engine streams the same metric globally)
        self._deformed = mm._deformed
        if self._deformed:
            Gq_g = np.asarray(mm._np_geo_cell)  # [nb*C, n_q, packed]
            Gq_r = np.zeros((R, nb_max * C) + Gq_g.shape[1:], dtype=dt)
            for r in range(R):
                k = len(bricks_r[r])
                if k:
                    sel = (
                        bricks_r[r][:, None] * C + np.arange(C)[None, :]
                    ).reshape(-1)
                    Gq_r[r, : k * C] = Gq_g[sel]
            self._dev["Gq"] = Gq_r

        if self.exchange == "halo":
            self._build_halo()
        self._staged = False

    # ------------------------------------------------------------- halo plan
    def _build_halo(self):
        """Neighbor-wise exchange plan (the analog of the reference
        partitioner's ghost-index-only point-to-point exchange,
        benchmark_02.cc:136-165).

        DSS: each rank accumulates PARTIAL sums of the boundary pools its
        bricks touch into a compact local buffer; one pairwise all_to_all
        sends each other rank exactly the pools both touch, and adding the
        received partials completes every touched pool locally. A pool
        touched by >2 ranks works the same way — every toucher sends its
        partial to every other toucher. The send and receive positions of a
        pair coincide (both sides enumerate the shared pools in global-id
        order), so one index table serves both directions.

        Chain: the fold/fill transfer graph splits into small connected
        components; need(r) = the union of components containing r's own
        chain cells. Rows of remote needed cells arrive via one pairwise
        all_to_all per phase, and the chain runs on the per-rank compact
        buffer using the data-driven masked HN kernel (same math as the
        replicated composite-matmul path, just order-free)."""
        mm, R = self.mm, self.n_ranks
        bs = mm.bs
        dim, NB = bs.dim, bs.NB
        C = bs.B**dim
        dt = self.mf.dtype
        nb_max = self.nb_max
        rank_of_brick = self.rank_of_brick

        # ---- DSS pool halo ------------------------------------------------
        fsize = (NB - 2) ** (dim - 1)
        esize = NB - 2 if dim == 3 else 0
        classes = [("fp", bs.face_pool_id, bs.n_face_pools, fsize)]
        if dim == 3:
            classes.append(("ep", bs.edge_pool_id, bs.n_edge_pools, esize))
        classes.append(("cp", bs.corner_pool_id, bs.n_corner_pools, 1))

        touched = {}
        ntouch = {}
        halo_dev = {}
        for name, pid, n_pools, size in classes:
            rk = np.repeat(rank_of_brick, pid.shape[1])
            upr = np.unique(
                np.stack([pid.reshape(-1), rk], axis=1), axis=0
            )
            cnt = np.bincount(upr[:, 0], minlength=n_pools)
            is_bnd = cnt > 1
            per_rank = []
            for r in range(R):
                pl = np.sort(upr[upr[:, 1] == r, 0])
                per_rank.append(pl[is_bnd[pl]])
            touched[name] = per_rank
            nt = max(max((len(p) for p in per_rank), default=0), 1)
            ntouch[name] = nt
            bl = np.full((R, nb_max, pid.shape[1]), nt, np.int32)
            for r in range(R):
                pl = per_rank[r]
                pids = pid[self.bricks_r[r]]
                loc = np.full(pids.shape, nt, np.int32)
                bmask = is_bnd[pids]
                if bmask.any():
                    loc[bmask] = np.searchsorted(pl, pids[bmask]).astype(
                        np.int32
                    )
                bl[r, : len(self.bricks_r[r])] = loc
            halo_dev[name + "_loc"] = bl
        self._halo_ntouch = ntouch

        # flat scalar layout: faces | [edges] | corners | trash
        sizes = {name: size for name, _, _, size in classes}
        offs = {}
        off = 0
        for name, _, _, size in classes:
            offs[name] = off
            off += ntouch[name] * size
        n_flat = off
        self._halo_nflat = n_flat

        pair_scal = [[None] * R for _ in range(R)]
        for r in range(R):
            for s in range(R):
                if s == r:
                    pair_scal[r][s] = np.zeros(0, np.int64)
                    continue
                pieces = []
                for name, _, _, size in classes:
                    shared = np.intersect1d(touched[name][r], touched[name][s])
                    if len(shared):
                        loc = np.searchsorted(touched[name][r], shared)
                        pos = (
                            offs[name]
                            + (loc[:, None] * size + np.arange(size)[None, :])
                        ).reshape(-1)
                        pieces.append(pos)
                pair_scal[r][s] = (
                    np.concatenate(pieces) if pieces else np.zeros(0, np.int64)
                )
        max_pair = max(
            max((len(pair_scal[r][s]) for s in range(R)) , default=1)
            for r in range(R)
        )
        max_pair = max(max_pair, 1)
        dsend_idx = np.full((R, R, max_pair), n_flat, np.int32)
        dsend_valid = np.zeros((R, R, max_pair), dtype=dt)
        for r in range(R):
            for s in range(R):
                ps = pair_scal[r][s]
                dsend_idx[r, s, : len(ps)] = ps
                dsend_valid[r, s, : len(ps)] = 1.0
        halo_dev["dsend_idx"] = dsend_idx
        halo_dev["dsend_valid"] = dsend_valid

        # halo ghost/import statistics (scalars exchanged, per rank)
        n_ghost = np.array(
            [sum(len(pair_scal[r][s]) for s in range(R)) for r in range(R)],
            dtype=np.int64,
        )
        n_import = n_ghost.copy()  # DSS exchange is symmetric
        self.n_ghost_dss = n_ghost.copy()

        # ---- chain halo ---------------------------------------------------
        # Direction-split need sets (NOT whole graph components — a
        # component contains all siblings folding into a shared coarse
        # cell, which a rank never reads): the FOLD phase needs the
        # descendants whose values flow into own rows (backward
        # reachability from own cells through fine->coarse edges); the
        # FILL phase needs the ancestors whose values flow into own xfer
        # rows (backward reachability through coarse->fine edges).
        n = bs.p + 1
        n_loc = n**dim
        if self.has_chain:
            from scipy.sparse import csr_matrix

            lin_list = self._chain_cells_g
            nch = len(lin_list)
            idx_of = {int(l): i for i, l in enumerate(lin_list)}
            levels = self._levels
            xfer_n = len(bs.hn_lin)  # chain idx 0..xfer_n-1 are xfer cells
            xfer_levels = np.asarray(self.mf.tria.level[bs.xfer_cells])
            rank_of = self._rank_of_chain
            own_idx = [np.nonzero(rank_of == r)[0] for r in range(R)]
            own_pos_of_idx = np.zeros((R, nch), np.int64)
            for r in range(R):
                own_pos_of_idx[r, own_idx[r]] = np.arange(len(own_idx[r]))
            n_own_max = self.n_chain_max

            # replicated per-level T stacks + group index lists
            T_halo = {}
            gidx_by_level = {}
            for lv in levels:
                gl = [g for g in bs.transfer_groups if g.level == lv]
                Ts = np.zeros((len(gl), n_loc, n_loc), dtype=dt)
                fidx, cidx = [], []
                for gi, g in enumerate(gl):
                    T = np.zeros((n_loc, n_loc))
                    T[g.src_slots, g.dst_slots] = 1.0
                    Ts[gi] = T
                    fidx.append(np.asarray(
                        [idx_of[int(x)] for x in g.fine_cells], np.int64
                    ))
                    cidx.append(np.asarray(
                        [idx_of[int(x)] for x in g.coarse_cells], np.int64
                    ))
                T_halo[lv] = Ts
                gidx_by_level[lv] = (fidx, cidx)
            self._rep["T_halo"] = T_halo

            # fold DAG: values flow fine -> coarse; M[f, c] = 1
            ef_all = np.concatenate(
                [gidx_by_level[lv][0][gi]
                 for lv in levels for gi in range(len(gidx_by_level[lv][0]))]
            )
            ec_all = np.concatenate(
                [gidx_by_level[lv][1][gi]
                 for lv in levels for gi in range(len(gidx_by_level[lv][1]))]
            )
            M = csr_matrix(
                (np.ones(len(ef_all)), (ef_all, ec_all)), shape=(nch, nch)
            )
            Mt = M.T.tocsr()

            def pred_closure(M_, start):
                S = start.copy()
                while True:
                    newS = S | ((M_ @ S) > 0)
                    if (newS == S).all():
                        return newS
                    S = newS

            def chain_tables(tag, in_need, keep_by, slot_mask):
                """Per-rank chain tables in this phase's need numbering.
                keep_by: an entry is processed by rank r iff its 'coarse'
                (fold) / 'fine' (fill) row is in r's need set; the other
                endpoint is then needed by closure. slot_mask [nch, n_loc]:
                the static set of slots of each row that any consumer ever
                reads (fold: union of entity src slots, post-HN^T; fill:
                union of mirror dst slots) — ONLY these scalars are
                exchanged, the ghost analog of the reference partitioner's
                per-dof ghost index lists."""
                need_remote = [
                    np.nonzero(in_need[r] & (rank_of != r))[0] for r in range(R)
                ]
                n_rem_max = max(
                    max((len(x) for x in need_remote), default=0), 1
                )
                N_need = n_own_max + n_rem_max  # trash row = N_need
                pos = np.full((R, nch), N_need, np.int64)
                for r in range(R):
                    pos[r, own_idx[r]] = np.arange(len(own_idx[r]))
                    pos[r, need_remote[r]] = n_own_max + np.arange(
                        len(need_remote[r])
                    )
                # pairwise scalar exchange: r sends s the read-slot values of
                # its own cells in s's need set (global chain order)
                cpx = [[np.zeros(0, np.int64)] * R for _ in range(R)]
                for r in range(R):
                    for s_ in range(R):
                        if s_ != r:
                            cpx[r][s_] = own_idx[r][in_need[s_][own_idx[r]]]
                slot_list = [np.nonzero(slot_mask[i])[0] for i in range(nch)]
                nsc = np.array([len(x) for x in slot_list], np.int64)
                spair = max(
                    max(
                        max((int(nsc[cpx[r][s_]].sum()) for s_ in range(R)),
                            default=1)
                        for r in range(R)
                    ),
                    1,
                )
                send_scal = np.zeros((R, R, spair), np.int32)
                send_scal_valid = np.zeros((R, R, spair), dtype=dt)
                recv_scal = np.full((R, R, spair), N_need * n_loc, np.int32)
                for r in range(R):
                    for s_ in range(R):
                        if s_ == r:
                            continue
                        # send side: positions in r's own-block flat buffer
                        ss = np.concatenate(
                            [own_pos_of_idx[r, f] * n_loc + slot_list[f]
                             for f in cpx[r][s_]]
                        ) if len(cpx[r][s_]) else np.zeros(0, np.int64)
                        send_scal[r, s_, : len(ss)] = ss
                        send_scal_valid[r, s_, : len(ss)] = 1.0
                        # recv side: positions in r's need-buffer flat form
                        rcv = cpx[s_][r]
                        rr = np.concatenate(
                            [pos[r, f] * n_loc + slot_list[f] for f in rcv]
                        ) if len(rcv) else np.zeros(0, np.int64)
                        recv_scal[r, s_, : len(rr)] = rr
                # own-block HN masks (applied to the whole own block with the
                # data-driven masked kernel; mask 0 rows pass through)
                own_masks = np.zeros((R, n_own_max), np.int32)
                own_is_xfer = np.zeros((R, n_own_max, 1), dtype=dt)
                for r in range(R):
                    ox = own_idx[r][own_idx[r] < xfer_n]
                    own_masks[r, own_pos_of_idx[r, ox]] = bs.hn_masks[ox]
                    own_is_xfer[r, own_pos_of_idx[r, ox]] = 1.0
                # per-level batched transfers + level-zero rows
                ctrans, clz = {}, {}
                for lv in levels:
                    fidx, cidx = gidx_by_level[lv]
                    G = len(fidx)
                    sel_per = [
                        [
                            np.nonzero(in_need[r][
                                cidx[gi] if keep_by == "coarse" else fidx[gi]
                            ])[0]
                            for gi in range(G)
                        ]
                        for r in range(R)
                    ]
                    m_max = max(
                        max((len(s2) for sr in sel_per for s2 in sr),
                            default=0),
                        1,
                    )
                    fine = np.full((R, G, m_max), N_need, np.int32)
                    coarse = np.full((R, G, m_max), N_need, np.int32)
                    tmask = np.zeros((R, G, m_max, 1), dtype=dt)
                    for gi in range(G):
                        for r in range(R):
                            s2 = sel_per[r][gi]
                            fine[r, gi, : len(s2)] = pos[r, fidx[gi][s2]]
                            coarse[r, gi, : len(s2)] = pos[r, cidx[gi][s2]]
                            tmask[r, gi, : len(s2)] = 1.0
                    ctrans[lv] = dict(fine=fine, coarse=coarse, mask=tmask)
                    lz_sel = [
                        np.nonzero(
                            in_need[r, :xfer_n] & (xfer_levels == lv)
                        )[0]
                        for r in range(R)
                    ]
                    z_max = max(max((len(s2) for s2 in lz_sel), default=0), 1)
                    lz_pos = np.full((R, z_max), N_need, np.int32)
                    lz_keep = np.zeros((R, z_max, n_loc), dtype=dt)
                    for r in range(R):
                        s2 = lz_sel[r]
                        lz_pos[r, : len(s2)] = pos[r, s2]
                        lz_keep[r, : len(s2)] = 1.0 - bs.hn_closure[
                            s2
                        ].astype(np.float64)
                    clz[lv] = dict(pos=lz_pos, keep=lz_keep)
                halo_dev[tag] = dict(
                    send_scal=send_scal, send_scal_valid=send_scal_valid,
                    recv_scal=recv_scal, own_masks=own_masks,
                    own_is_xfer=own_is_xfer, ctrans=ctrans, clz=clz,
                )
                setattr(self, f"_halo_n_need_{tag}", N_need)
                n_rem = np.array(
                    [int(nsc[need_remote[r]].sum()) for r in range(R)],
                    np.int64,
                )
                n_imp = np.array(
                    [sum(int(nsc[cpx[r][s_]].sum()) for s_ in range(R))
                     for r in range(R)],
                    np.int64,
                )
                return n_rem, n_imp

            in_need_fold = np.zeros((R, nch), dtype=bool)
            in_need_fill = np.zeros((R, nch), dtype=bool)
            for r in range(R):
                start = np.zeros(nch, dtype=bool)
                start[own_idx[r]] = True
                in_need_fold[r] = pred_closure(M, start)
                start2 = np.zeros(nch, dtype=bool)
                start2[own_idx[r][own_idx[r] < xfer_n]] = True
                S2 = pred_closure(Mt, start2)
                S2[own_idx[r]] = True  # own rows always live in the buffer
                in_need_fill[r] = S2

            # static read-slot sets: fold consumers read the entity src
            # slots of a fine row (post-HN^T); fill consumers read the
            # mirror dst slots of a coarse row
            fold_slots = np.zeros((nch, n_loc), dtype=bool)
            fill_slots = np.zeros((nch, n_loc), dtype=bool)
            for lv in levels:
                fidx, cidx = gidx_by_level[lv]
                gl = [g for g in bs.transfer_groups if g.level == lv]
                for gi, g in enumerate(gl):
                    fold_slots[np.ix_(fidx[gi], g.src_slots)] = True
                    fill_slots[np.ix_(cidx[gi], g.dst_slots)] = True

            g_fold, i_fold = chain_tables(
                "fold", in_need_fold, "coarse", fold_slots
            )
            g_fill, i_fill = chain_tables(
                "fill", in_need_fill, "fine", fill_slots
            )
            self.n_ghost_chain = g_fold + g_fill
            n_ghost += self.n_ghost_chain
            n_import += i_fold + i_fill

        self._dev.update(halo_dev)
        self.n_ghost = n_ghost
        self.n_import = n_import

    def _stage(self):
        if not self._staged:
            spec = NamedSharding(self.mesh, P(self.axis_name))
            self._dev_s = jax.device_put(
                jax.tree.map(jnp.asarray, self._dev), spec
            )
            rep = NamedSharding(self.mesh, P())
            self._rep_s = jax.device_put(
                jax.tree.map(jnp.asarray, self._rep), rep
            )
            # the global per-quad-point metric is NOT replicated: each rank
            # reads only its slab slice (self._dev["Gq"]); the single-chip
            # engine's global brick-/subset-layout metrics stay off-device
            mm_a = {
                k: v for k, v in self.mm._stage().items()
                if k not in ("Gqb", "Gq_sub", "Gq_hn")
            }
            self._mm_a = jax.device_put(mm_a, rep)
            self._staged = True
        return self._dev_s, self._rep_s, self._mm_a

    # --------------------------------------------------------------- pieces
    def _dss_local(self, surf, d):
        """Per-device DSS: internal pools locally, boundary pools via psum."""
        bs = self.mm.bs
        dim, NB = bs.dim, bs.NB
        nb = surf.shape[0]
        ax = self.axis_name
        comm = self.perform_communication
        nf = 2 * dim
        fsize = (NB - 2) ** (dim - 1)
        parts = []
        off = 0

        def pooled(block, int_id, bnd_id, flag, n_int, n_bnd, size):
            # block [nb, k, size]; ids [nb, k]
            k = block.shape[1]
            flat = block.reshape(-1, size)
            w_int = (1.0 - flag.reshape(-1, 1)) * flat
            w_bnd = flag.reshape(-1, 1) * flat
            ipool = jnp.zeros((n_int, size), surf.dtype)
            ipool = ipool.at[int_id.reshape(-1)].add(w_int)
            bpool = jnp.zeros((n_bnd + 1, size), surf.dtype)
            bpool = bpool.at[bnd_id.reshape(-1)].add(w_bnd)
            if comm and n_bnd:
                bpool = jax.lax.psum(bpool, ax)
            new = jnp.where(
                flag.reshape(-1, 1) > 0,
                bpool[bnd_id.reshape(-1)],
                ipool[int_id.reshape(-1)],
            )
            return new.reshape(nb, k * size)

        fblock = surf[:, : nf * fsize].reshape(nb, nf, fsize)
        parts.append(
            pooled(fblock, d["fp_int"], d["fp_bnd"], d["fp_flag"],
                   self.pools_f["n_int"], self.pools_f["n_bnd"], fsize)
        )
        off = nf * fsize
        if dim == 3:
            esize = NB - 2
            eblock = surf[:, off : off + 12 * esize].reshape(nb, 12, esize)
            parts.append(
                pooled(eblock, d["ep_int"], d["ep_bnd"], d["ep_flag"],
                       self.pools_e["n_int"], self.pools_e["n_bnd"], esize)
            )
            off += 12 * esize
        ncorner = 2**dim
        cblock = surf[:, off : off + ncorner].reshape(nb, ncorner, 1)
        parts.append(
            pooled(cblock, d["cp_int"], d["cp_bnd"], d["cp_flag"],
                   self.pools_c["n_int"], self.pools_c["n_bnd"], 1)
        )
        return jnp.concatenate(parts, axis=1)

    def _dss_local_halo(self, surf, d):
        """Neighbor-wise DSS: internal pools locally; each TOUCHED boundary
        pool's partial sum is exchanged pairwise with exactly the ranks that
        share it (one all_to_all of flat scalars), then read back."""
        bs = self.mm.bs
        dim, NB = bs.dim, bs.NB
        nb = surf.shape[0]
        ax = self.axis_name
        comm = self.perform_communication
        nf = 2 * dim
        fsize = (NB - 2) ** (dim - 1)
        esize = NB - 2 if dim == 3 else 0
        nt = self._halo_ntouch

        def accum(block, int_id, bnd_loc, flag, n_int, n_touch, size):
            flat = block.reshape(-1, size)
            w_int = (1.0 - flag.reshape(-1, 1)) * flat
            w_bnd = flag.reshape(-1, 1) * flat
            ipool = jnp.zeros((n_int, size), surf.dtype)
            ipool = ipool.at[int_id.reshape(-1)].add(w_int)
            bpool = jnp.zeros((n_touch + 1, size), surf.dtype)
            bpool = bpool.at[bnd_loc.reshape(-1)].add(w_bnd)
            return ipool, bpool

        fblock = surf[:, : nf * fsize].reshape(nb, nf, fsize)
        fi, fb = accum(fblock, d["fp_int"], d["fp_loc"], d["fp_flag"],
                       self.pools_f["n_int"], nt["fp"], fsize)
        flat_parts = [fb[: nt["fp"]].reshape(-1)]
        off = nf * fsize
        if dim == 3:
            eblock = surf[:, off : off + 12 * esize].reshape(nb, 12, esize)
            ei, eb = accum(eblock, d["ep_int"], d["ep_loc"], d["ep_flag"],
                           self.pools_e["n_int"], nt["ep"], esize)
            flat_parts.append(eb[: nt["ep"]].reshape(-1))
            off += 12 * esize
        ncorner = 2**dim
        cblock = surf[:, off : off + ncorner].reshape(nb, ncorner, 1)
        ci, cb = accum(cblock, d["cp_int"], d["cp_loc"], d["cp_flag"],
                       self.pools_c["n_int"], nt["cp"], 1)
        flat_parts.append(cb[: nt["cp"]].reshape(-1))
        flat_parts.append(jnp.zeros((1,), surf.dtype))  # trash scalar
        bflat = jnp.concatenate(flat_parts)

        send = bflat[d["dsend_idx"]] * d["dsend_valid"]  # [R, max_pair]
        if comm:
            recv = jax.lax.all_to_all(
                send, ax, split_axis=0, concat_axis=0, tiled=False
            )
        else:
            recv = send  # same-shape, collective elided (timing ablation)
        bflat = bflat.at[d["dsend_idx"].reshape(-1)].add(
            (recv * d["dsend_valid"]).reshape(-1)
        )

        def read(ipool, int_id, bnd_loc, flag, base, n_touch, size, k):
            bpool = jnp.concatenate(
                [
                    jax.lax.slice(bflat, (base,), (base + n_touch * size,))
                    .reshape(n_touch, size),
                    jnp.zeros((1, size), surf.dtype),  # trash row (pad reads)
                ]
            )
            new = jnp.where(
                flag.reshape(-1, 1) > 0,
                bpool[bnd_loc.reshape(-1)],
                ipool[int_id.reshape(-1)],
            )
            return new.reshape(nb, k * size)

        parts = [
            read(fi, d["fp_int"], d["fp_loc"], d["fp_flag"], 0, nt["fp"],
                 fsize, nf)
        ]
        base = nt["fp"] * fsize
        if dim == 3:
            parts.append(
                read(ei, d["ep_int"], d["ep_loc"], d["ep_flag"], base,
                     nt["ep"], esize, 12)
            )
            base += nt["ep"] * esize
        parts.append(
            read(ci, d["cp_int"], d["cp_loc"], d["cp_flag"], base, nt["cp"],
                 1, ncorner)
        )
        return jnp.concatenate(parts, axis=1)

    # --------------------------------------------------------- chain (halo)
    def _chain_exchange(self, block, t, N_need):
        """Own chain-cell rows -> per-rank need buffer [N_need+1, n_loc].
        Own rows sit in the leading block; ONLY the static read-slot
        scalars of remote needed rows travel, in one pairwise all_to_all
        (the ghost-dof-list analog; remaining slots of remote rows are
        zero and provably never read)."""
        R = self.n_ranks
        n_own_max = self.n_chain_max
        n_loc = block.shape[1]
        bflat = block.reshape(-1)
        send = bflat[t["send_scal"]] * t["send_scal_valid"]  # [R, spair]
        if self.perform_communication:
            recv = jax.lax.all_to_all(
                send, self.axis_name, split_axis=0, concat_axis=0, tiled=False
            )
        else:
            recv = send
        buf = jnp.zeros(((N_need + 1) * n_loc,), block.dtype)
        buf = buf.at[t["recv_scal"].reshape(-1)].set(recv.reshape(-1))
        buf = buf.reshape(N_need + 1, n_loc)
        return buf.at[:n_own_max].set(block)

    def _chain_fold_halo(self, buf, t, rep, a):
        """Chained folds (finest level first) on the need buffer. HN^T has
        already been applied to the own block BEFORE the exchange (remote
        rows arrive post-HN^T from their owners)."""
        for lv in sorted(self._levels, reverse=True):
            tb = t["ctrans"][lv]
            lz = t["clz"][lv]
            zeroed = jnp.take(buf, lz["pos"], axis=0) * lz["keep"]
            G, m = tb["fine"].shape
            sel = jnp.take(buf, tb["fine"].reshape(-1), axis=0).reshape(
                G, m, -1
            )
            out = jnp.einsum(
                "gmi,gij->gmj", sel, rep["T_halo"][lv],
                precision=_EXACT, preferred_element_type=buf.dtype,
            ) * tb["mask"]
            buf = buf.at[tb["coarse"].reshape(-1)].add(
                out.reshape(G * m, -1)
            )
            buf = buf.at[lz["pos"]].set(zeroed)
        return buf

    def _chain_fill_halo(self, buf, t, rep, a):
        """Level-zeroing + chained fills (coarsest first) on the need
        buffer; forward HN runs on the own block only (deltas are
        extracted at own xfer rows)."""
        for lv in sorted(self._levels):
            tb = t["ctrans"][lv]
            lz = t["clz"][lv]
            buf = buf.at[lz["pos"]].set(
                jnp.take(buf, lz["pos"], axis=0) * lz["keep"]
            )
            G, m = tb["fine"].shape
            sel = jnp.take(buf, tb["coarse"].reshape(-1), axis=0).reshape(
                G, m, -1
            )
            out = jnp.einsum(
                "gmi,gji->gmj", sel, rep["T_halo"][lv],
                precision=_EXACT, preferred_element_type=buf.dtype,
            ) * tb["mask"]
            buf = buf.at[tb["fine"].reshape(-1)].add(out.reshape(G * m, -1))
        return buf

    # ------------------------------------------------------------------ step
    def _build_step(self):
        mm = self.mm
        C = mm.bs.B ** mm.bs.dim
        ax = self.axis_name
        comm = self.perform_communication
        n_chain_max = self.n_chain_max
        R = self.n_ranks
        halo = self.exchange == "halo"

        def step(bv, d, rep, a):
            # bv [1, nb_max, N3p] local slab; squeeze the mesh axis
            bv = bv[0]
            d = jax.tree.map(lambda x: x[0], d)
            if self._deformed:
                # 1) deformed main path: per-cell packed-metric kernel over
                #    ALL local brick cells (no shared-A trick under a
                #    high-order mapping — benchmark_01.h:227-242); pad and
                #    absent slots carry G_q = 0 and output zero rows
                vals_all = mm._deformed_cell_apply(
                    mm._extract_cols(bv, a), a, d["Gq"]
                )
                v = mm._scatter_cols(vals_all, a)
                # 2) subset rows feed the unchanged chain machinery below:
                #    'plain' = the per-cell outputs at the exceptional
                #    subset (already correct for absent cells, so the only
                #    correction left is the HN^T + fold chain delta)
                Cr = jnp.arange(C, dtype=d["sub_ids"].dtype)
                sub_rows = (
                    d["sub_ids"][:, None] * C + Cr[None, :]
                ).reshape(-1)
                plain = jnp.take(vals_all, sub_rows, axis=0)
                final = plain
            else:
                # 1) main path + per-brick scale (local)
                v = mm._main_apply(bv, a) * d["geo"][:, None]

                # 2) corrections on the local exceptional subset
                u_sub = jnp.take(bv, d["sub_ids"], axis=0)
                cols_u = mm._extract_cols(u_sub, a)
                plain = jnp.dot(
                    cols_u, a["K"].T, preferred_element_type=bv.dtype
                )
                plain = plain * d["geo_cell_sub"][:, None]
                # absent (hole) cells contribute nothing: local zeroing
                final = plain * d["absent_keep"]
            dcols = final - plain
            if self.has_chain and halo:
                # neighbor-wise: HN^T on the own block, then a pairwise
                # exchange of the static read-slot scalars, then the folds
                from ..ops.hanging_nodes import apply_hanging_node_constraints

                block = jnp.take(final, d["chain_src"], axis=0) * d["chain_valid"]
                tf = d["fold"]
                block_hn = apply_hanging_node_constraints(
                    block, tf["own_masks"], a["P"], mm.bs.dim, True
                )
                buf = self._chain_exchange(
                    block_hn, tf, self._halo_n_need_fold
                )
                buf = self._chain_fold_halo(buf, tf, rep, a)
                delta = buf[:n_chain_max] - block  # includes the HN^T change
                dcols = dcols.at[d["chain_src"]].add(delta * d["chain_valid"])
            elif self.has_chain:
                # compact chain rows -> replicated buffer (the only volume
                # exchange; device-major gids match all_gather layout)
                block = jnp.take(final, d["chain_src"], axis=0) * d["chain_valid"]
                if comm:
                    buf = jax.lax.all_gather(block, ax, tiled=True)
                else:
                    buf = jnp.tile(block, (R, 1))
                buf0 = buf
                own = jnp.take(buf, rep["hn_sub_g"], axis=0)
                buf = buf.at[rep["hn_sub_g"]].set(
                    mm._hn_apply(own, a, transpose=True)
                )
                for lv in sorted(self._levels, reverse=True):
                    rows_all, coarse_all = [], []
                    for g in rep["transfers"][lv]:
                        rows_all.append(
                            jnp.dot(jnp.take(buf, g["fine"], axis=0), g["T"],
                                    precision=_EXACT,
                                    preferred_element_type=bv.dtype)
                        )
                        coarse_all.append(g["coarse"])
                    lz = rep["level_zero"][lv]
                    zeroed = jnp.take(buf, lz["lin"], axis=0) * lz["keep"]
                    buf = buf.at[jnp.concatenate(coarse_all)].add(
                        jnp.concatenate(rows_all, axis=0)
                    )
                    buf = buf.at[lz["lin"]].set(zeroed)
                delta = buf - buf0
                # own block: static slice via axis_index
                r = jax.lax.axis_index(ax)
                dblock = jax.lax.dynamic_slice_in_dim(
                    delta, r * n_chain_max, n_chain_max, axis=0
                )
                dcols = dcols.at[d["chain_src"]].add(dblock * d["chain_valid"])
            v = v + jnp.dot(d["Ssub"], mm._scatter_cols(dcols, a),
                            precision=_EXACT, preferred_element_type=bv.dtype)

            # 3) cross-brick DSS: internal pools local; boundary pools
            #    pairwise (halo) or psum'd (replicated)
            surf = jnp.dot(v, a["Es"].T, precision=_EXACT,
                           preferred_element_type=bv.dtype)
            if halo:
                surf_new = self._dss_local_halo(surf, d)
            else:
                surf_new = self._dss_local(surf, d)
            v = jnp.where(
                d["node_valid"],
                v + jnp.dot(surf_new - surf, a["Es"],
                            precision=_EXACT, preferred_element_type=bv.dtype),
                0.0,
            )

            # 4) fill pass (restore the distributed-hanging invariant)
            if self.has_chain and halo:
                v_sub = jnp.take(v, d["sub_ids"], axis=0)
                cols2_loc = mm._extract_cols(v_sub, a)
                block2 = (
                    jnp.take(cols2_loc, d["chain_src"], axis=0)
                    * d["chain_valid"]
                )
                from ..ops.hanging_nodes import apply_hanging_node_constraints

                tl = d["fill"]
                buf2 = self._chain_exchange(
                    block2, tl, self._halo_n_need_fill
                )
                buf2 = self._chain_fill_halo(buf2, tl, rep, a)
                own_rows = buf2[:n_chain_max]
                sub2 = apply_hanging_node_constraints(
                    own_rows, tl["own_masks"], a["P"], mm.bs.dim, False
                )
                dblock = (sub2 - block2) * tl["own_is_xfer"]
                dcols2 = jnp.zeros_like(cols2_loc).at[d["chain_src"]].add(
                    dblock * d["chain_valid"]
                )
                num = mm._scatter_cols(dcols2, a)
                v = v + jnp.dot(d["Ssub"], num * d["fill_invden"],
                                precision=_EXACT,
                                preferred_element_type=bv.dtype)
            elif self.has_chain:
                v_sub = jnp.take(v, d["sub_ids"], axis=0)
                cols2_loc = mm._extract_cols(v_sub, a)
                block2 = (
                    jnp.take(cols2_loc, d["chain_src"], axis=0)
                    * d["chain_valid"]
                )
                if comm:
                    cols2 = jax.lax.all_gather(block2, ax, tiled=True)
                else:
                    cols2 = jnp.tile(block2, (R, 1))
                orig_rows = jnp.take(cols2, rep["hn_sub_g"], axis=0)
                for lv in sorted(self._levels):
                    lz = rep["level_zero"][lv]
                    cols2 = cols2.at[lz["lin"]].set(
                        jnp.take(cols2, lz["lin"], axis=0) * lz["keep"]
                    )
                    rows_all, fine_all = [], []
                    for g in rep["transfers"][lv]:
                        rows_all.append(
                            jnp.dot(jnp.take(cols2, g["coarse"], axis=0),
                                    g["T"].T,
                                    precision=_EXACT,
                                    preferred_element_type=bv.dtype)
                        )
                        fine_all.append(g["fine"])
                    cols2 = cols2.at[jnp.concatenate(fine_all)].add(
                        jnp.concatenate(rows_all, axis=0)
                    )
                sub2 = mm._hn_apply(
                    jnp.take(cols2, rep["hn_sub_g"], axis=0), a,
                    transpose=False,
                )
                dbuf = jnp.zeros_like(cols2).at[rep["hn_sub_g"]].set(
                    sub2 - orig_rows
                )
                r = jax.lax.axis_index(ax)
                dblock = jax.lax.dynamic_slice_in_dim(
                    dbuf, r * n_chain_max, n_chain_max, axis=0
                )
                dcols2 = jnp.zeros_like(cols2_loc).at[d["chain_src"]].add(
                    dblock * d["chain_valid"]
                )
                num = mm._scatter_cols(dcols2, a)
                v = v + jnp.dot(d["Ssub"], num * d["fill_invden"],
                                precision=_EXACT,
                                preferred_element_type=bv.dtype)
            return v[None]

        spec = P(ax)
        rspec = P()
        self._step = jax.jit(
            jax.shard_map(
                step,
                mesh=self.mesh,
                in_specs=(spec, spec, rspec, rspec),
                out_specs=spec,
            )
        )

    # ------------------------------------------------------------------ api
    def from_dof_vector(self, u: np.ndarray) -> jnp.ndarray:
        """Global dof vector -> sharded brick slabs [R, nb_max, N3p]."""
        mm = self.mm
        bv = np.zeros((self.n_ranks, self.nb_max, mm.N3p), dtype=self.mf.dtype)
        bs = mm.bs
        u_dist = self.mf.constraints.distribute(np.asarray(u))
        flat = np.zeros(bs.n_bricks * mm.N3, dtype=self.mf.dtype)
        flat[bs.node_valid] = u_dist[bs.node_dof[bs.node_valid]]
        flat = flat.reshape(bs.n_bricks, mm.N3)
        for r in range(self.n_ranks):
            k = len(self.bricks_r[r])
            bv[r, :k, : mm.N3] = flat[self.bricks_r[r]]
        return jax.device_put(
            bv, NamedSharding(self.mesh, P(self.axis_name))
        )

    def to_dof_vector(self, bv, zero_hanging: bool = False) -> np.ndarray:
        """Sharded slabs -> global dof vector (owner-copy reads)."""
        mm, bs = self.mm, self.mm.bs
        arr = np.asarray(bv)  # [R, nb_max, N3p]
        glob = np.zeros((bs.n_bricks, mm.N3), dtype=arr.dtype)
        for r in range(self.n_ranks):
            k = len(self.bricks_r[r])
            glob[self.bricks_r[r]] = arr[r, :k, : mm.N3]
        u = glob.reshape(-1)[bs.owner_node_of_dof]
        if zero_hanging:
            u = u.copy()
            u[self.mf.constraints.constrained_dof_marker()] = 0.0
        return u

    def vmult(self, bv):
        d, rep, a = self._stage()
        with jax.default_matmul_precision(self.mm._matmul_precision):
            return self._step(bv, d, rep, a)

    # dot products over the reduced space (owner copies counted once)
    def dot(self, u, v):
        d, _, _ = self._stage()
        return jnp.sum(d["dot_mask"] * u * v)

    def norm(self, u):
        return jnp.sqrt(self.dot(u, u))
