"""Brick execution engine — a dense data layout for the hot vmult.

Motivation: the classic "global vector + per-cell index gather" formulation
(deal.II's layout, and our MatrixFree default) moves every cell's data
through element-wise gathers and scatter-adds. The brick engine re-lays the
vector as dense per-brick node arrays so that the bulk of the work is
static strided slices, dense matmuls and wide row copies:

- Cells are grouped into Morton-aligned, level-uniform bricks of B^dim cells
  (default B=4). A brick stores the (B*p+1)^dim nodes of its cell block,
  duplicating nodes shared with other bricks.
- ``BrickVector`` invariant: duplicated conforming nodes are equal, hanging
  nodes hold their *distributed* (coarse-interpolated) values. All linear
  vector ops preserve the invariant; dot products use a per-dof owner mask.
- vmult: im2col (125 static strided slices) -> per-cell kernel (dense
  matmul for Cartesian cells) -> hanging-node transpose on the constrained
  subset -> mask-grouped row transfers folding constrained-slot values into
  the coarse neighbor's cell columns (the C^T of the fast HN algorithm) ->
  col2im overlap-add inside each brick -> pooled direct-stiffness summation
  across bricks (face/edge/corner interface pools as wide row ops) -> fill
  pass restoring the invariant.

The engine is bitwise-equivalent (up to fp rounding) to MatrixFree's fast
path; tests compare both against the assembled scipy oracle.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import os

import numpy as np
import jax
import jax.numpy as jnp

from .constraints import decompress_mask
from .dof_handler import local_lattice
from .matrix_free import MatrixFree

__all__ = ["BrickStructure", "BrickLaplace"]

# Products with the engine's 0/1 selection matrices (E, Es, EsI, EscX, EFX,
# Ssub, W_col2im and the coarse-fine transfer matrices T) are copies. They
# run at HIGHEST whatever precision the operator's arithmetic uses: a TF32
# product would round every copied f32 value to a 10-bit mantissa.
_EXACT = jax.lax.Precision.HIGHEST


def _entity_slot_partition(mask: int, dim: int, p: int, lat: np.ndarray):
    """Partition the constrained-closure slots of a cell with this compressed
    mask among its constrained entities (faces first, then edges): each slot
    is claimed by exactly one entity so the fold/fill row transfers neither
    miss nor double-count. Returns list of (kind, axis, slots ndarray)."""
    sub, face, edge = decompress_mask(np.array([mask]), dim)
    sub, face, edge = int(sub[0]), int(face[0]), int(edge[0])
    claimed = np.zeros(len(lat), dtype=bool)
    out = []
    for d in range(dim):
        if (face >> d) & 1:
            s_d = (sub >> d) & 1
            sel = (lat[:, d] == s_d * p) & ~claimed
            out.append(("face", d, np.nonzero(sel)[0]))
            claimed |= sel
    if dim == 3:
        for e in range(3):
            if (edge >> e) & 1:
                a, b = [x for x in range(3) if x != e]
                s_a, s_b = (sub >> a) & 1, (sub >> b) & 1
                sel = (lat[:, a] == s_a * p) & (lat[:, b] == s_b * p) & ~claimed
                out.append(("edge", e, np.nonzero(sel)[0]))
                claimed |= sel
    return out


def _mirror_slots(kind: str, axis: int, slots: np.ndarray, mask: int,
                  dim: int, p: int, lat: np.ndarray) -> np.ndarray:
    """Destination slots on the coarse neighbor for a fold transfer: same
    tangential lattice indices, opposite side along the entity's normal(s)."""
    sub, _, _ = decompress_mask(np.array([mask]), dim)
    sub = int(sub[0])
    n = p + 1
    coords = lat[slots].copy()
    if kind == "face":
        s_d = (sub >> axis) & 1
        coords[:, axis] = (1 - s_d) * p
    else:  # edge along `axis`
        a, b = [x for x in range(3) if x != axis]
        s_a, s_b = (sub >> a) & 1, (sub >> b) & 1
        coords[:, a] = (1 - s_a) * p
        coords[:, b] = (1 - s_b) * p
    # lexicographic x fastest: slot = sum coords[d] * n^d
    flat = sum(coords[:, d] * (n**d) for d in range(dim))
    return flat.astype(np.int64)


@dataclass
class _TransferGroup:
    fine_cells: np.ndarray  # brick-cell linear ids [m]
    coarse_cells: np.ndarray  # brick-cell linear ids [m]
    src_slots: np.ndarray  # [k]
    dst_slots: np.ndarray  # [k]
    level: int = 0  # refinement level of the fine cells


def _pool_contrib_table(pool_id, n_pools, include_self):
    """Per-slot contributor lists for a pool assignment.

    pool_id: [nb, k] slot -> pool map. Returns an int32 table
    [nb*k, maxc] (or [nb*k, maxc-1] when include_self=False) whose row r
    lists the flat slot indices sharing r's pool in pool-canonical order,
    padded with the sentinel nb*k (consumers append one zero row). This
    turns the DSS pool scatter-add + gather-back into pure gathers: every
    copy of a shared interface reads its contributors directly
    (owner-computes-all, no XLA scatter on the hot path)."""
    flat = pool_id.reshape(-1).astype(np.int64)
    ns = flat.shape[0]
    if ns == 0:
        return np.zeros((0, 1), dtype=np.int32)
    order = np.argsort(flat, kind="stable")
    sorted_p = flat[order]
    starts = np.searchsorted(sorted_p, np.arange(n_pools))
    maxc = int(np.bincount(flat, minlength=n_pools).max())
    table = np.full((n_pools, maxc), ns, dtype=np.int64)
    rank = np.arange(ns) - starts[sorted_p]
    table[sorted_p, rank] = order
    full = table[flat]  # [ns, maxc], each row contains r itself once
    if include_self:
        return full.astype(np.int32)
    selfpos = np.argmax(full == np.arange(ns)[:, None], axis=1)
    keep = np.ones((ns, maxc), dtype=bool)
    keep[np.arange(ns), selfpos] = False
    return full[keep].reshape(ns, maxc - 1).astype(np.int32)


def auto_brick_size(degree: int, dim: int = 3) -> int:
    """Brick size heuristic: the largest power-of-two B whose brick holds
    at most ~5100 nodes in 3D (B=4 at p=3..4, B=2 at p>=5; ~17 nodes per
    brick edge at low degree, where the DSS/fill surface exchange shrinks
    as the surface-to-volume ratio ~1/(B*p)). Tuned on the platform the
    engine was first built for; not yet re-tuned on the GPU (ROADMAP).
    BRICK_B overrides for A/B runs."""
    env = os.environ.get("BRICK_B")
    if env:
        return int(env)
    cap = 5100 if dim == 3 else 2600
    best = 2
    for B in (2, 4, 8, 16):
        if (B * degree + 1) ** dim <= cap:
            best = B
    return best


class BrickStructure:
    """Static brick layout + exchange plan derived from a MatrixFree object."""

    def __init__(self, mf: MatrixFree, brick_size: int | None = None,
                 face_planes: bool = False):
        self.face_planes = bool(face_planes)
        if brick_size is None:
            brick_size = auto_brick_size(mf.degree, mf.dim)
        if mf.dim not in (2, 3):
            raise NotImplementedError("brick engine supports dim=2,3")
        if mf.categorize:
            raise ValueError("brick engine requires original cell order")
        self.mf = mf
        self.B = B = brick_size
        self.p = p = mf.degree
        self.dim = dim = mf.dim
        self.NB = NB = B * p + 1
        tria = mf.tria
        lat = local_lattice(p, dim)
        self._lat = lat
        n = p + 1
        n_loc = n**dim

        logB = int(np.log2(B))
        assert 2**logB == B

        # ---- brick membership -------------------------------------------
        lvl = tria.level
        bc = tria.coord >> np.int64(logB)
        bkey = lvl.astype(np.int64)
        for d in range(dim):
            bkey = (bkey << np.int64(16)) | bc[:, d]
        ukeys, brick_of_cell = np.unique(bkey, return_inverse=True)
        self.n_bricks = len(ukeys)
        self.brick_level = (ukeys >> np.int64(16 * dim)).astype(np.int64)
        self.brick_coord = np.stack(
            [(ukeys >> np.int64(16 * (dim - 1 - d))) & 0xFFFF for d in range(dim)],
            axis=1,
        ).astype(np.int64)
        lc = (tria.coord & (B - 1)).astype(np.int64)
        slot = sum(lc[:, d] * B**d for d in range(dim))

        # vertex-only cross-level contacts (needed before the subset-first
        # reorder below): a cell whose full-diagonal neighbor slot (across
        # the parent corner) is covered by an active one-level-coarser cell,
        # with NO constrained face/edge (mask 0) — it shares exactly one
        # master vertex with the coarse level (e.g. the octant corner of the
        # quadrant mesh). These need fold/fill transfers too, with identity
        # weights.
        from .constraints import _active_lookup

        masks = mf._np["masks"]
        find = _active_lookup(tria)
        s_bits = (tria.coord & 1).astype(np.int64)
        nc = tria.coord + (2 * s_bits - 1)
        lim = np.int64(1) << tria.level
        inside = np.all((nc >= 0) & (nc < lim[:, None]), axis=1)
        valid = inside & (tria.level >= 1)
        vdiag = find(tria.level - 1, nc >> np.int64(1), valid)
        self.vertex_contact = (vdiag >= 0) & (masks == 0)
        self.vertex_diag = vdiag

        # face-plane constraint resolution (node-domain, brick-wide),
        # computed BEFORE the tier sort so plane-covered cells neither
        # enter the chain tier nor size the per-cell cols machinery; the
        # group brick ids are remapped through the reorder below.
        self.plane_covered = np.zeros(tria.n_active_cells, dtype=bool)
        self.plane_groups = []
        self.brick_of_cell = brick_of_cell  # pre-reorder ids for the build
        if self.face_planes and B >= 2 and B % 2 == 0:
            self._build_face_planes(masks)

        # ---- subset-first brick order -------------------------------------
        # Exceptional bricks (holes, constrained cells, or fold/fill coarse
        # targets) are renumbered to the front, so every engine subset
        # gather/scatter (take(v, sub_ids), the Ssub one-hot, the
        # correction/fill write-back) becomes a STATIC leading slice — no
        # row gathers, no [nb, n_sub] one-hot MACs. Stable within each part
        # (Morton/level order preserved); the distributed partitioner builds
        # its own Morton order from brick_coord, so it is unaffected.
        C = B**dim
        ci = mf.constraints
        # chain bricks: touched by any constraint/fill/fold index (hn cells,
        # their face/edge master neighbors, vertex-contact diagonals). They
        # form the FIRST tier so the cols-domain chain work (extract, fill,
        # HN^T, folds, col2im) runs on a static leading slice of the subset
        # — hole-only bricks need only the assembled masked-quadrature
        # removal and skip the cols domain entirely.
        chain = np.zeros(self.n_bricks, dtype=bool)
        resid = (masks != 0) & ~self.plane_covered
        xsel = resid | self.vertex_contact
        chain[brick_of_cell[xsel]] = True
        mcells = np.nonzero(resid)[0]
        for nbr in (ci.face_neighbor[mcells], ci.edge_neighbor[mcells]):
            v = nbr[nbr >= 0]
            chain[brick_of_cell[v]] = True
        vd = vdiag[self.vertex_contact]
        if len(vd):
            chain[brick_of_cell[vd]] = True
        exc = (np.bincount(brick_of_cell, minlength=self.n_bricks) < C) | chain
        tier = np.where(chain, 0, np.where(exc, 1, 2))
        old_order = np.argsort(tier, kind="stable")  # chain, hole-only, rest
        rank = np.empty(self.n_bricks, dtype=np.int64)
        rank[old_order] = np.arange(self.n_bricks)
        self.brick_level = self.brick_level[old_order]
        self.brick_coord = self.brick_coord[old_order]
        brick_of_cell = rank[brick_of_cell]
        self.exc_brick = exc[old_order]
        self.n_exc_bricks = int(exc.sum())
        self.n_chain_bricks = int(chain.sum())
        assert self.exc_brick[: self.n_exc_bricks].all()
        for g in self.plane_groups:  # into the reordered numbering
            g["fine"] = rank[g["fine"]].astype(np.int32)
            g["coarse"] = rank[g["coarse"]].astype(np.int32)

        self.brick_of_cell = brick_of_cell
        self.slot_of_cell = slot
        self.cell_lin = brick_of_cell * (B**dim) + slot  # brick-cell linear id

        ncb = self.n_bricks * (B**dim)
        self.present = np.zeros(ncb, dtype=bool)
        self.present[self.cell_lin] = True
        # map brick-cell linear id -> active cell index (or -1)
        self.cell_at = np.full(ncb, -1, dtype=np.int64)
        self.cell_at[self.cell_lin] = np.arange(tria.n_active_cells)

        # geometry factor per brick cell (Cartesian: h^(dim-2), equal axes);
        # deformed mappings carry per-quad-point metrics in the engines
        if mf.high_order_mapping:
            self.geo_b = None
        else:
            geo = mf._np["geo"][:, 0]  # [n_cells]
            self.geo_b = np.zeros(ncb)
            self.geo_b[self.cell_lin] = geo

        # masks / hn subset in brick-cell numbering
        self.masks_b = np.zeros(ncb, dtype=np.int32)
        self.masks_b[self.cell_lin] = masks

        # transfer-active subset: constrained cells + vertex-contact cells,
        # stable-sorted by mask so each distinct mask forms one contiguous
        # range — the "sorted" runner analog; the engines then apply one
        # composite [n_loc, n_loc] matmul per range instead of the
        # per-cell masked-sweep kernel.
        xfer_sel = ((masks != 0) & ~self.plane_covered) | self.vertex_contact
        xfer_cells = np.nonzero(xfer_sel)[0]
        order = np.argsort(masks[xfer_cells], kind="stable")
        self.xfer_cells = xfer_cells[order]
        self.hn_lin = self.cell_lin[self.xfer_cells]
        self.hn_masks = masks[self.xfer_cells].astype(np.int32)

        # constrained-closure slot mask (slots whose fast-map entry was
        # replaced by a coarse master): zeroed before col2im, filled by the
        # fill pass. Derived from the same bit rules as the HN kernel.
        sub_b, face_b, edge_b = decompress_mask(self.hn_masks, dim)
        m = len(self.hn_masks)
        closure = np.zeros((m, n_loc), dtype=bool)
        for d in range(dim):
            has = ((face_b >> d) & 1) == 1
            side = ((sub_b >> d) & 1) * p
            closure |= has[:, None] & (lat[None, :, d] == side[:, None])
        for e in range(dim if dim == 3 else 0):
            a, b = [x for x in range(3) if x != e]
            has = ((edge_b >> e) & 1) == 1
            sa = ((sub_b >> a) & 1) * p
            sb = ((sub_b >> b) & 1) * p
            closure |= (
                has[:, None]
                & (lat[None, :, a] == sa[:, None])
                & (lat[None, :, b] == sb[:, None])
            )
        # vertex-contact cells (mask 0): closure = the parent-corner slot
        vsel = self.vertex_contact[self.xfer_cells]
        if vsel.any():
            sb = s_bits[self.xfer_cells[vsel]]
            corner = sum(sb[:, d] * p * (n**d) for d in range(dim))
            rows = np.nonzero(vsel)[0]
            closure[rows, corner] = True
        self.hn_closure = closure  # [n_hn, n_loc]

        # ---- node -> dof maps --------------------------------------------
        # brick node index of (cell slot, local lattice): per axis lc*p + il.
        # int32 throughout: node counts stay < 2^31, and these are the
        # largest setup arrays — the host's fresh-page faults past ~9 GB
        # run at ~20-40 MB/s (utils/hostmem.py), so bytes are the cost.
        self._cni_off = sum(
            lat[:, d][None, :] * NB**d for d in range(dim)
        ).astype(np.int32)  # [1, n_loc]
        self._cni_base = sum(lc[:, d] * p * NB**d for d in range(dim)).astype(
            np.int32
        )  # [n_cells]

        nnode = self.n_bricks * NB**dim
        node_dof = np.full(nnode, -1, dtype=np.int32)
        cd32 = np.asarray(mf.dof_handler.cell_dofs, dtype=np.int32)
        # flat node ids must use the owner dtype: int32 arithmetic would
        # silently wrap once nnode >= 2^31 (the case the odt branch below
        # exists for)
        ndt = np.int32 if nnode <= np.iinfo(np.int32).max else np.int64
        bo_n = brick_of_cell.astype(ndt)
        # chunked: the full flat_nodes array is another [n_cells, n_loc]
        # int32 (1 GB at nref=8); fixed-size chunks reuse the same pages
        cstep = max(1, 40_000_000 // n_loc)
        for s in range(0, tria.n_active_cells, cstep):
            e = min(s + cstep, tria.n_active_cells)
            fn_ = (
                bo_n[s:e, None] * ndt(NB**dim)
                + self.cell_node_index_range(s, e).astype(ndt, copy=False)
            )
            node_dof[fn_.ravel()] = cd32[s:e].ravel()
        self.node_dof = node_dof  # -1 at holes
        self.node_valid = node_dof >= 0

        # per-dof owner node (first covering brick node) for to_dof_vector:
        # scatter node indices in DESCENDING order so the surviving write
        # for each dof is its smallest covering node — replaces a full
        # argsort+searchsorted over the node array (the dominant setup cost
        # at nref>=8). Chunked high-to-low so the low chunks' writes win;
        # the sampled assert double-checks the scatter-order semantics.
        odt = np.int32 if nnode <= np.iinfo(np.int32).max else np.int64
        owner = np.empty(mf.n_dofs, dtype=odt)
        nstep = 50_000_000  # nonzero()'s int64 result is the chunk's cost
        for s in reversed(range(0, nnode, nstep)):
            e = min(s + nstep, nnode)
            nd = node_dof[s:e]
            val = np.nonzero(nd >= 0)[0][::-1]
            owner[nd[val]] = (val + s).astype(odt)
        self.owner_node_of_dof = owner
        samp = np.linspace(
            0, mf.n_dofs - 1, num=min(mf.n_dofs, 1 << 20), dtype=np.int64
        )
        assert (node_dof[owner[samp]] == samp).all()

        hanging = mf.constraints.constrained_dof_marker()
        self.node_hanging = np.zeros(nnode, dtype=bool)
        for s in range(0, nnode, nstep):
            e = min(s + nstep, nnode)
            nd = node_dof[s:e]
            v = nd >= 0
            self.node_hanging[s:e][v] = hanging[nd[v]]
        # dot-product weights: 1 at the owner node of each non-hanging dof
        wmask = np.zeros(nnode, dtype=bool)
        keep = ~hanging
        wmask[self.owner_node_of_dof[keep]] = True
        self.dot_mask = wmask

        # ---- same-level DSS pools (face / edge / corner interfaces) -----
        self._build_pools()
        # ---- coarse-fine fold/fill transfer groups -----------------------
        self._build_transfers()

    # ------------------------------------------------------------ node index
    def cell_node_index_range(self, s, e):
        """Brick node index of (cell slot, local lattice) for cells [s, e):
        computed on demand — the full [n_cells, n_loc] array is ~1 GB at
        nref=8 and the host's fresh-fault budget is the setup wall."""
        return self._cni_base[s:e, None] + self._cni_off

    @property
    def cell_node_index(self):
        return self.cell_node_index_range(0, len(self._cni_base))

    # ----------------------------------------------------------------- pools
    def _face_key(self, lvlb, bcb, d, side):
        """Geometric key of a brick face (canonical: lower brick, +d face)."""
        dim = self.dim
        c = bcb.copy()
        c[:, d] = c[:, d] + side  # face plane index in units of brick grid
        k = (lvlb << np.int64(16 * dim + 4)) | (np.int64(d) << np.int64(16 * dim))
        for dd in range(dim):
            k = k | (c[:, dd] << np.int64(16 * (dim - 1 - dd)))
        return k

    def _build_pools(self):
        NB = self.NB
        nb = self.n_bricks
        lvlb, bcb = self.brick_level, self.brick_coord

        # FACE pools: all NB x NB face nodes (including face edges/corners)
        # are pooled per geometric brick-face. Nodes shared by >2 bricks
        # (brick edges/corners) are then ALSO pooled by edge/corner pools;
        # to keep each node in exactly one pool class, face pools carry only
        # the face-interior (1..NB-2)^2, edge pools the edge-interior, and
        # corner pools the 8 corners.
        dim = self.dim
        keys = []
        for d in range(dim):
            for side in (0, 1):
                keys.append(self._face_key(lvlb, bcb, d, side))
        keys = np.concatenate(keys)
        uk, inv = np.unique(keys, return_inverse=True)
        counts = np.bincount(inv)
        self.face_pool_id = inv.reshape(2 * dim, nb).T.copy()  # [nb, 2*dim]
        self.n_face_pools = len(uk)
        self.face_pool_shared = counts == 2

        # EDGE pools (3D only: brick-edge lines shared by up to 4 bricks)
        if dim == 3:
            edge_keys = []
            for e in range(3):
                a, b = [x for x in range(3) if x != e]
                for sa in (0, 1):
                    for sb in (0, 1):
                        c = bcb.copy()
                        c[:, a] += sa
                        c[:, b] += sb
                        k = ((lvlb << np.int64(50)) | (np.int64(e) << np.int64(48))
                             | (c[:, 0] << np.int64(32)) | (c[:, 1] << np.int64(16))
                             | c[:, 2])
                        edge_keys.append(k)
            ek = np.concatenate(edge_keys)
            uek, einv = np.unique(ek, return_inverse=True)
            self.edge_pool_id = einv.reshape(12, nb).T.copy()  # [nb, 12]
            self.n_edge_pools = len(uek)
        else:
            self.edge_pool_id = np.zeros((nb, 0), dtype=np.int64)
            self.n_edge_pools = 0

        # CORNER pools (2^dim per brick)
        ck = []
        for combo in range(2**dim):
            off = np.array([(combo >> d) & 1 for d in range(dim)])
            c = bcb + off
            k = lvlb << np.int64(16 * dim)
            for d in range(dim):
                k = k | (c[:, d] << np.int64(16 * (dim - 1 - d)))
            ck.append(k)
        ckk = np.concatenate(ck)
        uck, cinv = np.unique(ckk, return_inverse=True)
        self.corner_pool_id = cinv.reshape(2**dim, nb).T.copy()  # [nb, 2^dim]
        self.n_corner_pools = len(uck)

        # gather-only ("pair") DSS tables: faces pair at most 2 bricks, so
        # each face slot has exactly one partner (or the sentinel); edge and
        # corner copies sum their full contributor list in pool-canonical
        # order so all copies of a shared entity stay bit-identical.
        self.face_other = _pool_contrib_table(
            self.face_pool_id, self.n_face_pools, include_self=False
        )
        assert self.face_other.shape[1] <= 1
        self.edge_contrib = _pool_contrib_table(
            self.edge_pool_id, self.n_edge_pools, include_self=True
        )
        self.corner_contrib = _pool_contrib_table(
            self.corner_pool_id, self.n_corner_pools, include_self=True
        )

    # ----------------------------------------------------------- face planes
    def _build_face_planes(self, masks):
        """Enumerate aligned cross-level interface pairs (fine brick face ↔
        quarter of the coarse neighbor brick's face) and the cells they
        fully resolve. A masked cell is plane-covered iff its compressed
        mask has ONLY face bits (no edges), every constrained face is a
        brick-boundary face against a one-level-coarser aligned brick, and
        each face's master cell is unconstrained or itself plane-covered
        (so the plane passes, staged coarse-first, read/write only values
        earlier passes made valid). Everything else stays on the exact
        per-cell chain. Groups are keyed (fine level, face axis, side,
        tangential quarter offsets) so every slice in the engine kernels
        is static."""
        from .constraints import decompress_mask

        mf, tria = self.mf, self.mf.tria
        dim, p, B, NB = self.dim, self.p, self.B, self.NB
        ci = mf.constraints
        lvl = tria.level
        coord = tria.coord
        bofc = self.brick_of_cell
        sub_a, face_a, edge_a = decompress_mask(masks, dim)
        pure = (masks != 0) & (edge_a == 0)
        # accepted cells per level, ascending (masters resolve first)
        levels = np.unique(lvl[pure]) if pure.any() else []
        props = {}  # (lF, d, s, *offs) -> {(F, Cb): [cells]}
        for lv in levels:
            cand = np.nonzero(pure & (lvl == lv))[0]
            ok = np.ones(len(cand), dtype=bool)
            faces_of = []  # per candidate: list of (d, s, F, Cb, offs)
            for ii, c in enumerate(cand):
                entry = []
                for d in range(dim):
                    if not (int(face_a[c]) >> d) & 1:
                        continue
                    s = (int(sub_a[c]) >> d) & 1
                    lc_d = int(coord[c, d]) & (B - 1)
                    if lc_d != (0 if s == 0 else B - 1):
                        ok[ii] = False
                        break
                    m = int(ci.face_neighbor[c, d])
                    if m < 0 or lvl[m] != lv - 1:
                        ok[ii] = False
                        break
                    if masks[m] != 0 and not self.plane_covered[m]:
                        # master's hanging nodes not plane-resolved
                        ok[ii] = False
                        break
                    F = int(bofc[c])
                    Cb = int(bofc[m])
                    if self.brick_level[Cb] != lv - 1:
                        ok[ii] = False
                        break
                    # coarse read/write plane: the masters' face toward the
                    # fine side — possibly INTERIOR to Cb (a fine brick
                    # nests inside half the coarse brick's region)
                    lcm_d = int(coord[m, d]) & (B - 1)
                    c_pl = lcm_d * p + (0 if s == 1 else p)
                    offs = []
                    for t in range(dim):
                        if t == d:
                            continue
                        off = (
                            int(self.brick_coord[F][t]) * (B // 2)
                            - int(self.brick_coord[Cb][t]) * B
                        )
                        if off not in (0, B // 2):
                            offs = None
                            break
                        offs.append(0 if off == 0 else 1)
                    if offs is None:
                        ok[ii] = False
                        break
                    entry.append((d, s, F, Cb, c_pl, tuple(offs)))
                faces_of.append(entry)
            for ii, c in enumerate(cand):
                if not ok[ii] or not faces_of[ii]:
                    continue
                self.plane_covered[c] = True
                for d, s, F, Cb, c_pl, offs in faces_of[ii]:
                    key = (int(lvl[c]), d, s, c_pl) + offs
                    props.setdefault(key, {}).setdefault((F, Cb), []).append(c)

        # per-group arrays with per-pair node masks
        Half = (NB - 1) // 2
        Nh = Half + 1
        from .elements import shape_info

        nodes1 = shape_info(p).nodes  # FE nodal points on [0, 1]
        # 1D fine-axis positions in coarse-half units + conforming flags
        xf = np.empty(NB)
        for q in range(B):
            for j in range(p + 1):
                xf[q * p + j] = (q + nodes1[j]) / B
        xc = np.empty(Nh)
        for k in range(B // 2):
            for j in range(p + 1):
                xc[k * p + j] = (2 * k + 2 * nodes1[j]) / B
        for key in sorted(props):
            lvF, d, s, c_pl = key[0], key[1], key[2], key[3]
            offs = key[4:]
            pairs = props[key]
            fine_ids = np.array([f for f, _ in pairs], dtype=np.int32)
            coarse_ids = np.array([cb for _, cb in pairs], dtype=np.int32)
            tang = [t for t in range(dim) if t != d]
            # plane array axes are (t_hi, t_lo) — spatial axes descending,
            # matching the [.., z, y, x] brick tensor with axis d removed
            mshape = (len(pairs),) + (NB,) * (dim - 1)
            cover = np.zeros(mshape)
            for pi, ((f, cb), cells) in enumerate(pairs.items()):
                for c in cells:
                    idx = [pi]
                    for t in reversed(tang):  # t_hi first
                        lc = int(coord[c, t]) & (B - 1)
                        idx.append(slice(lc * p, lc * p + p + 1))
                    cover[tuple(idx)] = 1.0
            # the fold (corr) mask equals the fill mask: conforming
            # cross-level copies fold too (one-hot P1^T rows) — the coarse
            # copy owns the assembled value, fine copies are zeroed and
            # restored by the input fill, exactly like the per-cell
            # closure convention. Masks are DISJOINTIFIED across groups
            # per (fine brick, node) — two faces of one brick share edge
            # nodes; claiming each node once lets every group of a level
            # compose through one scatter-ADD (values agree on fill,
            # folds must run once).
            self.plane_groups.append(dict(
                level=lvF, d=d, s=s, c_pl=c_pl, offs=offs,
                fine=fine_ids, coarse=coarse_ids, cover=cover,
            ))
        claimed = {}  # fine brick -> bool[N3] of already-claimed nodes
        N3 = NB**dim
        for g in self.plane_groups:
            d, s = g["d"], g["s"]
            tang = sorted([t for t in range(dim) if t != d], reverse=True)
            idx_d = (0 if s == 0 else NB - 1) * NB**d
            if dim == 3:
                hi, lo = np.meshgrid(np.arange(NB), np.arange(NB),
                                     indexing="ij")
                plane_idx = (idx_d + hi * NB**tang[0]
                             + lo * NB**tang[1]).ravel()
            else:
                plane_idx = idx_d + np.arange(NB) * NB**tang[0]
            for pi, f in enumerate(g["fine"]):
                cl = claimed.setdefault(int(f), np.zeros(N3, dtype=bool))
                cov = g["cover"][pi].ravel() > 0
                eff = cov & ~cl[plane_idx]
                cl[plane_idx[eff]] = True
                g["cover"][pi] = eff.astype(np.float64).reshape(
                    g["cover"][pi].shape
                )
        # interpolation from the covering coarse cell's nodal basis
        P1 = np.zeros((NB, Nh))
        from .elements import lagrange_values

        for i in range(NB):
            k = min(int(np.floor(xf[i] * (B // 2) - 1e-12)), B // 2 - 1)
            k = max(k, 0)
            xi = xf[i] * (B // 2) - k
            P1[i, k * p: k * p + p + 1] = lagrange_values(
                nodes1, np.array([xi]))[0]
        self.plane_P1 = P1

    # ------------------------------------------------------------- transfers
    def _build_transfers(self):
        """Mask-grouped fold/fill row transfers between fine constrained cells
        and their coarse neighbors, in the cols [*, n_loc] domain."""
        mf = self.mf
        dim, p = self.dim, self.p
        n = p + 1
        lat = self._lat
        ci = mf.constraints
        masks = mf._np["masks"]
        hn_cells = np.nonzero((masks != 0) & ~self.plane_covered)[0]
        groups = []
        for mval in np.unique(masks[hn_cells]):
            cells = hn_cells[masks[hn_cells] == mval]
            for kind, axis, slots in _entity_slot_partition(int(mval), dim, p, lat):
                if len(slots) == 0:
                    continue
                if kind == "face":
                    nbr = ci.face_neighbor[cells, axis]
                else:
                    nbr = ci.edge_neighbor[cells, axis]
                assert (nbr >= 0).all()
                dst = _mirror_slots(kind, axis, slots, int(mval), dim, p, lat)
                for lv in np.unique(mf.tria.level[cells]):
                    lsel = mf.tria.level[cells] == lv
                    groups.append(
                        _TransferGroup(
                            fine_cells=self.cell_lin[cells[lsel]],
                            coarse_cells=self.cell_lin[nbr[lsel]],
                            src_slots=slots.astype(np.int64),
                            dst_slots=dst,
                            level=int(lv),
                        )
                    )
        # vertex-contact groups (identity weight), grouped by subcell combo
        vcells = np.nonzero(self.vertex_contact)[0]
        if len(vcells):
            sb = (mf.tria.coord[vcells] & 1).astype(np.int64)
            combo = sum(sb[:, d] << d for d in range(dim))
            for cv in np.unique(combo):
                sel = vcells[combo == cv]
                bits = [(cv >> d) & 1 for d in range(dim)]
                src = np.array(
                    [sum(bits[d] * p * (n**d) for d in range(dim))], dtype=np.int64
                )
                dst = np.array(
                    [sum((1 - bits[d]) * p * (n**d) for d in range(dim))],
                    dtype=np.int64,
                )
                for lv in np.unique(mf.tria.level[sel]):
                    lsel = mf.tria.level[sel] == lv
                    groups.append(
                        _TransferGroup(
                            fine_cells=self.cell_lin[sel[lsel]],
                            coarse_cells=self.cell_lin[self.vertex_diag[sel[lsel]]],
                            src_slots=src,
                            dst_slots=dst,
                            level=int(lv),
                        )
                    )
        self.transfer_groups = groups


# ===========================================================================
class BrickLaplace:
    """Laplace vmult on BrickVectors (Cartesian mapping, dim=3).

    See module docstring for the pipeline: XLA static slices and one dense
    matmul per cell block. BrickLaplaceMM is the production engine.
    """

    def __init__(self, mf: MatrixFree, brick_size: int | None = None):
        if mf.dim != 3:
            raise NotImplementedError("use BrickLaplaceMM for dim=2")
        if mf.high_order_mapping:
            raise NotImplementedError(
                "use BrickLaplaceMM for deformed mappings"
            )
        self.mf = mf
        self.bs = bs = BrickStructure(mf, brick_size)
        p, B, NB, dim = bs.p, bs.B, bs.NB, bs.dim
        self.n = n = p + 1
        n_loc = n**dim

        # dense reference-cell stiffness (sum over axes; equal-h Cartesian)
        from .elements import shape_info

        si = shape_info(p)
        w = si.quad_w
        M1 = np.einsum("q,qi,qj->ij", w, si.S, si.S)
        K1 = np.einsum("q,qi,qj->ij", w, si.D, si.D)
        K = np.zeros((n_loc, n_loc))
        for d in range(dim):
            facs = [K1 if t == d else M1 for t in range(dim)]
            A = facs[dim - 1]
            for t in range(dim - 2, -1, -1):
                A = np.kron(A, facs[t])
            K += A

        # per-level transfer groups (chained folds: fine -> coarse)
        levels = sorted({g.level for g in bs.transfer_groups})
        groups_by_level = {lv: [] for lv in levels}
        for g in bs.transfer_groups:
            T = np.zeros((n_loc, n_loc))
            T[g.src_slots, g.dst_slots] = 1.0
            groups_by_level[g.level].append(
                dict(
                    fine=jnp.asarray(g.fine_cells.astype(np.int32)),
                    coarse=jnp.asarray(g.coarse_cells.astype(np.int32)),
                    fine_s=None,  # filled below once the subset map exists
                    coarse_s=None,
                    T=jnp.asarray(T, dtype=mf.dtype),
                )
            )
        # per-level xfer-cell closure zeroing data
        xfer_levels = np.asarray(mf.tria.level[bs.xfer_cells])
        level_zero = {}
        for lv in levels:
            sel = xfer_levels == lv
            level_zero[lv] = dict(
                lin=jnp.asarray(bs.hn_lin[sel].astype(np.int32)),
                lin_s=None,
                keep=jnp.asarray(
                    (1.0 - bs.hn_closure[sel].astype(np.float64)), dtype=mf.dtype
                ),
            )
        self._levels = levels

        # node coverage by present cells (for averaging writes in the fill);
        # chunked like the node_dof build — the full cell_node_index is
        # another [n_cells, n_loc] array (1 GB at nref=8) — and bincount
        # instead of ufunc.at (~10x)
        nnode_cov = bs.n_bricks * NB**3
        cov = np.zeros(nnode_cov)
        _cstep = max(1, 40_000_000 // n_loc)
        for s in range(0, len(bs.brick_of_cell), _cstep):
            e = min(s + _cstep, len(bs.brick_of_cell))
            idx = (
                bs.brick_of_cell[s:e, None].astype(np.int64) * NB**3
                + bs.cell_node_index_range(s, e)
            )
            cov += np.bincount(idx.ravel(), minlength=nnode_cov)
        inv_cov = np.where(cov > 0, 1.0 / np.maximum(cov, 1), 0.0)

        n_pad = ((n_loc + 127) // 128) * 128
        K_pad = np.zeros((n_pad, n_pad))
        K_pad[:n_loc, :n_loc] = K

        # fill-pass brick subset: bricks containing transfer-active cells or
        # their coarse destinations; everything else is untouched by the fill
        C = B**dim
        touched = set((bs.hn_lin // C).tolist())
        for g in bs.transfer_groups:
            touched.update((g.fine_cells // C).tolist())
            touched.update((g.coarse_cells // C).tolist())
        sub_ids = np.array(sorted(touched), dtype=np.int64)
        sub_of_brick = np.full(bs.n_bricks, -1, dtype=np.int64)
        sub_of_brick[sub_ids] = np.arange(len(sub_ids))

        def _remap(lin):
            return (sub_of_brick[lin // C] * C + lin % C).astype(np.int32)

        self._n_sub = len(sub_ids)
        # remap transfer/closure indices into the fill subset numbering
        import jax.numpy as _jnp

        for lv in levels:
            for g in groups_by_level[lv]:
                g["fine_s"] = _jnp.asarray(_remap(np.asarray(g["fine"])))
                g["coarse_s"] = _jnp.asarray(_remap(np.asarray(g["coarse"])))
            level_zero[lv]["lin_s"] = _jnp.asarray(
                _remap(np.asarray(level_zero[lv]["lin"]))
            )
        hn_lin_s = _remap(bs.hn_lin)
        present_b = bs.present.reshape(bs.n_bricks, C)
        cov3 = inv_cov.reshape(bs.n_bricks, NB, NB, NB)

        self.arrays = dict(
            inv_cov=jnp.asarray(
                inv_cov.reshape(bs.n_bricks, NB, NB, NB), dtype=mf.dtype
            ),
            K=jnp.asarray(K_pad, dtype=mf.dtype),
            geo=jnp.asarray(bs.geo_b, dtype=mf.dtype),
            present=jnp.asarray(bs.present.astype(np.float32), dtype=mf.dtype),
            hn_lin=jnp.asarray(bs.hn_lin.astype(np.int32)),
            hn_masks=jnp.asarray(bs.hn_masks),
            closure=jnp.asarray(bs.hn_closure.astype(np.float32), dtype=mf.dtype),
            P=jnp.asarray(si.P, dtype=mf.dtype),
            face_pool_id=jnp.asarray(bs.face_pool_id.astype(np.int32)),
            edge_pool_id=jnp.asarray(bs.edge_pool_id.astype(np.int32)),
            corner_pool_id=jnp.asarray(bs.corner_pool_id.astype(np.int32)),
            node_valid=jnp.asarray(
                bs.node_valid.reshape(bs.n_bricks, NB, NB, NB)
            ),
            transfers={lv: groups_by_level[lv] for lv in levels},
            level_zero=level_zero,
            sub_ids=jnp.asarray(sub_ids.astype(np.int32)),
            hn_lin_s=jnp.asarray(hn_lin_s),
            present_s=jnp.asarray(
                present_b[sub_ids].reshape(-1).astype(np.float32), dtype=mf.dtype
            ),
            inv_cov_s=jnp.asarray(cov3[sub_ids], dtype=mf.dtype),
        )
        self._jit_vmult = jax.jit(self._vmult_impl)

    # ---------------------------------------------------------- conversions
    def from_dof_vector(self, u: np.ndarray) -> jnp.ndarray:
        bs = self.bs
        u_dist = self.mf.constraints.distribute(np.asarray(u))
        flat = np.zeros(bs.n_bricks * bs.NB**3, dtype=self.mf.dtype)
        flat[bs.node_valid] = u_dist[bs.node_dof[bs.node_valid]]
        return jnp.asarray(flat.reshape(bs.n_bricks, bs.NB, bs.NB, bs.NB))

    def to_dof_vector(self, bv: jnp.ndarray, zero_hanging: bool = False):
        bs = self.bs
        flat = np.asarray(bv).reshape(-1)
        u = flat[bs.owner_node_of_dof]
        if zero_hanging:
            u = u.copy()
            u[self.mf.constraints.constrained_dof_marker()] = 0.0
        return u

    # --------------------------------------------------------------- pieces
    def _im2col(self, bv):
        bs = self.bs
        p, B = bs.p, bs.B
        outs = []
        lim = (B - 1) * p + 1
        for kz in range(self.n):
            for ky in range(self.n):
                for kx in range(self.n):
                    outs.append(
                        jax.lax.slice(
                            bv,
                            (0, kz, ky, kx),
                            (bv.shape[0], kz + lim, ky + lim, kx + lim),
                            (1, p, p, p),
                        )
                    )
        cols = jnp.stack(outs, axis=-1)  # [nb, B,B,B, n_loc]
        return cols.reshape(-1, self.n**3)

    def _col2im(self, vals, add=True, n_bricks=None):
        bs = self.bs
        p, B, NB = bs.p, bs.B, bs.NB
        nb = n_bricks if n_bricks is not None else bs.n_bricks
        v = vals.reshape(nb, B, B, B, self.n**3)
        out = jnp.zeros((nb, NB, NB, NB), vals.dtype)
        lim = (B - 1) * p + 1
        k = 0
        for kz in range(self.n):
            for ky in range(self.n):
                for kx in range(self.n):
                    piece = v[..., k]
                    k += 1
                    sl = (
                        slice(None),
                        slice(kz, kz + lim, p),
                        slice(ky, ky + lim, p),
                        slice(kx, kx + lim, p),
                    )
                    out = out.at[sl].add(piece) if add else out.at[sl].set(piece)
        return out

    def _dss(self, pv, a):
        """Pooled direct-stiffness summation across bricks (same level)."""
        bs = self.bs
        NB = bs.NB
        nb = bs.n_bricks
        inner = slice(1, NB - 1)
        # ---- faces (interior nodes)
        planes = []
        sls = []
        for d in range(3):
            ax = 3 - d  # array axis of spatial axis d (z,y,x order + brick axis)
            for side in (0, 1):
                idx = [slice(None)] * 4
                idx[ax] = 0 if side == 0 else NB - 1
                for aa in range(1, 4):
                    if aa != ax:
                        idx[aa] = inner
                sls.append(tuple(idx))
                planes.append(pv[tuple(idx)].reshape(nb, -1))
        planes = jnp.stack(planes, axis=1)  # [nb, 6, 225]
        # face_pool_id is [nb, 6] ordered (d*2+side) — match the loop order
        pool = jnp.zeros((bs.n_face_pools, planes.shape[-1]), pv.dtype)
        pool = pool.at[a["face_pool_id"].reshape(-1)].add(planes.reshape(-1, planes.shape[-1]))
        back = pool[a["face_pool_id"].reshape(-1)].reshape(nb, 6, -1)
        for i, sl in enumerate(sls):
            shp = pv[sl].shape
            pv = pv.at[sl].set(back[:, i].reshape(shp))
        # ---- edges (interior nodes)
        lines = []
        esls = []
        i_e = 0
        for e in range(3):
            axes = [x for x in range(3) if x != e]
            ax_e = 3 - e
            for sa in (0, 1):
                for sb in (0, 1):
                    idx = [slice(None)] * 4
                    idx[3 - axes[0]] = 0 if sa == 0 else NB - 1
                    idx[3 - axes[1]] = 0 if sb == 0 else NB - 1
                    idx[ax_e] = inner
                    esls.append(tuple(idx))
                    lines.append(pv[tuple(idx)].reshape(nb, -1))
                    i_e += 1
        lines = jnp.stack(lines, axis=1)  # [nb, 12, 15]
        epool = jnp.zeros((bs.n_edge_pools, lines.shape[-1]), pv.dtype)
        epool = epool.at[a["edge_pool_id"].reshape(-1)].add(lines.reshape(-1, lines.shape[-1]))
        eback = epool[a["edge_pool_id"].reshape(-1)].reshape(nb, 12, -1)
        for i, sl in enumerate(esls):
            shp = pv[sl].shape
            pv = pv.at[sl].set(eback[:, i].reshape(shp))
        # ---- corners
        corners = []
        csls = []
        for sz in (0, 1):
            for sy in (0, 1):
                for sx in (0, 1):
                    idx = (
                        slice(None),
                        0 if sz == 0 else NB - 1,
                        0 if sy == 0 else NB - 1,
                        0 if sx == 0 else NB - 1,
                    )
                    csls.append(idx)
                    corners.append(pv[idx])
        corners = jnp.stack(corners, axis=1)  # [nb, 8]
        cpool = jnp.zeros((bs.n_corner_pools,), pv.dtype)
        cpool = cpool.at[a["corner_pool_id"].reshape(-1)].add(corners.reshape(-1))
        cback = cpool[a["corner_pool_id"].reshape(-1)].reshape(nb, 8)
        for i, sl in enumerate(csls):
            pv = pv.at[sl].set(cback[:, i])
        return pv

    # ----------------------------------------------------------------- vmult
    def _vmult_impl(self, bv, a):
        from .ops.hanging_nodes import apply_hanging_node_constraints

        bs = self.bs
        dim = bs.dim
        # 1) cells from bricks (hanging slots already hold distributed values)
        cols = self._im2col(bv)
        # 2) cell kernel: dense matmul, per-cell Cartesian scale
        # (K padded to a 128-multiple square at setup)
        nl = cols.shape[1]
        padded = jnp.pad(cols, ((0, 0), (0, a["K"].shape[0] - nl)))
        vals = jnp.dot(padded, a["K"].T, preferred_element_type=cols.dtype)[:, :nl]
        vals = vals * (a["geo"] * a["present"])[:, None]
        # 3) hanging-node transpose on the constrained subset
        if self.bs.hn_lin.shape[0] == 0:
            # no constraints: DSS totals already satisfy the invariant
            pv = self._col2im(vals, add=True)
            pv = self._dss(pv, a)
            return jnp.where(a["node_valid"], pv, 0.0)
        sub_raw = apply_hanging_node_constraints(
            vals[a["hn_lin"]], a["hn_masks"], a["P"], dim, transpose=True
        )
        vals = vals.at[a["hn_lin"]].set(sub_raw)
        # 4) chained folds, finest level first: forward constrained-slot
        #    values (own + received from finer levels) to coarse neighbors,
        #    then retire this level's closure slots. All groups of a level
        #    are concatenated into ONE scatter-add (buffer-update count is
        #    the dominant XLA cost, not the tiny matmuls).
        for lv in sorted(self._levels, reverse=True):
            rows_all, coarse_all = [], []
            for g in a["transfers"][lv]:
                rows_all.append(
                    jnp.dot(jnp.take(vals, g["fine"], axis=0), g["T"],
                            preferred_element_type=vals.dtype)
                )
                coarse_all.append(g["coarse"])
            lz = a["level_zero"][lv]
            zeroed = jnp.take(vals, lz["lin"], axis=0) * lz["keep"]
            vals = vals.at[jnp.concatenate(coarse_all)].add(
                jnp.concatenate(rows_all, axis=0)
            )
            vals = vals.at[lz["lin"]].set(zeroed)
        # 5) within-brick assembly + cross-brick summation
        pv = self._col2im(vals, add=True)
        pv = self._dss(pv, a)
        pv = jnp.where(a["node_valid"], pv, 0.0)
        # 6) fill pass (chained, coarsest first) on the brick SUBSET touched
        #    by transfers: restore the distributed-hanging invariant
        sub_bricks = jnp.take(pv, a["sub_ids"], axis=0)
        cols2 = self._im2col(sub_bricks)
        for lv in sorted(self._levels):
            lz = a["level_zero"][lv]
            cols2 = cols2.at[lz["lin_s"]].set(
                jnp.take(cols2, lz["lin_s"], axis=0) * lz["keep"]
            )
            rows_all, fine_all = [], []
            for g in a["transfers"][lv]:
                rows_all.append(
                    jnp.dot(jnp.take(cols2, g["coarse_s"], axis=0), g["T"].T,
                            preferred_element_type=pv.dtype)
                )
                fine_all.append(g["fine_s"])
            cols2 = cols2.at[jnp.concatenate(fine_all)].add(
                jnp.concatenate(rows_all, axis=0)
            )
        sub2 = apply_hanging_node_constraints(
            jnp.take(cols2, a["hn_lin_s"], axis=0), a["hn_masks"], a["P"], dim,
            transpose=False,
        )
        cols2 = cols2.at[a["hn_lin_s"]].set(sub2)
        out_sub = (
            self._col2im(cols2 * a["present_s"][:, None], add=True,
                         n_bricks=sub_bricks.shape[0])
            * a["inv_cov_s"]
        )
        out = pv.at[a["sub_ids"]].set(out_sub)
        return jnp.where(a["node_valid"], out, 0.0)

    def vmult(self, bv: jnp.ndarray) -> jnp.ndarray:
        return self._jit_vmult(bv, self.arrays)


# ===========================================================================
class BrickLaplaceMM:
    """Matmul-formulation brick engine (the production vmult).

    Bricks are stored FLAT [n_bricks, NB^3 (padded to a multiple of 128)].
    Structural data movement is expressed as matmuls with static 0/1
    selection matrices, kept exact by running them at _EXACT precision:

    - main path: v = h_b * (u @ A_brick^T), A_brick = sum_cells P_c^T K P_c
      — the assembled per-brick operator (identical for every brick of a
      level up to the scalar h factor, since brick cells share one size);
    - corrections for "exceptional" cells (absent hole cells and
      hanging-node-constrained cells) run on the small subset of bricks via
      im2col/col2im AS MATMULS with the one-hot patch matrix E;
    - cross-brick DSS extracts the 1538 surface nodes with a one-hot matrix,
      pools faces/edges/corners by interface id (wide row scatter/gather),
      and writes back with one matmul;
    - chained coarse-fine folds/fills and the HN kernel operate in the
      subset cols domain exactly as in BrickLaplace.
    """

    def __init__(self, mf: MatrixFree, brick_size: int | None = None,
                 matmul_precision: str = "highest",
                 main_path: str = "separable",
                 dss_mode: str | None = None, use_ssub: bool | None = None,
                 fill_mode: str | None = None,
                 col2im: str | None = None, face_planes: bool | None = None):
        if main_path not in ("separable", "dense"):
            raise ValueError(f"unknown main_path {main_path!r}")
        degree = mf.degree
        if fill_mode is None:
            # input-side resolution (the read_dof_values analog): the
            # output fill pass disappears entirely. Chosen by a fill-mode
            # A/B on the platform the engine was first built for; not yet
            # re-measured on the GPU.
            fill_mode = os.environ.get("BRICK_FILL", "input")
        if fill_mode not in ("exchange", "volume", "hybrid", "input"):
            raise ValueError(f"unknown fill_mode {fill_mode!r}")
        self._fill_mode = fill_mode
        if col2im is None:
            # one-hot E matmul at p>=2, the separable form (whose 7-d
            # transpose costs more than its FLOP savings at p>=2) at p=1;
            # not yet re-measured on the GPU
            col2im = os.environ.get(
                "BRICK_COL2IM", "onehot" if degree >= 2 else "sep"
            )
        if col2im not in ("sep", "onehot"):
            raise ValueError(f"unknown col2im {col2im!r}")
        self._col2im = col2im
        self._use_ssub_arg = use_ssub
        if dss_mode is None:
            dss_mode = os.environ.get("BRICK_DSS", "pool")
        if dss_mode not in ("pool", "pair"):
            raise ValueError(f"unknown dss_mode {dss_mode!r}")
        self.mf = mf
        self.main_path = main_path
        self._dss_mode = dss_mode
        # jax.default_matmul_precision name for the arithmetic dots (the
        # operator factors, K, HN and transfer interpolation); the 0/1
        # selection dots are always _EXACT
        self._matmul_precision = matmul_precision

        if face_planes is None:
            # face-plane constraint resolution rides the assembled
            # (Cartesian, input-fill) schedule only; engines that reuse
            # the per-cell machinery end-to-end (elasticity, distributed,
            # GMG levels) pass face_planes=False explicitly. Default on at
            # p<=2, where a brick holds B^dim tiny cells and the per-cell
            # chains cost several times the plane passes; at p>=3 the
            # plane passes' per-level buffer copies on the larger
            # [*, NB^dim] bricks cost more than they save (measured on the
            # platform the engine was first built for). BRICK_PLANES=0/1
            # overrides.
            env = os.environ.get("BRICK_PLANES", "auto")
            if env in ("0", "1"):
                face_planes = env == "1"
            else:
                face_planes = degree <= 2
            face_planes = (
                face_planes
                and not mf.high_order_mapping
                and self._fill_mode == "input"
            )
        self._face_planes = bool(face_planes)
        # assembled masked-quadrature removal: the win at low degree
        # (C=B^dim cells per brick make every per-row op dominant) but a
        # loss at the p=4 flagship, where the per-cell `plain` delta path
        # is already cheap (measured on the platform the engine was first
        # built for). BRICK_ASM=0/1 overrides the degree gate.
        env_asm = os.environ.get("BRICK_ASM", "auto")
        self._use_masked_removal = (
            (env_asm == "1" or (env_asm != "0" and degree <= 3))
            and not mf.high_order_mapping
            and self._fill_mode == "input"
        ) or self._face_planes

        self.bs = bs = BrickStructure(mf, brick_size,
                                      face_planes=self._face_planes)
        p, B, NB, dim = bs.p, bs.B, bs.NB, bs.dim
        self.n = n = p + 1
        n_loc = n**dim
        N3 = NB**dim
        self.N3 = N3
        self.N3p = N3p = ((N3 + 127) // 128) * 128
        C = B**dim

        from .elements import shape_info

        si = shape_info(p)
        w = si.quad_w
        M1 = np.einsum("q,qi,qj->ij", w, si.S, si.S)
        K1 = np.einsum("q,qi,qj->ij", w, si.D, si.D)
        K = np.zeros((n_loc, n_loc))
        for d in range(dim):
            facs = [K1 if t == d else M1 for t in range(dim)]
            A = facs[dim - 1]
            for t in range(dim - 2, -1, -1):
                A = np.kron(A, facs[t])
            K += A

        # per-slot node indices within a brick (same for all bricks)
        lat = local_lattice(p, dim)
        slot_lat = local_lattice(B - 1, dim) if B > 1 else np.zeros((1, dim), int)
        slot_idx = np.zeros((C, n_loc), dtype=np.int64)
        node_off = sum(lat[:, d] * NB**d for d in range(dim))
        for sl in range(C):
            base = sum(int(slot_lat[sl, d]) * p * NB**d for d in range(dim))
            slot_idx[sl] = base + node_off
        self.slot_idx = slot_idx

        # Kronecker-separable brick operator: the brick is a tensor-product
        # grid of B equal cells per axis, so the assembled brick matrix
        # factors exactly as A = sum_d  prod_t (Kb if t==d else Mb)  with 1D
        # assembled factors Kb/Mb [NB, NB] (x innermost). The main path
        # applies these tiny factors instead of the dense [N3p, N3p] matrix:
        # ~30x fewer FLOPs and ~5x less HBM traffic at p=4/B=4 (PERF.md).
        Kb = np.zeros((NB, NB))
        Mb = np.zeros((NB, NB))
        for c in range(B):
            csl = slice(c * p, c * p + n)
            Kb[csl, csl] += K1
            Mb[csl, csl] += M1
        if dim == 3:
            # xy-plane factors: A = Mz (x) Fxy + Kz (x) Mxy
            Fxy = np.kron(Mb, Kb) + np.kron(Kb, Mb)
            Mxy = np.kron(Mb, Mb)
        else:
            Fxy = Mxy = np.zeros((0, 0))

        if main_path == "dense":
            # assembled full-brick operator (kept for A/B benchmarking)
            A_full = np.zeros((N3p, N3p))
            for sl in range(C):
                A_full[np.ix_(slot_idx[sl], slot_idx[sl])] += K
        else:
            A_full = np.zeros((0, 0))

        # one-hot patch matrix E [C*n_loc, N3p] (cols -> brick nodes):
        # used only for the overlap-add scatter direction (the transposed
        # stride-p conv lowers to an input-dilated conv); the forward patch
        # extraction uses conv_general_dilated_patches.
        E = np.zeros((C * n_loc, N3p), dtype=np.float64)
        E[np.arange(C * n_loc), slot_idx.reshape(-1)] = 1.0

        # surface node ordering: face interiors, [3D: edge interiors], corners
        # — block order must match BrickStructure's pool tables
        surf = []
        self._surf_layout = {}
        pos = 0
        inner = np.arange(1, NB - 1)
        if dim == 3:
            grid3 = lambda z, y, x: (z * NB + y) * NB + x
            for d in range(3):
                for side in (0, 1):
                    c = 0 if side == 0 else NB - 1
                    if d == 0:  # x-face: vary (z, y)
                        ids = grid3(inner[:, None], inner[None, :], c)
                    elif d == 1:
                        ids = grid3(inner[:, None], c, inner[None, :])
                    else:
                        ids = grid3(c, inner[:, None], inner[None, :])
                    surf.append(ids.reshape(-1))
                    self._surf_layout[("face", d, side)] = (pos, ids.size)
                    pos += ids.size
            for e in range(3):
                axes = [x for x in range(3) if x != e]
                for sa in (0, 1):
                    for sb in (0, 1):
                        coord = [None, None, None]
                        coord[axes[0]] = 0 if sa == 0 else NB - 1
                        coord[axes[1]] = 0 if sb == 0 else NB - 1
                        pts = []
                        for t in inner:
                            cc = [0, 0, 0]
                            cc[e] = t
                            cc[axes[0]] = coord[axes[0]]
                            cc[axes[1]] = coord[axes[1]]
                            pts.append(grid3(cc[2], cc[1], cc[0]))
                        surf.append(np.array(pts))
                        self._surf_layout[("edge", e, sa, sb)] = (pos, len(pts))
                        pos += len(pts)
            for combo in range(8):
                cc = [(0 if ((combo >> d) & 1) == 0 else NB - 1) for d in range(3)]
                surf.append(np.array([grid3(cc[2], cc[1], cc[0])]))
                self._surf_layout[("corner", combo)] = (pos, 1)
                pos += 1
        else:  # dim == 2: face = side line interiors, then 4 corners
            grid2 = lambda y, x: y * NB + x
            for d in range(2):
                for side in (0, 1):
                    c = 0 if side == 0 else NB - 1
                    if d == 0:  # x-side: vary y
                        ids = grid2(inner, c)
                    else:
                        ids = grid2(c, inner)
                    surf.append(ids.reshape(-1))
                    self._surf_layout[("face", d, side)] = (pos, ids.size)
                    pos += ids.size
            for combo in range(4):
                cc = [(0 if ((combo >> d) & 1) == 0 else NB - 1) for d in range(2)]
                surf.append(np.array([grid2(cc[1], cc[0])]))
                self._surf_layout[("corner", combo)] = (pos, 1)
                pos += 1
        surf_idx = np.concatenate(surf)
        self.n_surf = len(surf_idx)
        Es = np.zeros((self.n_surf, N3p))
        Es[np.arange(self.n_surf), surf_idx] = 1.0

        # exceptional cells: absent slots + transfer-active cells (+ fold
        # destinations). Their bricks form the correction subset —
        # renumbered to the FRONT by BrickStructure (subset-first order),
        # so every subset gather/scatter is a static leading slice.
        absent_lin = np.nonzero(~bs.present)[0]
        sub_ids = np.nonzero(bs.exc_brick)[0].astype(np.int64)
        sub_of_brick = np.full(bs.n_bricks, -1, dtype=np.int64)
        sub_of_brick[sub_ids] = np.arange(len(sub_ids))
        self._n_sub = len(sub_ids)
        self._sub_contig = bool(
            (sub_ids == np.arange(len(sub_ids))).all()
        )

        def remap(lin):
            out = sub_of_brick[lin // C] * C + lin % C
            assert (out >= 0).all()
            return out.astype(np.int32)

        # subset index arrays
        absent_sub = remap(absent_lin) if len(absent_lin) else np.zeros(0, np.int32)
        hn_sub = remap(bs.hn_lin)
        levels = sorted({g.level for g in bs.transfer_groups})
        self._levels = levels
        groups = {lv: [] for lv in levels}
        for g in bs.transfer_groups:
            T = np.zeros((n_loc, n_loc))
            T[g.src_slots, g.dst_slots] = 1.0
            groups[g.level].append(
                dict(
                    fine=np.asarray(remap(g.fine_cells)),
                    coarse=np.asarray(remap(g.coarse_cells)),
                    T=np.asarray(T, dtype=mf.dtype),
                )
            )
        # every chain index (hn rows, fold sources/destinations) lives in
        # the chain-brick prefix of the subset (BrickStructure tier 0), so
        # the cols-domain chain work can run on u_sub[:n_chainb] only
        self._n_chainb = bs.n_chain_bricks
        _chain_lim = self._n_chainb * C
        assert (hn_sub < _chain_lim).all()
        for _lv in levels:
            for _g in groups[_lv]:
                assert (_g["fine"] < _chain_lim).all()
                assert (_g["coarse"] < _chain_lim).all()

        # batched per-level transfer tensors: one padded [G, m_max] gather +
        # one [G, m, n_loc] x [G, n_loc, n_loc] einsum + one scatter-add per
        # level replaces the per-group take/dot/concat chains (~144 groups
        # at nref=7, each a separate small kernel launch)
        transfers_b = {}
        for lv in levels:
            gl = groups[lv]
            G = len(gl)
            m_max = max(len(g["fine"]) for g in gl)
            fine_pad = np.zeros((G, m_max), dtype=np.int32)
            coarse_pad = np.zeros((G, m_max), dtype=np.int32)
            mask_pad = np.zeros((G, m_max, 1))
            T_stack = np.zeros((G, n_loc, n_loc))
            for gi, g in enumerate(gl):
                m = len(g["fine"])
                fine_pad[gi, :m] = g["fine"]
                coarse_pad[gi, :m] = g["coarse"]
                mask_pad[gi, :m] = 1.0
                T_stack[gi] = g["T"]
            transfers_b[lv] = dict(
                fine=fine_pad,
                coarse=coarse_pad,
                mask=np.asarray(mask_pad, dtype=mf.dtype),
                T=np.asarray(T_stack, dtype=mf.dtype),
            )

        xfer_levels = np.asarray(mf.tria.level[bs.xfer_cells])
        level_zero = {}
        for lv in levels:
            sel = xfer_levels == lv
            level_zero[lv] = dict(
                lin=np.asarray(hn_sub[sel]),
                keep=np.asarray(
                    1.0 - bs.hn_closure[sel].astype(np.float64), dtype=mf.dtype
                ),
            )

        # ---- flattened (dependency-staged) chain schedules -------------
        # The per-level fold loops serialize ~4-6 HBM gather/scatter round
        # trips per chain although almost no transfer actually READS a slot
        # another transfer WRITES (measured: 7 of 41157 pairs at quadrant
        # nref=7). Stage the pairs by true slot-level dependency: stage 1 is
        # one hoisted gather + per-level einsums + one scatter-add; later
        # stages (the rare multi-level constraint chains) are tiny per-pair
        # batches. Exactly equal to the sequential schedule: fold adds
        # commute, the lz masking moves to one pass (fill: before — reads of
        # unfilled closure slots see 0 in both schedules; correction: after
        # — no transfer writes an lz row once its finer level ran, which is
        # what staging guarantees).
        self._chain_mode = os.environ.get("BRICK_CHAIN", "compact")

        def _stage_chain(direction):
            order = levels if direction == "fill" else list(reversed(levels))
            stagemap = {}  # row -> int[n_loc] max stage writing each slot
            pair_stage = {lv: [] for lv in levels}
            for lv in order:
                for g in groups[lv]:
                    T = g["T"]
                    if direction == "fill":
                        # fill: out[j] = sum_i T[j,i] src[i] on the coarse
                        # row; writes nonzero rows of T into the fine row
                        read = np.abs(T).sum(axis=0) > 0
                        write = np.abs(T).sum(axis=1) > 0
                        src_rows, dst_rows = g["coarse"], g["fine"]
                    else:
                        read = np.abs(T).sum(axis=1) > 0
                        write = np.abs(T).sum(axis=0) > 0
                        src_rows, dst_rows = g["fine"], g["coarse"]
                    stages = np.ones(len(src_rows), dtype=np.int64)
                    for k, (s, d) in enumerate(zip(src_rows, dst_rows)):
                        sm = stagemap.get(int(s))
                        if sm is not None:
                            st = int(sm[read].max()) if read.any() else 0
                            stages[k] = st + 1
                    # update write map only after the level's reads resolve
                    for k, d in enumerate(dst_rows):
                        sm = stagemap.setdefault(
                            int(d), np.zeros(n_loc, dtype=np.int64)
                        )
                        sm[write] = np.maximum(sm[write], stages[k])
                    pair_stage[lv].append(stages)
            n_stages = max(
                (int(s.max()) for lv in levels for s in pair_stage[lv]
                 if len(s)), default=1,
            )
            # stage 1: padded [G, m] grids of stage-1 pairs with one
            # concatenated gather/scatter. Groups are pooled ACROSS levels
            # (each bucket entry stacks its own T), sorted by pair count and
            # greedily bucketed so the padding ratio stays bounded — the
            # per-level single-grid layout padded 41k slots for 17k real
            # pairs at quadrant nref=7, and the hoisted gather pays per
            # padded row.
            items = []  # (m1, lv, gi, srcs, dsts)
            for lv in levels:
                for gi, g in enumerate(groups[lv]):
                    sel1 = pair_stage[lv][gi] == 1
                    m1 = int(sel1.sum())
                    if m1 == 0:
                        continue
                    srcs = (g["coarse"] if direction == "fill"
                            else g["fine"])[sel1]
                    dsts = (g["fine"] if direction == "fill"
                            else g["coarse"])[sel1]
                    items.append((m1, lv, gi, srcs, dsts))
            items.sort(key=lambda it: -it[0])
            buckets = []  # list of lists of items
            for it in items:
                if buckets and it[0] * 1.25 >= buckets[-1][0][0]:
                    buckets[-1].append(it)
                else:
                    buckets.append([it])
            st1_src, st1_dst, st1_segs = [], [], []
            flat_extra = {}
            off = 0
            for si, bucket in enumerate(buckets):
                G = len(bucket)
                m_max = bucket[0][0]
                src_pad = np.zeros((G, m_max), dtype=np.int32)
                dst_pad = np.zeros((G, m_max), dtype=np.int32)
                mask_pad2 = np.zeros((G, m_max, 1))
                T_stack = np.zeros((G, n_loc, n_loc))
                for bi, (m1, lv, gi, srcs, dsts) in enumerate(bucket):
                    src_pad[bi, :m1] = srcs
                    dst_pad[bi, :m1] = dsts
                    mask_pad2[bi, :m1] = 1.0
                    T = groups[lv][gi]["T"]
                    T_stack[bi] = T.T if direction == "fill" else T
                st1_src.append(src_pad.reshape(-1))
                st1_dst.append(dst_pad.reshape(-1))
                st1_segs.append((si, off, G, m_max))
                flat_extra[f"T{si}"] = np.asarray(T_stack, dtype=mf.dtype)
                flat_extra[f"mask{si}"] = np.asarray(mask_pad2, dtype=mf.dtype)
                off += G * m_max
            flat = dict(
                src_all=np.concatenate(st1_src).astype(np.int32)
                if st1_src else np.zeros(0, np.int32),
                dst_all=np.concatenate(st1_dst).astype(np.int32)
                if st1_dst else np.zeros(0, np.int32),
                **flat_extra,
            )
            # tail stages: per-pair stacked T (tiny by construction)
            tails = []
            for s in range(2, n_stages + 1):
                t_src, t_dst, t_T = [], [], []
                for lv in levels:
                    for gi, g in enumerate(groups[lv]):
                        sel = pair_stage[lv][gi] == s
                        if not sel.any():
                            continue
                        srcs = (g["coarse"] if direction == "fill"
                                else g["fine"])[sel]
                        dsts = (g["fine"] if direction == "fill"
                                else g["coarse"])[sel]
                        T = g["T"].T if direction == "fill" else g["T"]
                        for sr, dr in zip(srcs, dsts):
                            t_src.append(int(sr))
                            t_dst.append(int(dr))
                            t_T.append(T)
                tails.append(dict(
                    src=np.asarray(t_src, dtype=np.int32),
                    dst=np.asarray(t_dst, dtype=np.int32),
                    T=np.asarray(np.stack(t_T), dtype=mf.dtype),
                ))
            meta = dict(segs=st1_segs, n_tails=len(tails))
            return flat, tails, meta

        flat_arrays = {}
        self._flat_meta = {}
        if len(hn_sub) and self._chain_mode in ("flat", "compact"):
            all_lz_lin = np.concatenate(
                [level_zero[lv]["lin"] for lv in levels]
            ).astype(np.int32)
            all_lz_keep = np.concatenate(
                [level_zero[lv]["keep"] for lv in levels]
            )
            flat_arrays["lz_lin"] = all_lz_lin
            flat_arrays["lz_keep"] = np.asarray(all_lz_keep, dtype=mf.dtype)
            for direction in ("fill", "corr"):
                flat, tails, meta = _stage_chain(direction)
                for k, v in flat.items():
                    flat_arrays[f"{direction}_{k}"] = v
                for ti, t in enumerate(tails):
                    for k, v in t.items():
                        flat_arrays[f"{direction}_tail{ti}_{k}"] = v
                self._flat_meta[direction] = meta

        # ---- compact-space chain schedules (chain_mode="compact") -------
        # The flat schedule still runs its lz mask, scatter-add and delta
        # subtraction on the FULL [n_sub*C, n_loc] cols array — three
        # full-size passes per chain that dominated the measured HN
        # overhead at quadrant nref=7. Key structural
        # facts (asserted below): every fill destination, every corr source
        # and every tail row is an hn row, and the lz row set IS hn_sub. So
        # the whole chain lives in the compact [n_hn, n_loc] space:
        #   fill: base = cols_u[hn]*keep (lz masking on 26k rows, not a
        #         full-array set), stage-1 outs scatter-add into the
        #         compact buffer, tails read/write it locally;
        #   corr: stage-1 gathers from sub_raw DIRECTLY (no full-size
        #         final.at[hn].set first), hn-destined folds accumulate
        #         compactly, non-hn folds go straight into the sparse
        #         dcols delta (so `final - plain` is never materialized).
        # Padded grid slots are dropped by static real-position gathers
        # instead of mask multiplies.
        if len(hn_sub) and self._chain_mode == "compact":
            pos_in_hn = np.full(len(sub_ids) * C, -1, dtype=np.int64)
            pos_in_hn[hn_sub] = np.arange(len(hn_sub))
            # structural assumption of the compact schedule: the lz row set
            # IS hn_sub (keep_hn rows default to 0, so an lz row missing
            # from lz_lin — or a non-hn lz row — would silently diverge
            # from the flat schedule); fail loudly at build time instead
            assert np.array_equal(
                np.sort(flat_arrays["lz_lin"]), np.sort(hn_sub)
            ), "compact chains require lz rows == hn_sub (each once)"
            keep_hn = np.zeros((len(hn_sub), n_loc))
            keep_hn[pos_in_hn[flat_arrays["lz_lin"]]] = np.asarray(
                flat_arrays["lz_keep"], dtype=np.float64
            )
            flat_arrays["cp_keep_hn"] = np.asarray(keep_hn, dtype=mf.dtype)
            in_hn = np.zeros(len(sub_ids) * C, dtype=bool)
            in_hn[hn_sub] = True

            def _i32(x):
                return np.ascontiguousarray(np.asarray(x), dtype=np.int32)

            for direction in ("fill", "corr"):
                meta = self._flat_meta[direction]
                src = np.asarray(flat_arrays[f"{direction}_src_all"],
                                 dtype=np.int64)
                dst = np.asarray(flat_arrays[f"{direction}_dst_all"],
                                 dtype=np.int64)
                mask = (
                    np.concatenate([
                        np.asarray(
                            flat_arrays[f"{direction}_mask{si}"]
                        ).reshape(-1)
                        for si, off, G, m in meta["segs"]
                    ]) > 0
                    if len(src)
                    else np.zeros(0, dtype=bool)
                )
                real = np.nonzero(mask)[0]
                if direction == "fill":
                    assert in_hn[dst[real]].all()
                    fix = real[in_hn[src[real]]]
                    flat_arrays["cp_fill_fix_idx"] = _i32(fix)
                    flat_arrays["cp_fill_fix_local"] = _i32(
                        pos_in_hn[src[fix]]
                    )
                    flat_arrays["cp_fill_real_pos"] = _i32(real)
                    flat_arrays["cp_fill_dst_local"] = _i32(
                        pos_in_hn[dst[real]]
                    )
                    for ti in range(meta["n_tails"]):
                        ts = np.asarray(
                            flat_arrays[f"fill_tail{ti}_src"], dtype=np.int64)
                        td = np.asarray(
                            flat_arrays[f"fill_tail{ti}_dst"], dtype=np.int64)
                        assert in_hn[ts].all() and in_hn[td].all()
                        flat_arrays[f"cp_fill_tail{ti}_src_local"] = _i32(
                            pos_in_hn[ts])
                        flat_arrays[f"cp_fill_tail{ti}_dst_local"] = _i32(
                            pos_in_hn[td])
                else:
                    assert in_hn[src[real]].all()
                    flat_arrays["cp_corr_src_local"] = _i32(
                        np.maximum(pos_in_hn[src], 0))
                    hn_pos = real[in_hn[dst[real]]]
                    nh_pos = real[~in_hn[dst[real]]]
                    flat_arrays["cp_corr_hn_pos"] = _i32(hn_pos)
                    flat_arrays["cp_corr_hn_dst_local"] = _i32(
                        pos_in_hn[dst[hn_pos]])
                    flat_arrays["cp_corr_nh_pos"] = _i32(nh_pos)
                    flat_arrays["cp_corr_nh_dst"] = _i32(dst[nh_pos])
                    for ti in range(meta["n_tails"]):
                        ts = np.asarray(
                            flat_arrays[f"corr_tail{ti}_src"], dtype=np.int64)
                        td = np.asarray(
                            flat_arrays[f"corr_tail{ti}_dst"], dtype=np.int64)
                        assert in_hn[ts].all()
                        flat_arrays[f"cp_corr_tail{ti}_src_local"] = _i32(
                            pos_in_hn[ts])
                        thn = np.nonzero(in_hn[td])[0]
                        tnh = np.nonzero(~in_hn[td])[0]
                        flat_arrays[f"cp_corr_tail{ti}_hn_pos"] = _i32(thn)
                        flat_arrays[f"cp_corr_tail{ti}_hn_dst_local"] = _i32(
                            pos_in_hn[td[thn]])
                        flat_arrays[f"cp_corr_tail{ti}_nh_pos"] = _i32(tnh)
                        flat_arrays[f"cp_corr_tail{ti}_nh_dst"] = _i32(td[tnh])

        # mask-sorted contiguous HN groups -> one composite [n_loc, n_loc]
        # matmul per distinct mask (hn cells were sorted by mask in
        # BrickStructure; mask 0 = vertex contacts is the identity group)
        from .ops.hanging_nodes import hn_composite_matrix

        hn_bounds = []
        hn_Q = []
        if len(bs.hn_masks):
            uniq, starts = np.unique(bs.hn_masks, return_index=True)
            starts = list(starts) + [len(bs.hn_masks)]
            for i, mv in enumerate(uniq):
                s, e = int(starts[i]), int(starts[i + 1])
                if mv == 0:
                    hn_bounds.append((s, e, None))
                else:
                    hn_bounds.append((s, e, len(hn_Q)))
                    hn_Q.append(
                        np.asarray(
                            hn_composite_matrix(int(mv), si.P, dim),
                            dtype=mf.dtype,
                        )
                    )
        self._hn_bounds = hn_bounds

        # geometry: per-brick scalar h factor (level-uniform cells)
        h_cell = (mf.tria.right - mf.tria.left) * (
            0.5 ** bs.brick_level.astype(np.float64)
        )  # cell size (brick cells are level-uniform)
        geo_brick = h_cell ** (dim - 2)

        # static fill coverage: how many hn-cell writers cover each node of a
        # subset brick (value-independent -> precomputed, replacing a dense
        # one-hot matmul per vmult); computed below on the exchange
        # positions only (the full [n_sub, N3p] form is ~1 GB at nref=8)
        hn_brick = (hn_sub // C).astype(np.int64)
        hn_slot = (hn_sub % C).astype(np.int64)
        # Fill-on-the-exchange-vector operands. The fill touches only:
        #   writes — closure slots (constrained entity slots + vertex-contact
        #     corners; diff is provably zero elsewhere: folds/level-zeroing
        #     touch closure slots only and the composite Q is identity off
        #     the constrained entities),
        #   reads — closure slots (Q inputs, lz rows, fold src) plus the
        #     fold mirror slots on coarse cells.
        # Most of these are brick-surface nodes already carried by the DSS
        # surface vector; the rest (interfaces interior to straddling
        # bricks) extend it by nX extra positions. The fill then RIDES the
        # existing surface extract/scatter matmul pair instead of paying its
        # own volume-sized pair (which was the entire measured HN overhead).
        closure_nodes = slot_idx[hn_slot][bs.hn_closure]
        F_nodes = np.unique(closure_nodes)
        read_nodes = [F_nodes]
        for gl in groups.values():
            for g in gl:
                _, dst = np.nonzero(np.asarray(g["T"], dtype=np.float64))
                read_nodes.append(
                    np.unique(slot_idx[np.asarray(g["coarse"]) % C][:, dst])
                )
        fill_nodes = np.unique(np.concatenate(read_nodes))
        X_nodes = np.setdiff1d(fill_nodes, surf_idx)
        nX = len(X_nodes)
        self.n_surfX = self.n_surf + nX
        self._nX = nX
        # interior-extension one-hot (sub-brick-only traffic): the global
        # exchange pair stays at the plain path's n_surf width — only the
        # n_sub exceptional bricks pay for the nX interior fill nodes
        EsI = np.zeros((nX, N3p))
        EsI[np.arange(nX), X_nodes] = 1.0
        pos_of_node = np.full(N3p, -1, dtype=np.int64)
        pos_of_node[surf_idx] = np.arange(self.n_surf)
        pos_of_node[X_nodes] = self.n_surf + np.arange(nX)
        kpos = pos_of_node[slot_idx.reshape(-1)]  # [C*n_loc] -> pos | -1
        # extraction one-hot (exchange -> cols), restricted to fill reads
        kread = np.zeros(N3p, dtype=bool)
        kread[fill_nodes] = True
        ks = np.nonzero(kread[slot_idx.reshape(-1)])[0]
        EscX = np.zeros((self.n_surfX, C * n_loc))
        EscX[kpos[ks], ks] = 1.0
        # scatter one-hot (cols -> exchange), restricted to fill writes (F)
        kF = np.zeros(N3p, dtype=bool)
        kF[F_nodes] = True
        ksw = np.nonzero(kF[slot_idx.reshape(-1)])[0]
        EFX = np.zeros((C * n_loc, self.n_surfX))
        EFX[ksw, kpos[ksw]] = 1.0
        node_of_pos = np.concatenate([surf_idx, X_nodes]).astype(np.int64)
        # fill coverage directly on exchange positions (writes land only on
        # surfX nodes; anything else goes to a trash column and is dropped)
        den_X = np.zeros((len(sub_ids), self.n_surfX + 1))
        wp = pos_of_node[slot_idx[hn_slot]]  # [n_hn, n_loc]
        wp = np.where(wp < 0, self.n_surfX, wp)
        np.add.at(den_X, (hn_brick[:, None], wp), 1.0)
        den_X = den_X[:, : self.n_surfX]
        fill_invden_X = np.where(den_X > 0, 1.0 / np.maximum(den_X, 1.0), 0.0)

        # separable col2im factor: the overlap-add scatter cols -> brick
        # volume  out[c*p + j] += cols[c, j]  factors per axis into one tiny
        # [B*n, NB] 0/1 matrix (E = W (x) W (x) W up to the (c, j) digit
        # interleave), so the volume-sized one-hot E/EFX matmuls collapse to
        # three ~[*, B*n] x [B*n, NB] contractions (~100x fewer MACs at
        # p=4, B=4). Exact: same 0/1 weights, f32 accumulation.
        W_col2im = np.zeros((B * n, NB))
        for c in range(B):
            W_col2im[c * n + np.arange(n), c * p + np.arange(n)] = 1.0

        # volume-domain fill (fill_mode="volume"): per-hn-row inverse write
        # coverage on the row's own nodes, pre-masked by the closure slots
        # (the exchange path's EFX restriction + fill_invden_X division,
        # folded into one per-row static factor so the scatter-back is a
        # plain separable overlap-add).
        if self._fill_mode == "volume" and len(hn_sub):
            den_vol = np.zeros((len(sub_ids), N3), dtype=np.float64)
            np.add.at(
                den_vol,
                (hn_brick[:, None], slot_idx[hn_slot]),
                np.float64(1.0),
            )
            fill_invcov = (
                1.0 / den_vol[hn_brick[:, None], slot_idx[hn_slot]]
            ) * bs.hn_closure.astype(np.float64)
            del den_vol
        else:
            fill_invcov = np.zeros((len(hn_sub), n_loc), dtype=np.float64)

        # present/validity in subset cols numbering
        present_sub = bs.present.reshape(bs.n_bricks, C)[sub_ids].reshape(-1)
        # per-dof node validity/coverage for final masking
        node_valid = bs.node_valid.reshape(bs.n_bricks, N3)
        nv_pad = np.zeros((bs.n_bricks, N3p), dtype=bool)
        nv_pad[:, :N3] = node_valid

        self.arrays = dict(
            E=np.asarray(E, dtype=mf.dtype),
            Kb=np.asarray(Kb, dtype=mf.dtype),
            **(
                # the dense assembled brick operator is only read by
                # main_path="dense" — [N3p, N3p] is ~100 MB at NB=17, so
                # keep it off the device for the separable default
                {"A": np.asarray(A_full, dtype=mf.dtype)}
                if main_path == "dense"
                else {}
            ),
            Mb=np.asarray(Mb, dtype=mf.dtype),
            Fxy=np.asarray(Fxy, dtype=mf.dtype),
            Mxy=np.asarray(Mxy, dtype=mf.dtype),
            Es=np.asarray(Es, dtype=mf.dtype),
            K=np.asarray(K, dtype=mf.dtype),
            geo=np.asarray(geo_brick, dtype=mf.dtype),
            sub_ids=np.asarray(sub_ids.astype(np.int32)),
            absent_sub=np.asarray(absent_sub),
            hn_sub=np.asarray(hn_sub),
            hn_masks=np.asarray(bs.hn_masks),
            closure=np.asarray(bs.hn_closure.astype(np.float64), dtype=mf.dtype),
            P=np.asarray(si.P, dtype=mf.dtype),
            transfers=groups,
            transfers_b=transfers_b,
            level_zero=level_zero,
            node_valid=np.asarray(nv_pad),
            face_pool_id=np.asarray(bs.face_pool_id.astype(np.int32)),
            edge_pool_id=np.asarray(bs.edge_pool_id.astype(np.int32)),
            corner_pool_id=np.asarray(bs.corner_pool_id.astype(np.int32)),
            face_other=np.asarray(bs.face_other),
            edge_contrib=np.asarray(bs.edge_contrib),
            corner_contrib=np.asarray(bs.corner_contrib),
            geo_sub=np.asarray(geo_brick[sub_ids], dtype=mf.dtype),
            geo_cell_sub=np.asarray(
                np.repeat(geo_brick[sub_ids], C), dtype=mf.dtype
            ),
            present_sub=np.asarray(present_sub.astype(np.float64), dtype=mf.dtype),
            hn_Q=hn_Q,
            EsI=np.asarray(EsI, dtype=mf.dtype),
            EscX=np.asarray(EscX, dtype=mf.dtype),
            EFX=np.asarray(EFX, dtype=mf.dtype),
            fill_invden_X=np.asarray(fill_invden_X, dtype=mf.dtype),
            W_col2im=np.asarray(W_col2im, dtype=mf.dtype),
            fill_invcov=np.asarray(fill_invcov, dtype=mf.dtype),
            **{f"flat_{k}": v for k, v in flat_arrays.items()},
        )
        # subset write-back strategy: the one-hot scatter [nb, n_sub] matmul
        # beat the row scatter-add at moderate sizes where it was profiled
        # (not yet re-measured on the GPU), but its cost grows as
        # nb * n_sub * N3p — quadratic in mesh size — so large
        # meshes switch back to .at[sub_ids].add (linear in n_sub)
        env_ssub = os.environ.get("BRICK_SSUB")
        if self._sub_contig:
            self._use_ssub = False  # static leading-slice add instead
        elif self._use_ssub_arg is not None:
            self._use_ssub = bool(self._use_ssub_arg)
        elif env_ssub is not None:
            self._use_ssub = bool(int(env_ssub))
        else:
            self._use_ssub = bs.n_bricks * max(self._n_sub, 1) * N3p <= 2e11
        if self._use_ssub and len(sub_ids):
            self.arrays["Ssub"] = np.asarray(
                (np.arange(bs.n_bricks)[:, None] == sub_ids[None, :])
                .astype(np.float64),
                dtype=mf.dtype,
            )

        # block-diagonal 1D quadrature operators on the brick axis
        # (Sqb [Q, NB] collocation values, Dqb [Q, Q] collocation
        # derivatives, Q = B*n_q1) — shared by the deformed main path and
        # the Cartesian masked-quadrature subset apply (_masked_quad_apply)
        nq1 = mf._np["S"].shape[0]
        Qn = B * nq1
        S1 = mf._np["S"]
        Dc1 = mf._np["Dc"]
        Sqb = np.zeros((Qn, NB))
        Dqb = np.zeros((Qn, Qn))
        for c in range(B):
            Sqb[c * nq1: (c + 1) * nq1, c * p: c * p + n] = S1
            Dqb[c * nq1: (c + 1) * nq1, c * nq1: (c + 1) * nq1] = Dc1
        self.arrays.update(
            Sqb=np.asarray(Sqb, dtype=mf.dtype),
            Dqb=np.asarray(Dqb, dtype=mf.dtype),
            w1=np.asarray(si.quad_w, dtype=mf.dtype),
        )
        # face-plane pair arrays (groups are level-ascending by build;
        # static meta — axis/side/offsets — stays python-side). All group
        # indices are remapped into a compact WORKING SET of plane-touched
        # bricks: the group loop's row scatters then copy a [n_W, N3]
        # buffer instead of the full brick tensor per group (one global
        # gather at entry, one scatter at exit).
        self._plane_meta = []
        if self._face_planes and bs.plane_groups:
            self._plane_meta = [
                dict(level=g["level"], d=g["d"], s=g["s"], c_pl=g["c_pl"],
                     offs=g["offs"], n=len(g["fine"]))
                for g in bs.plane_groups
            ]
            W = np.unique(np.concatenate(
                [g["fine"] for g in bs.plane_groups]
                + [g["coarse"] for g in bs.plane_groups]
            ))
            w_of = np.full(bs.n_bricks, -1, dtype=np.int64)
            w_of[W] = np.arange(len(W))
            self.arrays["plane_W"] = W.astype(np.int32)
            self.arrays["plane_P1"] = np.asarray(bs.plane_P1, dtype=mf.dtype)
            self._plane_levels = sorted({m["level"] for m in self._plane_meta})
            for i, g in enumerate(bs.plane_groups):
                self.arrays[f"plane{i}_fine"] = w_of[g["fine"]].astype(
                    np.int32
                )
                self.arrays[f"plane{i}_coarse"] = w_of[g["coarse"]].astype(
                    np.int32
                )
                self.arrays[f"plane{i}_cover"] = np.asarray(
                    g["cover"], dtype=mf.dtype
                )
        if not mf.high_order_mapping and self._n_sub:
            # per-cell selectors for the assembled (quadrature-domain)
            # subset removals, geo-premultiplied: absent (hole) cells, and
            # absent+constrained cells (input-fill mode removes the
            # constrained cells' unconstrained contributions in assembled
            # form instead of gathering/subtracting per-cell `plain` rows)
            geo_col = geo_brick[sub_ids][:, None]
            pres2 = np.asarray(present_sub, dtype=bool).reshape(
                self._n_sub, C
            )
            hn_flag = np.zeros(self._n_sub * C, dtype=bool)
            hn_flag[hn_sub] = True
            hn2 = hn_flag.reshape(self._n_sub, C)
            self.arrays.update(
                qmask_absent=np.asarray(
                    (~pres2) * geo_col, dtype=mf.dtype
                ),
                qmask_rem=np.asarray(
                    (~pres2 | hn2) * geo_col, dtype=mf.dtype
                ),
            )

        # deformed (MappingQCache analog) main path: the shared-A Kronecker
        # trick needs equal Cartesian cells, so the deformed operator
        # integrates with per-quad-point packed metrics instead
        # (benchmark_01.h:227-242 parity on the brick engine). The MAIN pass
        # runs in the brick-tensor domain with block-diagonal 1D quadrature
        # operators (Sqb collocation values [Q, NB], Dqb collocation
        # derivatives [Q, Q]; Q = B * n_q1) — whole-brick sweeps like
        # _main_apply, no im2col/col2im, NB-length contractions — and
        # the metric lives in the matching brick-quad lattice (Gqb). The
        # per-cell cols kernel (_deformed_cell_apply) survives for the
        # exceptional-subset corrections, fed by per-cell metric rows
        # restricted to the subset cells (Gq_sub) and the hn cells (Gq_hn).
        self._deformed = bool(mf.high_order_mapping)
        if self._deformed:
            geo_full = mf._np["geo"]  # [n_cells, n_q, n_pairs]
            n_q, n_pairs = geo_full.shape[1], geo_full.shape[2]
            Gfull = np.zeros(
                (bs.n_bricks * C, n_q, n_pairs), dtype=mf.dtype
            )
            Gfull[bs.cell_lin] = geo_full  # absent slots keep 0 => no output
            # brick-quad lattice layout: axis index along dim d is
            # c_d * n_q1 + q_d (cells x-fastest, quad x-fastest within)
            Q = Qn
            nb = bs.n_bricks
            if dim == 3:
                Gqb = np.ascontiguousarray(
                    Gfull.reshape(nb, B, B, B, nq1, nq1, nq1, n_pairs)
                    .transpose(0, 7, 1, 4, 2, 5, 3, 6)
                    .reshape(nb, n_pairs, Q, Q, Q)
                )
            else:
                Gqb = np.ascontiguousarray(
                    Gfull.reshape(nb, B, B, nq1, nq1, n_pairs)
                    .transpose(0, 5, 1, 3, 2, 4)
                    .reshape(nb, n_pairs, Q, Q)
                )
            sub_cell_rows = (
                sub_ids[:, None] * C + np.arange(C)[None, :]
            ).reshape(-1)
            # per-cell metric source kept on host for the distributed engine
            self._np_geo_cell = Gfull
            self.arrays.update(
                Gqb=Gqb,
                Gq_sub=Gfull[sub_cell_rows],
                Gq_hn=Gfull[bs.hn_lin],
                S=mf._np["S"].astype(mf.dtype),
                Dc=mf._np["Dc"].astype(mf.dtype),
            )
        self._np_arrays = self.arrays
        self.arrays = None  # staged lazily on first vmult
        self._jit_vmult = jax.jit(self._vmult_impl)


    def _stage(self):
        if self.arrays is None:
            self.arrays = jax.tree.map(jnp.asarray, self._np_arrays)
        return self.arrays

    # ------------------------------------------------------------ conversions
    def from_dof_vector(self, u, to_device: bool = True):
        """to_device=False returns the host array, so callers can finish
        all host setup before the first device use.
        Brick-chunked so only the [nb, N3p] result is materialized."""
        bs = self.bs
        u_dist = self.mf.constraints.distribute(np.asarray(u))
        out = np.zeros((bs.n_bricks, self.N3p), dtype=self.mf.dtype)
        bstep = max(1, 50_000_000 // self.N3)
        for s in range(0, bs.n_bricks, bstep):
            e = min(s + bstep, bs.n_bricks)
            nd = bs.node_dof[s * self.N3 : e * self.N3]
            # one clamped gather + sparse hole fixup instead of the double
            # boolean-mask path (2x on the 166M-node nref=8 conversion)
            vals = u_dist[np.maximum(nd, 0)].astype(self.mf.dtype, copy=False)
            vals[nd < 0] = 0.0
            out[s:e, : self.N3] = vals.reshape(e - s, self.N3)
        return jnp.asarray(out) if to_device else out

    def to_dof_vector(self, bv, zero_hanging=False):
        bs = self.bs
        if self._fill_mode == "input" and not zero_hanging:
            # input-fill vmult outputs are REDUCED (hanging slots carry no
            # meaning, like the reference's post-distribute vectors);
            # restore the invariant so the dof vector's hanging entries
            # hold their master-interpolated values
            bv = self.refill(bv)
        arr = np.asarray(bv)[:, : self.N3].reshape(-1)
        u = arr[bs.owner_node_of_dof]
        if zero_hanging:
            u = u.copy()
            u[self.mf.constraints.constrained_dof_marker()] = 0.0
        return u

    def _subset_scatter_add(self, v, dsub, a):
        """v[sub_ids] += dsub. With the subset-first brick order (default)
        this is a STATIC leading-slice add; otherwise a one-hot matmul
        (fastest at moderate sizes) or a row scatter-add (linear cost,
        large meshes)."""
        if self._sub_contig:
            return v.at[: self._n_sub].add(dsub)
        if self._use_ssub:
            return v + jnp.dot(a["Ssub"], dsub, precision=_EXACT,
                               preferred_element_type=v.dtype)
        return v.at[a["sub_ids"]].add(dsub)

    def _take_sub(self, x, a):
        """x[sub_ids]: a static leading slice under the subset-first brick
        order, a row gather otherwise."""
        if self._sub_contig:
            return x[: self._n_sub]
        return jnp.take(x, a["sub_ids"], axis=0)

    # ------------------------------------------------------------------ dss
    def _dss_surface(self, surf, a):
        """Pool face/[edge]/corner interface classes on [nb, n_surf] arrays.

        dss_mode='pool': scatter-add into per-pool rows, gather back.
        dss_mode='pair': gather-only — every interface copy reads its
        contributors directly from the per-slot tables (faces have exactly
        one partner; edge/corner copies sum the full contributor list in
        pool-canonical order so duplicates stay bit-identical). Removes the
        XLA scatter from the vmult hot path."""
        if self._dss_mode == "pair":
            return self._dss_surface_pair(surf, a)
        bs = self.bs
        nb = bs.n_bricks
        dim = bs.dim
        nf = 2 * dim
        fsize = (bs.NB - 2) ** (dim - 1)
        fblock = surf[:, : nf * fsize].reshape(nb, nf, fsize)
        pool = jnp.zeros((bs.n_face_pools, fsize), surf.dtype)
        pool = pool.at[a["face_pool_id"].reshape(-1)].add(
            fblock.reshape(-1, fsize)
        )
        fnew = pool[a["face_pool_id"].reshape(-1)].reshape(nb, nf * fsize)
        off = nf * fsize
        parts = [fnew]
        if dim == 3:
            esize = bs.NB - 2
            eblock = surf[:, off : off + 12 * esize].reshape(nb, 12, esize)
            epool = jnp.zeros((bs.n_edge_pools, esize), surf.dtype)
            epool = epool.at[a["edge_pool_id"].reshape(-1)].add(
                eblock.reshape(-1, esize)
            )
            parts.append(
                epool[a["edge_pool_id"].reshape(-1)].reshape(nb, 12 * esize)
            )
            off += 12 * esize
        ncorner = 2**dim
        cblock = surf[:, off : off + ncorner]
        cpool = jnp.zeros((bs.n_corner_pools,), surf.dtype)
        cpool = cpool.at[a["corner_pool_id"].reshape(-1)].add(cblock.reshape(-1))
        parts.append(cpool[a["corner_pool_id"].reshape(-1)].reshape(nb, ncorner))
        return jnp.concatenate(parts, axis=1)

    def _dss_surface_pair(self, surf, a):
        bs = self.bs
        nb = bs.n_bricks
        dim = bs.dim
        nf = 2 * dim
        fsize = (bs.NB - 2) ** (dim - 1)
        fflat = surf[:, : nf * fsize].reshape(nb * nf, fsize)
        if a["face_other"].shape[1]:
            fpad = jnp.concatenate(
                [fflat, jnp.zeros((1, fsize), fflat.dtype)], axis=0
            )
            fnew = fflat + jnp.take(fpad, a["face_other"][:, 0], axis=0)
        else:
            fnew = fflat
        off = nf * fsize
        parts = [fnew.reshape(nb, nf * fsize)]
        if dim == 3:
            esize = bs.NB - 2
            eflat = surf[:, off : off + 12 * esize].reshape(nb * 12, esize)
            epad = jnp.concatenate(
                [eflat, jnp.zeros((1, esize), eflat.dtype)], axis=0
            )
            mc = a["edge_contrib"].shape[1]
            enew = (
                jnp.take(epad, a["edge_contrib"].reshape(-1), axis=0)
                .reshape(nb * 12, mc, esize)
                .sum(axis=1)
            )
            parts.append(enew.reshape(nb, 12 * esize))
            off += 12 * esize
        ncorner = 2**dim
        cflat = surf[:, off : off + ncorner].reshape(-1)
        cpad = jnp.concatenate([cflat, jnp.zeros((1,), cflat.dtype)])
        cnew = jnp.take(cpad, a["corner_contrib"].reshape(-1)).reshape(
            nb * ncorner, -1
        ).sum(axis=1)
        parts.append(cnew.reshape(nb, ncorner))
        return jnp.concatenate(parts, axis=1)

    # ------------------------------------------------- cols <-> brick domain
    def _extract_cols(self, u_sub, a):
        """[n_rows, N3p] brick vectors -> [n_rows*C, n_loc] cell-local cols.

        Expressed as stride-p patch extraction (XLA conv machinery) — exact
        and measurably faster than the one-hot E matmul; the patch feature
        order matches the E layout (x fastest) bit-for-bit."""
        bs = self.bs
        NB, p, dim = bs.NB, bs.p, bs.dim
        n = p + 1
        m = u_sub.shape[0]
        u4 = u_sub[:, : self.N3].reshape((m, 1) + (NB,) * dim)
        pat = jax.lax.conv_general_dilated_patches(
            u4, filter_shape=(n,) * dim, window_strides=(p,) * dim,
            padding="VALID",
        )  # [m, n_loc, B..B]
        C = bs.B**dim
        return jnp.moveaxis(pat.reshape(m, n**dim, C), 1, 2).reshape(-1, n**dim)

    def _scatter_cols(self, cols, a):
        """Adjoint of _extract_cols: [n_rows*C, n_loc] -> [n_rows, N3p]
        overlap-add. col2im="sep" (default) uses the exact Kronecker
        factorization of E (three tiny [B*n, NB] contractions, ~100x fewer
        MACs than the dense one-hot at p=4); col2im="onehot" keeps the
        single E matmul for A/B."""
        if self._col2im == "sep":
            m = cols.shape[0] // (self.bs.B ** self.bs.dim)
            return self._col2im_sep(cols, m, a)
        m = cols.shape[0] // (self.bs.B ** self.bs.dim)
        return jnp.dot(cols.reshape(m, -1), a["E"],
                       precision=_EXACT, preferred_element_type=cols.dtype)

    def _col2im_sep(self, cols, m, a):
        """[m*C, n_loc] cols -> [m, N3p] overlap-add via the separable form.

        Row r = (brick, cell sl, node j) with sl and j both x-fastest
        lattices (local_lattice), so cols reshapes to the digit tensor
        [m, cz, cy, cx, jz, jy, jx]; interleaving each (c_d, j_d) pair and
        contracting with W[c*n+j, c*p+j] = 1 per axis reproduces
        cols @ E exactly (same 0/1 weights, f32 accumulation)."""
        bs = self.bs
        B, n, NB, dim = bs.B, self.n, bs.NB, bs.dim
        W = a["W_col2im"]
        if dim == 3:
            t = jnp.transpose(
                cols.reshape(m, B, B, B, n, n, n), (0, 1, 4, 2, 5, 3, 6)
            ).reshape(m, B * n, B * n, B * n)
            t = jnp.einsum("bzyx,zZ->bZyx", t, W,
                           precision=_EXACT, preferred_element_type=cols.dtype)
            t = jnp.einsum("bZyx,yY->bZYx", t, W,
                           precision=_EXACT, preferred_element_type=cols.dtype)
            t = jnp.einsum("bZYx,xX->bZYX", t, W,
                           precision=_EXACT, preferred_element_type=cols.dtype)
        else:
            t = jnp.transpose(
                cols.reshape(m, B, B, n, n), (0, 1, 3, 2, 4)
            ).reshape(m, B * n, B * n)
            t = jnp.einsum("byx,yY->bYx", t, W,
                           precision=_EXACT, preferred_element_type=cols.dtype)
            t = jnp.einsum("bYx,xX->bYX", t, W,
                           precision=_EXACT, preferred_element_type=cols.dtype)
        out = t.reshape(m, NB**dim)
        if self.N3p > NB**dim:
            out = jnp.pad(out, ((0, 0), (0, self.N3p - NB**dim)))
        return out

    # ------------------------------------------------------- hn application
    def _hn_apply(self, rows, a, transpose: bool):
        """HN interpolation on mask-sorted rows [n_hn, n_loc]: one composite
        matmul per contiguous distinct-mask range (identity ranges pass
        through). Exact adjoint pair via Q / Q^T."""
        parts = []
        for s, e, qi in self._hn_bounds:
            if qi is None:
                parts.append(rows[s:e])
            else:
                Q = a["hn_Q"][qi]
                parts.append(
                    jnp.dot(rows[s:e], Q.T if transpose else Q,
                            preferred_element_type=rows.dtype)
                )
        return jnp.concatenate(parts, axis=0)

    # ----------------------------------------------------------- fold level
    def _fold_chain_flat(self, rows, a, direction: str):
        """Dependency-staged fold chain (chain_mode="flat"): stage 1 is ONE
        hoisted gather over every independent transfer pair of every level,
        per-level einsums on compact slices, and ONE scatter-add; later
        stages (the rare true multi-level constraint chains — 7 of 41157
        pairs at quadrant nref=7) are tiny per-pair batches. Exactly equal
        to the sequential per-level loop (fold adds commute; staging orders
        the genuine read-after-write pairs)."""
        meta = self._flat_meta[direction]
        pre = f"flat_{direction}_"
        if a[pre + "src_all"].shape[0]:
            sel_all = jnp.take(rows, a[pre + "src_all"], axis=0)
            outs = []
            for si, off, G, m in meta["segs"]:
                sel = sel_all[off:off + G * m].reshape(
                    (G, m) + sel_all.shape[1:]
                )
                # per-bucket T stacks are pre-transposed for fill at build
                out = jnp.einsum(
                    "gm...i,gij->gm...j", sel, a[pre + f"T{si}"],
                    precision=_EXACT, preferred_element_type=rows.dtype,
                ) * self._gmask(a[pre + f"mask{si}"], rows)
                outs.append(out.reshape((G * m,) + out.shape[2:]))
            rows = rows.at[a[pre + "dst_all"]].add(
                jnp.concatenate(outs, axis=0)
            )
        for ti in range(meta["n_tails"]):
            sel = jnp.take(rows, a[pre + f"tail{ti}_src"], axis=0)
            out = jnp.einsum(
                "k...i,kij->k...j", sel, a[pre + f"tail{ti}_T"],
                precision=_EXACT, preferred_element_type=rows.dtype,
            )
            rows = rows.at[a[pre + f"tail{ti}_dst"]].add(out)
        return rows

    def _fold_level(self, rows, tb, fill: bool):
        """One batched level of coarse-fine transfers on cols rows.

        fill=False (fold, correction direction): rows[coarse] += T^T-free
        form — gather fine rows, apply T, scatter-add into coarse rows.
        fill=True: gather coarse rows, apply T^T, scatter-add into fine.
        One gather + one batched einsum + one scatter-add per level instead
        of per-group chains."""
        src = tb["coarse"] if fill else tb["fine"]
        dst = tb["fine"] if fill else tb["coarse"]
        G, m = src.shape
        sel = jnp.take(rows, src.reshape(-1), axis=0).reshape(
            (G, m) + rows.shape[1:]
        )
        T = tb["T"]
        out = jnp.einsum(
            "gm...i,gij->gm...j", sel,
            jnp.swapaxes(T, 1, 2) if fill else T,
            precision=_EXACT, preferred_element_type=rows.dtype,
        ) * self._gmask(tb["mask"], rows)
        return rows.at[dst.reshape(-1)].add(
            out.reshape((G * m,) + out.shape[2:])
        )

    # ------------------------------------------------------------ main path
    def _main_apply(self, bv, a):
        """v = bv @ A_brick^T, either via the dense assembled matrix or the
        exact Kronecker-separable factorization (default; same operator up
        to fp rounding, ~30x fewer FLOPs)."""
        if self.main_path == "dense":
            return jnp.dot(bv, a["A"].T, preferred_element_type=bv.dtype)
        bs = self.bs
        NB, N3, N3p = bs.NB, self.N3, self.N3p
        nb = bv.shape[0]
        dt = bv.dtype
        u = bv[:, :N3]
        if bs.dim == 3:
            u3 = u.reshape(nb, NB, NB * NB)
            t = jnp.dot(u3, a["Fxy"].T, preferred_element_type=dt)
            t = jnp.einsum("wz,bzr->bwr", a["Mb"], t, preferred_element_type=dt)
            s = jnp.einsum("wz,bzr->bwr", a["Kb"], u3, preferred_element_type=dt)
            v = (t + jnp.dot(s, a["Mxy"].T, preferred_element_type=dt)).reshape(
                nb, N3
            )
        else:
            u2 = u.reshape(nb, NB, NB)
            t = jnp.dot(u2, a["Kb"].T, preferred_element_type=dt)
            t = jnp.einsum("wy,byx->bwx", a["Mb"], t, preferred_element_type=dt)
            s = jnp.einsum("wy,byx->bwx", a["Kb"], u2, preferred_element_type=dt)
            v = (t + jnp.dot(s, a["Mb"].T, preferred_element_type=dt)).reshape(
                nb, N3
            )
        return jnp.pad(v, ((0, 0), (0, N3p - N3)))

    # ---------------------------------------------------------------- vmult
    def _vmult_impl(self, bv, a):
        bs = self.bs
        dim = bs.dim
        C = bs.B**dim
        # 0) face-plane input resolution (assembled schedule): plane-covered
        #    constraints fill before the main pass, so their cells compute
        #    correct integrals with no per-cell correction at all
        assembled = self._use_masked_removal
        if assembled and self._plane_meta:
            bv = self._plane_fill(bv, a)
        # 1) main path: assembled brick operator (Kronecker-separable form),
        #    or whole-brick quadrature sweeps under a high-order mapping
        if self._deformed:
            v = self._deformed_brick_apply(bv, a)
        else:
            v = self._main_apply(bv, a)
            v = v * a["geo"][:, None]

        if assembled and not self._n_sub:
            # plane-only constraints (no exceptional bricks): fold the
            # hanging outputs and hand a corr-free vector to the DSS
            return self._dss_fill(self._plane_corr(v, a), a, None)

        # 2) corrections on the exceptional-brick subset: absent (hole) cells
        #    contribute nothing; constrained cells contribute HN^T values with
        #    their closure slots folded (chained) into coarse neighbors.
        if self._n_sub and assembled:
            # assembled removal (Cartesian input-fill, the default): the
            # unconstrained contributions of absent AND constrained cells
            # are subtracted by ONE masked quadrature apply on the subset
            # bricks, so the full-size cols `plain` array, its per-cell
            # scale, and every absent/hn row gather/subtract disappear.
            # The chain works on a SPARSE cols buffer holding only the
            # HN^T rows and their fold deltas.
            u_sub = self._take_sub(bv, a)
            n_hn = int(a["hn_sub"].shape[0])
            if n_hn:
                # every chain index lives in the chain-brick prefix
                # (BrickStructure tier 0, asserted at build): extract,
                # fill, folds and col2im all run on n_chainb bricks only
                n_cb = self._n_chainb
                cols_u = self._extract_cols(u_sub[:n_cb], a)
                # input-side fill (the read_dof_values analog,
                # benchmark_03.h:296-317): interpolate the constrained
                # cells' hanging slots from their masters in the cols
                # domain; vmult accepts reduced inputs, outputs stay
                # reduced.
                u_hat = self._fill_rows(cols_u, a)
                own = jnp.dot(
                    u_hat, a["K"].T, preferred_element_type=bv.dtype
                ) * jnp.take(a["geo_cell_sub"], a["hn_sub"])[:, None]
                sub_raw = self._hn_apply(own, a, transpose=True)
                if self._chain_mode == "compact" and self._flat_meta:
                    dcols = self._corr_compact(None, None, sub_raw, a)
                else:
                    dcols = jnp.zeros(
                        (n_cb * C,) + sub_raw.shape[1:], bv.dtype
                    ).at[a["hn_sub"]].set(sub_raw)
                    if self._flat_meta:
                        dcols = self._fold_chain_flat(dcols, a, "corr")
                        lin = a["flat_lz_lin"]
                        dcols = dcols.at[lin].set(
                            jnp.take(dcols, lin, axis=0) * a["flat_lz_keep"]
                        )
                    else:
                        for lv in sorted(self._levels, reverse=True):
                            lz = a["level_zero"][lv]
                            zeroed = (
                                jnp.take(dcols, lz["lin"], axis=0)
                                * lz["keep"]
                            )
                            dcols = self._fold_level(
                                dcols, a["transfers_b"][lv], fill=False
                            )
                            dcols = dcols.at[lz["lin"]].set(zeroed)
                corr = -self._masked_quad_apply(u_sub, a, a["qmask_rem"])
                corr = corr.at[:n_cb].add(self._scatter_cols(dcols, a))
            elif a["absent_sub"].shape[0]:
                corr = -self._masked_quad_apply(u_sub, a, a["qmask_absent"])
            else:
                corr = None
            if self._plane_meta:
                # residual corr merges first (its deltas vacate the
                # hanging slots it owns), then the plane fold runs pre-DSS
                if corr is not None:
                    v = self._subset_scatter_add(v, corr, a)
                    corr = None
                v = self._plane_corr(v, a)
            return self._dss_fill(v, a, corr)

        if self._n_sub:
            u_sub = self._take_sub(bv, a)
            cols_u = self._extract_cols(u_sub, a)  # [n_sub*C, n_loc]
            if self._deformed:
                # per-cell metric kernel (absent rows output exact zeros,
                # so the absent handling below is a numerical no-op)
                plain = self._deformed_cell_apply(cols_u, a, a["Gq_sub"])
            else:
                plain = jnp.dot(
                    cols_u, a["K"].T, preferred_element_type=bv.dtype
                )
                # per-cell scale BEFORE folds (levels differ)
                plain = plain * a["geo_cell_sub"][:, None]
            n_hn = int(a["hn_sub"].shape[0])
            if self._chain_mode == "compact" and self._flat_meta and n_hn:
                # compact-space correction: no full-size final/lz/delta
                # passes (see _corr_compact)
                plain_hn = jnp.take(plain, a["hn_sub"], axis=0)
                if self._fill_mode == "input":
                    # in-register input-side fill (the read_dof_values
                    # analog, benchmark_03.h:296-317): interpolate the
                    # constrained cells' hanging slots from their masters
                    # IN THE COLS DOMAIN, so vmult accepts unfilled inputs
                    # and the output fill pass disappears entirely.
                    u_hat = self._fill_rows(cols_u, a)
                    if self._deformed:
                        own = self._deformed_cell_apply(u_hat, a, a["Gq_hn"])
                    else:
                        own = jnp.dot(
                            u_hat, a["K"].T, preferred_element_type=bv.dtype
                        ) * jnp.take(a["geo_cell_sub"], a["hn_sub"])[:, None]
                else:
                    own = plain_hn
                sub_raw = self._hn_apply(own, a, transpose=True)
                dcols = self._corr_compact(plain, plain_hn, sub_raw, a)
                corr = self._scatter_cols(dcols, a)  # [n_sub, N3p]
            elif self._chain_mode == "compact" and not n_hn:
                # hole-only subset: same sparse delta as the plain path
                dcols = jnp.zeros_like(plain)
                if a["absent_sub"].shape[0]:
                    dcols = dcols.at[a["absent_sub"]].set(
                        -jnp.take(plain, a["absent_sub"], axis=0)
                    )
                corr = self._scatter_cols(dcols, a)
            else:
                final = plain
                if a["absent_sub"].shape[0]:
                    final = final.at[a["absent_sub"]].set(0.0)
                if n_hn:
                    if self._fill_mode == "input":
                        # input-side fill, full-size schedule (see above)
                        u_hat = self._fill_rows(cols_u, a)
                        if self._deformed:
                            own = self._deformed_cell_apply(
                                u_hat, a, a["Gq_hn"]
                            )
                        else:
                            own = jnp.dot(
                                u_hat, a["K"].T,
                                preferred_element_type=bv.dtype,
                            ) * jnp.take(
                                a["geo_cell_sub"], a["hn_sub"]
                            )[:, None]
                    else:
                        own = jnp.take(final, a["hn_sub"], axis=0)
                    sub_raw = self._hn_apply(own, a, transpose=True)
                    final = final.at[a["hn_sub"]].set(sub_raw)
                    if self._flat_meta:
                        # staged batch folds; the per-level snapshot/restore
                        # collapses to one final masking (no transfer writes
                        # an lz row after its own level in the staged order)
                        final = self._fold_chain_flat(final, a, "corr")
                        lin = a["flat_lz_lin"]
                        final = final.at[lin].set(
                            jnp.take(final, lin, axis=0) * a["flat_lz_keep"]
                        )
                    else:
                        for lv in sorted(self._levels, reverse=True):
                            lz = a["level_zero"][lv]
                            zeroed = (
                                jnp.take(final, lz["lin"], axis=0) * lz["keep"]
                            )
                            final = self._fold_level(
                                final, a["transfers_b"][lv], fill=False
                            )
                            final = final.at[lz["lin"]].set(zeroed)
                delta = final - plain
                corr = self._scatter_cols(delta, a)  # [n_sub, N3p]
        else:
            corr = None

        return self._dss_fill(v, a, corr)

    def _dss_fill(self, v, a, corr=None):
        """Steps 3-4, shared by the Cartesian and deformed paths:
        cross-brick DSS and the fill pass, both riding ONE extract/scatter
        pair on the extended exchange vector [nb, n_surfX] (surface nodes +
        the few interior fill nodes of straddling bricks). The fill reads
        the post-DSS exchange values, runs the fold/HN chain on small
        [*, n_loc] rows, and lands its updates in the same exchange delta
        that the DSS scatters back — its marginal cost is the chain plus
        subset-sized matmuls, not the volume-sized pair it used to pay
        (which was the entire measured HN overhead of the constrained
        vmult).

        corr (optional, [n_sub, N3p]) is the exceptional-subset correction
        delta of the constrained vmult. Instead of scattering it into v
        BEFORE the exchange (a second full-width subset pass — nb*n_sub*N3p
        one-hot MACs at moderate sizes), its surface trace joins the
        exchange vector, its rows join the fill's subset reads, and the
        volume rows merge into the ONE final subset scatter together with
        the fill's interior extension."""
        if corr is not None and self._sub_contig:
            # contiguous subset order: merging the correction into v is one
            # static slice add, making the downstream write path identical
            # in shape to the plain path (no separate corr surf trace or
            # final subset add)
            v = self._subset_scatter_add(v, corr, a)
            corr = None
        if self._fill_mode == "volume":
            return self._dss_fill_volume(v, a, corr)
        ns = self.n_surf  # static int
        surf = jnp.dot(v, a["Es"].T, precision=_EXACT,
                       preferred_element_type=v.dtype)
        if corr is not None:
            corr_surf = jnp.dot(corr, a["Es"].T, precision=_EXACT,
                                preferred_element_type=v.dtype)
            surf = self._subset_scatter_add(surf, corr_surf, a)
        surf_new = self._dss_surface(surf, a)
        delta = surf_new - surf  # [nb, ns] — same width as the plain path
        sub_upd = corr  # rows to land in the single final subset scatter

        # fill pass (restore the distributed invariant), exchange domain.
        # The interior extension (X nodes of straddling bricks) is read and
        # written on the n_sub exceptional bricks ONLY — the global
        # exchange pair stays at the plain path's width. (No node_valid
        # masking needed first: hole-node values are ~0 after the absent
        # correction, and the fill reads entity rows of present cells only.)
        # fill_mode="input" resolved the constraints on the READ side, so
        # the output stays reduced (hanging slots carry no meaning, exactly
        # like the reference's post-distribute_local_to_global vectors) and
        # this block is skipped.
        if self._fill_mode != "input" and self._n_sub and a["hn_sub"].shape[0]:
            v_sub = self._take_sub(v, a)
            if corr is not None:
                v_sub = v_sub + corr
            if self._fill_mode == "hybrid":
                # volume-domain read side: land the post-DSS surface delta in
                # the subset volumes and pull cell rows with the cheap
                # conv-patch extraction — the EscX [ns+nX, C*n_loc] and
                # EsI-read operands drop out of the hot path entirely. Rows
                # the chain never reads carry true values instead of EscX's
                # zeros, which cannot change the closure-slot diff.
                v_sub_new = v_sub + jnp.dot(
                    self._take_sub(delta, a), a["Es"],
                    precision=_EXACT, preferred_element_type=v.dtype,
                )
                add = self._fill_updates_hybrid(v_sub_new, a)
            else:
                add = self._fill_updates(v_sub, surf_new, a)
            # surface part rides the shared Es scatter-back; interior part
            # expands on the subset only
            delta = self._subset_scatter_add(delta, add[:, :ns], a)
            if self._nX:
                upd_int = jnp.dot(
                    add[:, ns:], a["EsI"], precision=_EXACT,
                    preferred_element_type=v.dtype
                )
                sub_upd = upd_int if sub_upd is None else sub_upd + upd_int

        # one shared scatter-back; hole-node masking fused here
        out = v + jnp.dot(delta, a["Es"], precision=_EXACT,
                          preferred_element_type=v.dtype)
        if sub_upd is not None:
            out = self._subset_scatter_add(out, sub_upd, a)
        return jnp.where(a["node_valid"], out, 0.0)

    def _dss_fill_volume(self, v, a, corr=None):
        """Volume-domain variant of steps 3-4 (fill_mode="volume"): instead
        of carrying the fill through the [ns+nX]-wide EscX/EFX one-hot pair
        (~100 GFLOP of mostly-zero MACs at nref=7 p=4), apply the post-DSS
        exchange delta to
        the n_sub subset volumes ONCE (one subset-width Es scatter), read
        cell rows with the cheap conv-patch extraction, run the same
        fold/HN chain, and scatter the per-row coverage-scaled diffs back
        with the separable col2im. The EscX/EFX/EsI operands drop out of
        the hot path entirely."""
        surf = jnp.dot(v, a["Es"].T, precision=_EXACT,
                       preferred_element_type=v.dtype)
        if corr is not None:
            corr_surf = jnp.dot(corr, a["Es"].T, precision=_EXACT,
                                preferred_element_type=v.dtype)
            surf = self._subset_scatter_add(surf, corr_surf, a)
        surf_new = self._dss_surface(surf, a)
        delta = surf_new - surf
        sub_upd = corr
        if self._n_sub and a["hn_sub"].shape[0]:
            v_sub = self._take_sub(v, a)
            if corr is not None:
                v_sub = v_sub + corr
            v_sub = v_sub + jnp.dot(
                self._take_sub(delta, a), a["Es"],
                precision=_EXACT, preferred_element_type=v.dtype,
            )
            upd = self._fill_updates_volume(v_sub, a)
            sub_upd = upd if sub_upd is None else sub_upd + upd
        out = v + jnp.dot(delta, a["Es"], precision=_EXACT,
                          preferred_element_type=v.dtype)
        if sub_upd is not None:
            out = self._subset_scatter_add(out, sub_upd, a)
        return jnp.where(a["node_valid"], out, 0.0)

    def _fill_updates_volume(self, v_sub, a):
        """Volume-domain fill updates: conv-patch cell rows of the post-DSS
        subset volumes, the same fold/HN chain as the exchange path, then
        closure-masked per-row inverse-coverage scaling and one separable
        overlap-add back to [n_sub, N3p] (sum of x/den over equal writers
        == the exchange path's pooled x * 1/den)."""
        cols2 = self._extract_cols(v_sub, a)
        orig_rows = jnp.take(cols2, a["hn_sub"], axis=0)
        sub2 = self._fill_rows(cols2, a)
        diff = (sub2 - orig_rows) * a["fill_invcov"]
        dcols = jnp.zeros_like(cols2).at[a["hn_sub"]].set(diff)
        return self._col2im_sep(dcols, self._n_sub, a)

    def _fill_updates(self, v_sub, surf_vals, a):
        """Exchange-domain fill updates: read the subset bricks' exchange
        values (surf_vals [nb, n_surf] — post-DSS inside vmult, the raw
        surface extraction in the standalone refill) plus the subset brick
        rows v_sub [n_sub, N3p] for the interior X extension, run the
        fold/HN chain, and return the coverage-divided closure-slot updates
        [n_sub, n_surfX] (surface part first)."""
        parts = [self._take_sub(surf_vals, a)]
        if self._nX:
            parts.append(
                jnp.dot(v_sub, a["EsI"].T, precision=_EXACT,
                        preferred_element_type=v_sub.dtype)
            )
        inp_sub = jnp.concatenate(parts, axis=1)  # [n_sub, ns + nX]
        C = self.bs.B**self.bs.dim
        cols2 = jnp.dot(
            inp_sub, a["EscX"], precision=_EXACT,
            preferred_element_type=inp_sub.dtype
        ).reshape(self._n_sub * C, -1)
        return self._fill_chain_efx(cols2, a)

    def _fill_updates_hybrid(self, v_sub_new, a):
        """Hybrid fill updates (fill_mode="hybrid"): volume-domain read —
        conv-patch cell rows of the post-DSS subset volumes (identical to
        the EscX expansion on every slot the fold/HN chain reads, since the
        surfX set covers the chain's read set by construction) — with the
        exchange-domain EFX write-back of _fill_updates."""
        cols2 = self._extract_cols(v_sub_new, a)
        return self._fill_chain_efx(cols2, a)

    def _fill_rows(self, cols2, a):
        """Fold/HN chain of the fill on cell rows [n_sub*C, n_loc]: returns
        the FILLED hn rows (hanging closure slots replaced by their
        master-interpolated values, chained through levels coarse-first)."""
        if self._chain_mode == "compact" and self._flat_meta:
            return self._hn_apply(
                self._fill_hn_compact(cols2, a), a, transpose=False
            )
        if self._flat_meta:
            lin = a["flat_lz_lin"]
            cols2 = cols2.at[lin].set(
                jnp.take(cols2, lin, axis=0)
                * self._bmask(a["flat_lz_keep"], cols2)
            )
            cols2 = self._fold_chain_flat(cols2, a, "fill")
        else:
            for lv in sorted(self._levels):
                lz = a["level_zero"][lv]
                cols2 = cols2.at[lz["lin"]].set(
                    jnp.take(cols2, lz["lin"], axis=0)
                    * self._bmask(lz["keep"], cols2)
                )
                cols2 = self._fold_level(cols2, a["transfers_b"][lv], fill=True)
        return self._hn_apply(
            jnp.take(cols2, a["hn_sub"], axis=0), a, transpose=False
        )

    @staticmethod
    def _bmask(mask, rows):
        """Broadcast a [m, n_loc] chain mask over rows that may carry extra
        trailing batch axes ([m, k, n_loc] in the multi-RHS / vector-valued
        layouts)."""
        return mask[:, None] if rows.ndim == 3 else mask

    @staticmethod
    def _gmask(mask, rows):
        """Broadcast a [G, m, n_loc] fold mask over fold outputs whose row
        operand carries a trailing batch axis (out is [G, m, k, n_loc] when
        rows is [n_rows, k, n_loc])."""
        return mask[:, :, None] if rows.ndim == 3 else mask

    def _fill_hn_compact(self, cols_u, a):
        """Compact-space fill chain (chain_mode="compact"): the lz masking,
        fold scatter and tail stages all act on a [n_hn, n_loc] buffer —
        never on the full cols array. Equal to the flat schedule: every
        fill destination and every tail row is an hn row (asserted at
        build), padded grid slots are dropped by the static real-position
        gather, and hn-row sources read the masked base exactly as the
        masked-cols2 schedule does.

        cols_u may be [n_rows, n_loc] or [n_rows, k, n_loc] (k RHS /
        components batched on a trailing row axis; every index array
        addresses rows, so the chain is identical per batch entry)."""
        meta = self._flat_meta["fill"]
        base = jnp.take(cols_u, a["hn_sub"], axis=0) * self._bmask(
            a["flat_cp_keep_hn"], cols_u
        )
        filled = base
        if a["flat_fill_src_all"].shape[0]:
            sel = jnp.take(cols_u, a["flat_fill_src_all"], axis=0)
            if a["flat_cp_fill_fix_idx"].shape[0]:
                sel = sel.at[a["flat_cp_fill_fix_idx"]].set(
                    jnp.take(base, a["flat_cp_fill_fix_local"], axis=0)
                )
            outs = []
            for si, off, G, m in meta["segs"]:
                out = jnp.einsum(
                    "gm...i,gij->gm...j",
                    sel[off:off + G * m].reshape((G, m) + sel.shape[1:]),
                    a[f"flat_fill_T{si}"],  # pre-transposed at build
                    precision=_EXACT, preferred_element_type=cols_u.dtype,
                )
                outs.append(out.reshape((G * m,) + out.shape[2:]))
            outs = jnp.concatenate(outs, axis=0)
            filled = filled.at[a["flat_cp_fill_dst_local"]].add(
                jnp.take(outs, a["flat_cp_fill_real_pos"], axis=0)
            )
        for ti in range(meta["n_tails"]):
            sel_t = jnp.take(
                filled, a[f"flat_cp_fill_tail{ti}_src_local"], axis=0
            )
            out_t = jnp.einsum(
                "k...i,kij->k...j", sel_t, a[f"flat_fill_tail{ti}_T"],
                precision=_EXACT, preferred_element_type=cols_u.dtype,
            )
            filled = filled.at[a[f"flat_cp_fill_tail{ti}_dst_local"]].add(out_t)
        return filled

    def _corr_compact(self, plain, plain_hn, sub_raw, a):
        """Compact-space correction chain + sparse delta assembly
        (chain_mode="compact"): returns dcols = final - plain without ever
        materializing `final`. Corr sources are hn rows (asserted at
        build) so stage 1 gathers from sub_raw directly; hn-destined fold
        contributions accumulate in a [n_hn, n_loc] buffer (tails read
        sub_raw + acc, the exact pre-lz sequential state); non-hn
        contributions scatter-add straight into the sparse delta. The lz
        zeroing collapses to one keep multiply on the hn rows.

        plain/plain_hn may be None (assembled-removal mode): the -plain
        subtraction and the absent rows are then handled OUTSIDE by
        _masked_quad_apply, and dcols carries the raw folded HN^T rows."""
        meta = self._flat_meta["corr"]
        acc = None
        nh_parts = []
        if a["flat_corr_src_all"].shape[0]:
            sel = jnp.take(sub_raw, a["flat_cp_corr_src_local"], axis=0)
            outs = []
            for si, off, G, m in meta["segs"]:
                out = jnp.einsum(
                    "gm...i,gij->gm...j",
                    sel[off:off + G * m].reshape((G, m) + sel.shape[1:]),
                    a[f"flat_corr_T{si}"],
                    precision=_EXACT, preferred_element_type=sub_raw.dtype,
                )
                outs.append(out.reshape((G * m,) + out.shape[2:]))
            outs = jnp.concatenate(outs, axis=0)
            if a["flat_cp_corr_hn_pos"].shape[0]:
                acc = jnp.zeros_like(sub_raw).at[
                    a["flat_cp_corr_hn_dst_local"]
                ].add(jnp.take(outs, a["flat_cp_corr_hn_pos"], axis=0))
            if a["flat_cp_corr_nh_pos"].shape[0]:
                nh_parts.append((
                    a["flat_cp_corr_nh_dst"],
                    jnp.take(outs, a["flat_cp_corr_nh_pos"], axis=0),
                ))
        for ti in range(meta["n_tails"]):
            cur = sub_raw if acc is None else sub_raw + acc
            sel_t = jnp.take(
                cur, a[f"flat_cp_corr_tail{ti}_src_local"], axis=0
            )
            out_t = jnp.einsum(
                "k...i,kij->k...j", sel_t, a[f"flat_corr_tail{ti}_T"],
                precision=_EXACT, preferred_element_type=sub_raw.dtype,
            )
            if a[f"flat_cp_corr_tail{ti}_hn_pos"].shape[0]:
                upd = jnp.take(out_t, a[f"flat_cp_corr_tail{ti}_hn_pos"], axis=0)
                ali = a[f"flat_cp_corr_tail{ti}_hn_dst_local"]
                acc = (jnp.zeros_like(sub_raw) if acc is None else acc
                       ).at[ali].add(upd)
            if a[f"flat_cp_corr_tail{ti}_nh_pos"].shape[0]:
                nh_parts.append((
                    a[f"flat_cp_corr_tail{ti}_nh_dst"],
                    jnp.take(out_t, a[f"flat_cp_corr_tail{ti}_nh_pos"], axis=0),
                ))
        final_hn = sub_raw if acc is None else sub_raw + acc
        final_hn = final_hn * self._bmask(a["flat_cp_keep_hn"], final_hn)
        if plain_hn is not None:
            final_hn = final_hn - plain_hn
        if plain is not None:
            dcols = jnp.zeros_like(plain)
            if a["absent_sub"].shape[0]:
                dcols = dcols.at[a["absent_sub"]].set(
                    -jnp.take(plain, a["absent_sub"], axis=0)
                )
        else:
            C = self.bs.B ** self.bs.dim
            dcols = jnp.zeros(
                (self._n_chainb * C,) + sub_raw.shape[1:], sub_raw.dtype
            )
        dcols = dcols.at[a["hn_sub"]].set(final_hn)
        for idx, rows in nh_parts:
            dcols = dcols.at[idx].add(rows)
        return dcols

    def _fill_chain_efx(self, cols2, a):
        """Shared tail of the fill pass: fold/HN chain on cell rows, then
        the coverage-divided closure-slot updates [n_sub, n_surfX]."""
        orig_rows = jnp.take(cols2, a["hn_sub"], axis=0)
        sub2 = self._fill_rows(cols2, a)
        # node updates from changed (constrained) cells only; every
        # covering writer holds the same value, so divide by the
        # (static, precomputed) coverage count. diff is provably zero
        # off the closure slots (fill writes = F positions only).
        diff = sub2 - orig_rows
        dcols = jnp.zeros_like(cols2).at[a["hn_sub"]].set(diff)
        return jnp.dot(
            dcols.reshape(self._n_sub, -1), a["EFX"],
            precision=_EXACT, preferred_element_type=dcols.dtype,
        ) * a["fill_invden_X"]

    def _refill_impl(self, v, a):
        """Restore the hanging-node invariant of a brick vector whose
        conforming copies already agree: recompute every hanging closure
        copy from its (possibly multi-level) master values. Same chain as
        the vmult fill pass, reading the vector's own surface values (no
        DSS). Used by the Dirichlet mask / diagonal scaling of the GMG
        stack, whose pointwise operations break only the hanging copies."""
        if self._plane_meta:
            # plane-covered hanging copies restore at face granularity;
            # the per-cell chain below covers the residual set
            v = self._plane_fill(v, a)
        if not (self._n_sub and a["hn_sub"].shape[0]):
            return v
        if self._fill_mode == "volume":
            upd = self._fill_updates_volume(self._take_sub(v, a), a)
            v = self._subset_scatter_add(v, upd, a)
            return jnp.where(a["node_valid"], v, 0.0)
        ns = self.n_surf
        surf = jnp.dot(v, a["Es"].T, precision=_EXACT,
                       preferred_element_type=v.dtype)
        if self._fill_mode in ("hybrid", "input"):
            add = self._fill_updates_hybrid(self._take_sub(v, a), a)
        else:
            add = self._fill_updates(self._take_sub(v, a), surf, a)
        dsurf = self._subset_scatter_add(
            jnp.zeros_like(surf), add[:, :ns], a
        )
        v = v + jnp.dot(dsurf, a["Es"], precision=_EXACT,
                        preferred_element_type=v.dtype)
        if self._nX:
            upd_int = jnp.dot(
                add[:, ns:], a["EsI"], precision=_EXACT,
                preferred_element_type=v.dtype
            )
            v = self._subset_scatter_add(v, upd_int, a)
        return jnp.where(a["node_valid"], v, 0.0)

    def refill(self, bv):
        prec = self._matmul_precision
        if not hasattr(self, "_jit_refill"):
            self._jit_refill = jax.jit(self._refill_impl)
        with jax.default_matmul_precision(prec):
            return self._jit_refill(bv, self._stage())

    def _vmult_plain_impl(self, bv, a):
        """Constraints-off vmult: main operator + hole (absent-cell)
        correction + cross-brick DSS, but no HN interpolation, folds, or fill
        — the brick analog of the reference's unconstrained read/write
        variant (benchmark_03.h:510-532), used for the eta overhead pair."""
        if self._deformed:
            # absent slots carry G_q = 0, so no hole correction is needed
            v = self._deformed_brick_apply(bv, a)
            surf = jnp.dot(v, a["Es"].T, precision=_EXACT,
                           preferred_element_type=bv.dtype)
            surf_new = self._dss_surface(surf, a)
            return jnp.where(
                a["node_valid"],
                v + jnp.dot(surf_new - surf, a["Es"],
                            precision=_EXACT, preferred_element_type=bv.dtype),
                0.0,
            )
        v = self._main_apply(bv, a)
        v = v * a["geo"][:, None]
        if self._n_sub and a["absent_sub"].shape[0]:
            u_sub = self._take_sub(bv, a)
            if self._use_masked_removal:
                # assembled hole removal: one masked quadrature apply on
                # the subset bricks instead of the cols-domain extract/K/
                # gather/col2im chain (whose per-row ops dominate at low
                # degree)
                v = self._subset_scatter_add(
                    v,
                    -self._masked_quad_apply(u_sub, a, a["qmask_absent"]),
                    a,
                )
            else:
                cols_u = self._extract_cols(u_sub, a)
                plain = jnp.dot(
                    cols_u, a["K"].T, preferred_element_type=bv.dtype
                ) * a["geo_cell_sub"][:, None]
                dcols = jnp.zeros_like(plain).at[a["absent_sub"]].set(
                    -jnp.take(plain, a["absent_sub"], axis=0)
                )
                v = self._subset_scatter_add(
                    v, self._scatter_cols(dcols, a), a
                )
        surf = jnp.dot(v, a["Es"].T, precision=_EXACT,
                       preferred_element_type=bv.dtype)
        surf_new = self._dss_surface(surf, a)
        return jnp.where(
            a["node_valid"],
            v + jnp.dot(surf_new - surf, a["Es"], precision=_EXACT,
                        preferred_element_type=bv.dtype),
            0.0,
        )

    # ----------------------------------------------- deformed-mapping path
    def _deformed_cell_apply(self, cols_u, a, Gq):
        """Per-cell deformed Laplace kernel in the cols domain: sum-factorized
        gradients at quadrature points, packed-metric contraction, adjoint
        integration (the MappingQCache analog, benchmark_01.h:227-242).
        Gq [m, n_q, n_pairs] are the metric rows matching cols_u's rows;
        absent slots carry G_q = 0 and so output zero rows. Used on the
        exceptional SUBSET only — the main pass is _deformed_brick_apply."""
        from .ops.sum_factorization import evaluate_gradients, integrate_gradients

        dim = self.bs.dim
        g = evaluate_gradients(cols_u, a["S"], a["Dc"], dim)  # [m, dim, n_q]
        pairs = [(x, y) for x in range(dim) for y in range(x, dim)]
        out = [jnp.zeros_like(g[:, 0]) for _ in range(dim)]
        for k, (x, y) in enumerate(pairs):
            out[x] = out[x] + Gq[:, :, k] * g[:, y]
            if x != y:
                out[y] = out[y] + Gq[:, :, k] * g[:, x]
        return integrate_gradients(jnp.stack(out, axis=1), a["S"], a["Dc"], dim)

    def _deformed_brick_apply(self, bv, a):
        """Deformed main path in the brick-tensor domain: block-diagonal 1D
        quadrature operators sweep whole bricks exactly like _main_apply
        (Sqb [Q, NB] collocation values, Dqb [Q, Q] collocation derivatives,
        Q = B*n_q1), the packed metric contracts elementwise on the
        brick-quad lattice, and the adjoint sweeps integrate back — no
        im2col/col2im, NB-length contractions.
        Per-cell equal to _deformed_cell_apply over every present cell
        (absent slots carry G_q = 0); cross-cell node sharing makes the
        S^T sweeps assemble neighbor contributions, which the Cartesian
        main path gets from the assembled brick operator."""
        bs = self.bs
        NB, dim = bs.NB, bs.dim
        nb = bv.shape[0]
        dt = bv.dtype
        Sq, Dq, G = a["Sqb"], a["Dqb"], a["Gqb"]
        u = bv[:, : self.N3]
        if dim == 3:
            t = u.reshape(nb, NB, NB, NB)
            t = jnp.einsum("Zz,bzyx->bZyx", Sq, t, preferred_element_type=dt)
            t = jnp.einsum("Yy,bzyx->bzYx", Sq, t, preferred_element_type=dt)
            t = jnp.einsum("Xx,bzyx->bzyX", Sq, t, preferred_element_type=dt)
            gx = jnp.einsum("XW,bzyW->bzyX", Dq, t, preferred_element_type=dt)
            gy = jnp.einsum("YW,bzWx->bzYx", Dq, t, preferred_element_type=dt)
            gz = jnp.einsum("ZW,bWyx->bZyx", Dq, t, preferred_element_type=dt)
            # packed upper triangle, component t=0 is the x (fastest) axis
            ox = G[:, 0] * gx + G[:, 1] * gy + G[:, 2] * gz
            oy = G[:, 1] * gx + G[:, 3] * gy + G[:, 4] * gz
            oz = G[:, 2] * gx + G[:, 4] * gy + G[:, 5] * gz
            acc = (
                jnp.einsum("WX,bzyW->bzyX", Dq, ox, preferred_element_type=dt)
                + jnp.einsum("WY,bzWx->bzYx", Dq, oy, preferred_element_type=dt)
                + jnp.einsum("WZ,bWyx->bZyx", Dq, oz, preferred_element_type=dt)
            )
            acc = jnp.einsum("Zz,bZyx->bzyx", Sq, acc, preferred_element_type=dt)
            acc = jnp.einsum("Yy,bzYx->bzyx", Sq, acc, preferred_element_type=dt)
            acc = jnp.einsum("Xx,bzyX->bzyx", Sq, acc, preferred_element_type=dt)
        else:
            t = u.reshape(nb, NB, NB)
            t = jnp.einsum("Yy,byx->bYx", Sq, t, preferred_element_type=dt)
            t = jnp.einsum("Xx,byx->byX", Sq, t, preferred_element_type=dt)
            gx = jnp.einsum("XW,byW->byX", Dq, t, preferred_element_type=dt)
            gy = jnp.einsum("YW,bWx->bYx", Dq, t, preferred_element_type=dt)
            ox = G[:, 0] * gx + G[:, 1] * gy
            oy = G[:, 1] * gx + G[:, 2] * gy
            acc = (
                jnp.einsum("WX,byW->byX", Dq, ox, preferred_element_type=dt)
                + jnp.einsum("WY,bWx->bYx", Dq, oy, preferred_element_type=dt)
            )
            acc = jnp.einsum("Yy,bYx->byx", Sq, acc, preferred_element_type=dt)
            acc = jnp.einsum("Xx,byX->byx", Sq, acc, preferred_element_type=dt)
        v = acc.reshape(nb, self.N3)
        if self.N3p > self.N3:
            v = jnp.pad(v, ((0, 0), (0, self.N3p - self.N3)))
        return v

    # ---------------------------------------------------- face-plane chain
    @staticmethod
    def _face_ix(dim, d, idx):
        """Static index tuple selecting the face plane at lattice index idx
        along spatial axis d of a [m, ...lattice] brick tensor (array axis
        dim - d, since the lattice axes are (z, y, x))."""
        sl = [slice(None)] * (dim + 1)
        sl[dim - d] = idx
        return tuple(sl)

    def _plane_fill(self, bv, a):
        """Input-side face-plane constraint resolution: for every aligned
        interface pair, overwrite the covered nodes of the fine brick's
        face with the interpolation of the coarse neighbor's quarter face
        (wide brick-row gathers + static slices + [NB, Nh] matmuls; no
        per-cell work). Groups run coarse level first so multi-level
        masters are valid before finer pairs read them."""
        if not self._plane_meta:
            return bv
        bs = self.bs
        NB, dim = bs.NB, bs.dim
        nb = bv.shape[0]
        Nh = (NB - 1) // 2 + 1
        Half = Nh - 1
        P1 = a["plane_P1"]
        dt = bv.dtype
        tf = bv[:, : self.N3]
        W = a["plane_W"]
        N3 = NB**dim
        t = jnp.take(tf, W, axis=0)  # [n_W, N3]
        for lv in self._plane_levels:  # coarse level first
            rows, ids = [], []
            for i, m in enumerate(self._plane_meta):
                if m["level"] != lv:
                    continue
                d, s, offs = m["d"], m["s"], m["offs"]
                # all reads come from the pre-level state; the disjoint
                # cover masks make the level's updates compose by ADD
                cr = jnp.take(t, a[f"plane{i}_coarse"], axis=0).reshape(
                    (-1,) + (NB,) * dim
                )
                cpl = cr[self._face_ix(dim, d, m["c_pl"])]
                if dim == 3:
                    r0, c0 = offs[1] * Half, offs[0] * Half
                    q = cpl[:, r0:r0 + Nh, c0:c0 + Nh]
                    fp = jnp.einsum("iI,bIJ->biJ", P1, q,
                                    preferred_element_type=dt)
                    fp = jnp.einsum("jJ,biJ->bij", P1, fp,
                                    preferred_element_type=dt)
                else:
                    c0 = offs[0] * Half
                    fp = jnp.einsum("iI,bI->bi", P1, cpl[:, c0:c0 + Nh],
                                    preferred_element_type=dt)
                fr = jnp.take(t, a[f"plane{i}_fine"], axis=0).reshape(
                    (-1,) + (NB,) * dim
                )
                fix = self._face_ix(dim, d, 0 if s == 0 else NB - 1)
                cover = a[f"plane{i}_cover"]
                upd = jnp.zeros_like(fr).at[fix].set(
                    (fp - fr[fix]) * cover
                )
                rows.append(upd.reshape(-1, N3))
                ids.append(a[f"plane{i}_fine"])
            if rows:
                t = t.at[jnp.concatenate(ids)].add(jnp.concatenate(rows))
        out = tf.at[W].set(t)
        if self.N3p > self.N3:
            out = jnp.pad(out, ((0, 0), (0, self.N3p - self.N3)))
        return out

    def _plane_corr(self, v, a):
        """Output-side face-plane fold (the C^T of _plane_fill): the
        hanging nodes of each covered fine face scatter their partial sums
        into the coarse quarter face through P1^T and are zeroed (reduced
        outputs). Fine levels run first so multi-level chains fold
        onward."""
        if not self._plane_meta:
            return v
        bs = self.bs
        NB, dim = bs.NB, bs.dim
        nb = v.shape[0]
        Nh = (NB - 1) // 2 + 1
        Half = Nh - 1
        P1 = a["plane_P1"]
        dt = v.dtype
        tf = v[:, : self.N3]
        W = a["plane_W"]
        N3 = NB**dim
        t = jnp.take(tf, W, axis=0)  # [n_W, N3]
        for lv in reversed(self._plane_levels):  # fine level first
            rows, ids = [], []
            for i, m in enumerate(self._plane_meta):
                if m["level"] != lv:
                    continue
                d, s, offs = m["d"], m["s"], m["offs"]
                hang = a[f"plane{i}_cover"]
                fr = jnp.take(t, a[f"plane{i}_fine"], axis=0).reshape(
                    (-1,) + (NB,) * dim
                )
                fix = self._face_ix(dim, d, 0 if s == 0 else NB - 1)
                fpl = fr[fix]
                h = fpl * hang  # disjoint masks: each node folds ONCE
                n_k = h.shape[0]
                if dim == 3:
                    r0, c0 = offs[1] * Half, offs[0] * Half
                    fold = jnp.einsum("iI,bij->bIj", P1, h,
                                      preferred_element_type=dt)
                    fold = jnp.einsum("jJ,bIj->bIJ", P1, fold,
                                      preferred_element_type=dt)
                    cadd = jnp.zeros((n_k, NB, NB), dt).at[
                        :, r0:r0 + Nh, c0:c0 + Nh
                    ].set(fold)
                else:
                    c0 = offs[0] * Half
                    fold = jnp.einsum("iI,bi->bI", P1, h,
                                      preferred_element_type=dt)
                    cadd = jnp.zeros((n_k, NB), dt).at[
                        :, c0:c0 + Nh
                    ].set(fold)
                crow = jnp.zeros((n_k,) + (NB,) * dim, dt).at[
                    self._face_ix(dim, d, m["c_pl"])
                ].set(cadd)
                rows.append(crow.reshape(n_k, N3))
                ids.append(a[f"plane{i}_coarse"])
                # zero the folded fine copies: subtract each once
                zrow = jnp.zeros_like(fr).at[fix].set(-h)
                rows.append(zrow.reshape(n_k, N3))
                ids.append(a[f"plane{i}_fine"])
            if rows:
                t = t.at[jnp.concatenate(ids)].add(jnp.concatenate(rows))
        out = tf.at[W].set(t)
        if self.N3p > self.N3:
            out = jnp.pad(out, ((0, 0), (0, self.N3p - self.N3)))
        return out

    def _masked_quad_apply(self, u_rows, a, mask):
        """Assembled Laplace apply restricted to a cell subset, in the
        brick-tensor domain: v = sum_{c: mask} geo_c * E_c^T K_cell E_c u,
        computed as block-diagonal quadrature sweeps (Sqb/Dqb, like the
        deformed main path) with the Cartesian metric geo_b * w3[q]
        expressed as BROADCAST factors — no per-cell metric array, no cols
        domain, no per-row gathers. mask [m, B^dim] carries the per-brick
        geo factor on its selected cells (staged premultiplied:
        qmask_absent / qmask_rem). Replaces the cols-domain `plain`
        gather/subtract machinery for hole cells and (input-fill mode) the
        constrained cells' unconstrained contributions — the measured bulk
        of the low-degree HN overhead, where C = B^dim is large and n_loc
        tiny so every per-row op ran at a few % lane efficiency."""
        bs = self.bs
        NB, dim, B = bs.NB, bs.dim, bs.B
        m = u_rows.shape[0]
        dt = u_rows.dtype
        Sq, Dq, w1 = a["Sqb"], a["Dqb"], a["w1"]
        nq = w1.shape[0]
        u = u_rows[:, : self.N3]
        if dim == 3:
            t = u.reshape(m, NB, NB, NB)
            t = jnp.einsum("Zz,bzyx->bZyx", Sq, t, preferred_element_type=dt)
            t = jnp.einsum("Yy,bzyx->bzYx", Sq, t, preferred_element_type=dt)
            t = jnp.einsum("Xx,bzyx->bzyX", Sq, t, preferred_element_type=dt)
            f = (
                mask.reshape(m, B, 1, B, 1, B, 1)
                * w1.reshape(1, 1, nq, 1, 1, 1, 1)
                * w1.reshape(1, 1, 1, 1, nq, 1, 1)
                * w1.reshape(1, 1, 1, 1, 1, 1, nq)
            ).reshape(m, B * nq, B * nq, B * nq)
            gx = f * jnp.einsum("XW,bzyW->bzyX", Dq, t,
                                preferred_element_type=dt)
            gy = f * jnp.einsum("YW,bzWx->bzYx", Dq, t,
                                preferred_element_type=dt)
            gz = f * jnp.einsum("ZW,bWyx->bZyx", Dq, t,
                                preferred_element_type=dt)
            acc = (
                jnp.einsum("WX,bzyW->bzyX", Dq, gx, preferred_element_type=dt)
                + jnp.einsum("WY,bzWx->bzYx", Dq, gy,
                             preferred_element_type=dt)
                + jnp.einsum("WZ,bWyx->bZyx", Dq, gz,
                             preferred_element_type=dt)
            )
            acc = jnp.einsum("Zz,bZyx->bzyx", Sq, acc,
                             preferred_element_type=dt)
            acc = jnp.einsum("Yy,bzYx->bzyx", Sq, acc,
                             preferred_element_type=dt)
            acc = jnp.einsum("Xx,bzyX->bzyx", Sq, acc,
                             preferred_element_type=dt)
        else:
            t = u.reshape(m, NB, NB)
            t = jnp.einsum("Yy,byx->bYx", Sq, t, preferred_element_type=dt)
            t = jnp.einsum("Xx,byx->byX", Sq, t, preferred_element_type=dt)
            f = (
                mask.reshape(m, B, 1, B, 1)
                * w1.reshape(1, 1, nq, 1, 1)
                * w1.reshape(1, 1, 1, 1, nq)
            ).reshape(m, B * nq, B * nq)
            gx = f * jnp.einsum("XW,byW->byX", Dq, t,
                                preferred_element_type=dt)
            gy = f * jnp.einsum("YW,bWx->bYx", Dq, t,
                                preferred_element_type=dt)
            acc = (
                jnp.einsum("WX,byW->byX", Dq, gx, preferred_element_type=dt)
                + jnp.einsum("WY,bWx->bYx", Dq, gy,
                             preferred_element_type=dt)
            )
            acc = jnp.einsum("Yy,bYx->byx", Sq, acc,
                             preferred_element_type=dt)
            acc = jnp.einsum("Xx,byX->byx", Sq, acc,
                             preferred_element_type=dt)
        v = acc.reshape(m, self.N3)
        if self.N3p > self.N3:
            v = jnp.pad(v, ((0, 0), (0, self.N3p - self.N3)))
        return v

    def vmult_plain(self, bv):
        prec = self._matmul_precision
        if not hasattr(self, "_jit_vmult_plain"):
            self._jit_vmult_plain = jax.jit(self._vmult_plain_impl)
        with jax.default_matmul_precision(prec):
            return self._jit_vmult_plain(bv, self._stage())

    # ---------------------------------------------- vector space helpers
    def dot_mask(self):
        """[nb, N3p] weights: 1 at the owner copy of each non-hanging dof —
        <u, v> over the reduced CG space = sum(mask * u * v)."""
        if not hasattr(self, "_dot_mask"):
            bs = self.bs
            m = np.zeros((bs.n_bricks, self.N3p), dtype=self.mf.dtype)
            m[:, : self.N3] = bs.dot_mask.reshape(bs.n_bricks, self.N3)
            self._dot_mask = jnp.asarray(m)
        return self._dot_mask

    def dot(self, u, v):
        return jnp.sum(self.dot_mask() * u * v)

    def norm(self, u):
        return jnp.sqrt(self.dot(u, u))

    def vmult(self, bv):
        with jax.default_matmul_precision(self._matmul_precision):
            return self._jit_vmult(bv, self._stage())

    # ------------------------------------------------------------- multi-RHS
    def _fold_level_multi(self, rows, tb, k, nr1, fill):
        """_fold_level on k-major flattened rows [k*nr1, n_loc]: the gather
        indices get per-RHS offsets j*nr1; the einsum batches k into the m
        (matmul M-) dimension so the [G, n_loc, n_loc] transfer tensors are
        read once for all k right-hand sides."""
        src = tb["coarse"] if fill else tb["fine"]
        dst = tb["fine"] if fill else tb["coarse"]
        G, m = src.shape
        offs = (jnp.arange(k, dtype=src.dtype) * src.dtype.type(nr1))
        src_k = offs[:, None, None] + src[None]  # [k, G, m]
        dst_k = offs[:, None, None] + dst[None]
        sel = jnp.take(rows, src_k.reshape(-1), axis=0).reshape(k, G, m, -1)
        T = tb["T"]
        out = jnp.einsum(
            "kgmi,gij->kgmj", sel,
            jnp.swapaxes(T, 1, 2) if fill else T,
            precision=_EXACT, preferred_element_type=rows.dtype,
        ) * tb["mask"][None]
        return rows.at[dst_k.reshape(-1)].add(out.reshape(k * G * m, -1))

    def _dss_surface_multi(self, surf, a, k):
        """_dss_surface on [k*nb, n_surf], k-MINOR pool layout: each entity
        block is transposed to [n_copies, k*entity_size] so the scatter-add
        and gather-back touch exactly the same NUMBER of rows as the
        single-RHS path (row-granular scatter cost was width-insensitive
        where this was measured); the k-fold width is where the
        amortization lives. The earlier k-major formulation offset the pool
        ids per RHS and paid k x the scatter rows."""
        bs = self.bs
        nb = bs.n_bricks
        dim = bs.dim
        nf = 2 * dim
        fsize = (bs.NB - 2) ** (dim - 1)

        def _kmin(block, ncopy, esz):
            # [k*nb, ncopy*esz] class block -> [nb*ncopy, k*esz]
            x = block.reshape(k, nb * ncopy, esz)
            return jnp.swapaxes(x, 0, 1).reshape(nb * ncopy, k * esz)

        def _kmaj(block, ncopy, esz):
            # inverse of _kmin
            x = block.reshape(nb * ncopy, k, esz)
            return jnp.swapaxes(x, 0, 1).reshape(k * nb, ncopy * esz)

        fblock = _kmin(surf[:, : nf * fsize], nf, fsize)
        fid = a["face_pool_id"].reshape(-1)
        pool = jnp.zeros((bs.n_face_pools, k * fsize), surf.dtype)
        pool = pool.at[fid].add(fblock)
        parts = [_kmaj(pool[fid], nf, fsize)]
        off = nf * fsize
        if dim == 3:
            esize = bs.NB - 2
            eblock = _kmin(surf[:, off : off + 12 * esize], 12, esize)
            eid = a["edge_pool_id"].reshape(-1)
            epool = jnp.zeros((bs.n_edge_pools, k * esize), surf.dtype)
            epool = epool.at[eid].add(eblock)
            parts.append(_kmaj(epool[eid], 12, esize))
            off += 12 * esize
        ncorner = 2**dim
        cblock = _kmin(surf[:, off : off + ncorner], ncorner, 1)
        cid = a["corner_pool_id"].reshape(-1)
        cpool = jnp.zeros((bs.n_corner_pools, k), surf.dtype)
        cpool = cpool.at[cid].add(cblock)
        parts.append(_kmaj(cpool[cid], ncorner, 1))
        return jnp.concatenate(parts, axis=1)

    def _subset_scatter_add_multi(self, v, dsub, a, k):
        """v[j*nb + sub_ids] += dsub (k-major): the one-hot path shares the
        [nb, n_sub] selector across RHS via a k-batched einsum."""
        nb = self.bs.n_bricks
        if self._sub_contig:
            x = v.shape[-1]
            return (
                v.reshape(k, nb, x)
                .at[:, : self._n_sub]
                .add(dsub.reshape(k, self._n_sub, x))
                .reshape(k * nb, x)
            )
        if self._use_ssub:
            upd = jnp.einsum(
                "bs,ksx->kbx", a["Ssub"],
                dsub.reshape(k, self._n_sub, dsub.shape[-1]),
                precision=_EXACT, preferred_element_type=v.dtype,
            )
            return v + upd.reshape(k * nb, -1)
        sid = a["sub_ids"]
        offs = jnp.arange(k, dtype=sid.dtype) * sid.dtype.type(nb)
        return v.at[(offs[:, None] + sid[None]).reshape(-1)].add(dsub)

    def _take_sub_multi(self, x, a, k):
        """x[j*nb + sub_ids] on the k-major flattened layout: a static
        per-block leading slice under the subset-first order."""
        nb = self.bs.n_bricks
        if self._sub_contig:
            w = x.shape[-1]
            return (
                x.reshape(k, nb, w)[:, : self._n_sub].reshape(-1, w)
            )
        sid = a["sub_ids"]
        offs = jnp.arange(k, dtype=sid.dtype) * sid.dtype.type(nb)
        return jnp.take(x, (offs[:, None] + sid[None]).reshape(-1), axis=0)

    def _hn_ids2(self, a, k):
        """[n_hn, k] gather indices of the HN rows in the k-major flattened
        [k*n_sub*C, n_loc] cols space — hn-major so the mask-sorted
        contiguous slicing of _hn_apply still applies on axis 0 (k rides as
        a middle axis through the composite matmuls)."""
        hs = a["hn_sub"]
        nr1 = self._n_sub * self.bs.B**self.bs.dim
        offs = jnp.arange(k, dtype=hs.dtype) * hs.dtype.type(nr1)
        return hs[:, None] + offs[None, :]

    def _fill_updates_multi(self, v, surf_vals, a, k):
        """_fill_updates on the k-major layout: [k*n_sub, ...] subset rows,
        shared EscX/EFX operands read once for all RHS."""
        v_sub = self._take_sub_multi(v, a, k)
        parts = [self._take_sub_multi(surf_vals, a, k)]
        if self._nX:
            parts.append(
                jnp.dot(v_sub, a["EsI"].T, precision=_EXACT,
                        preferred_element_type=v.dtype)
            )
        inp_sub = jnp.concatenate(parts, axis=1)  # [k*n_sub, ns + nX]
        C = self.bs.B**self.bs.dim
        cols2 = jnp.dot(
            inp_sub, a["EscX"], precision=_EXACT,
            preferred_element_type=v.dtype
        ).reshape(k * self._n_sub * C, -1)
        ids2 = self._hn_ids2(a, k)
        n_hn = int(a["hn_sub"].shape[0])
        orig_rows = jnp.take(cols2, ids2.reshape(-1), axis=0).reshape(
            n_hn, k, -1
        )
        for lv in sorted(self._levels):
            lz = a["level_zero"][lv]
            lin = lz["lin"]
            loffs = jnp.arange(k, dtype=lin.dtype) * lin.dtype.type(
                self._n_sub * C
            )
            lin_k = (lin[:, None] + loffs[None, :]).reshape(-1)
            zer = jnp.take(cols2, lin_k, axis=0).reshape(
                lin.shape[0], k, -1
            ) * lz["keep"][:, None, :]
            cols2 = cols2.at[lin_k].set(zer.reshape(-1, zer.shape[-1]))
            cols2 = self._fold_level_multi(
                cols2, a["transfers_b"][lv], k, self._n_sub * C, fill=True
            )
        sub2 = self._hn_apply(
            jnp.take(cols2, ids2.reshape(-1), axis=0).reshape(n_hn, k, -1),
            a, transpose=False,
        )
        diff = sub2 - orig_rows
        dcols = jnp.zeros_like(cols2).at[ids2.reshape(-1)].set(
            diff.reshape(-1, diff.shape[-1])
        )
        add = jnp.dot(
            dcols.reshape(k * self._n_sub, -1), a["EFX"],
            precision=_EXACT, preferred_element_type=v.dtype,
        )
        add = (
            add.reshape(k, self._n_sub, -1) * a["fill_invden_X"][None]
        ).reshape(k * self._n_sub, -1)
        return add

    def _vmult_multi_impl(self, bvk, a, k):
        """Blocked multi-RHS vmult on the k-major flattened layout
        [k*nb, N3p]: every matmul's M dimension grows k-fold, so the static
        operands (Kronecker factors, Es/EscX/EFX, composite HN matrices) are
        streamed from HBM once per k right-hand sides — the matmul
        formulation the reference's multi-vector interfaces would use
        (benchmark_03.h:210-275 operates on one vector). Index ops get
        per-RHS iota offsets instead of vmap's
        batched gather/scatter lowering (measured slower per vector)."""
        bs = self.bs
        nb = bs.n_bricks
        dim = bs.dim
        C = bs.B**dim
        bv = bvk.reshape(k * nb, self.N3p)
        v = self._main_apply(bv, a)
        v = v * jnp.tile(a["geo"], k)[:, None]

        input_fill = self._fill_mode == "input"
        if self._n_sub and input_fill and a["hn_sub"].shape[0]:
            # input-side constraint resolution on the k-major layout: all
            # chain work rides [_, k, n_loc] buffers (trailing-axis batch,
            # see _fill_hn_compact / _fold_chain_flat / _fold_level);
            # outputs stay REDUCED exactly like the single-RHS input-fill
            # vmult under every chain schedule (compact/flat/sequential).
            nsC = self._n_sub * C
            u_sub = self._take_sub_multi(bv, a, k)
            cols_u = self._extract_cols(u_sub, a)  # [k*nsC, n_loc]
            u3 = jnp.swapaxes(cols_u.reshape(k, nsC, -1), 0, 1)
            plain3 = jnp.swapaxes(
                jnp.dot(cols_u, a["K"].T, preferred_element_type=bv.dtype)
                .reshape(k, nsC, -1), 0, 1,
            ) * a["geo_cell_sub"][:, None, None]
            u_hat = self._fill_rows(u3, a)  # [n_hn, k, n_loc]
            own = jnp.dot(
                u_hat, a["K"].T, preferred_element_type=bv.dtype
            ) * jnp.take(a["geo_cell_sub"], a["hn_sub"])[:, None, None]
            sub_raw = self._hn_apply(own, a, transpose=True)
            if self._chain_mode == "compact" and self._flat_meta:
                plain_hn = jnp.take(plain3, a["hn_sub"], axis=0)
                dcols3 = self._corr_compact(plain3, plain_hn, sub_raw, a)
            else:
                # full-size correction schedule (flat / sequential) on the
                # trailing-batch layout, mirroring the single-RHS branch
                final3 = plain3
                if a["absent_sub"].shape[0]:
                    final3 = final3.at[a["absent_sub"]].set(0.0)
                final3 = final3.at[a["hn_sub"]].set(sub_raw)
                if self._flat_meta:
                    final3 = self._fold_chain_flat(final3, a, "corr")
                    lin = a["flat_lz_lin"]
                    final3 = final3.at[lin].set(
                        jnp.take(final3, lin, axis=0)
                        * self._bmask(a["flat_lz_keep"], final3)
                    )
                else:
                    for lv in sorted(self._levels, reverse=True):
                        lz = a["level_zero"][lv]
                        zeroed = (
                            jnp.take(final3, lz["lin"], axis=0)
                            * self._bmask(lz["keep"], final3)
                        )
                        final3 = self._fold_level(
                            final3, a["transfers_b"][lv], fill=False
                        )
                        final3 = final3.at[lz["lin"]].set(zeroed)
                dcols3 = final3 - plain3
            delta = jnp.swapaxes(dcols3, 0, 1).reshape(k * nsC, -1)
            v = self._subset_scatter_add_multi(
                v, self._scatter_cols(delta, a), a, k
            )
        elif self._n_sub:
            u_sub = self._take_sub_multi(bv, a, k)
            cols_u = self._extract_cols(u_sub, a)  # [k*n_sub*C, n_loc]
            plain = jnp.dot(cols_u, a["K"].T, preferred_element_type=bv.dtype)
            plain = plain * jnp.tile(a["geo_cell_sub"], k)[:, None]
            final = plain
            if a["absent_sub"].shape[0]:
                ab = a["absent_sub"]
                aoffs = jnp.arange(k, dtype=ab.dtype) * ab.dtype.type(
                    self._n_sub * C
                )
                final = final.at[
                    (aoffs[:, None] + ab[None]).reshape(-1)
                ].set(0.0)
            if a["hn_sub"].shape[0]:
                ids2 = self._hn_ids2(a, k)
                n_hn = int(a["hn_sub"].shape[0])
                own = jnp.take(final, ids2.reshape(-1), axis=0).reshape(
                    n_hn, k, -1
                )
                sub_raw = self._hn_apply(own, a, transpose=True)
                final = final.at[ids2.reshape(-1)].set(
                    sub_raw.reshape(-1, sub_raw.shape[-1])
                )
                for lv in sorted(self._levels, reverse=True):
                    lz = a["level_zero"][lv]
                    lin = lz["lin"]
                    loffs = jnp.arange(k, dtype=lin.dtype) * lin.dtype.type(
                        self._n_sub * C
                    )
                    lin_k = (lin[:, None] + loffs[None, :]).reshape(-1)
                    zeroed = jnp.take(final, lin_k, axis=0).reshape(
                        lin.shape[0], k, -1
                    ) * lz["keep"][:, None, :]
                    final = self._fold_level_multi(
                        final, a["transfers_b"][lv], k, self._n_sub * C,
                        fill=False,
                    )
                    final = final.at[lin_k].set(
                        zeroed.reshape(-1, zeroed.shape[-1])
                    )
            delta = final - plain
            v = self._subset_scatter_add_multi(
                v, self._scatter_cols(delta, a), a, k
            )

        # DSS + fill on the k-major layout (input-fill outputs stay reduced;
        # the fill pass exists only for the output-fill modes)
        ns = self.n_surf
        surf = jnp.dot(v, a["Es"].T, precision=_EXACT,
                       preferred_element_type=v.dtype)
        surf_new = self._dss_surface_multi(surf, a, k)
        delta = surf_new - surf
        if self._n_sub and a["hn_sub"].shape[0] and not input_fill:
            add = self._fill_updates_multi(v, surf_new, a, k)
            delta = self._subset_scatter_add_multi(delta, add[:, :ns], a, k)
            if self._nX:
                upd_int = jnp.dot(
                    add[:, ns:], a["EsI"], precision=_EXACT,
                    preferred_element_type=v.dtype
                )
                v = self._subset_scatter_add_multi(v, upd_int, a, k)
        out = v + jnp.dot(delta, a["Es"], precision=_EXACT,
                          preferred_element_type=v.dtype)
        return jnp.where(
            a["node_valid"][None], out.reshape(k, nb, self.N3p), 0.0
        )

    def vmult_multi(self, bvk):
        """Multi-RHS vmult: bvk [n_rhs, n_bricks, N3p] -> same shape.

        Blocked formulation (k-major flattened rows): amortizes every static
        operand read across the RHS block; equal to stacked single vmults to
        rounding (tests/test_bricks.py::test_vmult_multi_matches_single)."""
        import jax as _jax
        from functools import partial

        if self._deformed:
            raise NotImplementedError(
                "vmult_multi does not support high_order_mapping; apply "
                "vmult per RHS (the deformed kernels are not k-batched)"
            )
        if self._plane_meta:
            raise NotImplementedError(
                "vmult_multi does not support face_planes=True; construct "
                "the engine with face_planes=False for multi-RHS use"
            )
        k = int(bvk.shape[0])
        cache = self.__dict__.setdefault("_jit_vmult_multi_k", {})
        if k not in cache:
            cache[k] = _jax.jit(partial(self._vmult_multi_impl, k=k))
        prec = self._matmul_precision
        with _jax.default_matmul_precision(prec):
            return cache[k](bvk, self._stage())
