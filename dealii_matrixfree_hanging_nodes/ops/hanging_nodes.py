"""In-register hanging-node constraint interpolation (capabilities C2, C12).

Analog of deal.II's FEEvaluationImplHangingNodes runners /
FEEvaluationHangingNodesFactory::apply (benchmark_00_likwid.cc:56-59,
README.md:27-57): a pure function of (1D subface matrices P, 9-bit compressed
masks, cell-local values) — no mesh access.

Algorithm (see ARCHITECTURE.md): for sweep axis t = 0..dim-1, every lattice
node lying on a constrained face plane with normal != t, or on a constrained
edge along t, is replaced by the 1D subface interpolation P_{s_t} applied
along t; all other nodes pass through. The OR-union of the per-entity node
sets makes cells with several constrained faces correct (shared edges are
interpolated exactly once per sweep). ``transpose=True`` applies the exact
adjoint (reversed sweep order, P^T against the masked input), so
gather+interpolate and its scatter counterpart are exact adjoints.

Vectorization-type analogs of the reference's three runners (HN_TYPE patch):
the caller chooses between applying this kernel to *all* cells (masked,
"vectorized/group"), to a gathered compact subset of constrained cells
("index"), or to a contiguous pre-sorted range ("sorted"/categorize) — see
MatrixFree.hn_mode.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..dof_handler import local_lattice

__all__ = ["apply_hanging_node_constraints", "hn_composite_matrix"]


def hn_composite_matrix(mask: int, P: np.ndarray, dim: int) -> np.ndarray:
    """Dense composite of the masked interpolation sweeps, built host-side.

    Returns Q [n_loc, n_loc] with  forward(u) = u @ Q  and, since the sweeps
    are exact adjoints, transpose(u) = u @ Q.T. Used by the brick engines to
    turn the HN application on a mask-sorted contiguous range into one
    matmul per distinct mask (the dense evolution of deal.II's "sorted"
    runner, README.md:27-57). Pure NumPy so setup never touches a device.
    """
    P = np.asarray(P, dtype=np.float64)
    n = P.shape[-1]
    p = n - 1
    lat = local_lattice(p, dim)
    n_loc = n**dim
    sub = [(mask >> d) & 1 for d in range(dim)]
    face = [(mask >> (dim + d)) & 1 for d in range(dim)]
    edge = [(mask >> (2 * dim + d)) & 1 for d in range(dim)] if dim == 3 else None

    v = np.eye(n_loc).reshape(n_loc, *([n] * dim))  # rows: input basis index
    for t in range(dim):
        mm = np.zeros(n_loc, dtype=bool)
        for d in range(dim):
            if d == t:
                continue
            if face[d]:
                mm |= lat[:, d] == sub[d] * p
        if dim == 3 and edge[t]:
            line = np.ones(n_loc, dtype=bool)
            for a2 in range(dim):
                if a2 != t:
                    line &= lat[:, a2] == sub[a2] * p
            mm |= line
        mmt = mm.reshape(*([n] * dim))
        ax = v.ndim - 1 - t
        vt = np.moveaxis(v, ax, -1)
        swept = np.moveaxis(np.einsum("ij,...j->...i", P[sub[t]], vt), -1, ax)
        v = np.where(mmt[None], swept, v)
    return v.reshape(n_loc, n_loc)


def _bits(masks: jnp.ndarray, shift: int) -> jnp.ndarray:
    return (masks >> shift) & 1


def _batched_sweep(v: jnp.ndarray, M: jnp.ndarray, t: int, transpose: bool):
    """Per-cell 1D contraction over spatial axis t. v: [m, n,..,n], M: [m,n,n]."""
    ax = v.ndim - 1 - t
    v = jnp.moveaxis(v, ax, -1)
    eq = "mji,m...j->m...i" if transpose else "mij,m...j->m...i"
    v = jnp.einsum(eq, M, v, preferred_element_type=v.dtype)
    return jnp.moveaxis(v, -1, ax)


def apply_hanging_node_constraints(
    values: jnp.ndarray,
    masks: jnp.ndarray,
    P: jnp.ndarray,
    dim: int,
    transpose: bool = False,
    n_components: int = 1,
) -> jnp.ndarray:
    """Apply (or transpose-apply) the hanging-node interpolation in-register.

    Parameters
    ----------
    values : [m, n_components * (p+1)^dim] cell-local coefficients after a
        plain gather (component-major blocks, matching the reference
        factory's n_components signature, benchmark_00_likwid.cc:56-59)
    masks  : [m] compressed constraint kinds (0 = unconstrained, identity)
    P      : [2, p+1, p+1] subface embedding matrices (ShapeInfo.P)
    n_components : vector-valued FE component count; each component block
        gets the same per-cell mask (the constraint structure is geometric)
    """
    n = P.shape[-1]
    p = n - 1
    m = values.shape[0]
    if n_components > 1:
        # fold components into the batch: same masks per component block
        vc = values.reshape(m * n_components, -1)
        mc = jnp.repeat(masks, n_components)
        out = apply_hanging_node_constraints(
            vc, mc, P, dim, transpose=transpose
        )
        return out.reshape(m, -1)
    masks = masks.astype(jnp.int32)
    lat = jnp.asarray(local_lattice(p, dim))  # [n_loc, dim] static

    sub = [_bits(masks, d) for d in range(dim)]
    face = [_bits(masks, dim + d) for d in range(dim)]
    edge = [_bits(masks, 2 * dim + d) for d in range(dim)] if dim == 3 else None

    def node_mask(t: int) -> jnp.ndarray:
        mm = jnp.zeros((m, n**dim), dtype=bool)
        for d in range(dim):
            if d == t:
                continue
            plane = (face[d][:, None] == 1) & (
                lat[None, :, d] == sub[d][:, None] * p
            )
            mm = mm | plane
        if dim == 3:
            line = edge[t][:, None] == 1
            for a in range(dim):
                if a == t:
                    continue
                line = line & (lat[None, :, a] == sub[a][:, None] * p)
            mm = mm | line
        return mm.reshape(m, *([n] * dim))

    v = values.reshape(m, *([n] * dim))
    Pm = jnp.asarray(P, dtype=values.dtype)
    order = reversed(range(dim)) if transpose else range(dim)
    for t in order:
        Mt = Pm[sub[t]]  # [m, n, n] per-cell subface matrix
        mk = node_mask(t)
        if transpose:
            masked = jnp.where(mk, v, 0)
            v = _batched_sweep(masked, Mt, t, transpose=True) + jnp.where(mk, 0, v)
        else:
            v = jnp.where(mk, _batched_sweep(v, Mt, t, transpose=False), v)
    return v.reshape(m, -1)
