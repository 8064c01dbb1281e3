"""Sum-factorized cell evaluation (capability C1).

Analog of FEEvaluation::evaluate/integrate(EvaluationFlags::gradients)
(benchmark_01.h:600-608): batched tensor contractions over the (p+1)^dim
cell lattice, cells on the leading dimension so XLA maps the 1D sweeps onto
batched matmuls.

Uses the collocation-basis trick: values at quadrature points are computed
with dim sweeps of the 1D interpolation matrix S, then each gradient
component with one sweep of the collocation derivative Dc — 2*dim sweeps per
evaluate instead of dim*(dim+1) for the naive form. ``integrate`` is the
exact transpose (adjoint), preserving operator symmetry bit-for-bit.

Convention: local flat index l = ix + n*iy + n^2*iz, so a cell tensor
reshaped to [..., n, n, n] has axes (z, y, x); spatial axis t lives at array
axis ``ndim - 1 - t``.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "sweep",
    "evaluate_values",
    "evaluate_gradients",
    "integrate_values",
    "integrate_gradients",
]


def _spatial_axis(ndim: int, t: int) -> int:
    return ndim - 1 - t


def sweep(u: jnp.ndarray, M: jnp.ndarray, t: int) -> jnp.ndarray:
    """Contract 1D matrix M [q, i] over spatial axis t of u [cells, *lattice]."""
    ax = _spatial_axis(u.ndim, t)
    u = jnp.moveaxis(u, ax, -1)
    u = jnp.einsum("qi,...i->...q", M, u, preferred_element_type=u.dtype)
    return jnp.moveaxis(u, -1, ax)


def _to_lattice(u: jnp.ndarray, dim: int, n: int) -> jnp.ndarray:
    return u.reshape(u.shape[0], *([n] * dim))


def evaluate_values(u, S, dim):
    """Nodal coefficients -> values at quadrature points. u: [cells, n^dim]."""
    n = S.shape[1]
    v = _to_lattice(u, dim, n)
    for t in range(dim):
        v = sweep(v, S, t)
    return v.reshape(u.shape[0], -1)


def evaluate_gradients(u, S, Dc, dim):
    """Nodal coefficients -> reference-space gradients at quadrature points.

    Returns [cells, dim, n_q] (gradient component d = d/d x_d on the unit cell).
    """
    n = S.shape[1]
    v = _to_lattice(u, dim, n)
    for t in range(dim):
        v = sweep(v, S, t)  # collocation values at quad points
    grads = [sweep(v, Dc, t).reshape(u.shape[0], -1) for t in range(dim)]
    return jnp.stack(grads, axis=1)


def integrate_values(q, S, dim):
    """Adjoint of evaluate_values. q: [cells, n_q] -> [cells, n^dim]."""
    n = S.shape[1]
    v = _to_lattice(q, dim, n)
    for t in reversed(range(dim)):
        v = sweep(v, S.T, t)
    return v.reshape(q.shape[0], -1)


def integrate_gradients(qg, S, Dc, dim):
    """Adjoint of evaluate_gradients. qg: [cells, dim, n_q] -> [cells, n^dim]."""
    n = S.shape[1]
    cells = qg.shape[0]
    acc = None
    for t in range(dim):
        g = sweep(_to_lattice(qg[:, t, :], dim, n), Dc.T, t)
        acc = g if acc is None else acc + g
    for t in reversed(range(dim)):
        acc = sweep(acc, S.T, t)
    return acc.reshape(cells, -1)
