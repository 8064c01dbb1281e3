"""Matrix-free Laplace operator (benchmark_03.h:210-358 analog — both the
host LaplaceOperator and the CUDA LaplaceOperatorLocal/Quad functors collapse
into this one jitted cell kernel).

All device tensors are threaded through the jitted program as arguments
(mf.arrays pytree) — closing over them would embed multi-MB constants in the
HLO and explode compile time."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..matrix_free import MatrixFree
from ..ops.sum_factorization import evaluate_gradients, integrate_gradients

__all__ = ["LaplaceOperator", "laplace_cell_kernel"]


def laplace_cell_kernel(mf: MatrixFree):
    """Per-cell-batch quadrature kernel (u_loc, arrays) -> v_loc.

    evaluate(gradients) → submit_gradient(geo * get_gradient) →
    integrate(gradients), sum-factorized (benchmark_01.h:600-608).
    """
    dim = mf.dim

    if not mf.high_order_mapping:

        def kernel(u, a):
            g = evaluate_gradients(u, a["S"], a["Dc"], dim)  # [c, dim, nq]
            g = g * a["geo"][:, :, None] * a["quad_w"][None, None, :]
            return integrate_gradients(g, a["S"], a["Dc"], dim)

        return kernel

    # deformed mapping: per-quad-point symmetric metric (packed upper triangle)
    pairs = [(x, y) for x in range(dim) for y in range(x, dim)]

    def kernel(u, a):
        g = evaluate_gradients(u, a["S"], a["Dc"], dim)
        out = [jnp.zeros_like(g[:, 0]) for _ in range(dim)]
        for k, (x, y) in enumerate(pairs):
            out[x] = out[x] + a["geo"][:, :, k] * g[:, y]
            if x != y:
                out[y] = out[y] + a["geo"][:, :, k] * g[:, x]
        return integrate_gradients(jnp.stack(out, axis=1), a["S"], a["Dc"], dim)

    return kernel


class LaplaceOperator:
    """vmult = cell_loop(laplace kernel); fast or legacy constraint path."""

    def __init__(self, mf: MatrixFree, constraints: bool = True, slow: bool = False,
                 matmul_precision: str = "highest"):
        self.mf = mf
        self.constraints = constraints
        self.slow = slow
        self._matmul_precision = matmul_precision
        kernel = laplace_cell_kernel(mf)

        def _vmult(src, arrays):
            return mf.cell_loop(
                kernel, src, constraints=constraints, slow=slow, arrays=arrays
            )

        self._jit = jax.jit(_vmult)
        self._arrays = mf.arrays

    def vmult(self, src: jnp.ndarray) -> jnp.ndarray:
        # "highest" keeps the f32 contractions in full f32 products
        # (XLA's GPU default for f32 dots may use TF32)
        with jax.default_matmul_precision(self._matmul_precision):
            return self._jit(src, self._arrays)

    def __call__(self, src: jnp.ndarray) -> jnp.ndarray:
        return self.vmult(src)
