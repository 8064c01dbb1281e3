"""Fine-grained phase ablation of the brick-engine HN overhead (round 4).

Decomposes constrained-minus-plain into cumulative phases, all timed
interleaved in one window (utils.timing.repeat_timed_paired).
Uses the hybrid fill read side (volume extraction). Reference pair being
modeled: benchmark_03.h:510-532 (±constraints vmult).

Phases (cumulative, each adds one cost component):
  plain        constraints-off vmult (the eta denominator)
  chain1       + correction fold/HN chain, token write (no corr scatter)
  corr         + corr materialization (scatter_cols) and its surf/DSS merge
  fill_x       + fill read side: delta->subset volume + conv extraction
  fill_chain   + fill fold/HN chain, token write
  full         + EFX write-back, coverage divide, final subset scatter

  python experiments/eta_phases2.py [nref] [degree] [geometry]
"""

import os
import sys
import numpy as np
import jax
import jax.numpy as jnp

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM
from dealii_matrixfree_hanging_nodes.utils.timing import repeat_timed_paired


def main(nref=7, degree=4, geometry="quadrant"):
    t = mfhn.create_geometry(geometry, 3, nref)
    mf = MatrixFree(t, degree, dtype=np.float32)
    op = BrickLaplaceMM(mf, fill_mode=os.environ.get("BRICK_FILL", "hybrid"))
    src = np.random.default_rng(0).standard_normal(
        (op.bs.n_bricks, op.N3p)).astype(np.float32)
    a = op._stage()
    bv0 = jnp.asarray(src)
    scale = jnp.float32(1e-3)

    def token(v, x):
        return v.at[0, :1].add(jnp.sum(x) * 1e-30)

    def correction_chain(bv):
        """main + subset K apply + HN^T/fold chain -> (v, plain, final)."""
        v = op._main_apply(bv, a) * a["geo"][:, None]
        u_sub = op._take_sub(bv, a)
        cols_u = op._extract_cols(u_sub, a)
        plain = jnp.dot(cols_u, a["K"].T, preferred_element_type=bv.dtype)
        plain = plain * a["geo_cell_sub"][:, None]
        final = plain
        if a["absent_sub"].shape[0]:
            final = final.at[a["absent_sub"]].set(0.0)
        own = jnp.take(final, a["hn_sub"], axis=0)
        sub_raw = op._hn_apply(own, a, transpose=True)
        final = final.at[a["hn_sub"]].set(sub_raw)
        for lv in sorted(op._levels, reverse=True):
            lz = a["level_zero"][lv]
            zeroed = jnp.take(final, lz["lin"], axis=0) * lz["keep"]
            final = op._fold_level(final, a["transfers_b"][lv], fill=False)
            final = final.at[lz["lin"]].set(zeroed)
        return v, plain, final

    def chain1(bv):
        # chain computed, result folded into a token; the DSS runs as in
        # plain (no corr merge)
        v, plain, final = correction_chain(bv)
        v = token(v, final)
        surf = jnp.dot(v, a["Es"].T, preferred_element_type=bv.dtype)
        surf_new = op._dss_surface(surf, a)
        return jnp.where(
            a["node_valid"],
            v + jnp.dot(surf_new - surf, a["Es"],
                        preferred_element_type=bv.dtype),
            0.0,
        )

    def corr_parts(bv):
        """Everything through the corr merge; returns pieces for reuse."""
        v, plain, final = correction_chain(bv)
        delta = final - plain
        corr = op._scatter_cols(delta, a)
        surf = jnp.dot(v, a["Es"].T, preferred_element_type=bv.dtype)
        corr_surf = jnp.dot(corr, a["Es"].T, preferred_element_type=bv.dtype)
        surf = op._subset_scatter_add(surf, corr_surf, a)
        surf_new = op._dss_surface(surf, a)
        dlt = surf_new - surf
        return v, corr, dlt

    def corr(bv):
        v, c, dlt = corr_parts(bv)
        out = v + jnp.dot(dlt, a["Es"], preferred_element_type=bv.dtype)
        out = op._subset_scatter_add(out, c, a)
        return jnp.where(a["node_valid"], out, 0.0)

    def fill_x(bv):
        v, c, dlt = corr_parts(bv)
        v_sub = op._take_sub(v, a) + c
        v_sub_new = v_sub + jnp.dot(
            op._take_sub(dlt, a), a["Es"], preferred_element_type=bv.dtype)
        cols2 = op._extract_cols(v_sub_new, a)
        out = v + jnp.dot(dlt, a["Es"], preferred_element_type=bv.dtype)
        out = op._subset_scatter_add(out, c, a)
        out = token(out, cols2)
        return jnp.where(a["node_valid"], out, 0.0)

    def fill_chain(bv):
        v, c, dlt = corr_parts(bv)
        v_sub = op._take_sub(v, a) + c
        v_sub_new = v_sub + jnp.dot(
            op._take_sub(dlt, a), a["Es"], preferred_element_type=bv.dtype)
        cols2 = op._extract_cols(v_sub_new, a)
        orig_rows = jnp.take(cols2, a["hn_sub"], axis=0)
        for lv in sorted(op._levels):
            lz = a["level_zero"][lv]
            cols2 = cols2.at[lz["lin"]].set(
                jnp.take(cols2, lz["lin"], axis=0) * lz["keep"])
            cols2 = op._fold_level(cols2, a["transfers_b"][lv], fill=True)
        sub2 = op._hn_apply(
            jnp.take(cols2, a["hn_sub"], axis=0), a, transpose=False)
        diff = sub2 - orig_rows
        out = v + jnp.dot(dlt, a["Es"], preferred_element_type=bv.dtype)
        out = op._subset_scatter_add(out, c, a)
        out = token(out, diff)
        return jnp.where(a["node_valid"], out, 0.0)

    jc1 = jax.jit(lambda x: chain1(x * scale))
    jco = jax.jit(lambda x: corr(x * scale))
    jfx = jax.jit(lambda x: fill_x(x * scale))
    jfc = jax.jit(lambda x: fill_chain(x * scale))

    def with_prec(f):
        def g(x):
            with jax.default_matmul_precision("highest"):
                return f(x)
        return g

    variants = {
        "plain": lambda x: op.vmult_plain(x * scale),
        "chain1": with_prec(jc1),
        "corr": with_prec(jco),
        "fill_x": with_prec(jfx),
        "fill_chain": with_prec(jfc),
        "full": lambda x: op.vmult(x * scale),
    }
    names = list(variants)
    results = repeat_timed_paired(
        [variants[n] for n in names], [bv0] * len(names),
        n_reps=60, n_trials=4)
    base = results[0].min
    prev = None
    for n, r in zip(names, results):
        inc = "" if prev is None else f"  (+{(r.min-prev)*1e3:6.3f} ms)"
        print(f"{n:<12} min {r.min*1e3:8.3f} ms  avg {r.avg*1e3:8.3f} ms  "
              f"vs plain {100*(r.min/base-1):+7.2f}%{inc}")
        prev = r.min
    print("ETA-PHASES2-DONE")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 7,
         int(sys.argv[2]) if len(sys.argv) > 2 else 4,
         sys.argv[3] if len(sys.argv) > 3 else "quadrant")
