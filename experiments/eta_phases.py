"""Phase ablation of the brick-engine HN overhead (eta work).

Times the constrained brick vmult with HN-specific phases peeled off, all
interleaved in one window (utils.timing.repeat_timed_paired), to
locate where the constrained-minus-plain time goes. Reference pair being
modeled: benchmark_03.h:510-532 (±constraints vmult).

  python experiments/eta_phases.py [nref] [degree]
"""

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


def main(nref=7, degree=4):
    t = mfhn.create_quadrant(3, nref)
    mf = MatrixFree(t, degree, dtype=np.float32)
    op = BrickLaplaceMM(mf)
    src = np.random.default_rng(0).standard_normal(
        (op.bs.n_bricks, op.N3p)).astype(np.float32)
    a = op._stage()
    bv0 = jnp.asarray(src)
    scale = jnp.float32(1e-3)

    def correction_only(bv):
        # main + correction (no DSS, no fill)
        v = op._main_apply(bv, a) * a["geo"][:, None]
        if op._n_sub:
            u_sub = jnp.take(bv, a["sub_ids"], axis=0)
            cols_u = op._extract_cols(u_sub, a)
            plain = jnp.dot(cols_u, a["K"].T,
                            preferred_element_type=bv.dtype)
            plain = plain * a["geo_cell_sub"][:, None]
            final = plain
            if a["absent_sub"].shape[0]:
                final = final.at[a["absent_sub"]].set(0.0)
            if a["hn_sub"].shape[0]:
                own = jnp.take(final, a["hn_sub"], axis=0)
                sub_raw = op._hn_apply(own, a, transpose=True)
                final = final.at[a["hn_sub"]].set(sub_raw)
                for lv in sorted(op._levels, reverse=True):
                    lz = a["level_zero"][lv]
                    zeroed = jnp.take(final, lz["lin"], axis=0) * lz["keep"]
                    final = op._fold_level(
                        final, a["transfers_b"][lv], fill=False)
                    final = final.at[lz["lin"]].set(zeroed)
            delta = final - plain
            v = op._subset_scatter_add(v, op._scatter_cols(delta, a), a)
        return v

    def no_fill(bv):
        # main + correction + DSS (skip step 4)
        v = correction_only(bv)
        surf = jnp.dot(v, a["Es"].T, preferred_element_type=v.dtype)
        surf_new = op._dss_surface(surf, a)
        return jnp.where(
            a["node_valid"],
            v + jnp.dot(surf_new - surf, a["Es"],
                        preferred_element_type=v.dtype),
            0.0,
        )

    C = op.bs.B ** op.bs.dim

    def fill_chain(bv):
        # full fill computation chain, but the final scatter pair replaced
        # by a token write — isolates fold/hn chain cost from scatter cost
        v = no_fill(bv)
        if op._n_sub and a["hn_sub"].shape[0]:
            v_sub = jnp.take(v, a["sub_ids"], axis=0)
            cols2 = op._extract_cols(v_sub, a)
            orig_rows = jnp.take(cols2, a["hn_sub"], axis=0)
            for lv in sorted(op._levels):
                lz = a["level_zero"][lv]
                cols2 = cols2.at[lz["lin"]].set(
                    jnp.take(cols2, lz["lin"], axis=0) * lz["keep"]
                )
                cols2 = op._fold_level(cols2, a["transfers_b"][lv], fill=True)
            sub2 = op._hn_apply(
                jnp.take(cols2, a["hn_sub"], axis=0), a, transpose=False)
            diff = sub2 - orig_rows
            v = v.at[0, :1].add(jnp.sum(diff) * 1e-30)
        return v

    jco = jax.jit(lambda x: correction_only(x * scale))
    jnf = jax.jit(lambda x: no_fill(x * scale))
    jfc = jax.jit(lambda x: fill_chain(x * scale))

    def with_prec(f):
        # match the operator's precision context (vmult/vmult_plain run
        # tf32); without this the ablation variants time bf16 matmuls
        def g(x):
            with jax.default_matmul_precision("highest"):
                return f(x)
        return g

    variants = {
        "plain": lambda x: op.vmult_plain(x * scale),
        "corr_only": with_prec(jco),
        "no_fill": with_prec(jnf),
        "fill_chain": with_prec(jfc),
        "full": lambda x: op.vmult(x * scale),
    }
    names = list(variants)
    results = repeat_timed_paired(
        [variants[n] for n in names], [bv0] * len(names),
        n_reps=60, n_trials=4)
    base = results[0].min
    for n, r in zip(names, results):
        print(f"{n:<12} min {r.min*1e3:8.3f} ms  avg {r.avg*1e3:8.3f} ms  "
              f"vs plain {100*(r.min/base-1):+6.2f}%")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 7,
         int(sys.argv[2]) if len(sys.argv) > 2 else 4)
