"""Phase ablation of the INPUT-fill brick vmult (round 4).

Cumulative phases:
  plain      constraints-off vmult
  ichain     + input-side fill chain (fold/HN on cols_u) + K(u_hat), token
  cchain     + HN^T + correction fold chain, token (no corr scatter)
  full       + delta E scatter, corr surf merge, final subset add

  python experiments/eta_phases_input.py [nref] [degree] [geometry]
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


def main(nref=7, degree=4, geometry="quadrant"):
    t = mfhn.create_geometry(geometry, 3, nref)
    mf = MatrixFree(t, degree, dtype=np.float32)
    op = BrickLaplaceMM(mf, fill_mode="input")
    src = np.random.default_rng(0).standard_normal(
        (op.bs.n_bricks, op.N3p)).astype(np.float32)
    a = op._stage()
    bv0 = jnp.asarray(src)
    scale = jnp.float32(1e-3)

    def token(v, x):
        return v.at[0, :1].add(jnp.sum(x) * 1e-30)

    def base(bv):
        v = op._main_apply(bv, a) * a["geo"][:, None]
        u_sub = op._take_sub(bv, a)
        cols_u = op._extract_cols(u_sub, a)
        plain = jnp.dot(cols_u, a["K"].T, preferred_element_type=bv.dtype)
        plain = plain * a["geo_cell_sub"][:, None]
        return v, cols_u, plain

    def dss(v):
        surf = jnp.dot(v, a["Es"].T, preferred_element_type=v.dtype)
        surf_new = op._dss_surface(surf, a)
        return jnp.where(
            a["node_valid"],
            v + jnp.dot(surf_new - surf, a["Es"],
                        preferred_element_type=v.dtype),
            0.0,
        )

    def corr_chain(bv):
        v, cols_u, plain = base(bv)
        u_hat = op._fill_rows(cols_u, a)
        own = jnp.dot(u_hat, a["K"].T, preferred_element_type=bv.dtype
                      ) * jnp.take(a["geo_cell_sub"], a["hn_sub"])[:, None]
        final = plain
        if a["absent_sub"].shape[0]:
            final = final.at[a["absent_sub"]].set(0.0)
        sub_raw = op._hn_apply(own, a, transpose=True)
        final = final.at[a["hn_sub"]].set(sub_raw)
        if op._flat_meta:
            final = op._fold_chain_flat(final, a, "corr")
            lin = a["flat_lz_lin"]
            final = final.at[lin].set(
                jnp.take(final, lin, axis=0) * a["flat_lz_keep"])
        else:
            for lv in sorted(op._levels, reverse=True):
                lz = a["level_zero"][lv]
                zeroed = jnp.take(final, lz["lin"], axis=0) * lz["keep"]
                final = op._fold_level(final, a["transfers_b"][lv], fill=False)
                final = final.at[lz["lin"]].set(zeroed)
        return v, plain, final

    def ichain(bv):
        v, cols_u, plain = base(bv)
        u_hat = op._fill_rows(cols_u, a)
        own = jnp.dot(u_hat, a["K"].T, preferred_element_type=bv.dtype
                      ) * jnp.take(a["geo_cell_sub"], a["hn_sub"])[:, None]
        return dss(token(v, own))

    def cchain(bv):
        v, plain, final = corr_chain(bv)
        return dss(token(v, final))

    def wdelta(bv):
        # + delta materialization and E scatter into corr, token the merge
        v, plain, final = corr_chain(bv)
        delta = final - plain
        corr = op._scatter_cols(delta, a)
        return dss(token(v, corr))

    jic = jax.jit(lambda x: ichain(x * scale))
    jcc = jax.jit(lambda x: cchain(x * scale))
    jwd = jax.jit(lambda x: wdelta(x * scale))

    def with_prec(f):
        def g(x):
            with jax.default_matmul_precision("highest"):
                return f(x)
        return g

    variants = {
        "plain": lambda x: op.vmult_plain(x * scale),
        "ichain": with_prec(jic),
        "cchain": with_prec(jcc),
        "wdelta": with_prec(jwd),
        "full": lambda x: op.vmult(x * scale),
    }
    names = list(variants)
    results = repeat_timed_paired(
        [variants[n] for n in names], [bv0] * len(names),
        n_reps=60, n_trials=4)
    base_t = results[0].min
    prev = None
    for n, r in zip(names, results):
        inc = "" if prev is None else f"  (+{(r.min-prev)*1e3:6.3f} ms)"
        print(f"{n:<8} min {r.min*1e3:8.3f} ms  avg {r.avg*1e3:8.3f} ms  "
              f"vs plain {100*(r.min/base_t-1):+7.2f}%{inc}")
        prev = r.min
    print("ETA-PHASES-INPUT-DONE")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 7,
         int(sys.argv[2]) if len(sys.argv) > 2 else 4,
         sys.argv[3] if len(sys.argv) > 3 else "quadrant")
