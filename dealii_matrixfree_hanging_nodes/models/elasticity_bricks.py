"""Vector-valued linear elasticity on the brick engine (BASELINE stretch
configs; brick-layout evolution of the index-engine ElasticityOperator).

    a(u, v) = ∫ 2 mu eps(u):eps(v) + lambda (div u)(div v)

On Cartesian cube cells every block of the dim x dim component operator is
a short sum of Kronecker-separable terms over the brick's assembled 1D
factors, exactly like the Laplace main path (bricks.py):

    A_ck = mu δ_ck Σ_ax D_ax^T W D_ax  +  mu D_k^T W D_c  +  lam D_c^T W D_k

with D_a^T W D_b factoring per axis into {K1, G1, G1^T, M1}
(K1 = D^T W D, M1 = S^T W S, G1 = D^T W S). All factors scale uniformly
with the cell size (h^(dim-2) on cubes), so the per-brick scalar `geo`
multiplies every term — the coupled operator rides the same brick tensors,
HN chains, DSS and subset machinery as the scalar engine, with the
components batched on the trailing row axis ([rows, dim, n_loc]).

Reference parity: the CUDA/C++ reference is scalar Laplace throughout;
elasticity is the SURVEY §7 / BASELINE.json stretch family (vector-valued
FE with the same compressed HN constraint structure per component,
benchmark_00_likwid.cc:56-59 n_components signature).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..matrix_free import MatrixFree
from ..bricks import _EXACT, BrickLaplaceMM
from ..elements import shape_info

__all__ = ["BrickElasticity"]


def _kron_axes(facs):
    """Kronecker product over axes with x (axis 0) innermost — the brick
    node lattice order (local_lattice)."""
    A = facs[len(facs) - 1]
    for t in range(len(facs) - 2, -1, -1):
        A = np.kron(A, facs[t])
    return A


def _axis_factors(a_test, b_trial, dim):
    """Per-axis 1D factor names of D_a^T W D_b."""
    out = []
    for ax in range(dim):
        if ax == a_test == b_trial:
            out.append("K")
        elif ax == a_test:
            out.append("G")
        elif ax == b_trial:
            out.append("GT")
        else:
            out.append("M")
    return out


class BrickElasticity:
    """Coupled elasticity vmult on brick vectors [dim, n_bricks, N3p].

    Outputs are REDUCED (input-side constraint resolution, like the scalar
    engine's fill_mode="input"): hanging slots carry no meaning, exactly
    like the reference's post-distribute vectors."""

    def __init__(self, mf: MatrixFree, mu: float = 1.0, lam: float = 1.0,
                 brick_size: int | None = None,
                 matmul_precision: str = "highest"):
        if mf.high_order_mapping:
            raise NotImplementedError(
                "BrickElasticity uses the Cartesian brick factorization"
            )
        geo = mf._np["geo"]
        if not np.allclose(geo, geo[:, :1]):
            raise NotImplementedError(
                "BrickElasticity requires equal-axis (cube) cells"
            )
        self.mf = mf
        self.mu = float(mu)
        self.lam = float(lam)
        # the scalar engine supplies brick structure, HN chains, DSS and
        # subset machinery; input fill keeps outputs reduced
        self.mm = mm = BrickLaplaceMM(
            mf, brick_size, matmul_precision, fill_mode="input",
            face_planes=False,  # elasticity drives the per-cell chains
        )
        if mm._n_sub and mm._np_arrays["hn_sub"].shape[0] and (
            mm._chain_mode != "compact" or mm._flat_meta is None
        ):
            raise NotImplementedError(
                "constrained elasticity requires the compact chain schedules"
            )
        self._build_extras()
        self._jit = jax.jit(self._vmult_impl)
        self._arrays = None

    # ------------------------------------------------------------ assembly
    def _build_extras(self):
        mm, mf = self.mm, self.mf
        bs = mm.bs
        dim, B, NB, p = bs.dim, bs.B, bs.NB, bs.p
        n = p + 1
        mu, lam = self.mu, self.lam
        si = shape_info(p)
        w = si.quad_w
        M1 = np.einsum("q,qi,qj->ij", w, si.S, si.S)
        K1 = np.einsum("q,qi,qj->ij", w, si.D, si.D)
        G1 = np.einsum("q,qi,qj->ij", w, si.D, si.S)
        cellF = {"M": M1, "K": K1, "G": G1, "GT": G1.T}

        # brick-assembled 1D factors (cells share one size per brick; the
        # physical h scaling folds into the per-brick scalar `geo`)
        Fb = {}
        for name, F1 in cellF.items():
            Fbx = np.zeros((NB, NB))
            for c in range(B):
                sl = slice(c * p, c * p + n)
                Fbx[sl, sl] += F1
            Fb[name] = Fbx

        def terms(c, k):
            out = []
            if c == k:
                out += [(mu, _axis_factors(ax, ax, dim)) for ax in range(dim)]
            out.append((mu, _axis_factors(k, c, dim)))
            out.append((lam, _axis_factors(c, k, dim)))
            return out

        extras = {}
        dt = mf.dtype
        # element block matrices for the exceptional-subset corrections
        n_loc = n**dim
        Kel = np.zeros((dim, dim, n_loc, n_loc))
        for c in range(dim):
            for k in range(dim):
                for coeff, facs in terms(c, k):
                    Kel[c, k] += coeff * _kron_axes(
                        [cellF[f] for f in facs]
                    )
        extras["el_Kel"] = np.asarray(Kel, dtype=dt)

        if dim == 3:
            # plane scheme: each Kron term = Zfac ⊗ P(y,x); group per
            # (c, k) block by the z factor and precombine the planes
            plan = []  # per c: list of (k, z_name, plane_key)
            for c in range(3):
                entries = []
                for k in range(3):
                    groups = {}
                    for coeff, facs in terms(c, k):
                        groups.setdefault(facs[2], []).append((coeff, facs))
                    for zname, lst in groups.items():
                        P = np.zeros((NB * NB, NB * NB))
                        for coeff, facs in lst:
                            P += coeff * np.kron(Fb[facs[1]], Fb[facs[0]])
                        key = f"el_P{c}{k}_{zname}"
                        extras[key] = np.asarray(P, dtype=dt)
                        entries.append((k, zname, key))
                plan.append(entries)
            self._plan = plan
            for zname in ("M", "K", "G", "GT"):
                extras[f"el_z_{zname}"] = np.asarray(Fb[zname], dtype=dt)
        else:
            # 2D: one combined [NB^2, NB^2] matrix per block
            for c in range(2):
                for k in range(2):
                    A = np.zeros((NB * NB, NB * NB))
                    for coeff, facs in terms(c, k):
                        A += coeff * np.kron(Fb[facs[1]], Fb[facs[0]])
                    extras[f"el_A{c}{k}"] = np.asarray(A, dtype=dt)
        self._extras_np = extras

    def _stage(self):
        if self._arrays is None:
            a = dict(self.mm._stage())
            a.update({k: jnp.asarray(v) for k, v in self._extras_np.items()})
            self._arrays = a
        return self._arrays

    # ----------------------------------------------------------- main path
    def _main_apply(self, u_k, a):
        """Coupled separable main path: u_k [dim, nb, N3] -> [dim, nb, N3]."""
        mm = self.mm
        bs = mm.bs
        dim, NB, N3 = bs.dim, bs.NB, mm.N3
        nb = u_k.shape[1]
        dt = u_k.dtype
        if dim == 3:
            u3 = u_k.reshape(3, nb, NB, NB * NB)
            outs = []
            for c in range(3):
                acc = None
                for k, zname, pkey in self._plan[c]:
                    t = jnp.dot(u3[k], a[pkey].T, preferred_element_type=dt)
                    r = jnp.einsum(
                        "wz,bzr->bwr", a[f"el_z_{zname}"], t,
                        preferred_element_type=dt,
                    )
                    acc = r if acc is None else acc + r
                outs.append(acc.reshape(nb, N3))
            return jnp.stack(outs)
        outs = []
        for c in range(2):
            acc = None
            for k in range(2):
                r = jnp.dot(u_k[k], a[f"el_A{c}{k}"].T,
                            preferred_element_type=dt)
                acc = r if acc is None else acc + r
            outs.append(acc)
        return jnp.stack(outs)

    # ---------------------------------------------------------------- vmult
    def _vmult_impl(self, bvk, a, constraints: bool = True):
        mm = self.mm
        bs = mm.bs
        dim = bs.dim
        k = dim
        nb = bs.n_bricks
        C = bs.B**dim
        N3, N3p = mm.N3, mm.N3p

        v = self._main_apply(bvk[:, :, :N3], a) * a["geo"][None, :, None]
        v = jnp.pad(v, ((0, 0), (0, 0), (0, N3p - N3))).reshape(
            k * nb, N3p
        )
        bv = bvk.reshape(k * nb, N3p)

        if mm._n_sub:
            nsC = mm._n_sub * C
            u_sub = mm._take_sub_multi(bv, a, k)
            cols_u = mm._extract_cols(u_sub, a)  # [k*nsC, n_loc]
            u3 = jnp.swapaxes(cols_u.reshape(k, nsC, -1), 0, 1)
            # coupled cell kernel: out[n, c, i] = sum_kj Kel[c,k,i,j] u[n,k,j]
            plain3 = jnp.einsum(
                "nkj,ckij->nci", u3, a["el_Kel"],
                preferred_element_type=bv.dtype,
            ) * a["geo_cell_sub"][:, None, None]
            if constraints and a["hn_sub"].shape[0]:
                plain_hn = jnp.take(plain3, a["hn_sub"], axis=0)
                u_hat = self.mm._fill_rows(u3, a)  # [n_hn, k, n_loc] filled
                own = jnp.einsum(
                    "nkj,ckij->nci", u_hat, a["el_Kel"],
                    preferred_element_type=bv.dtype,
                ) * jnp.take(a["geo_cell_sub"], a["hn_sub"])[:, None, None]
                sub_raw = mm._hn_apply(own, a, transpose=True)
                dcols3 = mm._corr_compact(plain3, plain_hn, sub_raw, a)
            else:
                dcols3 = jnp.zeros_like(plain3)
                if a["absent_sub"].shape[0]:
                    dcols3 = dcols3.at[a["absent_sub"]].set(
                        -jnp.take(plain3, a["absent_sub"], axis=0)
                    )
            delta = jnp.swapaxes(dcols3, 0, 1).reshape(k * nsC, -1)
            v = mm._subset_scatter_add_multi(
                v, mm._scatter_cols(delta, a), a, k
            )

        # cross-brick DSS (outputs stay reduced: no fill pass)
        surf = jnp.dot(v, a["Es"].T, precision=_EXACT,
                       preferred_element_type=v.dtype)
        delta_s = mm._dss_surface_multi(surf, a, k) - surf
        out = v + jnp.dot(delta_s, a["Es"], precision=_EXACT,
                          preferred_element_type=v.dtype)
        return jnp.where(a["node_valid"][None], out.reshape(k, nb, N3p), 0.0)

    def vmult(self, bvk: jnp.ndarray) -> jnp.ndarray:
        """bvk: [dim, n_bricks, N3p] component-stacked brick vectors."""
        with jax.default_matmul_precision(self.mm._matmul_precision):
            return self._jit(bvk, self._stage())

    def vmult_plain(self, bvk: jnp.ndarray) -> jnp.ndarray:
        """Constraints-off variant (holes + DSS only) — the overhead-pair
        baseline of the window protocol (benchmark_01.cc:179-187 analog)."""
        if getattr(self, "_jit_plain", None) is None:
            from functools import partial
            self._jit_plain = jax.jit(
                partial(self._vmult_impl, constraints=False)
            )
        with jax.default_matmul_precision(self.mm._matmul_precision):
            return self._jit_plain(bvk, self._stage())

    # ------------------------------------------------------------ transfers
    def from_dof_vector(self, u) -> jnp.ndarray:
        """u: [n_dofs, dim] -> [dim, n_bricks, N3p]."""
        u = np.asarray(u)
        return jnp.stack(
            [self.mm.from_dof_vector(u[:, c]) for c in range(self.mf.dim)]
        )

    def to_dof_vector(self, bvk, zero_hanging: bool = False) -> np.ndarray:
        cols = [
            self.mm.to_dof_vector(bvk[c], zero_hanging=zero_hanging)
            for c in range(self.mf.dim)
        ]
        return np.stack(cols, axis=-1)
