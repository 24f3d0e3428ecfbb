# -*- coding: utf-8 -*-
"""Block cyclic reduction: log-depth exact factorization of the 2D operator.

Same block-tridiagonal system as :mod:`.block_direct` (the 9-point stencil
over axial lines), factorized by cyclic reduction instead of the sequential
block-LDL^T chain: eliminate the odd-numbered lines (their diagonal blocks
invert INDEPENDENTLY — one batched inverse over all of them), which yields a
half-size block-tridiagonal system over the even lines; recurse. Both the
factorization and every preconditioner application are ``log2(NZ)`` batched
stages of dense matmuls — the matmul-native schedule — versus the chain's NZ
sequential steps (factor) and 2xNZ-step scans per CG iteration (apply).

Math (exact block Gaussian elimination on a symmetric permutation — SPD is
preserved, no pivoting needed for SPD input): with D_i the diagonal blocks
and U_i the i->i+1 coupling (U_{i-1}^T couples i->i-1), eliminating odd i
gives, for even j,

    D'_j = D_j - U_{j-1}^T G_{j-1} U_{j-1} - U_j G_{j+1} U_j^T
    U'_j = -U_j G_{j+1} U_{j+1},          G_odd = D_odd^{-1}  (batched)
    b'_j = b_j - U_{j-1}^T (G b)_{j-1} - U_j (G b)_{j+1}
    x_odd = G ( b_odd - U_{j-1}^T x_{j-1} - U_j x_{j+1} )

Stored per level: symmetrized G_odd and the level's off-diagonals (float32 —
rounding-error amplification across log-depth chains is tiny compared to the
sequential chain's ~1e5x, see block_direct.py). Handles any NZ (no
power-of-two padding) via slice guards. Storage ~2x the LDL^T chain
(G stacks of all levels + dense off-diagonals).

Replaces the reference's sparse direct/CG hand-off (remo3d/
ngsolve_functions.py:46-56) on the 2D path; selected with
``preconditioner="direct"`` + ``direct_schedule="bcr"``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .block_direct import (
    _dense_line_blocks,
    _tri_diagonals_z,
    highest_matmul_precision,
)


def _dense_U(C):
    """Densify the i->i+1 coupling blocks: (B, NZ-1, NR, NR).

    U_i[r, r+d] = u_d[i, r] from the di=2 stencil row (see block_direct).
    """
    u_m, u_0, u_p = _tri_diagonals_z(C)  # (B, NZ, NR)
    u_m, u_0, u_p = u_m[:, :-1], u_0[:, :-1], u_p[:, :-1]
    nr = u_0.shape[-1]
    eye = jnp.eye(nr, dtype=C.dtype)
    up = jnp.pad(eye[1:, :], ((0, 1), (0, 0)))  # E_{+1}: [r, r+1]
    dn = jnp.pad(eye[:-1, :], ((1, 0), (0, 0)))  # E_{-1}: [r, r-1]
    return u_m[..., None] * dn + u_0[..., None] * eye + u_p[..., None] * up


def _sym_inv(S):
    G = jnp.linalg.inv(S)
    return 0.5 * (G + jnp.swapaxes(G, -1, -2))


def _mm(A, B):  # (B, m, NR, NR) x (B, m, NR, NR)
    return jnp.einsum("...ij,...jk->...ik", A, B)


def _mmT(A, B):
    return jnp.einsum("...ij,...kj->...ik", A, B)


def _mTm(A, B):
    return jnp.einsum("...ji,...jk->...ik", A, B)


@highest_matmul_precision
def bcr_factor(C, store_dtype=jnp.float32):
    """Cyclic-reduction factorization of the block-tridiagonal stencil operator.

    C: (B, NZ, NR, 3, 3) Dirichlet-eliminated stencil. Returns a pytree
    ``(levels, G_root)``: per level (G_odd, U_even, U_odd) and the final
    single-block inverse — consumed by :func:`bcr_apply`.
    """
    D = _dense_line_blocks(C)  # (B, NZ, NR, NR)
    U = _dense_U(C)  # (B, NZ-1, NR, NR)
    return bcr_factor_dense(D, U, store_dtype=store_dtype)


@highest_matmul_precision
def bcr_factor_dense(D, U, store_dtype=jnp.float32):
    """Generic dense-block cyclic reduction (any block size; 3D reuses this
    for levels >= 1 after a banded level-0 elimination, ops/block_bcr3d.py).

    D: (B, m, N, N) diagonal blocks; U: (B, m-1, N, N) i->i+1 couplings.
    """
    levels = []
    m = D.shape[1]
    while m > 1:
        Do = D[:, 1::2]  # odd diagonal blocks
        De = D[:, 0::2]
        Ue = U[:, 0::2]  # U_{2k}, k = 0..mo-1
        Uo = U[:, 1::2]  # U_{2k+1}
        G = _sym_inv(Do)
        mo, me = Do.shape[1], De.shape[1]
        n_uo = Uo.shape[1]

        GUeT = _mmT(G, Ue)  # G_k U_{2k}^T
        right = _mm(Ue, GUeT)  # U_{2k} G_k U_{2k}^T -> D_e[k], k < mo
        GUo = _mm(G[:, :n_uo], Uo)  # G_k U_{2k+1}
        left = _mTm(Uo, GUo)  # U^T G U -> D_e[k+1]
        pad = lambda a, lo, hi: jnp.pad(
            a, ((0, 0), (lo, hi), (0, 0), (0, 0))
        )
        D = De - pad(right, 0, me - mo) - pad(left, 1, me - 1 - n_uo)
        U = -_mm(Ue[:, :n_uo], GUo)  # (B, me-1, NR, NR)
        levels.append(
            (G.astype(store_dtype), Ue.astype(store_dtype), Uo.astype(store_dtype))
        )
        m = me
    G_root = _sym_inv(D).astype(store_dtype)  # (B, 1, NR, NR)
    return tuple(levels), G_root


@highest_matmul_precision
def bcr_apply(factors, b):
    """x = M^{-1} b via the cyclic-reduction factorization (log-depth, exact).

    factors: from :func:`bcr_factor`. b: (B, [S,] NZ, NR). Linear and SPD
    (symmetrized G blocks, symmetric elimination) — a valid PCG preconditioner
    and, at float32 rounding, an essentially exact inverse.
    """
    levels, G_root = factors
    dtype = b.dtype
    extra = b.ndim - 3  # optional solve axis

    def gmv(G, v):  # (B, m, NR, NR) x (B, [S,] m, NR)
        G = G.astype(dtype)
        if extra:
            return jnp.einsum("bmrc,bsmc->bsmr", G, v, preferred_element_type=dtype)
        return jnp.einsum("bmrc,bmc->bmr", G, v, preferred_element_type=dtype)

    def umv(Umat, v, transpose=False):  # coupling blocks on vectors
        Umat = Umat.astype(dtype)
        spec = "bmcr,bsmc->bsmr" if transpose else "bmrc,bsmc->bsmr"
        if not extra:
            spec = spec.replace("bsm", "bm")
        return jnp.einsum(spec, Umat, v, preferred_element_type=dtype)

    zpad = lambda a, lo, hi: jnp.pad(
        a, ((0, 0),) * (a.ndim - 2) + ((lo, hi), (0, 0))
    )

    def rec(lvl, b):
        if lvl == len(levels):
            return gmv(G_root, b)
        G, Ue, Uo = levels[lvl]
        mo, n_uo = G.shape[1], Uo.shape[1]
        b_o = b[..., 1::2, :]
        b_e = b[..., 0::2, :]
        me = b_e.shape[-2]
        w = gmv(G, b_o)
        # b'_e[k] = b_e[k] - U_{2k-1}^T w[k-1] - U_{2k} w[k]
        b_e = (
            b_e
            - zpad(umv(Uo, w[..., :n_uo, :], transpose=True), 1, me - 1 - n_uo)
            - zpad(umv(Ue, w), 0, me - mo)
        )
        x_e = rec(lvl + 1, b_e)
        # x_o[k] = G[k] (b_o[k] - U_{2k}^T x_e[k] - U_{2k+1} x_e[k+1])
        t = b_o - umv(Ue, x_e[..., :mo, :], transpose=True)
        t = t - zpad(umv(Uo, x_e[..., 1 : 1 + n_uo, :]), 0, mo - n_uo)
        x_o = gmv(G, t)
        # interleave
        x = jnp.zeros_like(b)
        x = x.at[..., 0::2, :].set(x_e)
        return x.at[..., 1::2, :].set(x_o)

    return rec(0, b)
