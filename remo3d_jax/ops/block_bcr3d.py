# -*- coding: utf-8 -*-
"""Block cyclic reduction for the 3D operator: log-depth factor AND apply.

The 27-point stencil is block-tridiagonal over axial planes with 9-point-
banded (NPR x NPR) blocks (see :mod:`.block_direct3d`). The sequential
block-LDL^T scan factors it in NZ dependent steps and applies it with two
NZ-step scans per CG iteration; cyclic reduction replaces both with
``log2(NZ)`` batched stages of dense matmuls — the matmul-native schedule.

Level 0 is specialized to the banded structure: the odd-plane diagonal
blocks are densified and inverted in one batched pass (``z_block``-grouped
under ``lax.map`` to bound inversion workspace), and the Schur products
U G U^T / U^T G U / U G U use the shifted-diagonal banded helpers instead of
materializing dense U. The reduced even-plane system has dense blocks and is
handed to the generic dense recursion (:func:`.block_bcr.bcr_factor_dense`).

Storage: level-0 G (NZ/2 dense blocks) + dense levels (~NZ/2 G + ~NZ/2 U'),
i.e. ~1.5x the scan factorization — callers cap 3D chunks accordingly
(parallel/runtime.py budget logic). SPD is preserved at every level (block
Gaussian elimination under a symmetric permutation, symmetrized inverses).

Replaces remo3d/ngsolve_functions.py:46-56 + ngsolve_functions_gpu.py:41-47
on the 3D path; selected with ``precond3d="direct"`` +
``direct_schedule="bcr"``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .block_direct import highest_matmul_precision

from .block_bcr import bcr_apply, bcr_factor_dense
from .block_direct3d import (
    _PLANE_OFFS,
    _banded_matmul_left,
    _banded_matmul_right,
    _banded_matvec,
    _dense_block,
    _flat_offset,
    _plane_coefs,
)


def _transpose_coefs(coefs, nr: int):
    """Diagonals of U^T from the diagonals of U (same trick as l_coefs in
    block_direct3d: the (dp,dr) diagonal of U^T is the (-dp,-dr) plane of U
    rolled by the flat offset; validity masks applied at the use site)."""
    out = []
    for k, (dp, dr) in enumerate(_PLANE_OFFS):
        off = _flat_offset(dp, dr, nr)
        u_md = coefs[len(_PLANE_OFFS) - 1 - k]
        out.append(jnp.roll(u_md, -off, axis=-1))
    return out


def _sym_inv_blocked(S, z_block: int):
    """Batched symmetrized inverse, grouped over the leading m axis to bound
    LU workspace: S (B, m, N, N)."""
    B, m = S.shape[0], S.shape[1]
    if m <= z_block:
        G = jnp.linalg.inv(S)
        return 0.5 * (G + jnp.swapaxes(G, -1, -2))
    mp = -(-m // z_block) * z_block
    eye = jnp.eye(S.shape[-1], dtype=S.dtype)
    Sp = jnp.concatenate(
        [S, jnp.broadcast_to(eye, (B, mp - m) + S.shape[2:])], axis=1
    )
    Sb = jnp.moveaxis(Sp, 1, 0).reshape(
        (mp // z_block, z_block, B) + S.shape[2:]
    )

    def inv_one(Sk):
        G = jnp.linalg.inv(Sk)
        return 0.5 * (G + jnp.swapaxes(G, -1, -2))

    Gb = jax.lax.map(inv_one, Sb)
    return jnp.moveaxis(Gb.reshape((mp, B) + S.shape[2:]), 0, 1)[:, :m]


@highest_matmul_precision
def bcr_factor_3d(C3, np_: int, nr: int, z_block: int = 8, store_dtype=jnp.float32):
    """Factorize the banded-block-tridiagonal 27-point operator by cyclic
    reduction. C3: (B, NZ, NP, NR, 27) Dirichlet-eliminated stencil.

    Returns ``(lvl0, dense_factors)``: level-0 (G_odd, Ue_coefs, Uo_coefs)
    with banded couplings kept as 9 coefficient planes, and the dense
    recursion factors of the even-plane Schur system.
    """
    B, nz = C3.shape[0], C3.shape[1]
    npr = np_ * nr
    diag = _plane_coefs(C3, 0, np_, nr)  # 9 x (B, NZ, NPR)
    up = _plane_coefs(C3, 1, np_, nr)  # U_i, i = 0..NZ-2 valid (last plane unused)

    d_odd = [c[:, 1::2] for c in diag]
    d_even = [c[:, 0::2] for c in diag]
    ue = [c[:, 0:-1:2] for c in up]  # U_{2k}, k = 0..mo-1
    uo = [c[:, 1:-1:2] for c in up]  # U_{2k+1}

    D_odd = _dense_block(d_odd, np_, nr, promote_diag=True)  # (B, mo, NPR, NPR)
    G = _sym_inv_blocked(D_odd, z_block)
    mo = G.shape[1]
    n_uo = uo[0].shape[1]

    ueT = _transpose_coefs(ue, nr)
    uoT = _transpose_coefs(uo, nr)

    # Schur products with banded couplings: right_k = U_{2k} G_k U_{2k}^T,
    # left_k = U_{2k+1}^T G_k U_{2k+1}, U'_k = -U_{2k} G_k U_{2k+1}.
    UeG = _banded_matmul_left(ue, G, np_, nr)  # U_{2k} G_k
    right = _banded_matmul_right(UeG, ueT, np_, nr)
    UoTG = _banded_matmul_left(uoT, G[:, :n_uo], np_, nr)  # U^T G
    left = _banded_matmul_right(UoTG, uo, np_, nr)
    U1 = -_banded_matmul_right(UeG[:, :n_uo], uo, np_, nr)

    D_even = _dense_block(d_even, np_, nr, promote_diag=True)
    me = D_even.shape[1]
    pad = lambda a, lo, hi: jnp.pad(a, ((0, 0), (lo, hi), (0, 0), (0, 0)))
    D1 = D_even - pad(right, 0, me - mo) - pad(left, 1, me - 1 - n_uo)

    dense_factors = bcr_factor_dense(D1, U1, store_dtype=store_dtype)
    lvl0 = (
        G.astype(store_dtype),
        [c.astype(store_dtype) for c in ue],
        [c.astype(store_dtype) for c in uo],
    )
    return lvl0, dense_factors


@highest_matmul_precision
def bcr_apply_3d(factors, b, np_: int, nr: int):
    """x = M^{-1} b. b: (B, [S,] NZ, NP, NR); exact inverse at f32 rounding.

    The coincident-axis (pole) DOFs stay untied here; callers wrap in
    ``pole_project`` exactly as for the scan-based apply."""
    lvl0, dense_factors = factors
    G, ue, uo = lvl0
    dtype = b.dtype
    nz = b.shape[-3]
    npr = np_ * nr
    extra = b.ndim - 4
    bz = b.reshape(b.shape[:-3] + (nz, npr))
    mo, n_uo = G.shape[1], uo[0].shape[1]

    def gmv(Gm, v):
        Gm = Gm.astype(dtype)
        if extra:
            return jnp.einsum("bmrc,bsmc->bsmr", Gm, v, preferred_element_type=dtype)
        return jnp.einsum("bmrc,bmc->bmr", Gm, v, preferred_element_type=dtype)

    def umv(coefs, v):  # banded coupling on per-plane vectors (..., m, NPR)
        cs = [c.astype(dtype) for c in coefs]
        if extra:
            cs = [c[:, None] for c in cs]
        return _banded_matvec(cs, v, np_, nr)

    ueT = _transpose_coefs(ue, nr)
    uoT = _transpose_coefs(uo, nr)
    zpad = lambda a, lo, hi: jnp.pad(
        a, ((0, 0),) * (a.ndim - 2) + ((lo, hi), (0, 0))
    )

    b_o = bz[..., 1::2, :]
    b_e = bz[..., 0::2, :]
    me = b_e.shape[-2]
    w = gmv(G, b_o)
    b_e = (
        b_e
        - zpad(umv(uoT, w[..., :n_uo, :]), 1, me - 1 - n_uo)
        - zpad(umv(ue, w), 0, me - mo)
    )
    x_e = bcr_apply(dense_factors, b_e)
    t = b_o - umv(ueT, x_e[..., :mo, :])
    t = t - zpad(umv(uo, x_e[..., 1 : 1 + n_uo, :]), 0, mo - n_uo)
    x_o = gmv(G, t)
    x = jnp.zeros_like(bz)
    x = x.at[..., 0::2, :].set(x_e)
    x = x.at[..., 1::2, :].set(x_o)
    return x.reshape(b.shape)
