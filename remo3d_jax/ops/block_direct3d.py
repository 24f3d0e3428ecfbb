# -*- coding: utf-8 -*-
"""Batched banded-block-tridiagonal direct factorization of the 3D operator.

The 27-point stencil is block-tridiagonal over axial planes: plane i couples
only to planes i±1, with blocks that are 9-point banded in the flattened
(p, r) index. Exactly like :mod:`.block_direct` (2D), one batch's operator
serves all S solves (workers/worker.py:104-110), so a single block-LDL^T per
batch amortizes, and the Schur-complement inverses G_i ≈ S_i^{-1} are formed
EXPLICITLY (symmetrized, float32 — the sweep recurrences amplify storage
error ~1e5x, see :mod:`.block_direct`) so the preconditioner application is
two batched-matmul sweeps — replacing the ~10^2-iteration ADI
line-CG of the dipping path with a handful of direct-preconditioned CG
iterations.

The dense blocks never materialize outside the factorization scan: each step
builds D_i (B, NPR, NPR) on the fly from 9 coefficient planes, sandwiches
L_i G_{i-1} U_{i-1} with banded (9-offset) shifted products, inverts, and
emits one G_i. Peak extra memory = G (NZ, B, NPR, NPR) float32
(~4.3 GB at the production 193x17x49 grid, B=8).

The coincident-axis (pole) DOFs stay untied here; callers wrap the apply in
``pole_project`` (the tied-subspace projection), under which
P M^{-1} P is symmetric positive semidefinite on the tied subspace — a valid
CG preconditioner. Replaces remo3d/ngsolve_functions.py:46-56 +
ngsolve_functions_gpu.py:41-47 on the 3D path (``precond3d="direct"``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .block_direct import highest_matmul_precision
import numpy as np

from .stencil3d import entry_index

# In-plane offsets (dz = 0), excluding the diagonal handled with them anyway.
_PLANE_OFFS = [(dp, dr) for dp in (-1, 0, 1) for dr in (-1, 0, 1)]


def _flat_offset(dp: int, dr: int, nr: int) -> int:
    return dp * nr + dr


def _valid_rows(np_: int, nr: int, dp: int, dr: int) -> np.ndarray:
    """(NPR,) mask: node (p, r) has an in-grid neighbor (p+dp, r+dr)."""
    p, r = np.divmod(np.arange(np_ * nr), nr)
    return (
        (p + dp >= 0) & (p + dp < np_) & (r + dr >= 0) & (r + dr < nr)
    ).astype(np.float32)


def _plane_coefs(C3, dz: int, np_: int, nr: int):
    """The 9 coefficient planes of the dz-row, flattened: list of (B, NZ, NPR)."""
    B, nz = C3.shape[0], C3.shape[1]
    return [
        C3[..., entry_index(dz, dp, dr)].reshape(B, nz, np_ * nr)
        for dp, dr in _PLANE_OFFS
    ]


def _dense_block(coefs_i, np_: int, nr: int, promote_diag: bool):
    """D = sum_d c_d * E_d with E_d = eye shifted by the flat offset, masked.

    coefs_i: list of 9 (B, NPR) planes (one z-plane). promote_diag turns
    all-zero rows (padded batches) into identity rows.
    """
    npr = np_ * nr
    out = None
    for (dp, dr), c in zip(_PLANE_OFFS, coefs_i):
        off = _flat_offset(dp, dr, nr)
        mask = jnp.asarray(_valid_rows(np_, nr, dp, dr))
        E = jnp.eye(npr, k=off, dtype=c.dtype) * mask[:, None]
        if promote_diag and dp == 0 and dr == 0:
            c = jnp.where(c == 0, 1.0, c)
        term = c[..., :, None] * E
        out = term if out is None else out + term
    return out  # (B, NPR, NPR)


def _banded_matmul_left(coefs_i, M, np_: int, nr: int):
    """T = L @ M with banded L: l_d[row]; T[row] = sum_d l_d[row] * M[row+off_d]."""
    out = None
    for (dp, dr), l in zip(_PLANE_OFFS, coefs_i):
        off = _flat_offset(dp, dr, nr)
        mask = jnp.asarray(_valid_rows(np_, nr, dp, dr))
        Ms = jnp.roll(M, -off, axis=-2)
        term = (l * mask)[..., :, None] * Ms
        out = term if out is None else out + term
    return out


def _banded_matmul_right(M, coefs_i, np_: int, nr: int):
    """T = M @ U with banded U: u_d[k] = U[k, k+off_d];
    T[:, c] = sum_d M[:, c-off_d] * u_d[c-off_d]."""
    out = None
    for (dp, dr), u in zip(_PLANE_OFFS, coefs_i):
        off = _flat_offset(dp, dr, nr)
        mask = jnp.asarray(_valid_rows(np_, nr, dp, dr))
        Mu = M * (u * mask)[..., None, :]
        term = jnp.roll(Mu, off, axis=-1)
        out = term if out is None else out + term
    return out


def _banded_matvec(coefs_i, v, np_: int, nr: int):
    """w = L v, banded L as above; v (..., NPR)."""
    out = None
    for (dp, dr), l in zip(_PLANE_OFFS, coefs_i):
        off = _flat_offset(dp, dr, nr)
        mask = jnp.asarray(_valid_rows(np_, nr, dp, dr))
        vs = jnp.roll(v, -off, axis=-1)
        term = (l * mask) * vs
        out = term if out is None else out + term
    return out


@highest_matmul_precision
def block_thomas_factor_3d(C3, np_: int, nr: int, store_dtype=jnp.float32):
    """Factorize the banded-block-tridiagonal 27-point operator.

    C3: (B, NZ, NP, NR, 27) Dirichlet-eliminated stencil.
    Returns G (NZ, B, NPR, NPR) in ``store_dtype``.
    """
    B, nz = C3.shape[0], C3.shape[1]
    npr = np_ * nr
    diag_coefs = _plane_coefs(C3, 0, np_, nr)  # 9 x (B, NZ, NPR)
    up_coefs = _plane_coefs(C3, 1, np_, nr)  # U_i diagonals

    # L_i = U_{i-1}^T: the (dp,dr) diagonal of L_i is the (-dp,-dr) plane of
    # U_{i-1} rolled by the flat offset (with the validity mask at use site).
    def l_coefs(up_prev):
        out = []
        for k, (dp, dr) in enumerate(_PLANE_OFFS):
            off = _flat_offset(dp, dr, nr)
            u_md = up_prev[len(_PLANE_OFFS) - 1 - k]
            out.append(jnp.roll(u_md, -off, axis=-1))
        return out

    def step(G_prev, inp):
        d9 = inp[:9]
        u9_prev = inp[9:]
        D_i = _dense_block(d9, np_, nr, promote_diag=True)
        L9 = l_coefs(u9_prev)
        T = _banded_matmul_left(L9, G_prev, np_, nr)
        S = D_i - _banded_matmul_right(T, u9_prev, np_, nr)
        G = jnp.linalg.inv(S)
        G = 0.5 * (G + jnp.swapaxes(G, -1, -2))
        return G, G.astype(store_dtype)

    shift1 = lambda a: jnp.pad(a[:, :-1], ((0, 0), (1, 0), (0, 0)))
    xs = tuple(jnp.moveaxis(c, 1, 0) for c in diag_coefs) + tuple(
        jnp.moveaxis(shift1(c), 1, 0) for c in up_coefs
    )
    G0 = jnp.zeros((B, npr, npr), dtype=C3.dtype)
    _, G_all = jax.lax.scan(step, G0, xs)
    return G_all


@highest_matmul_precision
def schur_fixedpoint_factor_3d(
    C3, np_: int, nr: int, passes=6, z_block=16, store_dtype=jnp.float32
):
    """Batched fixed-point approximation of the 3D Schur-inverse stack.

    Same construction (and the same Loewner-order SPD/monotonicity guarantee)
    as :func:`remo3d_jax.ops.block_direct.schur_fixedpoint_factor`: iterate
    G^(m)_i = (D_i - L_i G^(m-1)_{i-1} U_{i-1})^{-1} Jacobi-style from
    G^(0) = D^{-1}, so the factorization is ``passes`` batched inversions of
    the whole plane stack instead of one NZ-step sequential scan of small
    inversions (NZ x NPR sequential LU column-steps -> passes x NPR). After m
    passes the stack is exact for the first m planes and truncates the chain m
    planes back elsewhere — CG absorbs the (geometrically small) difference.

    The per-pass inversions run in ``z_block``-plane groups under ``lax.map``
    to bound workspace; transient memory is ~2 G-sized stacks (current +
    previous pass), so callers sizing chunks against HBM should budget 2x the
    factorization storage of the exact scan. Returns the same (NZ, B, NPR,
    NPR) stack; :func:`block_thomas_apply_3d` is shared.
    """
    B, nz = C3.shape[0], C3.shape[1]
    npr = np_ * nr
    diag_coefs = _plane_coefs(C3, 0, np_, nr)  # 9 x (B, NZ, NPR)
    up_coefs = _plane_coefs(C3, 1, np_, nr)
    shift1 = lambda a: jnp.pad(a[:, :-1], ((0, 0), (1, 0), (0, 0)))
    up_prev = [shift1(c) for c in up_coefs]  # U_{i-1} aligned to plane i

    def l_coefs(up_prev):
        out = []
        for k, (dp, dr) in enumerate(_PLANE_OFFS):
            off = _flat_offset(dp, dr, nr)
            u_md = up_prev[len(_PLANE_OFFS) - 1 - k]
            out.append(jnp.roll(u_md, -off, axis=-1))
        return out

    l_prev = l_coefs(up_prev)

    # z-major, padded to a multiple of z_block (padded planes factor to I:
    # zero coefficients -> promote_diag identity, zero couplings).
    nzp = -(-nz // z_block) * z_block
    zpad = lambda a: jnp.pad(
        jnp.moveaxis(a, 1, 0), ((0, nzp - nz),) + ((0, 0),) * (a.ndim - 1)
    )
    d9_z = [zpad(c) for c in diag_coefs]
    u9_z = [zpad(c) for c in up_prev]
    l9_z = [zpad(c) for c in l_prev]

    def sym_inv(S):
        G = jnp.linalg.inv(S)
        return 0.5 * (G + jnp.swapaxes(G, -1, -2))

    blk = lambda a: a.reshape((nzp // z_block, z_block) + a.shape[1:])

    def pass_once(G):
        # G, G_prev: (NZP, B, NPR, NPR)
        G_prev = jnp.pad(G[:-1], ((1, 0), (0, 0), (0, 0), (0, 0)))

        def one_block(inp):
            d9 = inp[:9]
            u9 = inp[9:18]
            l9 = inp[18:27]
            Gp = inp[27]
            D = _dense_block(list(d9), np_, nr, promote_diag=True)
            T = _banded_matmul_left(list(l9), Gp, np_, nr)
            S = D - _banded_matmul_right(T, list(u9), np_, nr)
            return sym_inv(S)

        xs = tuple(blk(a) for a in d9_z + u9_z + l9_z) + (blk(G_prev),)
        Gb = jax.lax.map(one_block, xs)
        return Gb.reshape((nzp, B, npr, npr))

    def first_block(inp):
        return sym_inv(_dense_block(list(inp), np_, nr, promote_diag=True))

    G = jax.lax.map(first_block, tuple(blk(a) for a in d9_z)).reshape(
        (nzp, B, npr, npr)
    )
    for _ in range(passes):
        G = pass_once(G)
    return G[:nz].astype(store_dtype)


@highest_matmul_precision
def block_thomas_apply_3d(G_all, C3, b, np_: int, nr: int):
    """x = M^{-1} b. G_all: (NZ, B, NPR, NPR); b: (B, [S,] NZ, NP, NR)."""
    B, nz = C3.shape[0], C3.shape[1]
    npr = np_ * nr
    extra = b.ndim - 4
    up_coefs = _plane_coefs(C3, 1, np_, nr)
    if extra:
        up_coefs = [jnp.expand_dims(c, 1) for c in up_coefs]
    bz = jnp.moveaxis(b.reshape(b.shape[:-3] + (nz, npr)), -2, 0)  # (NZ,B,[S,]NPR)
    upz = [jnp.moveaxis(c, -2, 0) for c in up_coefs]

    def l_coefs(up_prev):
        out = []
        for k, (dp, dr) in enumerate(_PLANE_OFFS):
            off = _flat_offset(dp, dr, nr)
            u_md = up_prev[len(_PLANE_OFFS) - 1 - k]
            out.append(jnp.roll(u_md, -off, axis=-1))
        return out

    dtype = b.dtype

    def gmatvec(G, v):
        if extra:
            return jnp.einsum(
                "brc,bsc->bsr", G.astype(dtype), v, preferred_element_type=dtype
            )
        return jnp.einsum(
            "brc,bc->br", G.astype(dtype), v, preferred_element_type=dtype
        )

    def fwd(w_prev, inp):
        b_i = inp[0]
        u9_prev = inp[1:10]
        G_i = inp[10]
        y_i = b_i - _banded_matvec(l_coefs(u9_prev), w_prev, np_, nr)
        w_i = gmatvec(G_i, y_i)
        return w_i, w_i

    pad1 = lambda a: jnp.pad(a[:-1], ((1, 0),) + ((0, 0),) * (a.ndim - 1))
    xs_f = (bz,) + tuple(pad1(c) for c in upz) + (G_all,)
    w0 = jnp.zeros_like(bz[0])
    _, w = jax.lax.scan(fwd, w0, xs_f)

    def bwd(x_next, inp):
        w_i = inp[0]
        u9 = inp[1:10]
        G_i = inp[10]
        t = _banded_matvec(list(u9), x_next, np_, nr)
        x_i = w_i - gmatvec(G_i, t)
        return x_i, x_i

    xs_b = (w,) + tuple(upz) + (G_all,)
    xN1 = jnp.zeros_like(w[0])
    _, xz = jax.lax.scan(bwd, xN1, xs_b, reverse=True)
    return jnp.moveaxis(xz, 0, -2).reshape(b.shape)
