# -*- coding: utf-8 -*-
"""Batched block-tridiagonal direct factorization of the 2D stencil operator.

The 9-point axisymmetric stencil is block-tridiagonal over axial lines: line i
couples only to lines i±1, and every block is tridiagonal in the radial index
(bandwidth 1). One batch's operator serves ALL S solves of that batch (the
reference solves one ``SolveBVP`` per simulation depth on a shared mesh,
workers/worker.py:104-110), so a single factorization per batch amortizes over
the solve axis — the classic regime where a direct method beats iteration.

Block-LDL^T (block Thomas): S_0 = D_0, S_i = D_i − L_i S_{i−1}^{-1} U_{i−1},
with U_i = L_{i+1}^T. We store G_i ≈ S_i^{-1} EXPLICITLY (float32,
symmetrized), because the apply then consists purely of batched matmuls — the
matmul-native operation — instead of sequential triangular solves:

    forward   y_i = b_i − L_i (G_{i−1} y_{i−1})        (L_i tridiagonal: shifts)
    backward  x_i = G_i y_i − G_i (U_i x_{i+1})

With every G_i symmetric the operator applied is exactly L̃^{-T} diag(G) L̃^{-1}
— symmetric positive definite for ANY symmetric positive-definite G, so
rounded block inverses still give a valid PCG preconditioner; CG controls the
final accuracy. Storage must be float32: the forward/backward recurrences
amplify per-entry storage error by ~κ of the chain (measured ~1e5 on the
production 761-line grid — float32 lands at 4e-3 apply error, an excellent
preconditioner, while bfloat16 diverges outright). Per chunk: one ~NZ-step
``lax.scan`` of batched (B, NR, NR) inverses (~0.3 TFLOP at production
sizes), then each application streams G twice — no Chebyshev smoothing, no
spectral estimation, and CG converges in a handful of iterations.

Structured-grid replacement for the sparse-CG solve of the reference
(remo3d/ngsolve_functions.py:46-56); selected with ``preconditioner="direct"``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def highest_matmul_precision(fn):
    """Trace ``fn`` under float32 matmul precision.

    On an H100 the DEFAULT matmul precision runs float32 products in TF32
    (about three decimal digits) — harmless for the FEM assembly contractions,
    catastrophic for a direct factorization whose recurrences amplify
    per-entry error by ~kappa (~1e5 on the production chain; a reduced-
    precision factorization NaNs every solve, while full float32 converges in
    4 CG iterations). The blocks are tiny (NR x NR), so the cost of full
    float32 products is irrelevant next to correctness.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def _tri_diagonals_z(C):
    """Off-diagonal (z -> z+1) block diagonals u_d[k] = U_i[k, k+d], d in -1,0,1.

    C[b, z, r, di, dj] couples node (z, r) to (z+di-1, r+dj-1), so the
    coupling into the NEXT line is the di=2 row of the stencil.
    """
    return C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]  # (B, NZ, NR) each


def _tri_matmul_left(l_m, l_0, l_p, M):
    """T = L @ M for tridiagonal L given by its diagonals (rows of M mix).

    l_d[r] = L[r, r+d]; T[r, :] = l_m[r]*M[r-1, :] + l_0[r]*M[r, :] + l_p[r]*M[r+1, :].
    M: (..., NR, NR) dense; l_*: (..., NR).
    """
    up = jnp.pad(M[..., 1:, :], ((0, 0),) * (M.ndim - 2) + ((0, 1), (0, 0)))
    dn = jnp.pad(M[..., :-1, :], ((0, 0),) * (M.ndim - 2) + ((1, 0), (0, 0)))
    return l_m[..., None] * dn + l_0[..., None] * M + l_p[..., None] * up


def _tri_matmul_right(M, u_m, u_0, u_p):
    """T = M @ U for tridiagonal U given by its diagonals (columns of M mix).

    u_d[k] = U[k, k+d]; T[:, c] = M[:, c+1]*u_m[c+1] + M[:, c]*u_0[c] + M[:, c-1]*u_p[c-1].
    """
    pad = ((0, 0),) * (M.ndim - 2)
    mu = jnp.pad((M[..., 1:] * u_m[..., None, 1:]), pad + ((0, 0), (0, 1)))
    mp = jnp.pad((M[..., :-1] * u_p[..., None, :-1]), pad + ((0, 0), (1, 0)))
    return mu + M * u_0[..., None, :] + mp


def _tri_matvec(l_m, l_0, l_p, v):
    """w = L v for tridiagonal L diagonals over the last axis of v (..., NR)."""
    up = jnp.pad(v[..., 1:], ((0, 0),) * (v.ndim - 1) + ((0, 1),))
    dn = jnp.pad(v[..., :-1], ((0, 0),) * (v.ndim - 1) + ((1, 0),))
    return l_m * dn + l_0 * v + l_p * up


def _dense_line_blocks(C):
    """Diagonal blocks D_i as dense (B, NZ, NR, NR) from the di=1 stencil row,
    with all-zero rows (padded batches / eliminated entries) promoted to
    identity so the factorization stays nonsingular."""
    d_m, d_0, d_p = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    d_0 = jnp.where(d_0 == 0, 1.0, d_0)
    nr = d_0.shape[-1]
    eye = jnp.eye(nr, dtype=C.dtype)
    up = jnp.pad(eye[1:, :], ((0, 1), (0, 0)))
    dn = jnp.pad(eye[:-1, :], ((1, 0), (0, 0)))
    return d_m[..., None] * dn + d_0[..., None] * eye + d_p[..., None] * up


@highest_matmul_precision
def schur_fixedpoint_factor(C, passes=8, store_dtype=jnp.float32):
    """Batched fixed-point approximation of the block-LDL^T Schur inverses.

    The exact chain G_i = (D_i - L_i G_{i-1} U_{i-1})^{-1} is inherently
    sequential: :func:`block_thomas_factor` runs one ``lax.scan`` step per
    axial line, each inverting a small (B, NR, NR) batch — on an accelerator
    that is NZ x NR sequential LU column-steps (~77k at production sizes), far from
    the hardware's batched-matmul sweet spot. This variant iterates the same
    recurrence JACOBI-style over the whole stack at once,

        G^(0)_i = D_i^{-1},     G^(m)_i = (D_i - L_i G^(m-1)_{i-1} U_{i-1})^{-1},

    so every pass is one batched (B*NZ, NR, NR) inversion plus tridiagonal
    block products — ``passes`` x NR sequential column-steps total (~100x
    fewer). After m passes G^(m)_i is EXACT for i <= m and equals the Schur
    inverse of the chain truncated m lines back otherwise; the truncation
    error decays like the operator's Green's function along z.

    Safety (Loewner-order induction): S_i(exact) <= D_i gives
    G^(0) = D^{-1} <= G_exact; congruence preserves order, so
    G^(m-1) <= G_exact implies S^(m) = D - L G^(m-1) L^T >= S_exact > 0 and
    G^(m) <= G_exact; likewise G^(m-1) >= G^(m-2) implies G^(m) >= G^(m-1).
    Every iterate is therefore SPD and increases monotonically toward the
    exact inverses — a valid PCG preconditioner at ANY pass count; ``passes``
    only trades CG iterations against factorization time. Returns the same
    (NZ, B, NR, NR) stack as :func:`block_thomas_factor` (the apply is
    shared). Same role as the reference's sparse factorization hand-off to
    NGSolve (remo3d/ngsolve_functions.py:46-56), batch-scheduled for the matrix units.
    """
    D = _dense_line_blocks(C)  # (B, NZ, NR, NR)
    u_m, u_0, u_p = _tri_diagonals_z(C)  # (B, NZ, NR)
    # U_{i-1} diagonals aligned to line i (zero row at i = 0).
    pad_z = lambda a: jnp.pad(a[:, :-1], ((0, 0), (1, 0), (0, 0)))
    um_s, u0_s, up_s = pad_z(u_m), pad_z(u_0), pad_z(u_p)
    # L_i = U_{i-1}^T diagonals: l_d[r] = U[r+d, r].
    l_m = jnp.pad(up_s[..., :-1], ((0, 0), (0, 0), (1, 0)))
    l_0 = u0_s
    l_p = jnp.pad(um_s[..., 1:], ((0, 0), (0, 0), (0, 1)))

    def sym_inv(S):
        G = jnp.linalg.inv(S)
        return 0.5 * (G + jnp.swapaxes(G, -1, -2))

    G = sym_inv(D)
    for _ in range(passes):
        G_prev = jnp.pad(G[:, :-1], ((0, 0), (1, 0), (0, 0), (0, 0)))
        T = _tri_matmul_left(l_m, l_0, l_p, G_prev)  # L_i G_{i-1}
        G = sym_inv(D - _tri_matmul_right(T, um_s, u0_s, up_s))
    return jnp.moveaxis(G, 1, 0).astype(store_dtype)  # (NZ, B, NR, NR)


@highest_matmul_precision
def block_thomas_factor(C, store_dtype=jnp.float32):
    """Factorize the block-tridiagonal stencil operator.

    C: (B, NZ, NR, 3, 3) Dirichlet-eliminated stencil. Returns the stacked
    symmetrized Schur-complement inverses G (NZ, B, NR, NR) in ``store_dtype``.
    """
    D = _dense_line_blocks(C)  # (B, NZ, NR, NR)
    u_m, u_0, u_p = _tri_diagonals_z(C)  # (B, NZ, NR)
    B, nz, nr = D.shape[0], D.shape[1], D.shape[2]

    # scan over z: carry G_{i-1} (f32), emit G_i (store_dtype)
    def step(G_prev, inp):
        D_i, lu = inp
        um, u0, up = lu  # U_{i-1} diagonals (zero for i = 0)
        # L_i = U_{i-1}^T: L diagonals l_d[r] = U[r+d, r] -> l_m[r] = u_p[r-1] etc.
        l_m = jnp.pad(up[..., :-1], ((0, 0), (1, 0)))
        l_0 = u0
        l_p = jnp.pad(um[..., 1:], ((0, 0), (0, 1)))
        T = _tri_matmul_left(l_m, l_0, l_p, G_prev)  # L_i G_{i-1}
        S = D_i - _tri_matmul_right(T, um, u0, up)  # D_i - L_i G_{i-1} U_{i-1}
        G = jnp.linalg.inv(S)
        G = 0.5 * (G + jnp.swapaxes(G, -1, -2))  # SPD preconditioner guarantee
        return G, G.astype(store_dtype)

    # U_{i-1} for step i: shift the U diagonals by one line, zero at i=0.
    um_s = jnp.pad(u_m[:, :-1], ((0, 0), (1, 0), (0, 0)))
    u0_s = jnp.pad(u_0[:, :-1], ((0, 0), (1, 0), (0, 0)))
    up_s = jnp.pad(u_p[:, :-1], ((0, 0), (1, 0), (0, 0)))
    Dz = jnp.moveaxis(D, 1, 0)  # (NZ, B, NR, NR)
    lus = (jnp.moveaxis(um_s, 1, 0), jnp.moveaxis(u0_s, 1, 0), jnp.moveaxis(up_s, 1, 0))
    G0 = jnp.zeros((B, nr, nr), dtype=C.dtype)
    _, G_all = jax.lax.scan(step, G0, (Dz, lus))
    return G_all  # (NZ, B, NR, NR) store_dtype


@highest_matmul_precision
def block_thomas_apply(G_all, C, b):
    """x = M^{-1} b with the factorization from :func:`block_thomas_factor`.

    G_all: (NZ, B, NR, NR); C: (B, NZ, NR, 3, 3); b: (B, [S,] NZ, NR).
    Linear, SPD (see module docstring) — a PCG preconditioner.
    """
    u_m, u_0, u_p = _tri_diagonals_z(C)
    extra = b.ndim - 3
    if extra:  # solve axis: diagonals broadcast over S
        u_m, u_0, u_p = (jnp.expand_dims(a, 1) for a in (u_m, u_0, u_p))
    bz = jnp.moveaxis(b, -2, 0)  # (NZ, B, [S,] NR)
    umz = jnp.moveaxis(u_m, -2, 0)
    u0z = jnp.moveaxis(u_0, -2, 0)
    upz = jnp.moveaxis(u_p, -2, 0)

    dtype = b.dtype

    def gmatvec(G, v):
        # (B, NR, NR) x (B, [S,] NR) -> (B, [S,] NR), f32 accumulation
        if extra:
            return jnp.einsum(
                "brc,bsc->bsr", G.astype(dtype), v, preferred_element_type=dtype
            )
        return jnp.einsum(
            "brc,bc->br", G.astype(dtype), v, preferred_element_type=dtype
        )

    # forward: y_i = b_i - L_i (G_{i-1} y_{i-1}); carry w = G_i y_i; emit w.
    def fwd(w_prev, inp):
        b_i, lu, G_i = inp
        um, u0, up = lu  # U_{i-1} diagonals
        l_m = jnp.pad(up[..., :-1], ((0, 0),) * (up.ndim - 1) + ((1, 0),))
        l_0 = u0
        l_p = jnp.pad(um[..., 1:], ((0, 0),) * (um.ndim - 1) + ((0, 1),))
        y_i = b_i - _tri_matvec(l_m, l_0, l_p, w_prev)
        w_i = gmatvec(G_i, y_i)
        return w_i, w_i

    pad1 = lambda a: jnp.pad(a[:-1], ((1, 0),) + ((0, 0),) * (a.ndim - 1))
    lus_prev = (pad1(umz), pad1(u0z), pad1(upz))
    w0 = jnp.zeros_like(bz[0])
    _, w = jax.lax.scan(fwd, w0, (bz, lus_prev, G_all))

    # backward: x_i = w_i - G_i (U_i x_{i+1})
    def bwd(x_next, inp):
        w_i, lu, G_i = inp
        um, u0, up = lu  # U_i diagonals
        t = _tri_matvec(um, u0, up, x_next)
        x_i = w_i - gmatvec(G_i, t)
        return x_i, x_i

    xN1 = jnp.zeros_like(w[0])
    _, xz = jax.lax.scan(bwd, xN1, (w, (umz, u0z, upz), G_all), reverse=True)
    return jnp.moveaxis(xz, 0, -2)
