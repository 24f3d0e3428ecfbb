# -*- coding: utf-8 -*-
"""Geometric multigrid V-cycle preconditioner on the structured stencil hierarchy.

Structured-grid counterpart of NGSolve's geometric multigrid preconditioner
(ngsolve_functions.py:46, ``preconditioner="multigrid"``). The structured grid makes
this natural:

* coarse levels are every-2nd-node subgrids (nested bilinear FEM spaces);
* coarse operators are EXACT Galerkin products P^T A P, computed on the 9-point
  stencils with 9 "comb" probes — no sparse algebra;
* restriction is the FEM adjoint P^T of bilinear prolongation;
* smoothing is Jacobi-preconditioned CHEBYSHEV with per-batch spectral-radius
  estimates from power iteration. (Plain damped Jacobi diverges here: the
  boundary-fitted cells have aspect ratios that push rho(D^-1 A) to ~3.)

Everything is dense shifted-array arithmetic, vectorized over batch and solve axes,
and a fixed linear SPD operator as PCG requires.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .assembly2d import apply_dirichlet, assemble_stencil_2d
from .stencil import stencil_apply, stencil_diag


@dataclasses.dataclass(frozen=True)
class MGConfig:
    n_levels: int = 4
    degree_pre: int = 3  # Chebyshev degree of the pre-smoother
    degree_post: int = 3
    coarse_degree: int = 24  # Chebyshev degree on the coarsest level
    lower_frac: float = 0.25  # target interval [lower_frac*lmax, 1.05*lmax]
    power_iters: int = 12
    # Factored-PCR line smoothers (elimination coefficients computed once per
    # level): fewer sweeps per V-cycle on accelerators, but the factored graph
    # sends the XLA *CPU* backend's compile time through the roof — keep False
    # on CPU.
    factored_lines: bool = False
    # Inner preconditioner of the Chebyshev smoother: "line_rz" is additive
    # alternating-direction line relaxation (radial + axial tridiagonal solves) —
    # required because the graded tensor grid carries BOTH anisotropy orientations
    # (thin radial stations under coarse z far-field, and thin source z-bands under
    # coarse radial far-field). "line_r" and "jacobi" are cheaper but stall on one
    # orientation each.
    smoother: str = "line_rz"
    # Truncate the PCR line solves to this many reduction levels (an approximate
    # solve within a 2^k window). As an MG *smoother* the lines only need to
    # damp coupling the coarse grid cannot represent, so a local window is
    # enough — and each dropped level removes two full-array multiply-add
    # sweeps from the hot path. None = exact (ceil(log2(n)) levels). Checked
    # on the CPU only; no accelerator run has used it yet.
    line_max_steps: int | None = None


def coarsen_cells(cells: jnp.ndarray) -> jnp.ndarray:
    """2x2 arithmetic average of cell values -> coarse cells."""
    return 0.25 * (
        cells[..., 0::2, 0::2]
        + cells[..., 1::2, 0::2]
        + cells[..., 0::2, 1::2]
        + cells[..., 1::2, 1::2]
    )


def prolong(zc: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interpolation coarse -> fine (fine size 2*(n-1)+1)."""
    sz = zc.shape
    nzf, nrf = 2 * (sz[-2] - 1) + 1, 2 * (sz[-1] - 1) + 1
    f = jnp.zeros(sz[:-2] + (nzf, nrf), dtype=zc.dtype)
    f = f.at[..., 0::2, 0::2].set(zc)
    f = f.at[..., 1::2, 0::2].set(0.5 * (zc[..., :-1, :] + zc[..., 1:, :]))
    f = f.at[..., 0::2, 1::2].set(0.5 * (zc[..., :, :-1] + zc[..., :, 1:]))
    f = f.at[..., 1::2, 1::2].set(
        0.25
        * (zc[..., :-1, :-1] + zc[..., 1:, :-1] + zc[..., :-1, 1:] + zc[..., 1:, 1:])
    )
    return f


def restrict(r: jnp.ndarray) -> jnp.ndarray:
    """FEM adjoint of bilinear prolongation: rc = P^T r."""
    rp = jnp.pad(r, [(0, 0)] * (r.ndim - 2) + [(1, 1), (1, 1)])
    c = r[..., 0::2, 0::2]
    c = c + 0.5 * (
        rp[..., 0:-2:2, 1:-1:2]
        + rp[..., 2::2, 1:-1:2]
        + rp[..., 1:-1:2, 0:-2:2]
        + rp[..., 1:-1:2, 2::2]
    )
    c = c + 0.25 * (
        rp[..., 0:-2:2, 0:-2:2]
        + rp[..., 2::2, 0:-2:2]
        + rp[..., 0:-2:2, 2::2]
        + rp[..., 2::2, 2::2]
    )
    return c


def galerkin_coarsen(C: jnp.ndarray, coarse_free: jnp.ndarray) -> jnp.ndarray:
    """Exact Galerkin coarse stencil C_H = P^T C P for bilinear P.

    Because C_H is again a 9-point stencil, its columns are probed with 9 "comb"
    vectors (coarse deltas on a stride-3 lattice whose prolongated supports cannot
    overlap): y = P^T (C (P e_comb)) then holds one full column of C_H per comb node,
    scattered back into stencil layout with static strided writes.
    """
    nz, nr = C.shape[-4], C.shape[-3]
    nzc, nrc = (nz + 1) // 2, (nr + 1) // 2
    lead = C.shape[:-4]
    # All 9 combs ride the broadcast "solve" axis of stencil_apply: one prolong/
    # apply/restrict for the whole probe set, then ONE gather rearranges probe
    # columns into stencil layout (strided scatter writes inflate XLA compile).
    combs = np.zeros((9, nzc, nrc), dtype=np.float32)
    for a in range(3):
        for b in range(3):
            combs[a * 3 + b, a::3, b::3] = 1.0
    comb = jnp.broadcast_to(jnp.asarray(combs, dtype=C.dtype), lead + (9, nzc, nrc))
    y = restrict(stencil_apply(C, prolong(comb)))
    y_t = jnp.moveaxis(y, -3, -1)  # (..., nzc, nrc, 9)

    # Stencil entry (dI,dJ) at node (i,j) couples to the neighbor (i+dI, j+dJ),
    # whose probe is the comb with residues ((i+dI)%3, (j+dJ)%3).
    iz = np.arange(nzc)[:, None]
    jr = np.arange(nrc)[None, :]
    idx = np.empty((nzc, nrc, 9), dtype=np.int32)
    for dI in (-1, 0, 1):
        for dJ in (-1, 0, 1):
            e = (dI + 1) * 3 + (dJ + 1)
            idx[..., e] = ((iz + dI) % 3) * 3 + ((jr + dJ) % 3)
    CH = jnp.take_along_axis(
        y_t, jnp.broadcast_to(jnp.asarray(idx), y_t.shape[:-1] + (9,)), axis=-1
    )
    CH = CH.reshape(CH.shape[:-1] + (3, 3))
    return apply_dirichlet(CH, coarse_free)


def _make_precond(
    C,
    inv_diag,
    free,
    smoother: str,
    factored: bool = False,
    max_steps=None,
):
    """Inner smoother preconditioner apply: r -> M^{-1} r (identity on Dirichlet).

    With ``factored`` the tridiagonal line parts are FACTORED once per level —
    the PCR elimination coefficients depend only on the operator, so every
    smoother application pays two shifted multiply-adds per reduction level
    instead of a full re-elimination broadcast over the solve axis. (Off on
    the CPU: the factored graph blows up the XLA CPU backend's compile time.)
    """
    from .lines import line_apply_2d, line_factor_2d, line_solve_r, line_solve_z

    if smoother == "jacobi":

        def apply_(r):
            inv_d = inv_diag if r.ndim == inv_diag.ndim else jnp.expand_dims(inv_diag, -3)
            return inv_d * r

    elif smoother == "line_r":
        if factored:
            f_r = line_factor_2d(C, "r", max_steps=max_steps)

            def apply_(r):
                return line_apply_2d(f_r, r)

        else:

            def apply_(r):
                return line_solve_r(C, r, max_steps=max_steps)

    elif smoother == "line_rz":
        if factored:
            f_r = line_factor_2d(C, "r", max_steps=max_steps)
            f_z = line_factor_2d(C, "z", max_steps=max_steps)

            def apply_(r):
                # Additive ADI: symmetric (PCG-safe), both orientations.
                return 0.5 * (line_apply_2d(f_r, r) + line_apply_2d(f_z, r))

        else:

            def apply_(r):
                return 0.5 * (
                    line_solve_r(C, r, max_steps=max_steps)
                    + line_solve_z(C, r, max_steps=max_steps)
                )

    else:
        raise ValueError(f"unknown smoother {smoother!r}")
    return apply_


def _estimate_lmax(C, precond, power_iters: int) -> jnp.ndarray:
    """Per-batch spectral radius of M^{-1} A via power iteration.

    Returns an array with C's leading (batch) shape. Deterministic start vector.
    """
    nz, nr = C.shape[-4], C.shape[-3]
    rng = np.random.default_rng(12345)
    x0 = jnp.asarray(rng.standard_normal((nz, nr)), dtype=C.dtype)
    x = jnp.broadcast_to(x0, C.shape[:-2])  # (..., nz, nr)
    lmax = None
    for _ in range(power_iters):
        y = precond(stencil_apply(C, x))
        lmax = jnp.sqrt(jnp.sum(y * y, axis=(-2, -1)) / jnp.sum(x * x, axis=(-2, -1)))
        x = y / (lmax[..., None, None] + 1e-30)
    return lmax


def _chebyshev_smooth(level, r, z, degree: int, lower_frac: float):
    """``degree`` iterations of Jacobi-preconditioned Chebyshev on A z = r,
    targeting the interval [lower_frac*lmax, 1.05*lmax] (Saad, Iterative Methods,
    Alg. 12.1 adapted to preconditioned form)."""
    if degree <= 0:
        return z
    C, free, lmax = level["C"], level["free"], level["lmax"]
    precond = level["precond"]
    extra = r.ndim - (C.ndim - 2)
    if extra == 1:
        free = jnp.expand_dims(free, -3)
        lmax = jnp.expand_dims(lmax, -1)
    lmax = lmax[..., None, None] * 1.05
    lmin = lmax * lower_frac
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma

    apply_A = level["apply"]

    def precond_residual(z):
        res = r - apply_A(z)
        return precond(jnp.where(free, res, 0.0))

    d = precond_residual(z) / theta
    z = z + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * precond_residual(z)
        z = z + d
        rho = rho_new
    return z


def build_hierarchy(coords, sigma_cells, free_mask, config: MGConfig, C_fine=None):
    """Assemble the fine stencil, Galerkin-coarsen down, estimate spectra."""
    nz, nr = coords.shape[-3], coords.shape[-2]
    for l in range(config.n_levels - 1):
        step = 2**l
        if (nz - 1) % (2 * step) or (nr - 1) % (2 * step):
            raise ValueError(
                f"grid {nz}x{nr} not coarsenable {config.n_levels - 1} times; "
                "choose nz-1, nr-1 divisible by 2^(n_levels-1)"
            )
    levels = []
    C = C_fine if C_fine is not None else assemble_stencil_2d(coords, sigma_cells, free_mask)
    for l in range(config.n_levels):
        diag = stencil_diag(C)
        inv_diag = 1.0 / jnp.where(diag != 0, diag, 1.0)
        precond = _make_precond(
            C,
            inv_diag,
            free_mask,
            config.smoother,
            config.factored_lines,
            config.line_max_steps,
        )
        levels.append(
            {
                "C": C,
                "inv_diag": inv_diag,
                "free": free_mask,
                "precond": precond,
                "apply": lambda u, C=C: stencil_apply(C, u),
                "lmax": _estimate_lmax(C, precond, config.power_iters),
            }
        )
        if l < config.n_levels - 1:
            free_mask = free_mask[..., ::2, ::2]
            C = galerkin_coarsen(C, free_mask)
    return levels


def v_cycle(levels, r, config: MGConfig, l: int = 0):
    """One V-cycle approximating A^{-1} r (zero initial guess). Unrolled recursion."""
    level = levels[l]
    free = level["free"]
    freeb = free if r.ndim == free.ndim else jnp.expand_dims(free, -3)
    if l == len(levels) - 1:
        return _chebyshev_smooth(
            level, r, jnp.zeros_like(r), config.coarse_degree, config.lower_frac / 8
        )
    z = _chebyshev_smooth(level, r, jnp.zeros_like(r), config.degree_pre, config.lower_frac)
    res = jnp.where(freeb, r - level["apply"](z), 0.0)
    zc = v_cycle(levels, restrict(res), config, l + 1)
    z = z + jnp.where(freeb, prolong(zc), 0.0)
    z = _chebyshev_smooth(level, r, z, config.degree_post, config.lower_frac)
    return z


def make_mg_preconditioner(
    coords, sigma_cells, free_mask, config: MGConfig = MGConfig(), C_fine=None
):
    """Returns (C_fine, M_inv) for use with :func:`remo3d_jax.ops.cg.pcg`."""
    levels = build_hierarchy(coords, sigma_cells, free_mask, config, C_fine=C_fine)

    def M_inv(r):
        return v_cycle(levels, r, config)

    return levels[0]["C"], M_inv
