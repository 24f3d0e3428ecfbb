# -*- coding: utf-8 -*-
"""Isoparametric trilinear hex assembly of ``sigma * grad u . grad v`` -> 27-pt stencil.

3D weak-form parity with the reference (ngsolve_functions.py:36: plain
``sigma*grad(u)*grad(v)`` — the half-ball volume carries no cylindrical weight).
Vectorized over all cells and batch axes; unrolled elementwise arithmetic (no dot_general —
see assembly2d.py notes on reduced-precision matmul defaults); per-cell coordinate translation
for float32-safe Jacobians. Degenerate (pole-collapsed) hexes are handled naturally:
their Gauss-point Jacobians stay positive, and the coincident-node DOFs are tied by
the pole projector at solve time.

Two geometric metrics (``metric=``):

* ``"cartesian"`` — the nodes' (x, y, z) positions span straight-edged hexes;
  azimuth circles become CHORDAL POLYGONS, whose ring areas/conductances are
  systematically off by O(dphi^2) (sin(dphi)/dphi ring-area deficit — measured
  1.8% mean dip->0 error at np_=9, still 0.9% at the np_=17 default).
* ``"cylindrical"`` — the element map is trilinear in (r, phi, z) with the TRUE
  cylindrical metric (gradient (u_r, u_phi/r, u_z), volume weight r): the
  discrete domain is exactly the solid of revolution through the nodes, so the
  azimuth direction carries only interpolation error, which VANISHES for the
  axisymmetric component of the field. The azimuth angle is reconstructed from
  the array index (grid3d spaces phi uniformly over [0, pi] by construction);
  the radius from hypot(x, y). Pole-adjacent cells are better conditioned than
  their collapsed Cartesian counterparts (the (r, phi, z) map is regular).
  This is the 3D analog of the 2D axisymmetric ``2*pi*r`` weak form
  (ngsolve_functions.py:34) and shares its accuracy character.

The stencil uses the flattened 27-entry layout of :mod:`.stencil3d`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .stencil3d import entry_index

# Local node order: (iz, jphi, kr) corner offsets.
_CORNERS3 = tuple((a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1))
_XI = np.array([2 * a - 1 for a, b, c in _CORNERS3], dtype=float)
_ETA = np.array([2 * b - 1 for a, b, c in _CORNERS3], dtype=float)
_ZETA = np.array([2 * c - 1 for a, b, c in _CORNERS3], dtype=float)
_GAUSS = (-1.0 / np.sqrt(3.0), 1.0 / np.sqrt(3.0))


def _corner_coords(x: jnp.ndarray):
    """x: (..., NZ, NP, NR) one coordinate -> list of 8 per-cell corner arrays."""
    out = []
    for a, b, c in _CORNERS3:
        out.append(
            x[
                (
                    ...,
                    slice(a, x.shape[-3] - 1 + a),
                    slice(b, x.shape[-2] - 1 + b),
                    slice(c, x.shape[-1] - 1 + c),
                )
            ]
        )
    return out


def _cylindrical_axes(coords: jnp.ndarray):
    """(r, phi, z) nodal fields from Cartesian coords; phi from the array index."""
    x = coords[..., 0]
    y = coords[..., 1]
    np_ = coords.shape[-3]
    phi_line = jnp.linspace(0.0, np.pi, np_, dtype=coords.dtype)
    phi = jnp.broadcast_to(phi_line[:, None], x.shape)
    return jnp.hypot(x, y), phi, coords[..., 2]


def element_matrices_3d(
    coords: jnp.ndarray, sigma_cells: jnp.ndarray, metric: str = "cartesian"
):
    """coords: (..., NZ, NP, NR, 3) [x, y, z]; sigma_cells: (..., NZ-1, NP-1, NR-1).

    Returns K as an 8x8 nested list of (..., NZ-1, NP-1, NR-1) arrays.
    ``metric``: "cartesian" (chordal hexes) or "cylindrical" (exact solid of
    revolution; see module docstring).

    Precondition for ``metric="cylindrical"``: the azimuth axis (dim -3) must
    be UNIFORM over [0, pi] — phi is reconstructed from the array index, not
    from atan2(y, x) (the pole column r=0 makes atan2 ill-defined there).
    Grids built by :mod:`..meshing.grid3d` satisfy this by construction;
    full-circle or clustered-azimuth coords would silently get a wrong
    stiffness matrix (use "cartesian" for those).
    """
    cyl = metric == "cylindrical"
    if cyl:
        r_n, phi_n, z_n = _cylindrical_axes(coords)
        xs = _corner_coords(r_n)
        ys = _corner_coords(phi_n)
        zs = _corner_coords(z_n)
    elif metric == "cartesian":
        xs = _corner_coords(coords[..., 0])
        ys = _corner_coords(coords[..., 1])
        zs = _corner_coords(coords[..., 2])
    else:
        raise ValueError(f"unknown metric {metric!r}")
    dx = [xi - xs[0] for xi in xs]
    dy = [yi - ys[0] for yi in ys]
    dz = [zi - zs[0] for zi in zs]

    K = [[None] * 8 for _ in range(8)]
    for gx in _GAUSS:
        for gy in _GAUSS:
            for gz in _GAUSS:
                dn = np.stack(
                    [
                        0.125 * _XI * (1 + _ETA * gy) * (1 + _ZETA * gz),
                        0.125 * _ETA * (1 + _XI * gx) * (1 + _ZETA * gz),
                        0.125 * _ZETA * (1 + _XI * gx) * (1 + _ETA * gy),
                    ],
                    axis=1,
                )  # (8, 3): d/d(xi, eta, zeta)

                J = [[None] * 3 for _ in range(3)]
                for l in range(3):
                    J[0][l] = sum(float(dn[a, l]) * dx[a] for a in range(8))
                    J[1][l] = sum(float(dn[a, l]) * dy[a] for a in range(8))
                    J[2][l] = sum(float(dn[a, l]) * dz[a] for a in range(8))

                # Adjugate / determinant (unrolled 3x3 inverse-transpose).
                a00, a01, a02 = J[0]
                a10, a11, a12 = J[1]
                a20, a21, a22 = J[2]
                c00 = a11 * a22 - a12 * a21
                c01 = a12 * a20 - a10 * a22
                c02 = a10 * a21 - a11 * a20
                c10 = a02 * a21 - a01 * a22
                c11 = a00 * a22 - a02 * a20
                c12 = a01 * a20 - a00 * a21
                c20 = a01 * a12 - a02 * a11
                c21 = a02 * a10 - a00 * a12
                c22 = a00 * a11 - a01 * a10
                detJ = a00 * c00 + a01 * c01 + a02 * c02
                inv_det = 1.0 / jnp.where(jnp.abs(detJ) > 1e-30, detJ, 1e-30)

                # grad_phys[a][m] = sum_l dn[a, l] * inv(J)[l, m]; inv(J)[l,m] =
                # c_{ml}/det.
                gxs, gys, gzs = [], [], []
                for a in range(8):
                    d0, d1, d2 = float(dn[a, 0]), float(dn[a, 1]), float(dn[a, 2])
                    gxs.append((d0 * c00 + d1 * c01 + d2 * c02) * inv_det)
                    gys.append((d0 * c10 + d1 * c11 + d2 * c12) * inv_det)
                    gzs.append((d0 * c20 + d1 * c21 + d2 * c22) * inv_det)

                if cyl:
                    # Physical phi-gradient = parametric/r; volume weight r.
                    # Gauss-point radius: r_g >= ~0.21*h even on pole-adjacent
                    # cells (interior Gauss points), so the division is safe.
                    n = (
                        0.125 * (1 + _XI * gx) * (1 + _ETA * gy) * (1 + _ZETA * gz)
                    )
                    r_g = sum(float(n[a]) * xs[a] for a in range(8))
                    inv_r = 1.0 / jnp.maximum(r_g, 1e-30)
                    gys = [g * inv_r for g in gys]
                    w = sigma_cells * jnp.abs(detJ) * r_g
                else:
                    w = sigma_cells * jnp.abs(detJ)
                for a in range(8):
                    for b in range(a, 8):
                        contrib = w * (
                            gxs[a] * gxs[b] + gys[a] * gys[b] + gzs[a] * gzs[b]
                        )
                        K[a][b] = contrib if K[a][b] is None else K[a][b] + contrib
    for a in range(8):
        for b in range(a):
            K[a][b] = K[b][a]
    return K


def fold_to_stencil_3d(K, nz: int, np_: int, nr: int) -> jnp.ndarray:
    lead = K[0][0].shape[:-3]
    C = jnp.zeros(lead + (nz, np_, nr, 27), dtype=K[0][0].dtype)
    for a, (ai, aj, ak) in enumerate(_CORNERS3):
        for b, (bi, bj, bk) in enumerate(_CORNERS3):
            e = entry_index(bi - ai, bj - aj, bk - ak)
            C = C.at[
                ..., ai : ai + nz - 1, aj : aj + np_ - 1, ak : ak + nr - 1, e
            ].add(K[a][b])
    return C


def apply_dirichlet_3d(C: jnp.ndarray, free_mask: jnp.ndarray) -> jnp.ndarray:
    nz, np_, nr = C.shape[-4], C.shape[-3], C.shape[-2]
    free = free_mask.astype(C.dtype)
    free_pad = jnp.pad(free, [(0, 0)] * (free.ndim - 3) + [(1, 1), (1, 1), (1, 1)])
    from .stencil3d import _OFFSETS, DIAG, entry_index as _ei

    neigh = jnp.stack(
        [
            free_pad[..., 1 + dz : 1 + dz + nz, 1 + dp : 1 + dp + np_, 1 + dr : 1 + dr + nr]
            for dz, dp, dr in _OFFSETS
        ],
        axis=-1,
    )  # (..., NZ, NP, NR, 27)
    C = C * (free[..., None] * neigh)
    C = C.at[..., DIAG].add(1.0 - free)
    return C


def assemble_stencil_3d(coords, sigma_cells, free_mask, metric="cartesian") -> jnp.ndarray:
    nz, np_, nr = coords.shape[-4], coords.shape[-3], coords.shape[-2]
    K = element_matrices_3d(coords, sigma_cells, metric=metric)
    C = fold_to_stencil_3d(K, nz, np_, nr)
    return apply_dirichlet_3d(C, free_mask)


def fundamental_potential_3d(coords, sigma0, src_z, src_fac, d_min=1e-4):
    """u_s at the grid nodes: half-space point-source fields on the borehole axis.

    The sources sit on the axis at (0, 0, z_s); the half-ball (y >= 0) carries the
    reference's half-space convention (full current into the half domain, readouts
    halved afterwards — worker.py:129-131), so ``u_s = fac / (2*pi*sigma0*d)``.

    coords (B, NZ, NP, NR, 3) [(x, y, z)]; sigma0 (B,) mud conductivity;
    src_z (B, S, K); src_fac (B, S, K). Returns (B, S, NZ, NP, NR).
    """
    x = coords[..., 0][:, None]
    y = coords[..., 1][:, None]
    z = coords[..., 2][:, None]
    u = 0.0
    for k in range(src_z.shape[-1]):
        zs = src_z[..., k][..., None, None, None]
        fac = src_fac[..., k][..., None, None, None]
        d = jnp.sqrt(x * x + y * y + (z - zs) ** 2)
        u = u + fac / (2.0 * jnp.pi * jnp.maximum(d, d_min))
    return u / sigma0[:, None, None, None, None]


def singularity_rhs_3d(
    coords, sigma_cells, sigma0, src_z, src_fac, d_min=1e-4, metric="cartesian"
):
    """Load vector of the 3D singularity-subtracted correction problem.

    With u = u_s + w, w satisfies ``a(w, v) = -∫ (sigma - sigma0) grad(u_s)·grad(v)``
    over the half-ball; the integrand vanishes inside the borehole (sigma == sigma0
    there), which contains every source, so 2x2x2 Gauss quadrature is accurate
    wherever it is nonzero. Returns rhs (B, S, NZ, NP, NR) BEFORE the Dirichlet
    lift and BEFORE the pole projection.

    In the cylindrical metric the sources sit ON the revolution axis, so
    ``grad u_s`` is axisymmetric: its e_phi component is identically zero and
    the integrand reduces to the (e_r, e_z) plane. Same precondition as
    :func:`element_matrices_3d`: ``metric="cylindrical"`` requires the azimuth
    axis uniform over [0, pi] (phi is index-reconstructed).
    """
    cyl = metric == "cylindrical"
    nz, np_, nr = coords.shape[-4], coords.shape[-3], coords.shape[-2]
    if cyl:
        r_n, phi_n, z_n = _cylindrical_axes(coords)
        xs = _corner_coords(r_n)
        ys = _corner_coords(phi_n)
        zs_c = _corner_coords(z_n)
    elif metric == "cartesian":
        xs = _corner_coords(coords[..., 0])
        ys = _corner_coords(coords[..., 1])
        zs_c = _corner_coords(coords[..., 2])
    else:
        raise ValueError(f"unknown metric {metric!r}")
    dx = [xi - xs[0] for xi in xs]
    dy = [yi - ys[0] for yi in ys]
    dz = [zi - zs_c[0] for zi in zs_c]
    sig_dev = (sigma_cells - sigma0[:, None, None, None])[:, None]  # (B,1,cells)
    inv_sig0 = 1.0 / sigma0[:, None, None, None, None]

    acc = [None] * 8
    for gx in _GAUSS:
        for gy in _GAUSS:
            for gz in _GAUSS:
                n = (
                    0.125
                    * (1 + _XI * gx)
                    * (1 + _ETA * gy)
                    * (1 + _ZETA * gz)
                )  # (8,)
                dn = np.stack(
                    [
                        0.125 * _XI * (1 + _ETA * gy) * (1 + _ZETA * gz),
                        0.125 * _ETA * (1 + _XI * gx) * (1 + _ZETA * gz),
                        0.125 * _ZETA * (1 + _XI * gx) * (1 + _ETA * gy),
                    ],
                    axis=1,
                )
                J = [[None] * 3 for _ in range(3)]
                for l in range(3):
                    J[0][l] = sum(float(dn[a, l]) * dx[a] for a in range(8))
                    J[1][l] = sum(float(dn[a, l]) * dy[a] for a in range(8))
                    J[2][l] = sum(float(dn[a, l]) * dz[a] for a in range(8))
                a00, a01, a02 = J[0]
                a10, a11, a12 = J[1]
                a20, a21, a22 = J[2]
                c00 = a11 * a22 - a12 * a21
                c01 = a12 * a20 - a10 * a22
                c02 = a10 * a21 - a11 * a20
                c10 = a02 * a21 - a01 * a22
                c11 = a00 * a22 - a02 * a20
                c12 = a01 * a20 - a00 * a21
                c20 = a01 * a12 - a02 * a11
                c21 = a02 * a10 - a00 * a12
                c22 = a00 * a11 - a01 * a10
                detJ = a00 * c00 + a01 * c01 + a02 * c02
                inv_det = 1.0 / jnp.where(jnp.abs(detJ) > 1e-30, detJ, 1e-30)
                gxs, gys, gzs = [], [], []
                for a in range(8):
                    d0, d1, d2 = float(dn[a, 0]), float(dn[a, 1]), float(dn[a, 2])
                    gxs.append((d0 * c00 + d1 * c01 + d2 * c02) * inv_det)
                    gys.append((d0 * c10 + d1 * c11 + d2 * c12) * inv_det)
                    gzs.append((d0 * c20 + d1 * c21 + d2 * c22) * inv_det)

                # Gauss-point position (B, 1, cells). In the cylindrical
                # metric x_g carries the radius r_g (and the phi coordinate
                # never enters: the sources are on the revolution axis, so
                # both the distance and grad u_s are phi-independent).
                x_g = sum(float(n[a]) * xs[a] for a in range(8))[:, None]
                y_g = 0.0 if cyl else sum(float(n[a]) * ys[a] for a in range(8))[:, None]
                z_g = sum(float(n[a]) * zs_c[a] for a in range(8))[:, None]

                # Analytic grad u_s at the Gauss point, summed over sources.
                # Cylindrical: components in the (e_r, e_phi, e_z) frame —
                # gus_x is the e_r component (= coef*r/d^3), gus_y (e_phi) = 0.
                gus_x = 0.0
                gus_y = 0.0
                gus_z = 0.0
                for k in range(src_z.shape[-1]):
                    zsk = src_z[..., k][..., None, None, None]  # (B, S, 1, 1, 1)
                    fac = src_fac[..., k][..., None, None, None]
                    ddz = z_g - zsk
                    d2 = x_g * x_g + (0.0 if cyl else y_g * y_g) + ddz * ddz
                    d3 = jnp.maximum(d2, d_min * d_min) ** 1.5
                    coef = -fac / (2.0 * jnp.pi) * inv_sig0
                    gus_x = gus_x + coef * x_g / d3
                    if not cyl:
                        gus_y = gus_y + coef * y_g / d3
                    gus_z = gus_z + coef * ddz / d3

                w_g = sig_dev * jnp.abs(detJ)[:, None]
                if cyl:
                    w_g = w_g * x_g  # volume weight r at the Gauss point
                for a in range(8):
                    term = -w_g * (
                        gus_x * gxs[a][:, None]
                        + gus_y * gys[a][:, None]
                        + gus_z * gzs[a][:, None]
                    )
                    acc[a] = term if acc[a] is None else acc[a] + term

    rhs = jnp.zeros(src_fac.shape[:2] + (nz, np_, nr), dtype=coords.dtype)
    for a, (ai, aj, ak) in enumerate(_CORNERS3):
        rhs = rhs.at[
            ..., ai : ai + nz - 1, aj : aj + np_ - 1, ak : ak + nr - 1
        ].add(acc[a])
    return rhs
