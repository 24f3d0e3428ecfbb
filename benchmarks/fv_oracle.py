# -*- coding: utf-8 -*-
"""Independent float64 finite-volume axisymmetric oracle.

A completely separate discretization + solver from the main package: conservative
node-centered finite volumes on a tensor grid (area-weighted axial face
conductances, log-radius radial shell conductances), assembled with scipy.sparse
and solved DIRECTLY in float64. It shares no code with the FEM path (different
discretization, different solver, different precision), so agreement is real
evidence. Two uses:

* thin-bed golden investigation (benchmarks/thinbed_parity.py): at z=5 and z=13
  this oracle agrees with the package's FEM to <=0.07% while both sit ~4.5% from
  the reference's committed A8.0M1.0N golden;
* BM2 invasion-zone gate (benchmarks/bm2_oracle.py): the oracle resolves the
  per-layer invasion zones (FZ_RADIUS/FZ_VALUE columns) that the reference
  validates with Examples/Benchmark models/Benchmark model 2/Formation_BM2.txt:3-9.

Usage (thin-bed CLI, preserved): python benchmarks/fv_oracle.py [measurement_depth]
"""
import os
import sys

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

try:
    import remo3d_jax  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from remo3d_jax.io import load_formation_parameters
from remo3d_jax.tools import parse_tool


def _build_z_grid(z_src, receivers, bounds, R_dom, n_base, h_min):
    """Axial node lines: uniform base, geometric refinement at source/receivers,
    snapped bed boundaries.

    The union of the base grid with the per-electrode refinement combs produces
    NEAR-DUPLICATE nodes (down to machine-epsilon spacings), whose ~1e15-scale
    face conductances poison the solve with a receiver-dependent phantom offset
    that GROWS under refinement (measured: the monopole deficit c_eff went
    0.018 -> 0.45 from a clean uniform grid to the raw union at nb=6001).
    Nodes are therefore merged into clusters with tolerance h_min/4; a cluster
    containing a mandatory node (source/receiver/bed boundary) collapses to it
    exactly, any other cluster to its mean.
    """
    lo, hi = z_src - R_dom, z_src + R_dom
    b_in = bounds[(bounds > lo) & (bounds < hi)]
    # Priority order: later entries win if two mandatory nodes share a cluster
    # (receivers/source must stay exact — callers look them up with z == c).
    mandatory = np.concatenate([b_in, [lo, hi, z_src], np.asarray(receivers)])
    pts = [np.linspace(lo, hi, n_base), mandatory]
    for c in (z_src, *receivers):
        pts.append(
            c
            + np.concatenate(
                [-np.geomspace(h_min, 3.0, 60)[::-1], np.geomspace(h_min, 3.0, 60)]
            )
        )
    for c in b_in:
        pts.append(c + np.array([-0.02, 0.02]))
    z = np.sort(np.clip(np.concatenate(pts), lo, hi))
    tol = h_min / 4
    cluster = np.concatenate([[0], np.cumsum(np.diff(z) >= tol)])
    # cluster -> mean, then overwrite with the mandatory member where present
    sums = np.zeros(cluster[-1] + 1)
    np.add.at(sums, cluster, z)
    counts = np.zeros(sums.size)
    np.add.at(counts, cluster, 1.0)
    out = sums / counts
    m_cluster = cluster[np.searchsorted(z, mandatory)]
    out[m_cluster] = mandatory
    return np.unique(out)


def _build_r_grid(rw, invasion_radii, R_dom, n_wall, n_out):
    """Radial stations: linear to the wall, log-graded beyond, invasion radii
    snapped as exact stations."""
    r_in = np.linspace(0, rw, n_wall)
    r_out = rw * np.geomspace(1.0, R_dom / rw, n_out)[1:]
    r = np.unique(np.concatenate([r_in, r_out]))
    for c in invasion_radii:
        if rw < c < R_dom:
            j = np.argmin(np.abs(r - c))
            if r[j] > rw:  # never unsnap the wall itself
                r[j] = c
    return np.unique(r)


def _fv_matrix(sig, z, r):
    """Assemble the full (no-BC) FV conduction matrix for cell conductivities
    ``sig`` on the tensor grid (z, r)."""
    NZ, NR = z.size, r.size
    zc = 0.5 * (z[:-1] + z[1:])
    rc = 0.5 * (r[:-1] + r[1:])

    # ---- FV conductances -------------------------------------------------------
    # z-face between nodes (i,j),(i+1,j): band area x band-averaged sigma / dz.
    dz = np.diff(z)
    re = np.concatenate([[0.0], rc, [r[-1]]])
    band_area = np.pi * (re[1:] ** 2 - re[:-1] ** 2)
    area_lo = np.pi * (r**2 - re[:-1] ** 2)
    area_hi = np.pi * (re[1:] ** 2 - r**2)
    sig_pad = np.pad(sig, [(0, 0), (1, 1)], mode="edge")
    band_sig = (
        area_lo[None, :] * sig_pad[:, :-1] + area_hi[None, :] * sig_pad[:, 1:]
    ) / band_area[None, :]
    Gz = band_sig * band_area[None, :] / dz[:, None]

    # r-face between nodes (i,j),(i,j+1): cylindrical-shell conductance over the
    # node's z band.
    dzn = np.diff(np.concatenate([[z[0]], zc, [z[-1]]]))
    with np.errstate(divide="ignore"):
        lnr = np.log(r[1:] / np.maximum(r[:-1], 1e-12))
    lnr[0] = np.log(r[1] / (0.25 * r[1]))  # axis cell: effective inner radius
    shell = 2 * np.pi / lnr
    sig_zpad = np.pad(sig, [(1, 1), (0, 0)], mode="edge")
    dz_lo = np.concatenate([[0.0], dz]) / 2
    dz_hi = np.concatenate([dz, [0.0]]) / 2
    sig_node_band = (
        dz_lo[:, None] * sig_zpad[:-1, :] + dz_hi[:, None] * sig_zpad[1:, :]
    ) / dzn[:, None]
    Gr = shell[None, :] * sig_node_band * dzn[:, None]

    # ---- assembly --------------------------------------------------------------
    N = NZ * NR
    I, J = np.meshgrid(np.arange(NZ - 1), np.arange(NR), indexing="ij")
    A_, B_ = (I * NR + J).ravel(), ((I + 1) * NR + J).ravel()
    Gzf = Gz.ravel()
    I2, J2 = np.meshgrid(np.arange(NZ), np.arange(NR - 1), indexing="ij")
    C_, D_ = (I2 * NR + J2).ravel(), (I2 * NR + J2 + 1).ravel()
    Grf = Gr.ravel()
    rows = np.concatenate([A_, A_, B_, B_, C_, C_, D_, D_])
    cols = np.concatenate([A_, B_, B_, A_, C_, D_, D_, C_])
    vals = np.concatenate([Gzf, -Gzf, Gzf, -Gzf, Grf, -Grf, Grf, -Grf])
    return sp.csr_matrix((vals, (rows, cols)), shape=(N, N))


def fv_solve_axis(z_src, sigma_of_cells, z, r, subtract_sigma0=None, disc_radius=None):
    """Unit point source at (z_src, r=0); returns u on the axis nodes (float64).

    sigma_of_cells(zc, rc) -> (NZ-1, NR-1) cell conductivities, evaluated at the
    cell centers of the tensor grid (z, r).

    ``disc_radius``: by default the homogeneous-Dirichlet truncation boundary is
    the grid box (|z - z_src| = R_dom, r = r_max). The FEM path and the
    reference both truncate on a DISC of radius ``domain_radius`` centered on
    the source (gmsh_functions.py:581, netgen_functions.py circle arc), whose
    truncation error is LARGER (the box contains the disc). Passing a radius
    additionally pins every node with sqrt((z-z_src)^2 + r^2) >= disc_radius,
    turning the boundary into a staircase approximation of that disc — the
    geometry error is O(local grid spacing) at distance ~R from the receivers,
    far below truncation-delta scales. Used by a removed study script to
    reproduce the Example_02 domain_radius=25 truncation.

    With ``subtract_sigma0`` the full-space fundamental field
    u_s = 1/(4*pi*sigma0*d) of the uniform medium sigma0 (the mud, which
    surrounds the source) is subtracted ANALYTICALLY: the correction w solves
    ``A w = (A0 - A) u_s`` with w = -u_s on the truncation boundary, where A0 is
    the same FV matrix assembled for the uniform medium. (A0 - A) vanishes
    identically wherever sigma == sigma0 — in particular on every row near the
    source — so the slowly-converging discrete-delta near field never enters the
    discrete problem. This is the FV counterpart of the FEM path's singularity
    subtraction (remo3d_jax/ops/assembly2d.py) computed in a completely
    different discretization, so the two stay independent evidence. Without it,
    short source-receiver spacings (e.g. the 0.4 m of B5.7A0.4M) converge so
    slowly in the near field that no affordable grid settles below ~1%.
    """
    NZ, NR = z.size, r.size
    zc = 0.5 * (z[:-1] + z[1:])
    rc = 0.5 * (r[:-1] + r[1:])
    sig = sigma_of_cells(zc, rc)
    A = _fv_matrix(sig, z, r)
    N = NZ * NR
    i_src = int(np.where(z == z_src)[0][0])

    mask = np.zeros((NZ, NR), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, -1] = True
    if disc_radius is not None:
        dist = np.sqrt((z[:, None] - z_src) ** 2 + r[None, :] ** 2)
        mask |= dist >= float(disc_radius)
    mask = mask.ravel()
    keep = ~mask

    if subtract_sigma0 is None:
        b = np.zeros(N)
        b[i_src * NR] = 1.0
        u = np.zeros(N)
        u[keep] = spla.spsolve(A[keep][:, keep].tocsc(), b[keep])
        return u.reshape(NZ, NR)[:, 0]

    sigma0 = float(subtract_sigma0)
    A0 = _fv_matrix(np.full_like(sig, sigma0), z, r)
    d = np.sqrt((z[:, None] - z_src) ** 2 + r[None, :] ** 2)
    with np.errstate(divide="ignore"):
        u_s = 1.0 / (4.0 * np.pi * sigma0 * d)
    # The source-node value multiplies only exact zeros of (A0 - A) (all cells
    # around the source are mud); any finite placeholder works.
    u_s[i_src, 0] = 0.0
    u_s = u_s.ravel()
    rhs = (A0 - A) @ u_s
    w_b = -u_s[mask]
    rhs_k = rhs[keep] - A[keep][:, mask] @ w_b
    w = np.empty(N)
    w[mask] = w_b
    w[keep] = spla.spsolve(A[keep][:, keep].tocsc(), rhs_k)
    return (u_s + w).reshape(NZ, NR)[:, 0]


def fv_apparent_resistivity(
    tool_name,
    z_meas,
    formation,
    rw,
    rho_mud,
    domain_radius=50.0,
    n_base=3001,
    n_r_out=220,
    h_min=0.004,
    subtract=False,
    disc_domain=False,
    rw_profile=None,
):
    """Apparent resistivity of ``tool_name`` at measurement depth ``z_meas``.

    formation: (L, 5) reference layout [TOP, BOTTOM, FZ_RADIUS, FZ_VALUE, UZ_VALUE]
    (NaN FZ entries = no invasion zone). Single-current tools only (two-current
    tools are first rewritten via reciprocity, exactly like the package's SEC
    mode, remo3d.py:211-214).

    ``rw_profile``: optional (N, 2) [DEPT, radius_m] polyline for a
    depth-VARYING borehole wall (the caliper logs of Example_01's Borehole.txt
    and the reference's caliper-following gmsh walls, gmsh_functions.py:33-88).
    The wall becomes a staircase on the radial stations; the grid adds dense
    stations across the caliper band [min rw, max rw] so the staircase step is
    a fraction of the caliper variation itself. ``rw`` still sets the nominal
    wall used for grid grading; ``rho_mud`` must describe the mud at every
    depth (the analytic subtraction needs sigma == sigma_mud in the cells
    adjacent to the source).
    """
    tp = parse_tool(tool_name, force_single_electrode_configuration=True)
    if not tp.is_single_current:
        raise ValueError(f"{tool_name} has two current electrodes even after the "
                         "reciprocity rewrite; the FV oracle solves one source")
    z_src = z_meas + tp.depth_shift
    receivers = z_src + tp.measuring_offsets

    formation = np.asarray(formation, dtype=float)
    bounds = formation[:-1, 1]
    rho_uz = formation[:, 4]
    fz_radius = formation[:, 2]
    rho_fz = formation[:, 3]

    z = _build_z_grid(z_src, receivers, bounds, domain_radius, n_base, h_min)
    inv = fz_radius[np.isfinite(fz_radius)]
    r = _build_r_grid(rw, np.unique(inv), domain_radius, 9, n_r_out)
    if rw_profile is not None:
        rw_profile = np.asarray(rw_profile, dtype=float)
        # Staircase-wall convergence is second-order in the band spacing
        # (measured at BM2-dip z=20: 17/33/65 stations -> 13.2122/13.1854/
        # 13.1789, Richardson limit 13.177); 65 stations leave ~0.01%.
        band = np.linspace(rw_profile[:, 1].min(), rw_profile[:, 1].max(), 65)
        r = np.unique(np.concatenate([r, band]))

    def sigma_of_cells(zc, rc):
        li = np.clip(np.searchsorted(bounds, zc), 0, rho_uz.size - 1)
        sig = np.empty((zc.size, rc.size))
        sig[:] = (1.0 / rho_uz[li])[:, None]
        has_fz = np.isfinite(fz_radius[li]) & np.isfinite(rho_fz[li])
        in_fz = has_fz[:, None] & (rc[None, :] < np.where(has_fz, fz_radius[li], 0.0)[:, None])
        sig = np.where(in_fz, (1.0 / np.where(has_fz, rho_fz[li], 1.0))[:, None], sig)
        if rw_profile is None:
            sig[:, rc < rw] = 1.0 / rho_mud
        else:
            rw_z = np.interp(zc, rw_profile[:, 0], rw_profile[:, 1])
            sig = np.where(rc[None, :] < rw_z[:, None], 1.0 / rho_mud, sig)
        return sig

    u_axis = fv_solve_axis(
        z_src, sigma_of_cells, z, r,
        subtract_sigma0=(1.0 / rho_mud) if subtract else None,
        disc_radius=domain_radius if disc_domain else None,
    )
    u_rec = [u_axis[int(np.where(z == zr)[0][0])] for zr in receivers]
    du = u_rec[0] - u_rec[1] if len(u_rec) == 2 else u_rec[0]
    return abs(tp.geometric_factor * du)


def main():
    # Thin-bed CLI (the original behavior of this script): A8.0M1.0N on
    # Formation_model_1 with the thin-bed borehole (rw=0.1, mud 0.35).
    TB = "/root/reference/Examples/Benchmark models/Thin-bedded model"
    formation = load_formation_parameters(
        os.path.join(TB, "Formation", "Formation_model_1.txt")
    )
    z_meas = float(sys.argv[1]) if len(sys.argv) > 1 else 5.0
    ra = fv_apparent_resistivity("A8.0M1.0N", z_meas, formation, rw=0.1, rho_mud=0.35)
    print(f"z_meas={z_meas}: FV oracle Ra = {ra:.4f}")


if __name__ == "__main__":
    main()
