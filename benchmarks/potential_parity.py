# -*- coding: utf-8 -*-
"""Potential-level parity evidence for the BASELINE north star.

BASELINE.md:25 asks for "potential parity vs NGSolve to 1e-6 relative on the
benchmark models" (solver context /root/reference/remo3d/ngsolve_functions.py:50).
NGSolve is unavailable in this environment, so the honest decomposition is:

* ``oracle`` — float64 FEM axis POTENTIALS vs the float64 finite-volume oracle
  (benchmarks/fv_oracle.py — an entirely independent discretization + sparse
  direct solver) at receiver offsets swept over BM1 + BM2 source depths. This
  bounds the DISCRETIZATION parity between two unrelated f64 methods.
* ``converge`` — float64 FEM self-convergence under uniform grid refinement:
  CG residual driven to 1e-13, potentials at the pinned receiver offsets
  compared between consecutive refinement levels. This is the arithmetic +
  convergence half of the 1e-6 story: the discrete solution itself is resolved
  far below 1e-6, and the refinement ladder measures how close the converged
  discrete potentials are to the mesh limit.

Both run in float64 on CPU (the executor runs float64 on the CPU only —
parallel/runtime.py dtype guard). Results are recorded in README.md
("Potential-level parity") and one BM1 depth is gated in
tests/test_potential_parity.py.

A full-resolution sweep takes tens of minutes on a single CPU core, so every
(case, depth) / scale result is cached in ``benchmarks/.parity_cache/`` and
the sweep can be run piecewise:

    python benchmarks/potential_parity.py oracle [CASE [DEPTH]]
    python benchmarks/potential_parity.py converge [SCALE ...]
    python benchmarks/potential_parity.py report     # assemble cached results
"""
import dataclasses
import json
import os
import sys

import numpy as np

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".parity_cache")


def _cache_get(key):
    path = os.path.join(CACHE_DIR, key + ".json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def _cache_put(key, value):
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, key + ".json")
    with open(path, "w") as f:
        json.dump(value, f)

try:
    import remo3d_jax  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BM = "/root/reference/Examples/Benchmark models"
R_DOM = 50.0
# Receiver offsets (m) relative to the source: covers the short-normal to
# long-lateral spacing range of the reference tool set.
OFFSETS = np.array([-4.0, -2.0, -1.0, -0.5, 0.5, 1.0, 2.0, 4.0])


def _load(formation_file):
    from remo3d_jax.io import load_formation_parameters

    return load_formation_parameters(formation_file)


def fem_axis_potentials(
    formation, z_src, offsets, spec=None, rw=0.1, rho_mud=1.0,
    tol=1e-13, maxiter=4000, preconditioner="multigrid", dtype=np.float64,
):
    """Float64 single-source FEM solve; returns (u(offset), rel_residual, iters).

    Drives the SAME production kernels as the executor (_solve_chunk /
    _solve_chunk_direct, parallel/runtime.py) on one hand-staged batch, with
    the receiver offsets pinned as electrode nodes so the readout needs no
    interpolation.
    """
    import jax

    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)

    from remo3d_jax.meshing.carve import carve_local_model
    from remo3d_jax.meshing.grid2d import GridSpec2D, build_grid2d
    from remo3d_jax.parallel.runtime import _solve_chunk, _solve_chunk_direct

    spec = spec or GridSpec2D()
    borehole = np.array([[-1000.0, rw, rho_mud], [1000.0, rw, rho_mud]])
    lm = carve_local_model(formation, borehole[:, :2], rho_mud, z_src, R_DOM)
    # Receivers AND the source must be pinned grid lines (the planner passes the
    # combined electrode array the same way; sources only add grading).
    pinned = np.unique(np.concatenate([np.asarray(offsets, float), [0.0]]))
    grid = build_grid2d(spec, R_DOM, lm, pinned, np.array([0.0]))

    with jax.default_device(jax.devices("cpu")[0]):
        coords = np.ascontiguousarray(grid.coords[None].astype(dtype))
        sigma = np.ascontiguousarray(grid.sigma_cells[None].astype(dtype))
        free = np.ascontiguousarray(grid.free_mask[None])
        src_i = np.full((1, 1, 2), grid.axis_node_index(0.0), dtype=np.int32)
        src_fac = np.zeros((1, 1, 2), dtype=dtype)
        src_fac[0, 0, 0] = 1.0
        if preconditioner == "direct":
            u_axis, res, iters = _solve_chunk_direct(
                coords, sigma, free, src_i, src_fac, tol=tol, maxiter=maxiter,
            )
        else:
            u_axis, res, iters = _solve_chunk(
                coords, sigma, free, src_i, src_fac, tol=tol, maxiter=maxiter,
                preconditioner=preconditioner,
            )
    u_axis = np.asarray(u_axis)[0, 0]
    u = np.array([u_axis[grid.axis_node_index(o)] for o in offsets])
    return u, float(np.asarray(res)[0, 0]), int(np.asarray(iters))


def fv_axis_potentials(formation, z_src, offsets, rw=0.1, rho_mud=1.0,
                       n_base=3001, n_r_out=220):
    """Float64 FV-oracle potentials at z_src + offsets (exact grid nodes)."""
    from benchmarks.fv_oracle import _build_r_grid, _build_z_grid, fv_solve_axis

    formation = np.asarray(formation, float)
    bounds = formation[:-1, 1]
    rho_uz = formation[:, 4]
    fz_radius = formation[:, 2]
    rho_fz = formation[:, 3]
    receivers = z_src + np.asarray(offsets, float)

    z = _build_z_grid(z_src, receivers, bounds, R_DOM, n_base, 0.004)
    inv = fz_radius[np.isfinite(fz_radius)]
    r = _build_r_grid(rw, np.unique(inv), R_DOM, 9, n_r_out)

    def sigma_of_cells(zc, rc):
        li = np.clip(np.searchsorted(bounds, zc), 0, rho_uz.size - 1)
        sig = np.empty((zc.size, rc.size))
        sig[:] = (1.0 / rho_uz[li])[:, None]
        has_fz = np.isfinite(fz_radius[li]) & np.isfinite(rho_fz[li])
        in_fz = has_fz[:, None] & (
            rc[None, :] < np.where(has_fz, fz_radius[li], 0.0)[:, None]
        )
        sig = np.where(in_fz, (1.0 / np.where(has_fz, rho_fz[li], 1.0))[:, None], sig)
        sig[:, rc < rw] = 1.0 / rho_mud
        return sig

    u_axis = fv_solve_axis(z_src, sigma_of_cells, z, r, subtract_sigma0=1.0 / rho_mud)
    return np.array([u_axis[int(np.where(z == zr)[0][0])] for zr in receivers])


# BM1/BM2 spot source depths: bed centers of both resistivity classes plus a
# boundary-adjacent station; BM2 covers all three invasion radii (0.2/0.35/0.5).
CASES = [
    ("BM1", "Benchmark model 1/Formation_BM1.txt", [13.5, 19.5, 32.5, 18.0]),
    ("BM2", "Benchmark model 2/Formation_BM2.txt", [10.0, 30.0, 50.0]),
]


def _oracle_one(name, path, zs):
    """One (case, depth) FEM-vs-FV comparison, cached on disk."""
    key = f"oracle_{name}_z{zs:g}"
    hit = _cache_get(key)
    if hit is None:
        formation = _load(os.path.join(BM, path))
        u_fem, res, iters = fem_axis_potentials(formation, zs, OFFSETS)
        u_fv = fv_axis_potentials(formation, zs, OFFSETS)
        hit = {
            "u_fem": list(map(float, u_fem)),
            "u_fv": list(map(float, u_fv)),
            "res": res,
            "iters": iters,
        }
        _cache_put(key, hit)
    rel = np.abs(np.array(hit["u_fem"]) / np.array(hit["u_fv"]) - 1.0)
    print(
        f"  {name} z_src={zs:5.1f}: max {rel.max():.2e} mean {rel.mean():.2e}"
        f"  (CG res {hit['res']:.1e}, {hit['iters']} iters)",
        flush=True,
    )
    return rel.max()


def run_oracle(case=None, depth=None):
    print("FEM(f64, tol 1e-13) vs FV oracle(f64, direct) axis potentials")
    print(f"offsets: {OFFSETS}")
    worst = 0.0
    n_run = 0
    for name, path, depths in CASES:
        if case is not None and name != case:
            continue
        for zs in depths:
            if depth is not None and abs(zs - depth) > 1e-9:
                continue
            worst = max(worst, _oracle_one(name, path, zs))
            n_run += 1
    print(f"[oracle] worst FEM-vs-FV relative potential diff ({n_run} depths): {worst:.2e}")


def _scaled_spec(s: int):
    """Uniformly refine the default grid: s x the node lines, 1/s the h floors."""
    from remo3d_jax.meshing.grid2d import GridSpec2D

    d = GridSpec2D()
    return dataclasses.replace(
        d,
        nz=s * (d.nz - 1) + 1,
        nr=s * (d.nr - 1) + 1,
        h_min_source=d.h_min_source / s,
        slope_source=d.slope_source / s,
        h_min_electrode=d.h_min_electrode / s,
        slope_electrode=d.slope_electrode / s,
        h_min_boundary=d.h_min_boundary / s,
        slope_boundary=d.slope_boundary / s,
        h_max_axial_frac=d.h_max_axial_frac / s,
        h_min_radial=d.h_min_radial / s,
        slope_radial=d.slope_radial / s,
        h_max_radial_frac=d.h_max_radial_frac / s,
    )


def _converge_one(formation, zs, s):
    key = f"converge_BM1_z{zs:g}_s{s}"
    hit = _cache_get(key)
    if hit is None:
        u, res, iters = fem_axis_potentials(formation, zs, OFFSETS, spec=_scaled_spec(s))
        hit = {"u": list(map(float, u)), "res": res, "iters": iters}
        _cache_put(key, hit)
    print(f"  scale {s}: CG res {hit['res']:.1e} iters {hit['iters']}", flush=True)
    return np.array(hit["u"])


def run_converge(scales=None):
    formation = _load(os.path.join(BM, "Benchmark model 1/Formation_BM1.txt"))
    zs = 13.5
    print(f"f64 self-convergence, BM1 z_src={zs} (residual tol 1e-13)")
    if scales:  # piecewise mode: just populate the cache for these scales
        for s in scales:
            _converge_one(formation, zs, s)
        return
    scales = [1, 2, 4]
    us = [_converge_one(formation, zs, s) for s in scales]
    for a, b in zip(range(len(scales) - 1), range(1, len(scales))):
        rel = np.abs(us[b] / us[a] - 1.0)
        print(
            f"  |u({scales[b]}x) - u({scales[a]}x)| / u: max {rel.max():.2e} "
            f"mean {rel.mean():.2e}"
        )
    # Richardson: second-order elements => error(h) ~ C h^2; the 2x->4x delta
    # is ~1/4 of 1x->2x if clean h^2 convergence holds, and the remaining
    # distance from u(4x) to the mesh limit is ~delta(2x->4x)/3.
    d12 = np.abs(us[1] - us[0])
    d24 = np.abs(us[2] - us[1])
    order = np.log2(np.where(d24 > 0, d12 / np.maximum(d24, 1e-300), 1.0))
    est_rem = np.abs(d24 / 3.0 / us[2])
    print(f"  observed convergence order per offset: {np.round(order, 2)}")
    print(
        f"  Richardson remaining-error estimate at 4x: max {est_rem.max():.2e} "
        f"mean {est_rem.mean():.2e}"
    )


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which == "oracle":
        case = sys.argv[2] if len(sys.argv) > 2 else None
        depth = float(sys.argv[3]) if len(sys.argv) > 3 else None
        run_oracle(case, depth)
    elif which == "converge":
        run_converge([int(s) for s in sys.argv[2:]] or None)
    elif which in ("all", "report"):
        # "report" only differs in intent: with a warm cache it assembles the
        # full table without re-solving anything.
        run_oracle()
        run_converge()
    else:
        raise SystemExit(f"unknown mode {which!r}")
