# -*- coding: utf-8 -*-
"""On-device 2D grid construction from 1D profiles (staging-traffic removal).

The boundary-fitted 2D grid is a closed-form function of four small 1D
profiles (axial lines, caliper wall, far radial stations, detach radius) and
the carved layer tables (meshing/grid2d.py:build_profiles_2d). The host path
stages the assembled (NZ, NR) coordinate/conductivity arrays — ~3 MB per
batch over the host↔device link; this module reproduces the assembly INSIDE the
chunk program from ~7 KB of profiles per batch:

* radial node positions: wall-scaled fractions, blend stations to the detach
  radius, shared far stations (grid2d.py's r_nodes construction);
* cell conductivities: layer lookup by centroid z (searchsorted over padded
  layer bottoms), invasion where r < FZ radius, mud in the wall column
  (grid2d.py:_sample_sigma parity);
* squircle blend onto the exact circular truncation boundary
  (grid2d.py:_squircle_blend parity).

float32 on device vs the host's float64 build introduces ~1e-7 relative
coordinate noise — far below the 0.07% discretization-level parity.

Replaces the reference's per-task host meshing + full-mesh transfer to the
workers (remo3d.py:822-836, workers/worker.py:82-101) with profile broadcast.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _mesh_one(spec_consts, R, z_lines, wall, far, r_detach,
              bottoms, fz_radius, sigma_fz, sigma_uz, n_layers, mud_sigma):
    """One batch: profiles -> (coords (NZ,NR,2), sigma (NZ-1,NR-1))."""
    nz, nr, wc, bc, blend_m0 = spec_consts
    dtype = z_lines.dtype

    f_in = jnp.linspace(0.0, 1.0, wc + 1, dtype=dtype)
    f_blend = jnp.linspace(0.0, 1.0, bc + 1, dtype=dtype)[1:]
    r_wall = wall[:, None] * f_in[None, :]
    r_blend = wall[:, None] + (r_detach - wall[:, None]) * f_blend[None, :]
    r_far = jnp.broadcast_to(far[None, 1:], (nz, nr - wc - bc - 1))
    r_nodes = jnp.concatenate([r_wall, r_blend, r_far], axis=1)
    z_nodes = jnp.broadcast_to(z_lines[:, None], (nz, nr))

    # Conductivity at centroids BEFORE blending (near field is conforming).
    zc = 0.25 * (z_nodes[:-1, :-1] + z_nodes[1:, :-1] + z_nodes[:-1, 1:] + z_nodes[1:, 1:])
    rc = 0.25 * (r_nodes[:-1, :-1] + r_nodes[1:, :-1] + r_nodes[:-1, 1:] + r_nodes[1:, 1:])
    idx = jnp.clip(jnp.searchsorted(bottoms, zc), 0, n_layers - 1)
    fz_r = fz_radius[idx]
    fz_r = jnp.where(jnp.isnan(fz_r), -1.0, fz_r)
    invaded = rc < fz_r
    s_fz = sigma_fz[idx]
    s_fz = jnp.where(jnp.isnan(s_fz), 0.0, s_fz)
    sigma = jnp.where(invaded, s_fz, sigma_uz[idx])
    sigma = jnp.concatenate(
        [jnp.broadcast_to(mud_sigma, (nz - 1, wc)), sigma[:, wc:]], axis=1
    )

    # Squircle blend (grid2d.py:_squircle_blend parity).
    zn = z_nodes / R
    rn = r_nodes / R
    m = jnp.maximum(jnp.abs(zn), jnp.abs(rn))
    s = jnp.clip((m - blend_m0) / (1.0 - blend_m0), 0.0, 1.0)
    w = s * s * (3.0 - 2.0 * s)
    q = jnp.where(m > 0, jnp.hypot(zn, rn) / jnp.where(m > 0, m, 1.0), 1.0)
    f = (1.0 - w) + w / jnp.where(q > 0, q, 1.0)
    coords = jnp.stack([z_nodes * f, r_nodes * f], axis=-1)
    return coords, sigma


@partial(jax.jit, static_argnames=("nz", "nr", "n_wall_cells", "n_blend_cells",
                                   "blend_m0"))
def device_mesh_2d(
    z_lines, wall, far, r_detach, bottoms, fz_radius, sigma_fz, sigma_uz,
    n_layers, mud_sigma, R, *, nz, nr, n_wall_cells, n_blend_cells, blend_m0,
):
    """Batched profiles -> (coords (B,NZ,NR,2), sigma (B,NZ-1,NR-1), free (B,NZ,NR)).

    Layer tables are padded to a common length: ``bottoms`` with +inf (so the
    searchsorted lookup never selects a pad entry below ``n_layers``),
    conductivities with benign values.
    """
    spec_consts = (nz, nr, n_wall_cells, n_blend_cells, blend_m0)
    coords, sigma = jax.vmap(
        lambda *a: _mesh_one(spec_consts, R, *a)
    )(z_lines, wall, far, r_detach, bottoms, fz_radius, sigma_fz, sigma_uz,
      n_layers, mud_sigma)
    free = jnp.ones((nz, nr), dtype=bool)
    free = free.at[0, :].set(False).at[-1, :].set(False).at[:, -1].set(False)
    free = jnp.broadcast_to(free, (coords.shape[0], nz, nr))
    return coords, sigma, free
