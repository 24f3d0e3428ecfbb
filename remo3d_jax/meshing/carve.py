# -*- coding: utf-8 -*-
"""Local model window ("carve-out") around one batch center depth.

Reproduces the reference's active-geometry-window semantics
(gmsh_functions.py:92-165, netgen_functions.py:65-97): layers are kept if they touch
the active window; invasion zones whose characteristic corners and connecting line all
fall outside the active radius are removed and their undisturbed resistivity promoted.
The first/last kept layers are treated as extending to infinity (the reference
stretches them 1% past the domain instead).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LocalModel:
    """Formation/borehole window recentered on the batch simulation depth.

    tops/bottoms: (L,) layer boundaries (z offsets from the batch center).
    fz_radius: (L,) invasion radius per layer (NaN when absent).
    sigma_fz / sigma_uz: (L,) conductivities (sigma_fz NaN when no invasion zone).
    borehole: (P, 2) polyline of (z offset, wall radius).
    mud_sigma: scalar mud conductivity at the batch center depth.
    """

    tops: np.ndarray
    bottoms: np.ndarray
    fz_radius: np.ndarray
    sigma_fz: np.ndarray
    sigma_uz: np.ndarray
    borehole: np.ndarray
    mud_sigma: float
    # Provenance for the differentiable path (remo3d_jax.diff): global
    # formation-table row of each kept layer, and which kept layers had their
    # out-of-window invasion zone removed with the FZ value promoted to UZ
    # (their "UZ" conductivity is the global row's FZ parameter).
    global_rows: np.ndarray | None = None
    fz_promoted: np.ndarray | None = None

    @property
    def invasion_radii(self) -> np.ndarray:
        r = self.fz_radius[~np.isnan(self.fz_radius)]
        return np.unique(r)

    @property
    def boundaries(self) -> np.ndarray:
        """Interior layer boundaries (z offsets) in ascending order."""
        return np.unique(np.concatenate([self.tops[1:], self.bottoms[:-1]]))


def carve_local_model(
    formation_parameters: np.ndarray,
    borehole_geometry: np.ndarray,
    mud_resistivity: float,
    simulation_depth: float,
    domain_radius: float,
    dip_rad: float = 0.0,
    active_geometry_window: float = 0.99,
) -> LocalModel:
    """Clip the global model to the simulation domain around ``simulation_depth``.

    ``formation_parameters``: (L, 5) [TOP, BOTTOM, FZ_RADIUS, FZ_RHO, UZ_RHO] (meters).
    ``borehole_geometry``: (P, 2) [depth, wall radius].
    """
    active_radius = domain_radius * active_geometry_window

    local = formation_parameters.copy().astype(float)
    local[:, :2] -= simulation_depth

    # Distance from the domain center to each (possibly dipping) layer-boundary plane:
    # |c| / sqrt(tan(dip)^2 + 1) (gmsh_functions.py:104-110).
    if dip_rad == 0:
        d = np.abs(local[:, :2])
    else:
        a = np.tan(dip_rad)
        d = np.abs(local[:, :2]) / np.sqrt(a**2 + 1)
    keep = np.any(d < active_radius, axis=1) | (
        (local[:, 0] < 0) & (local[:, 1] > 0)
    )
    global_rows = np.flatnonzero(keep)
    local = local[keep, :]

    # Invasion zones outside the active window: remove and promote UZ resistivity
    # (gmsh_functions.py:113-134 / netgen_functions.py:77-89).
    has_fz = ~np.isnan(local[:, 2])
    remove = np.zeros(local.shape[0], dtype=bool)
    if np.any(has_fz):
        if dip_rad == 0:
            x = np.repeat(local[has_fz, 2][:, None], 2, axis=1)
            y = local[has_fz, :2]
        else:
            a = np.tan(dip_rad)
            x = np.repeat(local[has_fz, 2][:, None], 4, axis=1)
            x[:, :2] *= -1
            y = a * x + np.hstack([local[has_fz, :2], local[has_fz, :2]])
        dist = np.sqrt(x**2 + y**2)
        corners_out = ~np.any(dist < active_radius, axis=1)
        line_in = (
            (local[has_fz, 0] < 0)
            & (local[has_fz, 1] > 0)
            & (local[has_fz, 2] < active_radius)
        )
        remove[has_fz] = corners_out & ~line_in
        # When the invasion boundary lies entirely outside the active window, the
        # in-domain part of the layer is fully invaded: the layer's single
        # resistivity becomes the invasion value (netgen_functions.py:87-89).
        local[remove, 4] = local[remove, 3]
        local[remove, 2] = np.nan
        local[remove, 3] = np.nan

    borehole = borehole_geometry.copy().astype(float)
    if borehole.shape[0] > 2:
        if dip_rad == 0:
            inside = (borehole[:, 0] - simulation_depth) ** 2 + borehole[:, 1] ** 2 < (
                domain_radius**2
            )
        else:
            inside = np.abs(borehole[:, 0] - simulation_depth) < domain_radius
        relevant = np.convolve(inside, np.array([True, True, True]), mode="same") > 0
        borehole = borehole[relevant, :]
    borehole[:, 0] -= simulation_depth

    with np.errstate(divide="ignore", invalid="ignore"):
        sigma_fz = np.where(np.isnan(local[:, 3]), np.nan, 1.0 / local[:, 3])
        sigma_uz = 1.0 / local[:, 4]

    return LocalModel(
        tops=local[:, 0],
        bottoms=local[:, 1],
        fz_radius=local[:, 2],
        sigma_fz=sigma_fz,
        sigma_uz=sigma_uz,
        borehole=borehole,
        mud_sigma=1.0 / float(mud_resistivity),
        global_rows=global_rows,
        fz_promoted=remove,
    )
