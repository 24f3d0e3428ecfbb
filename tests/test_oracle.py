# -*- coding: utf-8 -*-
"""Semi-analytic layered-medium oracle + FEM-vs-oracle accuracy tests.

The oracle (utils/layered_oracle.py) is the independent truth source for the
far-field accuracy of long-spacing lateral tools — the regime where the
reference's committed thin-bed goldens were found to carry a few-percent error
of their own (see benchmarks/thinbed_parity.py notes): our FEM and an
independent float64 finite-volume solve agree to <0.1% while both sit ~4.5%
from the golden for the K~905 tool A8.0M1.0N.
"""

import numpy as np
import pytest

from remo3d_jax.utils.layered_oracle import (
    layered_apparent_resistivity,
    layered_axis_potential,
)


def test_oracle_uniform_medium_reduces_to_coulomb():
    u = layered_axis_potential(
        np.array([0.0]), np.array([0.5, 0.5]), -1.0, np.array([1.0, 2.0])
    )
    exact = 1 / (4 * np.pi * 0.5) / np.array([2.0, 3.0])
    assert np.allclose(u, exact, rtol=1e-9)


def test_oracle_two_halfspaces_matches_image_solution():
    s1, s2 = 0.5, 0.1
    refl = (s1 - s2) / (s1 + s2)
    for zr in (-3.0, -0.5, -10.0, 2.0):
        u = layered_axis_potential(
            np.array([0.0]), np.array([s1, s2]), -1.0, np.array([zr])
        )[0]
        if zr < 0:  # same side: source + image
            exact = 1 / (4 * np.pi * s1) * (1 / abs(zr + 1) + refl / abs(zr - 1))
        else:  # transmission
            exact = (1 + refl) / (4 * np.pi * s1 * abs(zr + 1))
        assert abs(u / exact - 1) < 1e-4, zr


def test_oracle_offaxis_matches_image_solution():
    """Off-axis (J0 Hankel) evaluation — the rotated-frame dipping anchor path —
    vs the exact image-charge solution for two half-spaces."""
    from remo3d_jax.utils.layered_oracle import LayeredOracle

    s1, s2 = 0.5, 0.1
    refl = (s1 - s2) / (s1 + s2)
    oracle = LayeredOracle(np.array([0.0]), np.array([s1, s2]), n_lambda=4000)
    z_src = -1.0
    for r, zr in [(0.5, -3.0), (1.0, -0.5), (2.0, -2.0), (0.7, 1.5)]:
        u = oracle.potentials(
            np.array([z_src]), np.array([zr]), r_receivers=r
        )[0, 0]
        d_src = np.hypot(r, zr - z_src)
        d_img = np.hypot(r, zr + z_src)  # image mirrored across z=0
        if zr < 0:
            exact = 1 / (4 * np.pi * s1) * (1 / d_src + refl / d_img)
        else:
            exact = (1 + refl) / (4 * np.pi * s1 * d_src)
        assert abs(u / exact - 1) < 2e-4, (r, zr, u, exact)


def test_oracle_reciprocity():
    # Swap source and receiver across a layer stack: potentials must match.
    bounds = np.array([-0.5, 0.0, 0.4, 1.1])
    sig = np.array([0.1, 0.5, 0.05, 0.3, 0.2])
    u_ab = layered_axis_potential(bounds, sig, -2.0, np.array([3.0]))[0]
    u_ba = layered_axis_potential(bounds, sig, 3.0, np.array([-2.0]))[0]
    assert abs(u_ab / u_ba - 1) < 1e-4  # quadrature noise ~2e-5


def test_fem_matches_layered_oracle_long_lateral():
    """End-to-end far-field accuracy: a long lateral (K~452) over a random
    thin-bedded stack with a negligible borehole must match the semi-analytic
    oracle. This is the accuracy statement the thin-bed golden cannot provide."""
    from remo3d_jax import Model
    from remo3d_jax.meshing.grid2d import GridSpec2D
    from remo3d_jax.tools import parse_tools

    rng = np.random.default_rng(11)
    edges = np.cumsum(rng.uniform(0.12, 0.5, 40)) - 4.0
    rho = rng.uniform(1.5, 9.0, 41)
    formation = np.column_stack(
        [
            np.concatenate([[-1000.0], edges]),
            np.concatenate([edges, [1000.0]]),
            np.full(41, np.nan),
            np.full(41, np.nan),
            rho,
        ]
    )
    borehole = np.array([[-1000.0, 0.002, 4.0], [1000.0, 0.002, 4.0]])

    tool = "A4.0M0.5N"
    tools, _ = parse_tools([tool], True)
    tp = tools[tool]
    depths = np.array([0.0])

    m = Model([tool])
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius")
    m.initialize_workers(cpu_workers=1)
    m.simulate_logs(
        depths,
        grid_spec=GridSpec2D(nz=321, nr=65, n_wall_cells=4, n_blend_cells=2),
        platform="cpu",
        preconditioner="local",
        maxiter=30000,
        verbose=False,
    )
    fem = m.logs[tool][:, 1]

    offs = np.concatenate([[0.0], tp.geometry[tp.source_terms == 0]])
    ana = np.array(
        [
            layered_apparent_resistivity(
                edges, rho, offs, tp.geometric_factor, d + tp.depth_shift
            )
            for d in depths
        ]
    )
    assert np.all(np.isfinite(fem))
    # Measured 0.08% on this grid; 1% bound leaves headroom for BLAS variation.
    assert np.max(np.abs(fem / ana - 1)) < 0.01, (fem, ana)
