# -*- coding: utf-8 -*-
"""Gates for the independent float64 finite-volume oracle (benchmarks/fv_oracle.py)
and the BM2 invasion-zone agreement it anchors.

The oracle is the package's only independent f64 instrument (the reference
validates invasion physics with Benchmark model 2,
Examples/Benchmark models/Benchmark model 2/Formation_BM2.txt:3-9, but ships no
logs for it) — so the oracle itself needs a truth anchor: the uniform full
space, where u = I/(4*pi*sigma*d) exactly and domain truncation is a known
~1/R monopole deficit.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks"))

from fv_oracle import _build_z_grid, fv_apparent_resistivity, fv_solve_axis  # noqa: E402

BM2 = "/root/reference/Examples/Benchmark models/Benchmark model 2"


def test_z_grid_has_no_near_duplicate_nodes():
    # The raw union of base grid + refinement combs used to leave 1e-15 m
    # spacings whose ~1e15-scale conductances poisoned the solve with a
    # receiver-dependent offset GROWING under refinement (round-3 find).
    recv = np.array([0.4, 1.0, 5.7])
    bounds = np.array([0.39, 2.0])  # one boundary 0.01 m from a receiver
    z = _build_z_grid(0.0, recv, bounds, 50.0, 3001, 0.004)
    assert np.diff(z).min() > 1e-4
    # mandatory nodes survive the cluster merge exactly
    for c in (0.0, *recv, *bounds):
        assert np.any(z == c), c


@pytest.mark.parametrize("subtract", [False, True])
def test_uniform_full_space_matches_analytic(subtract):
    sig = 0.1
    recv = np.array([0.4, 1.0, 5.7])
    R = 25.0
    z = _build_z_grid(0.0, recv, np.array([]), R, 1001, 0.004)
    r_out = 0.1 * np.geomspace(1.0, R / 0.1, 80)
    r = np.unique(np.concatenate([np.linspace(0, 0.1, 9), r_out]))
    u = fv_solve_axis(
        0.0,
        lambda zc, rc: np.full((zc.size, rc.size), sig),
        z,
        r,
        subtract_sigma0=sig if subtract else None,
    )
    uu = np.array([u[int(np.where(z == c)[0][0])] for c in recv])
    ana = 1.0 / (4 * np.pi * sig * recv)
    # truncated-domain deficit: a positive, nearly constant monopole term ~1/R
    c_eff = (ana - uu) * 4 * np.pi * sig
    assert np.all(c_eff > 0.3 / R) and np.all(c_eff < 3.0 / R), c_eff
    assert np.ptp(c_eff) < 0.2 / R, c_eff
    # potential DIFFERENCES (what every readout uses) are truncation-free
    d_num = uu[0] - uu[1]
    d_ana = ana[0] - ana[1]
    assert abs(d_num / d_ana - 1) < 5e-3, d_num / d_ana - 1


def test_bm2_invasion_fem_matches_fv_on_cpu():
    # Reduced-resolution version of benchmarks/bm2_oracle.py (production
    # grids: worst 0.19% over 2 tools x 7 depths, README). One invaded-bed
    # depth, short-normal tool, small-grid CPU FEM vs subtracted FV, with
    # correspondingly coarse tolerance (measured +0.57% on these grids).
    from remo3d_jax import Model
    from remo3d_jax.io import load_formation_parameters
    from remo3d_jax.meshing.grid2d import GridSpec2D

    depth = 25.5
    tool = "B5.7A0.4M"
    formation = load_formation_parameters(os.path.join(BM2, "Formation_BM2.txt"))
    m = Model([tool], force_single_electrode_configuration=True)
    m.set_model_parameters(
        os.path.join(BM2, "Formation_BM2.txt"), os.path.join(BM2, "Borehole_BM2.txt")
    )
    m.initialize_workers()
    m.simulate_logs(
        np.array([depth]),
        platform="cpu",
        verbose=False,
        grid_spec=GridSpec2D(nz=193, nr=41, n_wall_cells=6, n_blend_cells=3),
    )
    fem = m.logs[tool][0, 1]
    fv = fv_apparent_resistivity(
        tool, depth, formation, 0.1, 1.0, n_base=1001, n_r_out=100, subtract=True
    )
    assert abs(fem / fv - 1) < 2e-2, (fem, fv)
