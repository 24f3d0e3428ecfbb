# -*- coding: utf-8 -*-
"""Rotated layered-medium oracle gate for the 3D dipping path (CPU, small grid).

A dipping-layer full space is a rigid rotation of a horizontal stack, so the
semi-analytic layered oracle evaluated along the tilted electrode line (off-axis
J0 mode) is EXACT for the BM3-style model with a negligible borehole — the
independent anchor for the reference's Benchmark-model-3 capability
(Examples/Benchmark models/Benchmark model 3/ upstream,
remo3d/gmsh_functions.py:544-684). The production-grid accuracy numbers live in
benchmarks/bm3_oracle.py + README; this CPU gate uses a moderately-coarse grid
(145x9x49) whose mid-bed error is small enough (measured -1.42%) that a real
solver regression moves it out of tolerance — VERDICT r3 weak #6 replaced the
original 97x9x33 grid, whose -2.97% mid-bed error needed a 4.5% gate that
masked percent-scale regressions.
"""

import numpy as np

from benchmarks.bm3_oracle import fem_log, oracle_log
from remo3d_jax.meshing.grid3d import GridSpec3D


def test_bm3_dip30_matches_rotated_oracle_on_cpu():
    depths = np.array([10.0, 12.5, 16.0])  # shoulder, mid-bed, shoulder
    ana = oracle_log("A1.0M0.2N", depths, 30.0)
    fem = fem_log(
        "A1.0M0.2N",
        depths,
        30,
        platform="cpu",
        tol=1e-6,
        grid_spec3d=GridSpec3D(nz=145, np_=9, nr=49, n_wall_cells=5, n_blend_cells=3),
        # R=50 keeps the coarse test grid's cells small enough in the bed; the
        # ~0.5% truncation shift is far below this grid's tolerance.
        domain_radius=50.0,
    )
    assert np.all(np.isfinite(fem))
    rel = np.abs(fem / ana - 1)
    # Shoulder points: measured 0.08% / 0.13%.
    assert rel[0] < 0.005 and rel[2] < 0.005, rel
    # Mid-bed: grid-limited at this resolution (measured -1.42%; gate at 1.5x).
    assert rel[1] < 0.022, rel
