# -*- coding: utf-8 -*-
"""3D invasion-zone + varying-caliper gate (VERDICT r3 item 5).

The one corner of the physics surface no previous benchmark pinned: a DIPPING
model with invasion zones and a depth-varying borehole wall — the reference
meshes 3D invasion half-cylinders (gmsh_functions.py:625-629) and a
caliper-following wall (gmsh_functions.py:33-88, Example_01's Borehole.txt
CALM column), and our grid3d.py:249-258 implements the per-(i,j) wall and
invasion snapping.

Model: Benchmark model 2's formation (invasion radii 0.2/0.35/0.5 m, FZ 5 ohmm
in 100 ohmm beds between 10 ohmm shoulders) with a SINUSOIDAL caliper
(0.10 +- 0.015 m, period 15 m — a much stronger variation than Example_01's
+-2%) and 1-ohmm mud. Two gates:

  (a) dip 0: the 2D axisymmetric solver (caliper-following wall) vs the
      independent f64 FV oracle with the same varying wall (rw_profile
      staircase) — the absolute anchor;
  (b) dip -> 0 (1e-3 deg, which routes through the FULL 3D path): the 3D
      solver vs the 2D solver on the SAME model — pins the 3D invasion +
      caliper machinery against the FV-anchored 2D path.

Plus a dip=30 NaN-free sanity run (no oracle exists for dipping + invasion +
borehole; physical plausibility only).

Usage: python benchmarks/bm2_dip_oracle.py [--cpu] [--skip-fv] [--dip30]
"""

import os
import sys
import time

import numpy as np

try:
    import remo3d_jax  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from remo3d_jax.io import load_formation_parameters

from fv_oracle import fv_apparent_resistivity

BM2 = "/root/reference/Examples/Benchmark models/Benchmark model 2"
RHO_MUD = 1.0
TOOL = "A2.0M0.5N"
# Shoulder mids + the three invaded-bed mids (fz radius 0.2/0.35/0.5) + one
# boundary-adjacent point.
SPOT_DEPTHS = np.array([10.0, 20.0, 30.0, 50.0, 14.5])


def caliper_profile():
    """Sinusoidal caliper: radius 0.10 +- 0.015 m, period 15 m."""
    dept = np.arange(0.0, 60.01, 0.5)
    radius = 0.10 + 0.015 * np.sin(2 * np.pi * dept / 15.0)
    return dept, radius


def make_model(dip, tools=(TOOL,)):
    from remo3d_jax import Model

    dept, radius = caliper_profile()
    borehole = np.column_stack([dept, radius, np.full(dept.size, RHO_MUD)])
    m = Model(list(tools), force_single_electrode_configuration=True)
    m.set_model_parameters(
        os.path.join(BM2, "Formation_BM2.txt"),
        borehole,
        borehole_geometry_type="radius",
        dip=dip,
    )
    return m


def fem_log(dip, depths, platform=None, grid_spec3d=None, **kw):
    m = make_model(dip)
    m.initialize_workers()
    if grid_spec3d is not None:
        kw["grid_spec3d"] = grid_spec3d
    m.simulate_logs(np.asarray(depths, dtype=float), platform=platform,
                    verbose=False, **kw)
    return m.logs[TOOL][:, 1]


def main():
    platform = None
    skip_fv = "--skip-fv" in sys.argv
    if "--cpu" in sys.argv:
        platform = "cpu"

    formation = load_formation_parameters(os.path.join(BM2, "Formation_BM2.txt"))
    dept, radius = caliper_profile()
    rw_profile = np.column_stack([dept, radius])

    t0 = time.time()
    fem2d = fem_log(0.0, SPOT_DEPTHS, platform=platform)
    print(f"2D (varying caliper): {np.round(fem2d, 4)}  [{time.time()-t0:.0f}s]")

    kw3d = {}
    if platform == "cpu":
        # A single batch covers the spot depths; don't pad the chunk to 8 meshes.
        kw3d["executor_overrides"] = {"chunk_size_3d": 1}

    t0 = time.time()
    fem3d = fem_log(1e-3, SPOT_DEPTHS, platform=platform, **kw3d)
    gap = np.abs(fem3d / fem2d - 1)
    print(f"3D dip->0 (default grid): {np.round(fem3d, 4)}  [{time.time()-t0:.0f}s]")
    print(f"  (b) 3D vs 2D gap: max {gap.max()*100:.2f}%  mean {gap.mean()*100:.2f}%")

    if not skip_fv:
        worst = 0.0
        for i, d in enumerate(SPOT_DEPTHS):
            t0 = time.time()
            ra_fv = fv_apparent_resistivity(
                TOOL, d, formation, rw=0.10, rho_mud=RHO_MUD,
                subtract=True, rw_profile=rw_profile,
            )
            rel = fem2d[i] / ra_fv - 1
            worst = max(worst, abs(rel))
            print(f"  (a) z={d:5.1f}: FEM2D {fem2d[i]:9.4f}  FV {ra_fv:9.4f}  "
                  f"rel {rel:+.3%}  ({time.time()-t0:.0f}s)", flush=True)
        print(f"  (a) WORST 2D-vs-FV: {worst:.3%}")

    if "--dip30" in sys.argv:
        t0 = time.time()
        fem30 = fem_log(30.0, SPOT_DEPTHS, platform=platform, **kw3d)
        print(f"3D dip=30: {np.round(fem30, 4)}  nan={np.isnan(fem30).sum()}  "
              f"[{time.time()-t0:.0f}s]")


if __name__ == "__main__":
    main()
