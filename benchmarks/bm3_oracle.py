# -*- coding: utf-8 -*-
"""BM3-style dipping-layer accuracy anchor vs the rotated layered-medium oracle.

A dipping-layer FULL SPACE is a rigid rotation of a horizontal layer stack:
rotating the frame by the dip angle a maps the dipping planes (which cross the
borehole axis at the TOP/BOTTOM depths of the formation file) to horizontal
ones, while the tool axis becomes a line tilted by a. With a negligible
borehole the problem is then EXACTLY the classical 1D layered-medium problem
evaluated at off-axis points:

    boundaries' = boundaries * cos(a)       (axis-crossing depth -> true depth)
    electrode at axis position t -> z' = t*cos(a), and relative to the source
    at t_s the horizontal offset is r = |t - t_s|*sin(a)

so the potential follows from the Hankel/propagator oracle with the J0 kernel
(remo3d_jax/utils/layered_oracle.py, off-axis mode). This pins the ABSOLUTE
accuracy of the 3D dipping solver with no FEM in the loop — the independent
anchor for the capability the reference validates with Benchmark model 3
(/root/reference/Examples/Benchmark models/Benchmark model 3/,
remo3d/gmsh_functions.py:544-684 + remo3d/workers/worker.py:124-131).

The model is the BM3 stack (10 | 100 | 10 ohmm, bed 10.77..14.23 m measured
along the axis) with the borehole shrunk to 0.002 m radius and mud matched to
the shoulder resistivity, so the only physics is the dipping layers. Two
systematic effects were measured and controlled in round 3 (they contaminate
the FEM-vs-oracle comparison, not the FEM itself):

* borehole: at 0.01 m radius the conductive mud needle is REAL physics the
  oracle lacks — max deviation 2.36% at dip 30; at 0.002 m it collapses to
  0.93% (the needle's channel conductance scales with radius^2);
* domain truncation: the oracle is a full space, the FEM truncates at
  domain_radius with u=0 (exactly like the reference, remo3d.py:77-83
  default R=50) — a ~d/R potential shift that survives differenced readouts
  at the few-0.1% level. R=150 (default here) leaves max 0.63%, and R=400
  shows no further gain (the residual is genuine discretization error).

Usage: python benchmarks/bm3_oracle.py [--dips=15,30,45,60] [--cpu]
       [--tools=A2.0M0.5N,A1.0M0.2N] [--np=N] [--radius=R] [-v]
"""

import dataclasses
import os
import sys
import time

import numpy as np

try:  # installed package (pip install -e .) or repo-root fallback
    import remo3d_jax  # noqa: F401
except ImportError:  # pragma: no cover
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from remo3d_jax.tools import parse_tools
from remo3d_jax.utils.layered_oracle import LayeredOracle

# BM3 stack (Formation_BM3_*.txt): axis-crossing depths and resistivities.
BOUNDARIES = np.array([10.77, 14.23])
RHOS = np.array([10.0, 100.0, 10.0])
BH_RADIUS = 0.002  # negligible borehole (needle effect ~ radius^2, see above)
MUD_RHO = 10.0  # matched to the shoulders
DOMAIN_RADIUS = 150.0  # truncation shift ~ d/R (see above)


def oracle_log(tool_name, depths, dip_deg, boundaries=BOUNDARIES, rhos=RHOS,
               n_lambda=6000, lam_max=100.0):
    """Apparent-resistivity log from the rotated layered-medium oracle."""
    tools, _ = parse_tools([tool_name], True)
    tp = tools[tool_name]
    c = np.cos(np.deg2rad(dip_deg))
    s = np.sin(np.deg2rad(dip_deg))
    oracle = LayeredOracle(
        boundaries * c, 1.0 / rhos, n_lambda=n_lambda, lam_max=lam_max
    )
    # Source at axis offset 0 (geometry is current-electrode-centered,
    # remo3d.py:319 parity); measuring electrodes at the zero-source offsets.
    rec_offs = tp.geometry[tp.source_terms == 0]
    out = np.empty(len(depths))
    for i, d in enumerate(depths):
        t_src = d + tp.depth_shift
        t_rec = t_src + rec_offs
        u = oracle.potentials(
            np.array([t_src * c]),
            t_rec * c,
            r_receivers=np.abs(rec_offs) * s,
        )[0]
        du = u[0] - u[1] if u.size == 2 else u[0]
        out[i] = abs(tp.geometric_factor * du)
    return out


def fem_log(tool_name, depths, dip_deg, platform=None, grid_spec3d=None, tol=None,
            domain_radius=DOMAIN_RADIUS, bh_radius=BH_RADIUS):
    from remo3d_jax import Model

    formation = np.column_stack(
        [
            np.concatenate([[-1000.0], BOUNDARIES]),
            np.concatenate([BOUNDARIES, [1000.0]]),
            np.full(3, np.nan),
            np.full(3, np.nan),
            RHOS,
        ]
    )
    borehole = np.array([[-1000.0, bh_radius, MUD_RHO], [1000.0, bh_radius, MUD_RHO]])
    m = Model([tool_name])
    m.set_model_parameters(
        formation, borehole, borehole_geometry_type="radius", dip=dip_deg
    )
    m.initialize_workers()
    kw = {}
    if grid_spec3d is not None:
        kw["grid_spec3d"] = grid_spec3d
    if tol is not None:
        kw["tol"] = tol
    m.simulate_logs(
        depths, domain_radius=domain_radius, platform=platform, verbose=False, **kw
    )
    return m.logs[tool_name][:, 1]


def main():
    dips = [15, 30, 45, 60]
    tools = ["A2.0M0.5N", "A1.0M0.2N"]
    platform = None
    overrides = {}
    preset = None
    domain_radius = DOMAIN_RADIUS
    for arg in sys.argv[1:]:
        if arg.startswith("--dips"):
            dips = [int(x) for x in arg.split("=")[1].split(",")]
        elif arg.startswith("--tools"):
            tools = arg.split("=")[1].split(",")
        elif arg.startswith("--np"):
            overrides["np_"] = int(arg.split("=")[1])
        elif arg.startswith("--nz"):
            overrides["nz"] = int(arg.split("=")[1])
        elif arg.startswith("--nr"):
            overrides["nr"] = int(arg.split("=")[1])
        elif arg.startswith("--preset"):
            preset = arg.split("=")[1]
        elif arg.startswith("--radius"):
            domain_radius = float(arg.split("=")[1])
        elif arg == "--cpu":
            platform = "cpu"

    grid_spec3d = None
    if overrides or preset:
        from remo3d_jax.meshing.grid3d import GridSpec3D

        base = getattr(GridSpec3D, preset)() if preset else GridSpec3D()
        grid_spec3d = dataclasses.replace(base, **overrides)

    # Depths span shoulder - bed - shoulder, denser near the boundaries.
    depths = np.round(np.arange(8.0, 17.01, 0.5), 4)

    worst = 0.0
    for tool in tools:
        for dip in dips:
            t0 = time.time()
            fem = fem_log(
                tool, depths, dip, platform=platform, grid_spec3d=grid_spec3d,
                domain_radius=domain_radius,
            )
            el = time.time() - t0
            ana = oracle_log(tool, depths, dip)
            rel = np.abs(fem / ana - 1)
            worst = max(worst, np.nanmax(rel))
            print(
                f"{tool:>10} dip={dip:2d}: max {np.nanmax(rel)*100:5.2f}%  "
                f"mean {np.nanmean(rel)*100:5.2f}%  "
                f"nan={np.isnan(fem).sum()}  ({el:.1f}s)",
                flush=True,
            )
            if "-v" in sys.argv:
                for d, f, a in zip(depths, fem, ana):
                    print(f"    {d:6.2f}  fem {f:8.3f}  oracle {a:8.3f}  "
                          f"{(f/a-1)*100:+6.2f}%")
    print(f"\nWORST deviation across dips/tools: {worst*100:.2f}%")


if __name__ == "__main__":
    main()
