# -*- coding: utf-8 -*-
"""Thin-bedded benchmark model parity vs the reference's committed logs.

The reference ships four precomputed log sets for its thin-bedded verification model
(Examples/Benchmark models/Thin-bedded model/README.txt): Logs 1 (no boundary
effects, aligned depths, Formation_model_1 — the variant with thick uniform end
layers) and Logs 2 (boundary effects, Formation_model_2), both with the 0.35 ohmm
mud borehole, tools
A0.4M6.0N / A1.62M6.0N / A4.0M0.5N / A8.0M1.0N at 81 depths (0..20 m step 0.25).

ACCURACY NOTE (round 2 investigation): the A8.0M1.0N (K≈905) golden itself
carries a few-percent error. Evidence: (a) our result is invariant to 0.05%
under 1.5–2x refinement of every grid axis, the CG tolerance, and the sigma
sampling scheme; (b) without the borehole it matches the semi-analytic
propagator-matrix oracle (utils/layered_oracle.py) to ≤0.4%; (c) WITH the
borehole it matches an independent float64 finite-volume direct solve to
0.07% at spot depths where both sit ~4.5% from the golden. The `--oracle` mode
below reproduces (b).

Usage: python benchmarks/thinbed_parity.py [logs_set(1|2|3|4)] [--oracle]
"""

import os
import sys
import time

import numpy as np

try:  # installed package (pip install -e .) or repo-root fallback
    import remo3d_jax  # noqa: F401
except ImportError:  # pragma: no cover
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TB = "/root/reference/Examples/Benchmark models/Thin-bedded model"
TOOLS = ["A0.4M6.0N", "A1.62M6.0N", "A4.0M0.5N", "A8.0M1.0N"]


def main(logs_set=1):
    from remo3d_jax import Model

    # Logs 1/3 use Formation_model_1 (thick uniform end layers, no boundary
    # effects); Logs 2/4 use Formation_model_2. Logs 3/4 are the
    # depth-MISALIGNMENT sets: the reference simulated at the perturbed true
    # depths (Logs_depth_shifts.txt DEPT_SHIFTED) and assigned the results to
    # the nominal depths (Thin-bedded model/README.txt "Logs" section).
    formation = os.path.join(
        TB, "Formation", f"Formation_model_{1 if logs_set in (1, 3) else 2}.txt"
    )
    borehole = os.path.join(TB, "Borehole", "Borehole_model_correct_rm.txt")
    golden = np.loadtxt(
        os.path.join(TB, "Logs", f"Logs {logs_set}", "Results_1.txt"), skiprows=2
    )
    depths = golden[:, 0]
    if logs_set in (3, 4):
        shifts = np.loadtxt(os.path.join(TB, "Logs", "Logs_depth_shifts.txt"), skiprows=2)
        assert np.allclose(shifts[:, 0], depths), "shift table depth mismatch"
        depths = shifts[:, 1]  # simulate at the misaligned true depths

    model = Model(TOOLS)
    model.set_model_parameters(formation, borehole)
    model.initialize_workers()
    t0 = time.time()
    model.simulate_logs(depths, verbose=False)
    elapsed = time.time() - t0

    print(f"Logs {logs_set}: {len(depths)} depths x {len(TOOLS)} tools in {elapsed:.1f}s")
    worst = 0.0
    for j, t in enumerate(TOOLS):
        ours = model.logs[t][:, 1]
        ref = golden[:, 1 + j]
        rel = (ours - ref) / ref
        worst = max(worst, np.nanmax(np.abs(rel)))
        print(
            f"  {t:>10}: mean {np.nanmean(rel)*100:+.3f}%  max {np.nanmax(np.abs(rel))*100:.3f}%"
            f"  nan={np.isnan(ours).sum()}"
        )
    print(f"  WORST: {worst*100:.3f}%")
    return worst


def main_oracle():
    """FEM (negligible borehole) vs the semi-analytic layered oracle, all tools."""
    from remo3d_jax import Model
    from remo3d_jax.io import load_formation_parameters
    from remo3d_jax.tools import parse_tools
    from remo3d_jax.utils.layered_oracle import layered_apparent_resistivity

    formation = load_formation_parameters(
        os.path.join(TB, "Formation", "Formation_model_1.txt")
    )
    bounds = formation[:-1, 1]
    rho = formation[:, 4]
    borehole = np.array([[-1000.0, 0.001, 4.0], [1000.0, 0.001, 4.0]])
    depths = np.arange(0.0, 20.1, 2.0)

    m = Model(TOOLS)
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius")
    m.initialize_workers()
    m.simulate_logs(depths, verbose=False)

    from remo3d_jax.utils.layered_oracle import LayeredOracle

    # Reflection paths are >= 0.4 m (shortest M offset): 500 log-spaced nodes
    # keep the 140-layer factorization affordable on the 1-core host.
    oracle = LayeredOracle(bounds, 1.0 / rho, n_lambda=500)
    tools, _ = parse_tools(TOOLS, True)
    print(f"FEM (no borehole) vs analytic oracle, {len(depths)} depths:")
    for t in TOOLS:
        tp = tools[t]
        srcs = depths + tp.depth_shift  # current-electrode positions
        recs = tp.geometry[tp.source_terms == 0]
        ana = np.empty(depths.size)
        for i, zs in enumerate(srcs):
            u = oracle.potentials(np.array([zs]), zs + recs)[0]
            du = u[0] - u[1] if u.size == 2 else u[0]
            ana[i] = abs(tp.geometric_factor * du)
        rel = np.abs(m.logs[t][:, 1] / ana - 1)
        print(f"  {t:>10}: mean {np.nanmean(rel)*100:.3f}%  max {np.nanmax(rel)*100:.3f}%")


if __name__ == "__main__":
    if "--oracle" in sys.argv:
        main_oracle()
    else:
        main(int(sys.argv[1]) if len(sys.argv) > 1 else 1)
