# -*- coding: utf-8 -*-
"""Benchmark-model oracle sweep: FEM vs the independent f64 FV direct solve.

Extends the BM2 spot gate (benchmarks/bm2_oracle.py) to a SWEEP over both
reference benchmark models the FV oracle represents exactly (constant caliper,
BM1 bed ladder 1/2/4/8 m + BM2 three invasion radii — the reference's
canonical 2D verification problems, Examples/Benchmark models/*/Formation_BM*.txt):
many depths through every bed and boundary region, two electrically distinct
tools. Prints a per-model/per-tool worst/mean table for the README.

Usage: python benchmarks/oracle_sweep.py [--cpu] [--quick]
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

BM = "/root/reference/Examples/Benchmark models"
RW, RHO_MUD = 0.1, 1.0

# Depths: mid-shoulder, bed centers, and boundary-adjacent points.
SWEEP = {
    "Benchmark model 1": {
        "formation": "Formation_BM1.txt",
        "depths": [4.0, 7.0, 8.0, 9.0, 13.5, 19.0, 19.5, 25.5, 31.5, 32.5,
                   39.5, 46.5, 48.5, 53.5],
    },
    "Benchmark model 2": {
        "formation": "Formation_BM2.txt",
        "depths": [2.5, 7.0, 10.0, 13.0, 20.0, 26.0, 30.0, 34.0, 42.0, 50.0,
                   55.0, 58.0],
    },
}
TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]


def fem_logs(model_dir, formation_file, depths, platform):
    from remo3d_jax import Model

    m = Model(TOOLS, force_single_electrode_configuration=True)
    m.set_model_parameters(
        os.path.join(BM, model_dir, formation_file),
        os.path.join(BM, model_dir, formation_file.replace("Formation", "Borehole")),
    )
    m.initialize_workers()
    m.simulate_logs(
        np.asarray(depths, dtype=float), platform=platform, verbose=False,
        executor_overrides={"preconditioner": "direct"},
    )
    return {t: m.logs[t][:, 1] for t in TOOLS}


def main():
    platform = "cpu" if "--cpu" in sys.argv else None
    quick = "--quick" in sys.argv
    rows = []
    for model_dir, cfg in SWEEP.items():
        depths = cfg["depths"][:4] if quick else cfg["depths"]
        formation = load_formation_parameters(os.path.join(BM, model_dir, cfg["formation"]))
        fem = fem_logs(model_dir, cfg["formation"], depths, platform)
        for tool in TOOLS:
            rels = []
            for i, zm in enumerate(depths):
                t0 = time.time()
                ra_fv = fv_apparent_resistivity(
                    tool, zm, formation, rw=RW, rho_mud=RHO_MUD, subtract=True
                )
                rel = abs(fem[tool][i] / ra_fv - 1)
                rels.append(rel)
                print(f"  {model_dir} {tool} z={zm:6.2f}: FEM {fem[tool][i]:9.4f} "
                      f"FV {ra_fv:9.4f} rel {rel:.2%}  ({time.time()-t0:.0f}s)",
                      flush=True)
            rows.append((model_dir, tool, max(rels), float(np.mean(rels)), len(rels)))
    print("\n=== SWEEP SUMMARY (FEM vs independent f64 FV oracle) ===")
    for model_dir, tool, worst, mean, n in rows:
        print(f"{model_dir:22s} {tool:12s} n={n:2d}  worst {worst:.2%}  mean {mean:.2%}")


if __name__ == "__main__":
    main()
