"""
Example 3 — a 3D dipping-layer model (Benchmark model 3, dip = 30 deg).

The reference's 3D capability is exercised by its Benchmark model 3 ladder;
this script runs the dip=30 member end-to-end on the generated BM3 stack
(inputs/BM3, needle borehole) — the 3D half-ball solver engages
automatically whenever dip != 0 — and writes Results_1.txt + Results_plot.png.

No mpiexec needed: the device mesh does the parallel work on the GPU; pass
platform="cpu" to simulate_logs for a (much slower) CPU run.

How to run:  python examples/Example_03_dip.py
"""

import os
import sys

import numpy as np

try:  # installed package (pip install -e .) or repo-root fallback
    import remo3d_jax  # noqa: F401
except ImportError:  # pragma: no cover
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from remo3d_jax import Model

BASE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "inputs", "BM3")

tools = ["A2.0M0.5N", "B5.7A0.4M"]
formation_model_file = os.path.join(BASE, "Formation.txt")
borehole_model_file = os.path.join(BASE, "Borehole.txt")
measurement_depths = np.arange(5.0, 20.01, 0.25)

model = Model.compute_synthetic_logs(
    tools,
    measurement_depths,
    formation_model_file,
    borehole_model_file,
    dip=30,  # degrees; any nonzero dip selects the 3D solver
)

model.save_results(output_folder=os.path.join(os.path.dirname(__file__), "Output"))
