"""
Example 1 — basic use of the package (mirrors the reference's Example_01).

Only required parameters are used. No mpiexec needed: the device mesh does the
parallel work.

How to run:  python examples/Example_01.py
"""

import os
import sys

import numpy as np

try:  # installed package (pip install -e .) or repo-root fallback
    import remo3d_jax  # noqa: F401
except ImportError:  # pragma: no cover
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from remo3d_jax import Model

# Input files in the reference's TSV format, generated by inputs/generate.py
# (the reference's own input files work as-is too):
BASE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "inputs", "Example_01")

tools = ["B5.7A0.4M", "B4.48A1.62M", "M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A", "M4.0A0.5B"]
formation_model_file = os.path.join(BASE, "Formation.txt")
borehole_model_file = os.path.join(BASE, "Borehole.txt")
measurement_depths = np.arange(0, 25.1, 0.1)

model = Model.compute_synthetic_logs(
    tools, measurement_depths, formation_model_file, borehole_model_file
)

model.save_results(output_folder="./Output")
