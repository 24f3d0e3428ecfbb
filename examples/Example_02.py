"""
Example 2 — advanced use with optional parameters (mirrors the reference's
Example_02: custom domain radius, batch size, generator selection, plot layout).

How to run:  python examples/Example_02.py
"""

import os
import sys

import numpy as np

try:  # installed package (pip install -e .) or repo-root fallback
    import remo3d_jax  # noqa: F401
except ImportError:  # pragma: no cover
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from remo3d_jax import Model

BASE = "/root/reference/Examples/Example_02"

tools = ["B5.7A0.4M", "B4.48A1.62M", "M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A", "M4.0A0.5B"]
formation_model_file = os.path.join(BASE, "Input", "Formation.txt")
borehole_model_file = os.path.join(BASE, "Input", "Borehole.txt")
measurement_depths = np.arange(0, 25.1, 0.1)

model = Model.compute_synthetic_logs(
    tools,
    measurement_depths,
    formation_model_file,
    borehole_model_file,
    borehole_geometry_type="diameter",
    dip=0,
    cpu_workers=11,
    gpu_workers=0,
    mesh_generator="netgen",
    domain_radius=25,
    batch_size=10,
)

model.save_results(
    output_folder="./Output",
    plot_layout=[["B5.7A0.4M", "B4.48A1.62M"], ["M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A", "M4.0A0.5B"]],
    plot_depth_lim=[0, 25],
    plot_aspect_ratio=1.25,
    model_rad_lim=[-1, 1],
    model_res_lim=[0, 20],
    logs_colours=[["red", "blue"], ["green", "orange", "purple", "deepskyblue"]],
    logs_res_lim=[0, 30],
    logs_at_nan="break",
)
