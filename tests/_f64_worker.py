# -*- coding: utf-8 -*-
"""Subprocess payload: the float64 CPU mode must actually compute in float64.

Run in a separate process because dtype="float64" flips the global x64 flag
(jax.config.update), which must not leak into the float32 suite.
"""
import numpy as np

from remo3d_jax import Model
from remo3d_jax.meshing.grid2d import GridSpec2D

rho = 6.0
formation = np.array([[-100.0, 100.0, np.nan, np.nan, rho]])
borehole = np.array([[-100.0, 0.1, rho], [100.0, 0.1, rho]])
m = Model(["A2.0M0.5N"])
m.set_model_parameters(formation, borehole, borehole_geometry_type="radius")
m.initialize_workers()
m.simulate_logs(
    np.arange(0.0, 0.31, 0.1),
    platform="cpu",
    dtype="float64",
    tol=1e-12,
    verbose=False,
    grid_spec=GridSpec2D(nz=129, nr=33, n_wall_cells=4, n_blend_cells=2),
    executor_overrides={"preconditioner": "direct", "chunk_size": 4},
)
vals = m.logs["A2.0M0.5N"][:, 1]
assert np.isfinite(vals).all()
assert np.allclose(vals, rho, rtol=0.03), vals
# The solve really ran in float64: the residual reached far below float32.
worst = max(c["worst_residual"] for c in m._executor.last_report["chunks"])
assert worst < 1e-10, worst
print("F64_MODE_OK", worst)
