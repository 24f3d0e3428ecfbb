# -*- coding: utf-8 -*-
"""Example 4: gradient-based log inversion with the differentiable forward model.

This has no counterpart in the reference package — there the forward model is
a black box behind MPI (remo3d/remo3d.py:723-899) and inversion workflows must
finite-difference it: one full log re-simulation per parameter per Jacobian.
Here the log is a pure JAX function of the formation resistivities
(remo3d_jax.DifferentiableLog), so the exact Jacobian costs P extra
right-hand sides on the already-factorized systems, and a Levenberg-Marquardt
loop recovers the layer resistivities directly.

The demo synthesizes "observed" normal+lateral logs from the Example_01
formation (7 layers, 3 with invasion zones -> 10 resistivity parameters),
starts from a uniform 10 ohmm guess, and inverts. Observations are generated
with the same grid (a deliberate inverse crime — this demonstrates the
machinery, not survey design).
"""

import os
import sys

import numpy as np

try:
    from remo3d_jax import DifferentiableLog, Model
    from remo3d_jax.meshing.grid2d import GridSpec2D
except ImportError:  # running from the repo without pip install -e .
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from remo3d_jax import DifferentiableLog, Model
    from remo3d_jax.meshing.grid2d import GridSpec2D

import jax
import jax.numpy as jnp

BASE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "inputs", "Example_01")
TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]
DEPTHS = np.arange(0.5, 24.6, 1.0)  # 25 measurement points through all 7 layers
GRID = GridSpec2D(nz=193, nr=41, n_wall_cells=6, n_blend_cells=3)


def main():
    model = Model(TOOLS)
    model.set_model_parameters(
        os.path.join(BASE, "Formation.txt"), os.path.join(BASE, "Borehole.txt")
    )
    dlog = DifferentiableLog(model, DEPTHS, grid_spec=GRID, chunk_size=8)
    p_true = np.asarray(dlog.params0, dtype=np.float64)
    print(f"{len(p_true)} parameters: {dlog.param_names}")

    obs = np.asarray(dlog.forward(p_true))
    mask = np.isfinite(obs)

    # Levenberg-Marquardt in log-resistivity space (positivity + scale-free).
    x = np.log(np.full_like(p_true, 10.0))  # uniform 10 ohmm starting model
    lam = 1e-2
    misfit_prev = np.inf
    for it in range(12):
        p = np.exp(x)
        sim = np.nan_to_num(np.asarray(dlog.forward(p)))
        J = np.nan_to_num(np.asarray(dlog.jacobian(p)))  # (n_meas, n_tools, P)
        # residuals/Jacobian in log-data space: d log(sim)/d log(p) = J * p / sim
        r = (np.log(sim[mask]) - np.log(obs[mask])).astype(np.float64)
        A = (J * p[None, None, :])[mask] / sim[mask][:, None]
        misfit = float(np.sqrt(np.mean(r**2)))
        print(
            f"iter {it:2d}  rms log-misfit {misfit:.5f}  "
            f"max param err {np.abs(np.exp(x) / p_true - 1).max() * 100:6.2f}%"
        )
        if misfit < 1e-4:
            break
        lam = max(lam * (0.3 if misfit < misfit_prev else 10.0), 1e-6)
        misfit_prev = misfit
        H = A.T @ A + lam * np.eye(A.shape[1])
        x = x - np.linalg.solve(H, A.T @ r)

    p_final = np.exp(x)
    print("\n  parameter     true   recovered   error")
    for name, pt, pf in zip(dlog.param_names, p_true, p_final):
        print(f"  {name:9s} {pt:8.2f}   {pf:8.2f}   {abs(pf/pt-1)*100:5.2f}%")
    worst = np.abs(p_final / p_true - 1).max()
    print(f"\nworst parameter error: {worst*100:.2f}%")
    return worst


if __name__ == "__main__":
    with jax.default_device(jax.devices()[0]):
        main()
