# -*- coding: utf-8 -*-
"""Example 5: gradient-based inversion of a 3D DIPPING model.

No counterpart exists in the reference package on two counts: its forward
model is not differentiable (gmsh/NGSolve behind MPI — finite differences pay
one full re-simulation per parameter), and its 3D dipping path is its most
expensive configuration (remo3d/gmsh_functions.py:544-684), making FD
Jacobians prohibitive exactly where they are needed most. Here the 3D dipping
log is a pure JAX function of the layer resistivities (remo3d_jax.diff —
the arithmetic sub-cell homogenization is linear in sigma, so dipping-plane
cell cuts are traced exactly), and a Levenberg-Marquardt loop recovers the
resistivities of a dipping invaded bed from a single normal-tool log.

The demo grid is deliberately small so the whole inversion runs in minutes on
CPU; for production resolution pass ``grid_spec3d=GridSpec3D()`` (or
``.accurate()``) and run on the GPU. Observations are generated with the same
grid (an inverse crime — this demonstrates the machinery, not survey design).
"""

import os
import sys

import numpy as np

try:
    from remo3d_jax import DifferentiableLog, Model
    from remo3d_jax.meshing.grid3d import GridSpec3D
except ImportError:  # running from the repo without pip install -e .
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from remo3d_jax import DifferentiableLog, Model
    from remo3d_jax.meshing.grid3d import GridSpec3D

import jax

# Dipping invaded bed (dip 30 deg): shoulders 10 ohmm, bed 100 ohmm with a
# 5 ohmm invasion zone to 0.4 m — 4 parameters (UZ[0..2] + FZ[1]).
FORMATION = np.array(
    [
        [-1000.0, 1.0, np.nan, np.nan, 10.0],
        [1.0, 2.2, 0.4, 5.0, 100.0],
        [2.2, 1000.0, np.nan, np.nan, 10.0],
    ]
)
BOREHOLE = np.array([[-1000.0, 0.1, 1.0], [1000.0, 0.1, 1.0]])
DIP = 30.0
TOOL = "A0.4M0.1N"
DEPTHS = np.arange(0.4, 2.81, 0.2)  # 13 points through the dipping bed
GRID = GridSpec3D(nz=49, np_=7, nr=21, n_wall_cells=3, n_blend_cells=2)


def main():
    model = Model([TOOL])
    model.set_model_parameters(
        FORMATION, BOREHOLE, borehole_geometry_type="radius", dip=DIP
    )
    dlog = DifferentiableLog(
        model, DEPTHS, grid_spec3d=GRID, domain_radius=10.0, chunk_size=4
    )
    p_true = np.asarray(dlog.params0, dtype=np.float64)
    print(f"dip {DIP} deg, {len(p_true)} parameters: {dlog.param_names}")

    obs = np.asarray(dlog.forward(p_true))
    mask = np.isfinite(obs)

    # Levenberg-Marquardt in log-resistivity space (positivity + scale-free).
    x = np.log(np.full_like(p_true, 20.0))  # uniform 20 ohmm starting model
    lam = 1e-2
    misfit_prev = np.inf
    for it in range(15):
        p = np.exp(x)
        sim = np.nan_to_num(np.asarray(dlog.forward(p)))
        J = np.nan_to_num(np.asarray(dlog.jacobian(p)))
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
