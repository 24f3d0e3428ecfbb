# -*- coding: utf-8 -*-
"""Arithmetic-fidelity benchmark: float32 production solve vs float64.

Same discretization, two precisions — isolates solver arithmetic from
discretization error (which the golden/oracle benchmarks anchor separately).
Three checks:

* ``ra2d``: Example_01, 4 tools x 6 depths, apparent-resistivity (K * delta-u,
  a potential-level functional) parity. Measured: 2.2e-4 worst tool.
* ``u2d``: axis-potential parity on one real batch (the raw north-star
  quantity). Measured: 6.9e-05 max / 2.4e-05 mean over significant nodes.
* ``ra3d``: BM3 dip=30 dipping path. Measured: 1.1e-04.

The float64 reference runs the SAME direct-preconditioned CG to tol 1e-12/13
(CPU; the executor runs float64 on the CPU only). Usage:
    python benchmarks/arithmetic_parity.py [ra2d|u2d|ra3d|all]
"""
import os
import sys

import numpy as np

try:
    import remo3d_jax  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EX1 = "/root/reference/Examples/Example_01"
BM3 = "/root/reference/Examples/Benchmark models/Benchmark model 3"


def _logs(tools, depths, files, dtype, tol, overrides, dip=0):
    from remo3d_jax import Model

    m = Model(tools)
    m.set_model_parameters(*files, dip=dip)
    m.initialize_workers(cpu_workers=1)
    m.simulate_logs(depths, platform="cpu", verbose=False, dtype=dtype, tol=tol,
                    executor_overrides=overrides)
    return {t: np.array(v[:, 1]) for t, v in m.logs.items()}


def ra2d():
    tools = ["B5.7A0.4M", "A2.0M0.5N", "M1.0A0.1B", "M4.0A0.5B"]
    depths = np.arange(5.0, 6.1, 0.2)
    files = (EX1 + "/Input/Formation.txt", EX1 + "/Input/Borehole.txt")
    ov = {"chunk_size": 8, "preconditioner": "direct"}
    f64 = _logs(tools, depths, files, "float64", 1e-12, ov)
    f32 = _logs(tools, depths, files, "float32", 3e-7, ov)
    worst = 0.0
    for t in tools:
        rel = np.abs(f32[t] / f64[t] - 1)
        print(f"  {t}: max {rel.max():.2e} mean {rel.mean():.2e}")
        worst = max(worst, rel.max())
    print(f"[ra2d] worst f32-vs-f64 relative Ra diff: {worst:.2e}")


def ra3d():
    tools = ["A2.0M0.5N"]
    depths = np.arange(14.0, 14.6, 0.25)
    files = (BM3 + "/Formation_BM3_30.txt", BM3 + "/Borehole_BM3.txt")
    ov = {"chunk_size_3d": 2, "precond3d": "direct"}
    f64 = _logs(tools, depths, files, "float64", 1e-12, ov, dip=30)
    f32 = _logs(tools, depths, files, "float32", 1e-5, ov, dip=30)
    rel = np.abs(f32["A2.0M0.5N"] / f64["A2.0M0.5N"] - 1)
    print(f"[ra3d] BM3 dip=30 f32-vs-f64 Ra parity: max {rel.max():.2e} "
          f"mean {rel.mean():.2e}")


def u2d():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from remo3d_jax import Model
    from remo3d_jax.ops.assembly2d import (
        apply_dirichlet, element_matrices_2d, fold_to_stencil,
        fundamental_potential_2d, singularity_rhs_2d,
    )
    from remo3d_jax.ops.block_direct import block_thomas_apply, block_thomas_factor
    from remo3d_jax.ops.cg import pcg
    from remo3d_jax.ops.stencil import stencil_apply
    from remo3d_jax.parallel.runtime import Executor, ExecutorConfig
    from remo3d_jax.planner import plan_tasks

    m = Model(["A2.0M0.5N"])
    m.set_model_parameters(EX1 + "/Input/Formation.txt", EX1 + "/Input/Borehole.txt")
    depths = np.arange(5.0, 5.21, 0.1)
    sim_depths, tasks = plan_tasks(m.tools, m.sec, depths, 5)
    mud = np.interp(sim_depths, m.borehole_model[:, 0], m.borehole_model[:, 2])
    ex = Executor(ExecutorConfig(platform="cpu"))
    grids = ex.prepare_batches(tasks, m.formation_model, m.borehole_model[:, :2],
                               mud, 50.0, m.dip_rad, 0.999)
    g = grids[0]
    t = tasks[0]
    src_z = g.z_axis[g.axis_node_index(t.solves[0].source_positions[0])]
    nz, nr = g.coords.shape[0], g.coords.shape[1]

    def solve(npdtype, tol):
        with jax.default_device(jax.devices("cpu")[0]):
            coords = jnp.asarray(g.coords[None].astype(npdtype))
            sigma = jnp.asarray(g.sigma_cells[None].astype(npdtype))
            free = jnp.asarray(g.free_mask[None])
            C_raw = fold_to_stencil(element_matrices_2d(coords, sigma), nz, nr)
            C = apply_dirichlet(C_raw, free)
            sigma0 = sigma[:, 0, 0]
            src = jnp.asarray(np.array([[[src_z, src_z]]], dtype=npdtype))
            fac = jnp.asarray(np.array([[[1.0, 0.0]]], dtype=npdtype))
            u_s = fundamental_potential_2d(coords, sigma0, src, fac)
            rhs = singularity_rhs_2d(coords, sigma, sigma0, src, fac)
            g_lift = jnp.where(free[:, None], 0.0, -u_s)
            rhs = jnp.where(free[:, None], rhs - stencil_apply(C_raw, g_lift), 0.0)
            G = block_thomas_factor(C, store_dtype=npdtype)
            M_inv = lambda r: block_thomas_apply(G, C, r)
            w, _ = pcg(C, rhs, M_inv=M_inv, tol=tol, maxiter=200)
            return np.asarray((w + g_lift + u_s)[0, 0, :, 0])

    u64 = solve(np.float64, 1e-13)
    u32 = solve(np.float32, 3e-7)
    mask = np.abs(u64) > 1e-3 * np.abs(u64).max()
    rel = np.abs(u32[mask] - u64[mask]) / np.abs(u64[mask])
    print(f"[u2d] axis-potential f32-vs-f64 parity (significant nodes, "
          f"n={mask.sum()}): max {rel.max():.2e} mean {rel.mean():.2e}")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("ra2d", "all"):
        ra2d()
    if which in ("ra3d", "all"):
        ra3d()
    if which in ("u2d", "all"):
        # NOTE: flips the global x64 flag - run last (or alone).
        u2d()
