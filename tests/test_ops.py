# -*- coding: utf-8 -*-
"""Numerics unit tests: assembly, stencil SpMV, CG, line solvers, multigrid.

All on explicit CPU devices with small grids (no accelerator required)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from remo3d_jax.ops import assemble_stencil_2d, pcg, stencil_apply, stencil_diag
from remo3d_jax.ops.assembly2d import element_matrices_2d
from remo3d_jax.ops.lines import line_solve_r, line_solve_z
from remo3d_jax.ops.multigrid import (
    MGConfig,
    make_mg_preconditioner,
    prolong,
    restrict,
)

cpu = jax.devices("cpu")[0]


def uniform_grid(nz, nr, rmax=1.0, zspan=1.0):
    z = np.linspace(-zspan, zspan, nz)
    r = np.linspace(0.0, rmax, nr)
    coords = np.stack(np.broadcast_arrays(z[:, None], r[None, :]), axis=-1)
    free = np.ones((nz, nr), bool)
    free[0] = free[-1] = False
    free[:, -1] = False
    return coords, free


def dense_from_stencil(C):
    """Materialize the stencil operator as a dense matrix (small grids only)."""
    C = np.asarray(C)
    nz, nr = C.shape[0], C.shape[1]
    n = nz * nr
    A = np.zeros((n, n))
    for i in range(nz):
        for j in range(nr):
            for di in range(3):
                for dj in range(3):
                    ii, jj = i + di - 1, j + dj - 1
                    if 0 <= ii < nz and 0 <= jj < nr:
                        A[i * nr + j, ii * nr + jj] += C[i, j, di, dj]
    return A


def test_element_matrices_rows_sum_zero():
    # Constant fields are in the kernel of the stiffness operator: row sums of the
    # element matrix vanish (before Dirichlet elimination).
    with jax.default_device(cpu):
        coords, free = uniform_grid(5, 4)
        K = element_matrices_2d(jnp.asarray(coords), jnp.ones((4, 3)))
        Ksum = sum(K[a][b] for a in range(4) for b in range(4))
        assert np.max(np.abs(np.asarray(Ksum))) < 1e-5


def test_assembled_operator_symmetric_and_psd():
    with jax.default_device(cpu):
        rng = np.random.default_rng(0)
        coords, free = uniform_grid(9, 7)
        # perturb interior nodes to exercise isoparametric paths
        pert = rng.uniform(-0.02, 0.02, coords.shape)
        pert[0] = pert[-1] = 0
        pert[:, 0] = pert[:, -1] = 0
        coords = coords + pert
        coords[:, 0, 1] = 0.0  # keep the axis on r=0
        sigma = jnp.asarray(rng.uniform(0.5, 2.0, (8, 6)))
        C = assemble_stencil_2d(jnp.asarray(coords), sigma, jnp.asarray(free))
        A = dense_from_stencil(C)
        assert np.allclose(A, A.T, atol=1e-5 * np.abs(A).max())
        w = np.linalg.eigvalsh(A)
        assert w.min() > -1e-6 * w.max()


def test_stencil_apply_matches_dense():
    with jax.default_device(cpu):
        rng = np.random.default_rng(1)
        coords, free = uniform_grid(7, 5)
        sigma = jnp.asarray(rng.uniform(0.5, 2.0, (6, 4)))
        C = assemble_stencil_2d(jnp.asarray(coords), sigma, jnp.asarray(free))
        x = rng.standard_normal((7, 5))
        y1 = np.asarray(stencil_apply(C, jnp.asarray(x, jnp.float32)))
        y2 = (dense_from_stencil(C) @ x.ravel()).reshape(7, 5)
        assert np.allclose(y1, y2, atol=1e-4 * np.abs(y2).max())


def test_pcg_solves_poisson():
    with jax.default_device(cpu):
        coords, free = uniform_grid(17, 9)
        C = assemble_stencil_2d(
            jnp.asarray(coords), jnp.ones((16, 8)), jnp.asarray(free)
        )
        b = jnp.zeros((17, 9)).at[8, 0].set(1.0)
        u, info = pcg(C, b, tol=1e-8, maxiter=2000)
        # True residual drifts from the CG recurrence residual in float32; allow the
        # float32 floor.
        r = np.asarray(b - stencil_apply(C, u))
        assert np.linalg.norm(r) < 2e-6


def test_pcg_batched_with_empty_lanes():
    with jax.default_device(cpu):
        coords, free = uniform_grid(17, 9)
        C = assemble_stencil_2d(
            jnp.asarray(coords), jnp.ones((16, 8)), jnp.asarray(free)
        )
        b = jnp.zeros((3, 17, 9))
        b = b.at[0, 8, 0].set(1.0)  # lane 1 is empty (padded solve)
        b = b.at[2, 4, 2].set(-2.0)
        u, info = pcg(C, b, tol=1e-8, maxiter=2000)
        assert np.allclose(np.asarray(u[1]), 0.0)
        assert float(info["rel_residual"][0]) < 1e-8
        assert float(info["rel_residual"][2]) < 1e-8


def test_line_solvers_match_tridiagonal_part():
    with jax.default_device(cpu):
        rng = np.random.default_rng(2)
        coords, free = uniform_grid(9, 7)
        sigma = jnp.asarray(rng.uniform(0.5, 2.0, (8, 6)))
        C = assemble_stencil_2d(jnp.asarray(coords), sigma, jnp.asarray(free))
        b = jnp.asarray(rng.standard_normal((9, 7)), jnp.float32)
        x = np.asarray(line_solve_r(C, b))
        # Verify per z-line: T x = b with T the (1,0),(1,1),(1,2) tridiagonal part.
        Cn = np.asarray(C)
        for i in range(9):
            T = (
                np.diag(Cn[i, :, 1, 1])
                + np.diag(Cn[i, 1:, 1, 0], -1)
                + np.diag(Cn[i, :-1, 1, 2], 1)
            )
            assert np.allclose(T @ x[i], np.asarray(b)[i], atol=1e-4)
        xz = np.asarray(line_solve_z(C, b))
        for j in range(7):
            T = (
                np.diag(Cn[:, j, 1, 1])
                + np.diag(Cn[1:, j, 0, 1], -1)
                + np.diag(Cn[:-1, j, 2, 1], 1)
            )
            assert np.allclose(T @ xz[:, j], np.asarray(b)[:, j], atol=1e-4)


def test_prolong_restrict_adjoint():
    with jax.default_device(cpu):
        rng = np.random.default_rng(3)
        zc = jnp.asarray(rng.standard_normal((9, 5)), jnp.float32)
        rf = jnp.asarray(rng.standard_normal((17, 9)), jnp.float32)
        lhs = float(jnp.sum(prolong(zc) * rf))
        rhs = float(jnp.sum(zc * restrict(rf)))
        assert abs(lhs - rhs) < 1e-4 * (abs(lhs) + 1)


def test_multigrid_beats_jacobi():
    with jax.default_device(cpu):
        coords, free = uniform_grid(33, 17)
        sigma = np.ones((32, 16))
        sigma[:, 8:] = 0.01  # high contrast
        C, M_inv = make_mg_preconditioner(
            jnp.asarray(coords, jnp.float32),
            jnp.asarray(sigma, jnp.float32),
            jnp.asarray(free),
            MGConfig(n_levels=3),
        )
        b = jnp.zeros((33, 17), jnp.float32).at[16, 0].set(1.0)
        u, info = pcg(C, b, M_inv=M_inv, tol=1e-7, maxiter=50)
        assert int(info["iterations"]) < 25
        assert float(info["rel_residual"]) < 1e-7
