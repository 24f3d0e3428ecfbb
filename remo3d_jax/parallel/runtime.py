# -*- coding: utf-8 -*-
"""Batched solve executor over the JAX device mesh.

Device-mesh replacement for the reference's MPI master/worker runtime
(remo3d.py:552-599,723-899 + workers/worker.py): instead of a dynamic pull-queue of
tasks over processes, all batch meshes are stacked into fixed-shape arrays, solved by
ONE compiled program (assembly + batched PCG + readout), and sharded over devices
along the batch axis with ``jax.sharding``. Dynamic load balancing is unnecessary —
solves are uniform-cost by construction (fixed topology), so static even partitioning
with NaN padding replaces the reference's ready-ping scheduler (remo3d.py:845-860).
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..meshing.carve import carve_local_model
from ..meshing.grid2d import (
    Grid2D,
    Grid2DLight,
    GridSpec2D,
    build_grid2d,
    build_grid2d_light,
)
from ..meshing.grid3d import Grid3D, GridSpec3D, build_grid3d
from ..meshing.native import build_grid2d_native, build_grid3d_native, native_available
from ..ops import assemble_stencil_2d, pcg
from ..ops.multigrid import MGConfig, make_mg_preconditioner
from ..planner import BatchTask
from ..utils.timers import PhaseTimers
from .distributed import gather_result, stage_sharded

MAX_SOURCES = 2  # per solve: one (+1) in SEC form or a (+1, -1) pair


def _feasible_mg_levels(*dims: int, want: int = 4) -> int:
    levels = 1
    step = 1
    while levels < want and all((n - 1) % (2 * step) == 0 for n in dims):
        levels += 1
        step *= 2
    return levels


@partial(jax.jit, static_argnames=("metric",))
def _assemble3(coords, sigma, free, metric="cartesian"):
    """Stage 1: Q1 hex assembly -> raw + Dirichlet-eliminated 27-point stencils."""
    from ..ops.assembly3d import (
        apply_dirichlet_3d,
        element_matrices_3d,
        fold_to_stencil_3d,
    )

    nz, np_, nr = coords.shape[-4], coords.shape[-3], coords.shape[-2]
    K = element_matrices_3d(coords, sigma, metric=metric)
    C_raw = fold_to_stencil_3d(K, nz, np_, nr)
    return C_raw, apply_dirichlet_3d(C_raw, free)


@partial(jax.jit, static_argnames=("metric",))
def _build_rhs3_subtract(coords, sigma, free, src_i, src_fac, C_raw, metric="cartesian"):
    """Stage 2: singularity-subtracted load + boundary lift + axis offset field.

    Returns (rhs, g_lift, u_axis_offset) where ``u_axis_offset`` is the
    (g_lift + u_s) part of the solution already sliced to the borehole axis.
    """
    from ..ops.assembly3d import fundamental_potential_3d, singularity_rhs_3d
    from ..ops.stencil3d import pole_project, stencil3d_apply

    freeb = free[:, None]
    sigma0 = sigma[:, 0, 0, 0]  # innermost ring = mud conductivity
    z_axis = coords[:, :, 0, 0, 2]  # (B, NZ) physical z on the borehole axis
    src_z = jnp.take_along_axis(z_axis[:, None, :], src_i, axis=-1)  # (B, S, K)
    u_s = fundamental_potential_3d(coords, sigma0, src_z, src_fac)
    rhs = singularity_rhs_3d(coords, sigma, sigma0, src_z, src_fac, metric=metric)
    g_lift = jnp.where(freeb, 0.0, -u_s)
    rhs = jnp.where(freeb, rhs - stencil3d_apply(C_raw, g_lift), 0.0)
    rhs = pole_project(rhs)
    return rhs, (g_lift + u_s)[..., :, 0, 0]


@partial(
    jax.jit,
    static_argnames=(
        "tol", "maxiter", "precond", "adi_damp", "schedule", "operator",
    ),
)
def _pcg3(
    C, b, u_axis_offset, G3=None, *, tol, maxiter, precond="adi", adi_damp=0.6,
    schedule="scan", operator="full",
):
    """Stage 3: pole-tied line-preconditioned CG + axis readout.

    Tolerance-controlled CG with exact tridiagonal line solves (factored PCR)
    along the grid directions. Two SPD preconditioners:

    * ``"adi"`` (default): damped symmetric multiplicative sweep z-p-r-p-z
      (alternating-direction palindrome). The damping keeps the sweep
      contractive — undamped, modes with ``rho(T^-1 A) > 2`` diverge; measured
      iteration counts on BM3 dip=30: ~285 at damp 0.6 vs ~800 additive.
    * ``"lines"``: additive average of the three line solves — unconditionally
      SPD fallback.
    * ``"direct"``: batched banded-block-tridiagonal LDL^T
      (ops/block_direct3d.py) — one factorization per chunk, a handful of CG
      iterations.

    Replaces the round-1 MG-PCG, whose V-cycle contracted at only ~0.9/cycle
    on the sheared anisotropic grids.
    """
    from ..ops.lines3d import line_apply3, line_factor3
    from ..ops import stencil3d as st
    from ..ops.stencil3d import pole_project

    # Factor the line tridiagonals / block operator ONCE per chunk
    # (loop-invariant, outside the CG while_loop).
    factors = (
        {}
        if precond == "direct"
        else {d: line_factor3(C, d) for d in ("z", "p", "r")}
    )

    def line_apply(d, x):
        return line_apply3(factors[d], x)

    # "half": the symmetric half of the stencil, staged once per chunk outside
    # the CG loop (14 coefficient planes per apply instead of 27).
    if operator == "half":
        Ch = st.half_planes(C)
        apply = lambda p: st.stencil3d_apply_half(Ch, p)
    elif operator == "full":
        apply = lambda p: st.stencil3d_apply(C, p)
    else:
        raise ValueError(f"unknown 3D operator {operator!r}")

    def matvec(p):
        return pole_project(apply(pole_project(p)))

    if precond == "direct":
        # Batched banded-block-tridiagonal LDL^T (ops/block_direct3d.py): the
        # factorization G3 is staged in its own jit (_factor3_direct) — the
        # inversion scan would otherwise bloat this program — and each
        # application is two batched-matmul sweeps, replacing the ~10^2
        # ADI-preconditioned iterations with a handful.
        np3, nr3 = b.shape[-2], b.shape[-1]
        if schedule == "bcr":
            from ..ops.block_bcr3d import bcr_apply_3d

            def M_inv(r):
                r = pole_project(r)
                return pole_project(bcr_apply_3d(G3, r, np3, nr3))

        else:
            from ..ops.block_direct3d import block_thomas_apply_3d

            def M_inv(r):
                r = pole_project(r)
                return pole_project(block_thomas_apply_3d(G3, C, r, np3, nr3))

    elif precond == "adi":
        def M_inv(r):
            r = pole_project(r)
            z = adi_damp * pole_project(line_apply("z", r))
            for d in ("p", "r", "p", "z"):
                res = r - matvec(z)
                z = z + adi_damp * pole_project(line_apply(d, res))
            return z
    else:
        def M_inv(r):
            r = pole_project(r)
            z = sum(line_apply(d, r) for d in factors) / 3.0
            return pole_project(z)

    u, info = pcg(
        None, b, M_inv=M_inv, tol=tol, maxiter=maxiter, n_grid_axes=3, matvec=matvec
    )
    u_axis = jnp.mean(u[..., :, :, 0], axis=-1) + u_axis_offset
    return u_axis, info["rel_residual"], info["iterations"]


def _solve_chunk_3d(
    coords, sigma, free, src_i, src_fac, *, tol, maxiter, subtract=True,
    precond="adi", adi_damp=0.6,
    schedule="scan", factor_passes=None, metric="cartesian", operator="full",
):
    """3D chunk solve: hex assembly + singularity subtraction + pole-tied line-CG.

    Three cached jits — assembly, load build, CG — identical on every platform.
    The split is inherited from an earlier target whose compiler refused the
    fused program; whether fusing pays on the GPU is not measured yet.
    Singularity subtraction removes the analytic half-space field
    ``fac/(2*pi*sigma0*d)`` of every source (the half-ball carries the
    reference's half-space convention, readouts halved downstream,
    worker.py:129-131), so CG only solves for the smooth heterogeneity
    correction.

    coords (B, NZ, NP, NR, 3), sigma (B, NZ-1, NP-1, NR-1), free (B, NZ, NP, NR),
    src_i (B, S, MAX_SOURCES) int32, src_fac (B, S, MAX_SOURCES).
    Reference behavior matched: one SolveBVP per simulation depth on the batch mesh
    (worker.py:104-110) with axis potentials for the readouts (worker.py:124-131).
    """
    nz, np_, nr = coords.shape[-4], coords.shape[-3], coords.shape[-2]
    C_raw, C = _assemble3(coords, sigma, free, metric=metric)
    if subtract:
        b, u_axis_offset = _build_rhs3_subtract(
            coords, sigma, free, src_i, src_fac, C_raw, metric=metric
        )
    else:
        @jax.jit
        def build_rhs(src_i, src_fac):
            def one_rhs(idx, fac):
                # The load lands on the tied axis node: fac/NP on each azimuth
                # copy (P b in the tied-subspace formulation).
                bb = jnp.zeros((nz, np_, nr), dtype=coords.dtype)
                return bb.at[idx, :, 0].add((fac / np_)[:, None])

            return jax.vmap(jax.vmap(one_rhs))(src_i, src_fac)

        b = build_rhs(src_i, src_fac)
        u_axis_offset = jnp.zeros(b.shape[:-3] + (nz,), dtype=b.dtype)
    G3 = (
        _factor3_direct(C, np_=np_, nr=nr, schedule=schedule, passes=factor_passes)
        if precond == "direct"
        else None
    )
    return _pcg3(
        C, b, u_axis_offset, G3, tol=tol, maxiter=maxiter, precond=precond,
        adi_damp=adi_damp, schedule=schedule, operator=operator,
    )


@partial(jax.jit, static_argnames=("np_", "nr", "schedule", "passes"))
def _factor3_direct(C, *, np_, nr, schedule="scan", passes=None):
    """3D direct stage: factorization in its own jit (the inversion stages
    would bloat the CG program). ``schedule``: "scan" = exact
    sequential banded-block-LDL^T; "bcr" = exact block cyclic reduction
    (log-depth batched stages, ops/block_bcr3d.py); "fp"/``passes`` =
    batched Schur fixed-point approximation."""
    if schedule == "bcr":
        from ..ops.block_bcr3d import bcr_factor_3d

        return bcr_factor_3d(C, np_, nr)
    if schedule == "fp" or passes is not None:
        from ..ops.block_direct3d import schur_fixedpoint_factor_3d

        return schur_fixedpoint_factor_3d(C, np_, nr, passes=8 if passes is None else passes)
    from ..ops.block_direct3d import block_thomas_factor_3d

    return block_thomas_factor_3d(C, np_, nr)


@partial(
    jax.jit,
    static_argnames=(
        "tol", "maxiter", "preconditioner", "subtract", "factored_lines",
        "mg_degree", "mg_power_iters", "mg_line_steps", "mg_smoother",
    ),
)
def _solve_chunk(
    coords, sigma, free, src_i, src_fac, *, tol, maxiter, preconditioner,
    subtract=True, factored_lines=False,
    mg_degree=3, mg_power_iters=12, mg_line_steps=None,
    mg_smoother="line_rz",
):
    """Assemble + batched PCG + axis-potential extraction for one chunk.

    Module-level so XLA's jit cache is shared across Executor instances (one compile
    per shape signature for the whole process).

    coords (B, NZ, NR, 2), sigma (B, NZ-1, NR-1), free (B, NZ, NR) bool,
    src_i (B, S, MAX_SOURCES) int32, src_fac (B, S, MAX_SOURCES).

    With ``subtract`` (default) the point-source singularity is removed
    analytically: we solve for the smooth correction w = u - u_s with the load
    ``-∫2·pi·r(sigma-sigma0)grad(u_s)·grad(v)`` and an inhomogeneous Dirichlet lift
    w = -u_s on the truncation circle, which upgrades the effective accuracy of the
    Q1 discretization by removing the 1/d field from the discrete problem.
    """
    from ..ops.assembly2d import (
        apply_dirichlet,
        element_matrices_2d,
        fold_to_stencil,
        fundamental_potential_2d,
        singularity_rhs_2d,
    )
    from ..ops.stencil import stencil_apply

    nz, nr = coords.shape[-3], coords.shape[-2]
    freeb = free[:, None]  # broadcast over the solve axis

    # Assemble once; keep the raw stencil for the boundary-lift product and derive
    # the eliminated system + MG hierarchy from it.
    C_raw = fold_to_stencil(element_matrices_2d(coords, sigma), nz, nr)
    C_fine = apply_dirichlet(C_raw, free)
    use_mg = preconditioner == "multigrid" and _feasible_mg_levels(nz, nr) > 1
    if use_mg:
        C, M_inv = make_mg_preconditioner(
            coords,
            sigma,
            free,
            MGConfig(
                n_levels=_feasible_mg_levels(nz, nr),
                factored_lines=factored_lines,
                degree_pre=mg_degree,
                degree_post=mg_degree,
                power_iters=mg_power_iters,
                line_max_steps=mg_line_steps,
                smoother=mg_smoother,
            ),
            C_fine=C_fine,
        )
    else:
        # "local" preconditioner parity (ngsolve_functions.py:46): point Jacobi.
        C = C_fine
        M_inv = None
    if subtract:
        sigma0 = sigma[:, 0, 0]  # borehole column = mud conductivity
        z_axis = coords[:, :, 0, 0]  # (B, NZ)
        src_z = jnp.take_along_axis(z_axis[:, None, :], src_i, axis=-1)  # (B,S,2)
        u_s = fundamental_potential_2d(coords, sigma0, src_z, src_fac)
        rhs = singularity_rhs_2d(coords, sigma, sigma0, src_z, src_fac)
        g_lift = jnp.where(freeb, 0.0, -u_s)
        rhs = jnp.where(freeb, rhs - stencil_apply(C_raw, g_lift), 0.0)
        w0, info = pcg(C, rhs, M_inv=M_inv, tol=tol, maxiter=maxiter)
        u = w0 + g_lift + u_s
    else:
        def one_rhs(idx, fac):
            b = jnp.zeros((nz, nr), dtype=coords.dtype)
            return b.at[idx, 0].add(fac)

        b = jax.vmap(jax.vmap(one_rhs))(src_i, src_fac)  # (B, S, NZ, NR)
        u, info = pcg(C, b, M_inv=M_inv, tol=tol, maxiter=maxiter)
    # Axis potentials are all the readout ever needs (electrodes sit on axis grid
    # nodes; worker.py:124-131 evaluates u at (0, z) / (0, 0, z)).
    return u[..., 0], info["rel_residual"], info["iterations"]


@jax.jit
def _assemble2(coords, sigma, free):
    """2D stage 1: Q1 assembly -> raw + Dirichlet-eliminated 9-point stencils."""
    from ..ops.assembly2d import apply_dirichlet, element_matrices_2d, fold_to_stencil

    nz, nr = coords.shape[-3], coords.shape[-2]
    C_raw = fold_to_stencil(element_matrices_2d(coords, sigma), nz, nr)
    return C_raw, apply_dirichlet(C_raw, free)


@partial(jax.jit, static_argnames=("schedule", "passes"))
def _factor2_direct(C, *, schedule="scan", passes=None):
    """2D stage 2 (direct): factorize the block-tridiagonal operator.

    ``schedule``: "scan" = the exact sequential block-LDL^T chain;
    "bcr" = exact block cyclic reduction (log-depth batched stages — the
    accelerator schedule, ops/block_bcr.py); "fp" = the batched Schur fixed-point
    approximation with ``passes`` whole-stack inversions (valid SPD
    preconditioner at any pass count, but window truncation converges
    slowly on the production elliptic chain — measured 471 CG iterations
    at 8 passes vs 4 for the exact factor)."""
    if schedule == "bcr":
        from ..ops.block_bcr import bcr_factor

        return bcr_factor(C)
    if schedule == "fp" or passes is not None:
        from ..ops.block_direct import schur_fixedpoint_factor

        return schur_fixedpoint_factor(C, passes=8 if passes is None else passes)
    from ..ops.block_direct import block_thomas_factor

    return block_thomas_factor(C)


@partial(
    jax.jit,
    static_argnames=("tol", "maxiter", "subtract", "schedule"),
)
def _pcg2_direct(
    C_raw, C, G_all, coords, sigma, free, src_i, src_fac, *, tol, maxiter,
    subtract=True, schedule="scan",
):
    """2D stage 3 (direct): load build + direct-preconditioned CG + axis readout.

    Staged separately from :func:`_solve_chunk` (which stays a single fused
    program for the multigrid/local paths) because the factorization scan
    makes this path large; the factor then enters the CG program as data.
    The load construction mirrors _solve_chunk's subtract branch exactly.
    """
    from ..ops.assembly2d import fundamental_potential_2d, singularity_rhs_2d
    from ..ops.block_direct import block_thomas_apply
    from ..ops.stencil import stencil_apply

    nz, nr = coords.shape[-3], coords.shape[-2]
    freeb = free[:, None]
    if schedule == "bcr":
        from ..ops.block_bcr import bcr_apply

        M_inv = lambda r: bcr_apply(G_all, r)
    else:
        M_inv = lambda r: block_thomas_apply(G_all, C, r)

    if subtract:
        sigma0 = sigma[:, 0, 0]
        z_axis = coords[:, :, 0, 0]
        src_z = jnp.take_along_axis(z_axis[:, None, :], src_i, axis=-1)
        u_s = fundamental_potential_2d(coords, sigma0, src_z, src_fac)
        rhs = singularity_rhs_2d(coords, sigma, sigma0, src_z, src_fac)
        g_lift = jnp.where(freeb, 0.0, -u_s)
        rhs = jnp.where(freeb, rhs - stencil_apply(C_raw, g_lift), 0.0)
        w0, info = pcg(C, rhs, M_inv=M_inv, tol=tol, maxiter=maxiter)
        u = w0 + g_lift + u_s
    else:
        def one_rhs(idx, fac):
            b = jnp.zeros((nz, nr), dtype=coords.dtype)
            return b.at[idx, 0].add(fac)

        b = jax.vmap(jax.vmap(one_rhs))(src_i, src_fac)
        u, info = pcg(C, b, M_inv=M_inv, tol=tol, maxiter=maxiter)
    return u[..., 0], info["rel_residual"], info["iterations"]


def _solve_chunk_direct(
    coords, sigma, free, src_i, src_fac, *, tol, maxiter, subtract=True,
    schedule="scan", factor_passes=None,
):
    """2D direct-solver chunk: three cached jits (assembly / factor / solve)."""
    C_raw, C = _assemble2(coords, sigma, free)
    G_all = _factor2_direct(C, schedule=schedule, passes=factor_passes)
    return _pcg2_direct(
        C_raw, C, G_all, coords, sigma, free, src_i, src_fac,
        tol=tol, maxiter=maxiter, subtract=subtract, schedule=schedule,
    )


class LazyGrids:
    """Sequence of per-batch grids, built on first access and cached.

    Lets :meth:`Executor.run`'s pipeline interleave host meshing with device
    solves: chunk N+1's grids are built while chunk N is still solving. Supports
    int and slice indexing and iteration (the classic ``__getitem__`` protocol),
    so eager-list call sites work unchanged.
    """

    def __init__(self, n: int, build_one):
        self._build = build_one
        self._cache: list = [None] * n

    def __len__(self) -> int:
        return len(self._cache)

    def ensure(self, start: int = 0, stop: int | None = None) -> None:
        stop = len(self._cache) if stop is None else min(stop, len(self._cache))
        for i in range(max(start, 0), stop):
            if self._cache[i] is None:
                self._cache[i] = self._build(i)

    def __getitem__(self, i):
        if isinstance(i, slice):
            idx = range(*i.indices(len(self._cache)))
            for j in idx:
                self.ensure(j, j + 1)
            return [self._cache[j] for j in idx]
        if i < 0:
            i += len(self._cache)
        if not 0 <= i < len(self._cache):
            raise IndexError(i)
        self.ensure(i, i + 1)
        return self._cache[i]


@dataclasses.dataclass
class ExecutorConfig:
    spec: GridSpec2D = dataclasses.field(default_factory=GridSpec2D)
    spec3d: GridSpec3D = dataclasses.field(default_factory=GridSpec3D)
    tol: float = 1e-7
    maxiter: int = 1000
    dtype: str = "float32"
    # Batch meshes per device dispatch (multiplied up to devices). None = auto
    # (see resolve_auto): 96 on accelerators, to amortize the per-dispatch
    # latency over more solves; 48 on CPU (the direct factorization's working
    # set). The GPU value is not screened yet.
    chunk_size: int | None = None
    # 3D grids carry ~160k nodes each (vs ~10k in 2D); chunks are bounded
    # separately so one dispatch stays within compile/memory limits.
    chunk_size_3d: int = 8
    # 2D: "auto", "local" (Jacobi), "multigrid", or "direct" (batched
    # block-LDL^T, ops/block_direct.py). "auto" resolves per platform at
    # executor init: CPU -> "direct" (measured 31x faster end-to-end on the
    # CPU: 4 CG iterations vs 11, and the factorization replaces the MG
    # setup); accelerators -> "multigrid", whose per-apply traffic is smaller
    # than the factor's O(NZ*NR*bw^2). Which one wins on the GPU is not
    # measured yet.
    preconditioner: str = "auto"
    # 3D: "auto", "adi" (damped z-p-r-p-z sweep), "lines" (additive), or
    # "direct" (banded-block LDL^T, ops/block_direct3d.py). "auto": CPU ->
    # "direct" (4 CG iterations vs 314), accelerators -> "adi".
    precond3d: str = "auto"
    # 3D assembly metric: "cylindrical" treats the hexes as the exact solid of
    # revolution through the nodes (azimuth carries only interpolation error —
    # see ops/assembly3d.py); "cartesian" uses the raw chordal-polygon hexes.
    metric3d: str = "cylindrical"
    # Direct-factorization schedule: "auto" (CPU -> "scan", accelerators ->
    # "bcr"); "scan" = exact sequential block-LDL^T chain (LAPACK-friendly,
    # hostile to accelerators — NZ x NR sequential LU column-steps); "bcr" = exact
    # block cyclic reduction — log2(NZ) batched stages for BOTH factor and
    # apply, the accelerator schedule (ops/block_bcr.py); "fp" = batched Schur
    # fixed-point with direct_factor_passes whole-stack inversions (valid SPD
    # preconditioner at any pass count, but window truncation converges
    # slowly on the production elliptic chain — 471 CG iters at 8 passes vs
    # 4 exact; kept as a measured-and-documented alternative).
    direct_schedule: str = "auto"
    # "fp" pass count; a non-None value also implies schedule "fp" for
    # backward compatibility. All three schedules cover 2D and 3D
    # (ops/block_bcr3d.py for the 3D "bcr" path).
    direct_factor_passes: int | None = None
    adi_damp: float = 0.6
    # 3D CG operator: "half" reads the 14 plane-major coefficient planes of
    # the symmetric stencil half (ops/stencil3d.stencil3d_apply_half); "full"
    # is the plain 27-plane apply it is checked and timed against
    # (chip_smoke.py). "auto": "half" on accelerators — on an H100 it took
    # the warm BM3 dip-30 log from 3.16-3.21 s to 2.93-2.95 s (PERF.md) —
    # and "full" on the CPU, where the half form's shifted products are
    # several times slower.
    stencil3d: str = "auto"
    # 2D MG smoother tuning (Chebyshev degree of pre/post smoothing; power
    # iterations of the per-batch spectral estimate; PCR line-solve truncation,
    # see MGConfig.line_max_steps). Chebyshev degree 2 trades one extra CG
    # iteration (11 -> 12) for a third less smoother work per V-cycle;
    # readouts move 2e-4. Power iterations 6 is enough for the smoother's
    # spectral interval at degree 2. The GPU optimum is not screened yet.
    mg_degree: int = 2
    mg_power_iters: int = 6
    mg_line_steps: int | None = None
    # Inner smoother of the 2D MG Chebyshev sweeps: "line_rz" (additive ADI
    # lines — fewest CG iterations), "line_r", or "jacobi" (cheapest per
    # iteration; competitive when per-op dispatch latency dominates).
    mg_smoother: str = "line_rz"
    platform: str | None = None  # None = JAX default (the GPU when present); "cpu" for tests
    # A solve is declared failed (NaN readouts, matching the reference's per-task NaN
    # containment, worker.py:135-138) only above this attained relative residual;
    # between tol and this, the attained accuracy is accepted (float32 stragglers).
    fail_residual: float = 1e-4
    # Host meshing backend: the native C++ builder (native/grid2d.cpp) when
    # available, with transparent fallback to the numpy reference implementation.
    use_native_mesher: bool = True
    # Build the 2D grids ON DEVICE from 1D profiles (meshing/device_mesh.py):
    # ~7 KB staged per batch instead of ~3 MB of coords/sigma arrays — the
    # host<->device link stops being the 2D bottleneck once solves are fast.
    # None = auto: on for float32 accelerator runs (dip == 0 only), off on
    # CPU. Readouts match the host-meshed path to float32 mesh noise
    # (tests/test_model.py::test_device_meshing_matches_host_meshing).
    device_meshing: bool | None = None
    # Observability/durability (SURVEY §5 aux subsystems):
    profile_dir: str | None = None  # jax.profiler trace of the solve phase
    checkpoint: str | None = None  # .npz path: per-chunk results, resume on rerun
    # Chunks staged+dispatched ahead of the gather point; overlaps host staging
    # and transfers with device solves. 1 = fully serial (old behavior).
    pipeline_window: int = 3


def resolve_auto(config: ExecutorConfig, platform: str) -> ExecutorConfig:
    """Resolve the "auto" solver knobs for a device platform ("cpu", "gpu").

    Pure: depends on the config and the platform name only, so the picks can
    be checked without the device. The reasons are at the field definitions.
    """
    on_accel = platform != "cpu"
    auto = {}
    if config.preconditioner == "auto":
        auto["preconditioner"] = "multigrid" if on_accel else "direct"
    if config.chunk_size is None:
        auto["chunk_size"] = 96 if on_accel else 48
    if config.precond3d == "auto":
        auto["precond3d"] = "adi" if on_accel else "direct"
    if config.direct_schedule == "auto":
        # An explicit pass count selects the fixed-point factor (backward
        # compatibility — the bcr/scan branches would ignore it).
        if config.direct_factor_passes is not None:
            auto["direct_schedule"] = "fp"
        else:
            auto["direct_schedule"] = "bcr" if on_accel else "scan"
    if config.device_meshing is None:
        auto["device_meshing"] = on_accel and config.dtype == "float32"
    if config.stencil3d == "auto":
        auto["stencil3d"] = "half" if on_accel else "full"
    return dataclasses.replace(config, **auto) if auto else config


class Executor:
    """Plans device dispatches for a list of :class:`BatchTask` and runs them."""

    def __init__(self, config: ExecutorConfig):
        self.timers = PhaseTimers()
        self.last_report = {"chunks": [], "n_failed_solves": 0, "n_nan_readouts": 0}
        self._devices = (
            jax.devices(config.platform) if config.platform else jax.devices()
        )
        self.config = config = resolve_auto(config, self._devices[0].platform)
        if config.dtype == "float64":
            # Without the x64 flag JAX silently downcasts float64 staging arrays
            # to float32 — the "f64 mode" would be a no-op.
            if self._devices[0].platform != "cpu":
                raise ValueError(
                    "dtype='float64' requires platform='cpu': the accelerator "
                    "solver paths are built and checked in float32 only"
                )
            jax.config.update("jax_enable_x64", True)

    # ------------------------------------------------------------------- host side
    def prepare_batches(
        self,
        tasks: list[BatchTask],
        formation_parameters: np.ndarray,
        borehole_geometry: np.ndarray,
        mud_resistivities: np.ndarray,
        domain_radius: float,
        dip_rad: float,
        active_geometry_window: float,
    ) -> "LazyGrids":
        """Per-batch grid builders, evaluated lazily.

        Grids are built on first access, so host meshing overlaps the pipelined
        device solves in :meth:`run` instead of running up front (the reference
        gets the same overlap from its MPI worker farm: each worker meshes its
        next task while others solve, worker.py:74-110). The "mesh" phase timer
        still accounts every build, wherever it is triggered.
        """

        def build_one(i: int):
            t = tasks[i]
            with self.timers.phase("mesh"):
                lm = carve_local_model(
                    formation_parameters,
                    borehole_geometry,
                    float(mud_resistivities[t.batch_index]),
                    t.center_depth,
                    domain_radius,
                    dip_rad=dip_rad,
                    active_geometry_window=active_geometry_window,
                )
                sources = np.unique(
                    np.concatenate([s.source_positions for s in t.solves])
                )
                if dip_rad != 0:
                    builder3 = (
                        build_grid3d_native
                        if self.config.use_native_mesher and native_available()
                        else build_grid3d
                    )
                    return builder3(
                        self.config.spec3d,
                        domain_radius,
                        lm,
                        dip_rad,
                        t.electrode_positions,
                        sources,
                    )
                if self.config.device_meshing:
                    # Profile-only build: the (NZ, NR) arrays are constructed
                    # on device inside the chunk program (device_mesh.py).
                    return build_grid2d_light(
                        self.config.spec, domain_radius, lm,
                        t.electrode_positions, sources,
                    )
                builder = (
                    build_grid2d_native
                    if self.config.use_native_mesher and native_available()
                    else build_grid2d
                )
                return builder(
                    self.config.spec,
                    domain_radius,
                    lm,
                    t.electrode_positions,
                    sources,
                )

        return LazyGrids(len(tasks), build_one)

    def run(
        self,
        tasks: list[BatchTask],
        grids,
        n_measurements: int,
        n_tools: int,
        readout_factor: float = 1.0,
        verbose: bool = False,
    ) -> np.ndarray:
        """Execute all batches; returns results[measurement, tool] (NaN on failure).

        ``readout_factor`` is 0.5 for 3D half-space models (worker.py:129-131).
        With ``verbose`` an in-run progress line is printed per chunk (the
        reference's dispatch progress bar, remo3d.py:853-856) with CG iteration
        counts and the worst attained residual; chunk statistics are accumulated
        in ``self.last_report`` either way.
        """
        is_3d = isinstance(grids[0], Grid3D)
        dtype = np.dtype(self.config.dtype)
        S = max(len(t.solves) for t in tasks)
        B_total = len(tasks)
        n_dev = len(self._devices)
        # Bound total concurrent solves (B*S): larger products exhaust device/compile
        # memory (chunk_size is calibrated for the default batch_size of 5).
        # Device mesh: ('batch', 'solve'). The batch axis (one mesh per entry —
        # the reference's MPI task axis, remo3d.py:845-860) carries the data
        # parallelism; when batches are scarcer than devices, leftover device
        # capacity is spent on the solve axis (right-hand sides sharing one
        # stencil) instead of idling on padded lanes.
        n_solve_axis = 1
        if n_dev > 1 and B_total < n_dev:
            spare = n_dev // math.gcd(n_dev, B_total)
            for cand in range(min(S, spare), 0, -1):
                if S % cand == 0 and n_dev % cand == 0:
                    n_solve_axis = cand
                    break
        n_batch_axis = n_dev // n_solve_axis

        base_chunk = self.config.chunk_size_3d if is_3d else self.config.chunk_size
        if (
            is_3d
            and int(np.prod(grids[0].coords.shape[:-1])) > 180_000
            and self.config.chunk_size_3d == type(self.config).chunk_size_3d
        ):
            # High-resolution 3D grids: chunks of 2. Lock-step CG makes every
            # batch in a chunk pay the worst batch's iteration count, so
            # small chunks waste less on these slow-converging grids. The cap
            # is inherited from an earlier target's compiler limit and is not
            # re-derived for the GPU's memory yet; an EXPLICIT chunk_size_3d
            # bypasses it (expert hatch).
            base_chunk = min(base_chunk, 2)
        if is_3d and self.config.precond3d == "direct":
            # The banded-block factorization stores G (NZ, B, NPR, NPR) float32
            # per chunk; cap the chunk so G stays within ~6 GB of HBM (the
            # default 193x17x49 grid at B=8 is ~4.3 GB; finer azimuth specs
            # would otherwise overflow).
            nz3, np3, nr3 = grids[0].coords.shape[:-1]
            g_bytes_per_batch = nz3 * (np3 * nr3) ** 2 * 4
            # The fixed-point factorization holds the current AND previous
            # pass stacks transiently (2x); cyclic reduction stores ~1.5x
            # (G levels + dense off-diagonal levels) plus a transient.
            budget = 6e9
            if self.config.direct_factor_passes is not None:
                budget = 3e9
            elif self.config.direct_schedule == "bcr":
                budget = 3.5e9
            base_chunk = max(2, min(base_chunk, int(budget // g_bytes_per_batch)))
        solve_budget = base_chunk * 5
        chunk = max(min(base_chunk, max(1, solve_budget // S)), n_batch_axis)
        # Quantize to a multiple of 8 (and of the batch mesh axis): coarse
        # quantization bounds the number of distinct compiled shapes. Never
        # pad past the task list by more than one quantum. Explicitly small
        # chunk configs (chunk_size_3d < 8, used for high-resolution 3D grids)
        # quantize to 2.
        q = math.lcm(8 if base_chunk >= 8 else 2, n_batch_axis)
        chunk = min(((chunk + q - 1) // q) * q, ((B_total + q - 1) // q) * q)

        if n_dev > 1:
            mesh = jax.sharding.Mesh(
                np.array(self._devices[:n_dev]).reshape(n_batch_axis, n_solve_axis),
                ("batch", "solve"),
            )
            P = jax.sharding.PartitionSpec
            mesh_sharding = jax.sharding.NamedSharding(mesh, P("batch"))
            solve_sharding = jax.sharding.NamedSharding(mesh, P("batch", "solve"))
            n_mesh_arrays = 10 if isinstance(grids[0], Grid2DLight) else 3
            shardings = [mesh_sharding] * n_mesh_arrays + [solve_sharding] * 2
        else:
            # Commit to the executor's device so jit runs there (the process default
            # device may be a different backend).
            shardings = [self._devices[0]] * 12

        results = np.full((n_measurements, n_tools), np.nan)
        self.last_report = {"chunks": [], "n_failed_solves": 0, "n_nan_readouts": 0}

        g0 = grids[0]
        # Dispatch geometry, for traffic estimates computed from shapes.
        self.last_report["chunk"] = chunk
        self.last_report["n_solve_slots"] = S
        self.last_report["mesh"] = {"batch": n_batch_axis, "solve": n_solve_axis}
        is_light = isinstance(g0, Grid2DLight)
        grid_shape = (
            g0.grid_shape if is_light else g0.coords.shape[:-1]
        )  # (NZ, NR) or (NZ, NP, NR)
        cell_shape = tuple(n - 1 for n in grid_shape)
        # Layer-table pad: one compiled shape per run, sized to the deepest
        # carved stack and bucketed (multiples of 16, floor 48) so typical
        # runs share an executable while thin-bedded models (the reference's
        # thin-bedded benchmark carves 140/201 layers) still fit.
        if is_light:
            lmax = max(g.bottoms.size for g in grids)
            LMAX_LAYERS = max(48, -(-lmax // 16) * 16)
        else:
            LMAX_LAYERS = 48

        # Checkpoint/resume: long (hour-scale 3D) runs persist per-chunk results
        # so a crashed/preempted run resumes instead of recomputing. The key
        # guards against resuming a different configuration: it hashes the full
        # solver config, the chunk partitioning (chunk-start offsets are only
        # meaningful for the stride that produced them) and the model content
        # (grid coordinates + conductivities + source/readout plan), so a rerun
        # with a tighter tol, a different device count, or an edited same-shape
        # formation recomputes instead of silently returning stale results.
        ckpt_key = None
        if self.config.checkpoint:
            import hashlib

            h = hashlib.blake2b(digest_size=16)
            spec_sig = dataclasses.astuple(
                self.config.spec3d if is_3d else self.config.spec
            )
            cfg_sig = (
                self.config.tol,
                self.config.maxiter,
                self.config.preconditioner,
                self.config.precond3d,
                self.config.direct_schedule,
                self.config.direct_factor_passes,
                self.config.adi_damp,
                self.config.fail_residual,
                readout_factor,
                chunk,
                spec_sig,
            )
            h.update(repr(cfg_sig).encode())
            for t, g in zip(tasks, grids):
                if is_light:
                    h.update(g.content_bytes())
                else:
                    h.update(np.ascontiguousarray(g.coords).tobytes())
                    h.update(np.ascontiguousarray(g.sigma_cells).tobytes())
                for s in t.solves:
                    h.update(
                        repr(
                            (
                                list(np.asarray(s.source_positions).ravel()),
                                list(np.asarray(s.source_terms).ravel()),
                                [
                                    (
                                        ro.measurement_index,
                                        ro.tool_index,
                                        ro.geometric_factor,
                                        list(np.asarray(ro.measuring_positions).ravel()),
                                    )
                                    for ro in s.readouts
                                ],
                            )
                        ).encode()
                    )
            ckpt_key = (
                f"{n_measurements}x{n_tools}|{B_total}x{S}|{grid_shape}|{h.hexdigest()}"
            )
        done_chunks: set[int] = set()
        if self.config.checkpoint and os.path.exists(self.config.checkpoint):
            saved = np.load(self.config.checkpoint, allow_pickle=False)
            if str(saved["key"]) == ckpt_key:
                results = saved["results"]
                done_chunks = set(int(c) for c in saved["done_chunks"])
                if verbose and done_chunks:
                    print(f"  resuming: {len(done_chunks)} chunks already done")

        if self.config.profile_dir:
            jax.profiler.start_trace(self.config.profile_dir)

        def dispatch(args):
            """Launch one chunk solve; returns lazy (u_axis, rel_res, iters)."""
            on_accel = self._devices[0].platform != "cpu"
            if is_light:
                # Build the (B, NZ, NR) arrays on device from the staged
                # profiles; the result feeds the normal solver path.
                from ..meshing.device_mesh import device_mesh_2d

                spec = self.config.spec
                coords, sigma, free = device_mesh_2d(
                    *args[:10],
                    dtype.type(g0.domain_radius),
                    nz=spec.nz,
                    nr=spec.nr,
                    n_wall_cells=spec.n_wall_cells,
                    n_blend_cells=spec.n_blend_cells,
                    blend_m0=spec.blend_m0,
                )
                args = [coords, sigma, free, args[10], args[11]]
            if is_3d:
                return _solve_chunk_3d(
                    *args,
                    tol=self.config.tol,
                    maxiter=self.config.maxiter,
                    precond=self.config.precond3d,
                    adi_damp=self.config.adi_damp,
                    schedule=self.config.direct_schedule,
                    factor_passes=self.config.direct_factor_passes,
                    metric=self.config.metric3d,
                    operator=self.config.stencil3d,
                )
            if self.config.preconditioner == "direct":
                return _solve_chunk_direct(
                    *args,
                    tol=self.config.tol,
                    maxiter=self.config.maxiter,
                    schedule=self.config.direct_schedule,
                    factor_passes=self.config.direct_factor_passes,
                )
            return _solve_chunk(
                *args,
                tol=self.config.tol,
                maxiter=self.config.maxiter,
                preconditioner=self.config.preconditioner,
                # Factored-PCR smoothers: faster V-cycles on accelerators; the
                # factored graph stalls the XLA CPU compiler, so CPU keeps the
                # original in-line elimination path.
                factored_lines=on_accel,
                mg_degree=self.config.mg_degree,
                mg_power_iters=self.config.mg_power_iters,
                mg_line_steps=self.config.mg_line_steps,
                mg_smoother=self.config.mg_smoother,
            )

        def stage_sources(batch_tasks, batch_grids, B):
            src_i = np.zeros((B, S, MAX_SOURCES), dtype=np.int32)
            src_fac = np.zeros((B, S, MAX_SOURCES), dtype=dtype)
            for bi, (t, g) in enumerate(zip(batch_tasks, batch_grids)):
                for si, s in enumerate(t.solves):
                    for k, (pos, fac) in enumerate(
                        zip(s.source_positions, s.source_terms)
                    ):
                        src_i[bi, si, k] = g.axis_node_index(pos)
                        src_fac[bi, si, k] = fac
            return src_i, src_fac

        def stage_light(start):
            """Device-meshing staging: ~KB of 1D profiles per batch."""
            batch_tasks = tasks[start : start + chunk]
            batch_grids = grids[start : start + chunk]
            B = chunk
            nz = grid_shape[0]
            nfar = batch_grids[0].far.size
            z = np.zeros((B, nz), dtype=dtype)
            wall = np.zeros((B, nz), dtype=dtype)
            far = np.zeros((B, nfar), dtype=dtype)
            rdet = np.zeros((B,), dtype=dtype)
            bot = np.full((B, LMAX_LAYERS), np.inf, dtype=dtype)
            fzr = np.full((B, LMAX_LAYERS), np.nan, dtype=dtype)
            sfz = np.full((B, LMAX_LAYERS), np.nan, dtype=dtype)
            suz = np.ones((B, LMAX_LAYERS), dtype=dtype)
            nlay = np.ones((B,), dtype=np.int32)
            mud = np.ones((B,), dtype=dtype)
            for bi, g in enumerate(batch_grids):
                L = g.bottoms.size
                if L > LMAX_LAYERS:
                    raise ValueError(
                        f"carved model has {L} layers > LMAX_LAYERS={LMAX_LAYERS}"
                    )
                z[bi] = g.z_axis
                wall[bi] = g.wall_of_z
                far[bi] = g.far
                rdet[bi] = g.r_detach
                bot[bi, :L] = g.bottoms
                fzr[bi, :L] = g.fz_radius
                sfz[bi, :L] = g.sigma_fz
                suz[bi, :L] = g.sigma_uz
                nlay[bi] = L
                mud[bi] = g.mud_sigma
            for bi in range(len(batch_grids), B):  # padded lanes: unit medium
                z[bi] = batch_grids[0].z_axis
                wall[bi] = batch_grids[0].wall_of_z
                far[bi] = batch_grids[0].far
                rdet[bi] = batch_grids[0].r_detach
            src_i, src_fac = stage_sources(batch_tasks, batch_grids, B)
            return stage_sharded(
                [z, wall, far, rdet, bot, fzr, sfz, suz, nlay, mud, src_i, src_fac],
                shardings,
            )

        def stage(start):
            """Assemble one chunk's arrays host-side and place them on devices."""
            if is_light:
                return stage_light(start)
            batch_tasks = tasks[start : start + chunk]
            batch_grids = grids[start : start + chunk]
            B = chunk  # pad to full chunk so one executable serves all dispatches

            coords = np.zeros((B,) + g0.coords.shape, dtype=dtype)
            sigma = np.zeros((B,) + cell_shape, dtype=dtype)
            free = np.zeros((B,) + grid_shape, dtype=bool)
            for bi, g in enumerate(batch_grids):
                coords[bi] = g.coords
                sigma[bi] = g.sigma_cells
                free[bi] = g.free_mask
            src_i, src_fac = stage_sources(batch_tasks, batch_grids, B)
            # Keep padded lanes numerically benign: unit coords, sigma 1.
            for bi in range(len(batch_tasks), B):
                coords[bi] = batch_grids[0].coords
                sigma[bi] = 1.0
                free[bi] = batch_grids[0].free_mask
            # Multi-host aware placement (plain device_put single-process).
            return stage_sharded([coords, sigma, free, src_i, src_fac], shardings)

        # PIPELINED execution: chunks are staged and dispatched up to
        # ``window`` ahead of the gather point, so host staging and
        # host->device transfers overlap the device solves (the reference
        # overlaps by running many MPI workers; here the async dispatch queue
        # plays that role).
        window = max(1, int(self.config.pipeline_window))
        todo = [s for s in range(0, B_total, chunk) if s not in done_chunks]
        inflight: list[tuple[int, object]] = []  # (start, lazy or None)
        next_i = 0

        def chunk_failed(start, e):
            # A chunk that raises is reported once and its solves become NaN
            # readouts (the reference's per-task containment,
            # worker.py:135-138); nothing is retried.
            print(
                f"solve chunk at batch {start} failed: "
                f"{type(e).__name__}: {str(e).splitlines()[0][:160]}",
                file=sys.stderr,
            )

        def fill_pipeline():
            nonlocal next_i
            while next_i < len(todo) and len(inflight) < window:
                s0 = todo[next_i]
                next_i += 1
                # Build this chunk's grids first (outside the "stage" phase so
                # mesh/stage seconds stay additive); previously-dispatched
                # chunks keep solving on device while the host meshes.
                if hasattr(grids, "ensure"):
                    grids.ensure(s0, s0 + chunk)
                with self.timers.phase("stage"):
                    args = stage(s0)
                try:
                    lazy = dispatch(args)
                except jax.errors.JaxRuntimeError as e:
                    chunk_failed(s0, e)
                    lazy = None
                inflight.append((s0, lazy))

        fill_pipeline()
        while inflight:
            start, lazy = inflight.pop(0)
            batch_tasks = tasks[start : start + chunk]
            batch_grids = grids[start : start + chunk]

            with self.timers.phase("solve"):
                u_axis, rel_res, iters = None, np.full((chunk, S), np.inf), -1
                if lazy is not None:
                    try:
                        u_axis = gather_result(lazy[0])
                        rel_res = gather_result(lazy[1])
                        iters = int(np.asarray(lazy[2]))
                    except jax.errors.JaxRuntimeError as e:
                        chunk_failed(start, e)
                        rel_res = np.full((chunk, S), np.inf)
            del lazy
            fill_pipeline()

            n_failed = 0
            n_nan = 0
            with self.timers.phase("readout"):
                for bi, (t, g) in enumerate(zip(batch_tasks, batch_grids)):
                    for si, s in enumerate(t.solves):
                        failed = (
                            not np.isfinite(rel_res[bi, si])
                            or rel_res[bi, si] > self.config.fail_residual
                        )
                        if failed:
                            n_failed += 1
                        for ro in s.readouts:
                            if failed:
                                value = np.nan
                            else:
                                pots = [
                                    u_axis[bi, si, g.axis_node_index(p)]
                                    for p in ro.measuring_positions
                                ]
                                if len(pots) == 2:
                                    value = abs(
                                        ro.geometric_factor * (pots[1] - pots[0])
                                    ) * readout_factor
                                else:
                                    value = (
                                        abs(ro.geometric_factor * pots[0])
                                        * readout_factor
                                    )
                            if failed:
                                n_nan += 1
                            results[ro.measurement_index, ro.tool_index] = value

            n_real = sum(len(t.solves) for t in batch_tasks)
            worst = float(np.max(rel_res[: len(batch_tasks)])) if len(batch_tasks) else 0.0
            self.last_report["chunks"].append(
                {
                    "batches": len(batch_tasks),
                    "solves": n_real,
                    "iterations": iters,
                    "worst_residual": worst,
                    "failed_solves": n_failed,
                }
            )
            self.last_report["n_failed_solves"] += n_failed
            self.last_report["n_nan_readouts"] += n_nan
            if verbose:
                done = min(start + chunk, B_total)
                msg = (
                    f"\r  [{done}/{B_total}] batches solved"
                    f" (CG iters {iters}, worst rel residual {worst:.1e}"
                )
                if n_failed:
                    msg += f", {n_failed} FAILED solves -> NaN"
                print(msg + ")", end="", flush=True)

            if self.config.checkpoint:
                done_chunks.add(start)
                tmp = self.config.checkpoint + ".tmp.npz"
                np.savez(
                    tmp,
                    key=ckpt_key,
                    results=results,
                    done_chunks=np.array(sorted(done_chunks), dtype=np.int64),
                )
                os.replace(tmp, self.config.checkpoint)
        if verbose:
            print()
        if self.config.profile_dir:
            jax.profiler.stop_trace()

        return results
