# -*- coding: utf-8 -*-
"""Differentiable forward modeling: logs as a pure JAX function of resistivity.

The reference is a forward-only code: inversion users wrap it in finite
differences, paying one FULL log simulation per parameter per Jacobian
(its mpiexec workflow exists to amortize exactly that cost,
remo3d/remo3d.py:592-598). Because this package's entire pipeline —
assembly, solve, readout — is traced JAX, the log can instead be exposed as a
differentiable function of the formation resistivities:

* ``DifferentiableLog(model, depths)`` captures the planning/meshing state of
  a configured :class:`~remo3d_jax.model.Model` (the geometry is frozen; the
  per-cell conductivity becomes a gather from the parameter vector);
* calling it with a resistivity vector returns the (n_measurements, n_tools)
  log matrix — ``jax.jit``-able, and usable inside any JAX optimizer;
* gradients of a scalar misfit cost ONE extra linear-solve pass (the adjoint
  solve, via ``lax.custom_linear_solve`` — by reciprocity it is just another
  source configuration on the same factorization);
* the full Jacobian via :meth:`DifferentiableLog.jacobian` (forward-mode)
  costs P extra right-hand sides sharing the chunk's direct factorization —
  NOT P full simulations.

Scope: parameters = the formation table's undisturbed/invaded zone
resistivities (mud and geometry stay fixed). Both the 2D axisymmetric
(dip == 0) and the 3D dipping path are supported; the solves mirror the
production direct-preconditioner paths (parallel/runtime.py:_pcg2_direct /
_pcg3) including analytic singularity subtraction, so values match
``Model.simulate_logs`` to solver tolerance. In 3D the sub-cell sigma
homogenization (the default "arithmetic" blend, meshing/grid3d.py) is
linear in the layer conductivities, so it is traced EXACTLY as a
host-precomputed per-cell weight matrix over the parameter vector.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .meshing.carve import carve_local_model
from .meshing.grid2d import GridSpec2D, build_grid2d
from .planner import plan_tasks

MAX_SOURCES = 4


@dataclasses.dataclass
class _ChunkPlan:
    """Static staging arrays for one device chunk (see DifferentiableLog)."""

    coords: np.ndarray  # (B, NZ, NR, 2)
    free: np.ndarray  # (B, NZ, NR) bool
    region: np.ndarray  # (B, NZ-1, NR-1) int32 param index, -1 = fixed (mud/pad)
    sigma_fixed: np.ndarray  # (B, NZ-1, NR-1) conductivity where region == -1
    src_i: np.ndarray  # (B, S, MAX_SOURCES) int32
    src_fac: np.ndarray  # (B, S, MAX_SOURCES)
    ro_b: np.ndarray  # (RO,) int32 batch lane of each readout
    ro_s: np.ndarray  # (RO,) int32 solve lane
    ro_i0: np.ndarray  # (RO,) int32 axis node of the first measuring electrode
    ro_i1: np.ndarray  # (RO,) int32 second electrode node, NZ = "zero potential"
    ro_k: np.ndarray  # (RO,) geometric factors
    ro_out: np.ndarray  # (RO, 2) int32 (measurement, tool); row0 = n_meas -> dropped


@dataclasses.dataclass
class _ChunkPlan3D:
    """Static staging arrays for one 3D device chunk.

    Per-cell sigma is reconstructed inside the trace as
    ``fixed ? sigma_fixed : (fz_cell >= 0 ? params[fz_cell]
    : weights @ params[uz_map])`` — the weight rows are the grid builder's
    arithmetic sub-cell homogenization (grid3d.py:_zeta_overlap_weights).
    """

    coords: np.ndarray  # (B, NZ, NP, NR, 3)
    free: np.ndarray  # (B, NZ, NP, NR) bool
    weights: np.ndarray  # (B, NZ-1, NP-1, NR-1, Lmax) local-layer weights
    uz_map: np.ndarray  # (B, Lmax) int32 global param of each local layer's UZ
    fz_cell: np.ndarray  # (B, NZ-1, NP-1, NR-1) int32 global FZ param, -1 = none
    fixed: np.ndarray  # (B, NZ-1, NP-1, NR-1) bool mud column / padding
    sigma_fixed: np.ndarray  # conductivity where fixed
    src_i: np.ndarray  # (B, S, MAX_SOURCES) int32
    src_fac: np.ndarray  # (B, S, MAX_SOURCES)
    ro_b: np.ndarray
    ro_s: np.ndarray
    ro_i0: np.ndarray
    ro_i1: np.ndarray
    ro_k: np.ndarray  # geometric factors (pre-multiplied by the 3D 0.5)
    ro_out: np.ndarray


class DifferentiableLog:
    """Logs of a fixed geometry as a pure JAX function of layer resistivities.

    Parameters are the formation table's resistivity VALUES in table order:
    first every layer's UZ (undisturbed) resistivity, then the FZ (invaded)
    resistivity of each layer that has an invasion zone — see
    :attr:`param_names` / :attr:`params0`. Layer boundaries, invasion radii,
    the borehole, and mud resistivity are frozen at construction (they shape
    the grid, which must stay fixed for the function to be traceable).

    >>> dlog = DifferentiableLog(model, depths)
    >>> logs = jax.jit(dlog)(dlog.params0)            # forward
    >>> J = dlog.jacobian(dlog.params0)               # (n_meas, n_tools, P)
    >>> g = jax.grad(lambda p: loss(dlog(p)))(p)      # one adjoint pass
    """

    def __init__(
        self,
        model,
        measurement_depths,
        *,
        domain_radius: float = 50.0,
        batch_size: int = 5,
        grid_spec: GridSpec2D | None = None,
        grid_spec3d=None,
        tol: float = 3e-7,
        maxiter: int = 1000,
        chunk_size: int = 8,
        factor_passes: int | None = None,
        active_window: float = 0.999,
        metric3d: str | None = None,
    ):
        if (
            model.formation_model is None
            or model.borehole_model is None
            or model.dip_deg is None
        ):
            raise ValueError("call model.set_model_parameters first")
        self._is3d = not np.isclose(model.dip_deg, 0)
        dip_rad = float(np.deg2rad(model.dip_deg))
        if self._is3d:
            from .meshing.grid3d import GridSpec3D, build_grid3d

            spec3 = grid_spec3d or GridSpec3D()
        else:
            spec = grid_spec or GridSpec2D()
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        self.factor_passes = factor_passes
        # Follow the production executor's 3D assembly metric by default so
        # forward parity with Model.simulate_logs holds: prefer the metric the
        # model's LIVE executor actually resolved (it may carry
        # executor_overrides={'metric3d': ...}); fall back to the class default
        # when no executor has run yet.
        if metric3d is None:
            executor = getattr(model, "_executor", None)
            if executor is not None:
                metric3d = executor.config.metric3d
            else:
                from .parallel.runtime import ExecutorConfig

                metric3d = ExecutorConfig.metric3d
        self.metric3d = metric3d
        self.n_tools = len(model.tools)

        measurement_depths = np.asarray(measurement_depths, dtype=float)
        self.n_measurements = measurement_depths.size
        simulation_depths, tasks = plan_tasks(
            model.tools, model.sec, measurement_depths, batch_size
        )
        mud_resistivities = np.interp(
            simulation_depths,
            model.borehole_model[:, 0],
            model.borehole_model[:, 2],
        )

        # ---- Parameter layout over the GLOBAL formation table ----------------
        fm = model.formation_model  # (L, 5): top, bottom, fz_radius, fz_rho, uz_rho
        L = fm.shape[0]
        has_fz = ~np.isnan(fm[:, 2])
        fz_param_of_row = np.full(L, -1, dtype=np.int32)
        fz_param_of_row[has_fz] = L + np.arange(int(has_fz.sum()), dtype=np.int32)
        self.param_names = [f"UZ[{l}]" for l in range(L)] + [
            f"FZ[{l}]" for l in np.flatnonzero(has_fz)
        ]
        self.params0 = np.concatenate([fm[:, 4], fm[has_fz, 3]])

        # ---- Host staging: grids with region provenance ----------------------
        S = max(len(t.solves) for t in tasks)
        chunk = max(1, int(chunk_size))
        plans: list[_ChunkPlan] = []
        grids = []
        for t in tasks:
            lm = carve_local_model(
                model.formation_model,
                model.borehole_model[:, :2],
                float(mud_resistivities[t.batch_index]),
                t.center_depth,
                domain_radius,
                dip_rad=dip_rad,
                active_geometry_window=active_window,
            )
            sources = np.unique(np.concatenate([s.source_positions for s in t.solves]))
            # local layer -> global param: promoted layers' "UZ" value IS the
            # global row's FZ parameter (carve.py invasion-zone promotion).
            rows = lm.global_rows
            uz_map = np.where(lm.fz_promoted, fz_param_of_row[rows], rows).astype(
                np.int32
            )
            fz_map = fz_param_of_row[rows]
            if self._is3d:
                g = build_grid3d(
                    spec3, domain_radius, lm, dip_rad,
                    t.electrode_positions, sources, with_regions=True,
                )
                lay = g.region_fz_layer
                fz_cell = np.where(
                    lay >= 0, fz_map[np.clip(lay, 0, None)], np.int32(-1)
                ).astype(np.int32)
                grids.append((g, (uz_map, fz_cell), lm))
                continue
            g = build_grid2d(spec, domain_radius, lm, t.electrode_positions, sources)
            lay = g.region_layer
            region = np.where(
                lay < 0,
                np.int32(-1),
                np.where(g.region_invaded, fz_map[lay], uz_map[lay]),
            ).astype(np.int32)
            grids.append((g, region, lm))

        nz = spec3.nz if self._is3d else spec.nz
        ro_max = 0
        for c0 in range(0, len(tasks), chunk):
            ro_max = max(
                ro_max,
                sum(
                    len(s.readouts)
                    for t in tasks[c0 : c0 + chunk]
                    for s in t.solves
                ),
            )
        # Half-space readout convention in 3D (runtime.py readout_factor=0.5).
        ro_factor = 0.5 if self._is3d else 1.0
        for c0 in range(0, len(tasks), chunk):
            btasks = tasks[c0 : c0 + chunk]
            g0 = grids[c0][0]
            B = chunk
            src_i = np.zeros((B, S, MAX_SOURCES), dtype=np.int32)
            src_fac = np.zeros((B, S, MAX_SOURCES))
            ro = {k: [] for k in ("b", "s", "i0", "i1", "k", "m", "t")}

            def stage_task(bi, t, g):
                for si, s in enumerate(t.solves):
                    for k, (pos, fac) in enumerate(
                        zip(s.source_positions, s.source_terms)
                    ):
                        src_i[bi, si, k] = g.axis_node_index(pos)
                        src_fac[bi, si, k] = fac
                    for r in s.readouts:
                        nodes = [g.axis_node_index(p) for p in r.measuring_positions]
                        ro["b"].append(bi)
                        ro["s"].append(si)
                        # |K (u1 - u0)|; single-electrode readouts use the
                        # zero-potential sentinel slot nz for u1.
                        ro["i0"].append(nodes[0])
                        ro["i1"].append(nodes[1] if len(nodes) == 2 else nz)
                        ro["k"].append(r.geometric_factor * ro_factor)
                        ro["m"].append(r.measurement_index)
                        ro["t"].append(r.tool_index)

            def ro_arrays():
                pad = ro_max - len(ro["b"])
                return dict(
                    ro_b=np.asarray(ro["b"] + [0] * pad, dtype=np.int32),
                    ro_s=np.asarray(ro["s"] + [0] * pad, dtype=np.int32),
                    ro_i0=np.asarray(ro["i0"] + [0] * pad, dtype=np.int32),
                    ro_i1=np.asarray(ro["i1"] + [nz] * pad, dtype=np.int32),
                    ro_k=np.asarray(ro["k"] + [0.0] * pad),
                    # padded rows scatter out of range -> dropped.
                    ro_out=np.asarray(
                        list(zip(ro["m"], ro["t"]))
                        + [(self.n_measurements, 0)] * pad,
                        dtype=np.int32,
                    ),
                )

            if self._is3d:
                np3, nr3 = spec3.np_, spec3.nr
                Lmax = max(reg[0].size for _, reg, _ in grids)
                coords = np.tile(g0.coords[None], (B, 1, 1, 1, 1))
                free = np.tile(g0.free_mask[None], (B, 1, 1, 1))
                cshape = (B, nz - 1, np3 - 1, nr3 - 1)
                weights = np.zeros(cshape + (Lmax,), dtype=np.float32)
                uz_map_b = np.zeros((B, Lmax), dtype=np.int32)
                fz_cell = np.full(cshape, -1, dtype=np.int32)
                fixed = np.ones(cshape, dtype=bool)  # padded lanes: uniform
                sigma_fixed = np.ones(cshape)
                for bi, t in enumerate(btasks):
                    g, (uz_map, fzc), lm = grids[c0 + bi]
                    coords[bi] = g.coords
                    free[bi] = g.free_mask
                    weights[bi, ..., : uz_map.size] = g.region_uz_weights
                    uz_map_b[bi, : uz_map.size] = uz_map
                    fz_cell[bi] = fzc
                    fixed[bi] = g.region_fixed
                    sigma_fixed[bi] = np.where(g.region_fixed, g.sigma_cells, 1.0)
                    stage_task(bi, t, g)
                plans.append(
                    _ChunkPlan3D(
                        coords=coords, free=free, weights=weights,
                        uz_map=uz_map_b, fz_cell=fz_cell, fixed=fixed,
                        sigma_fixed=sigma_fixed, src_i=src_i, src_fac=src_fac,
                        **ro_arrays(),
                    )
                )
                continue
            nr = spec.nr
            coords = np.tile(g0.coords[None], (B, 1, 1, 1))
            free = np.tile(g0.free_mask[None], (B, 1, 1))
            region = np.full((B, nz - 1, nr - 1), -1, dtype=np.int32)
            sigma_fixed = np.ones((B, nz - 1, nr - 1))
            for bi, t in enumerate(btasks):
                g, reg, lm = grids[c0 + bi]
                coords[bi] = g.coords
                free[bi] = g.free_mask
                region[bi] = reg
                sigma_fixed[bi] = np.where(reg < 0, g.sigma_cells, 1.0)
                stage_task(bi, t, g)
            plans.append(
                _ChunkPlan(
                    coords=coords,
                    free=free,
                    region=region,
                    sigma_fixed=sigma_fixed,
                    src_i=src_i,
                    src_fac=src_fac,
                    **ro_arrays(),
                )
            )
        # Stack chunks on a leading axis: ONE compiled body serves all chunks
        # (lax.map), exactly like the executor's chunk pipeline.
        dtype = np.float32
        self._stacked = {
            f.name: jnp.asarray(
                np.stack([getattr(p, f.name) for p in plans]),
                dtype=(
                    np.int32
                    if getattr(plans[0], f.name).dtype.kind == "i"
                    else (bool if getattr(plans[0], f.name).dtype == bool else dtype)
                ),
            )
            for f in dataclasses.fields(plans[0])
        }

        self._jit_forward = None
        self._jit_jacobian = None

    # ------------------------------------------------------------------ forward
    def __call__(self, resistivities):
        """Log matrix (n_measurements, n_tools) for a resistivity vector.

        Pure traced function of ``resistivities`` (ohm-m, :attr:`param_names`
        order); entries never measured stay NaN (parity with
        Model.simulate_logs). Compose freely with jax transforms; for repeated
        eager calls use :meth:`forward` (cached jit).
        """
        p = self._stacked
        sigma_params = 1.0 / jnp.asarray(resistivities, dtype=p["sigma_fixed"].dtype)
        tol, maxiter, passes = self.tol, self.maxiter, self.factor_passes

        def readout(c, u_axis):
            # zero-potential sentinel slot nz (single-electrode readouts).
            u_pad = jnp.pad(u_axis, ((0, 0), (0, 0), (0, 1)))
            u0 = u_pad[c["ro_b"], c["ro_s"], c["ro_i0"]]
            u1 = u_pad[c["ro_b"], c["ro_s"], c["ro_i1"]]
            return jnp.abs(c["ro_k"] * (u1 - u0)), c["ro_out"]

        P = sigma_params.size

        def one_chunk_3d(c):
            # sigma = fixed ? sigma_fixed : (invaded ? params[fz_cell]
            #         : arithmetic-blend weights @ params[uz_map])
            sig_uz = sigma_params[jnp.clip(c["uz_map"], 0, P - 1)]  # (B, Lmax)
            sigma_w = jnp.einsum(
                "bzprl,bl->bzpr", c["weights"], sig_uz,
                preferred_element_type=sig_uz.dtype,
            )
            fz = c["fz_cell"]
            sigma = jnp.where(
                c["fixed"],
                c["sigma_fixed"],
                jnp.where(fz >= 0, sigma_params[jnp.clip(fz, 0, P - 1)], sigma_w),
            )
            u_axis = _solve_chunk_diff_3d(
                c["coords"], sigma, c["free"], c["src_i"], c["src_fac"],
                tol=tol, maxiter=maxiter, factor_passes=passes,
                metric=self.metric3d,
            )
            return readout(c, u_axis)

        def one_chunk(c):
            if self._is3d:
                return one_chunk_3d(c)
            region = c["region"]
            sigma = jnp.where(
                region >= 0,
                sigma_params[jnp.clip(region, 0, P - 1)],
                c["sigma_fixed"],
            )
            u_axis = _solve_chunk_diff(
                c["coords"], sigma, c["free"], c["src_i"], c["src_fac"],
                tol=tol, maxiter=maxiter, factor_passes=passes,
            )
            return readout(c, u_axis)

        vals, outs = jax.lax.map(one_chunk, p)
        results = jnp.full(
            (self.n_measurements, self.n_tools), jnp.nan, dtype=vals.dtype
        )
        flat_out = outs.reshape(-1, 2)
        return results.at[flat_out[:, 0], flat_out[:, 1]].set(
            vals.reshape(-1), mode="drop"
        )

    def forward(self, resistivities):
        """Eager convenience: jitted-and-cached :meth:`__call__`."""
        if self._jit_forward is None:
            self._jit_forward = jax.jit(self.__call__)
        return self._jit_forward(jnp.asarray(resistivities))

    def jacobian(self, resistivities):
        """d(log)/d(resistivity): (n_measurements, n_tools, P), forward-mode.

        Each parameter adds one tangent right-hand side to every chunk's
        solve, sharing the chunk's factorization — NOT one finite-difference
        re-simulation per parameter (the reference's only option).
        """
        if self._jit_jacobian is None:
            self._jit_jacobian = jax.jit(jax.jacfwd(self.__call__))
        return self._jit_jacobian(jnp.asarray(resistivities))


def _solve_chunk_diff(
    coords, sigma, free, src_i, src_fac, *, tol, maxiter, factor_passes
):
    """One chunk's axis potentials, differentiable wrt ``sigma``.

    Mirrors the production direct-preconditioner path
    (parallel/runtime.py:_pcg2_direct, singularity-subtraction branch) with
    the CG wrapped in ``lax.custom_linear_solve``: forward/reverse derivatives
    become ONE extra linear solve on the same (gradient-stopped, hence
    constant) preconditioner instead of differentiating through the CG loop.
    """
    from .ops.assembly2d import (
        apply_dirichlet,
        element_matrices_2d,
        fold_to_stencil,
        fundamental_potential_2d,
        singularity_rhs_2d,
    )
    from .ops.block_direct import (
        block_thomas_apply,
        block_thomas_factor,
        schur_fixedpoint_factor,
    )
    from .ops.cg import pcg
    from .ops.stencil import stencil_apply

    nz, nr = coords.shape[-3], coords.shape[-2]
    C_raw = fold_to_stencil(element_matrices_2d(coords, sigma), nz, nr)
    C = apply_dirichlet(C_raw, free)
    C_pre = jax.lax.stop_gradient(C)
    if factor_passes is None:
        G_all = block_thomas_factor(C_pre)
    else:
        G_all = schur_fixedpoint_factor(C_pre, passes=factor_passes)

    freeb = free[:, None]
    sigma0 = sigma[:, 0, 0]
    z_axis = coords[:, :, 0, 0]
    src_z = jnp.take_along_axis(z_axis[:, None, :], src_i, axis=-1)
    u_s = fundamental_potential_2d(coords, sigma0, src_z, src_fac)
    rhs = singularity_rhs_2d(coords, sigma, sigma0, src_z, src_fac)
    g_lift = jnp.where(freeb, 0.0, -u_s)
    rhs = jnp.where(freeb, rhs - stencil_apply(C_raw, g_lift), 0.0)

    def matvec(x):
        return stencil_apply(C, x)

    def solve_fn(mv, b):
        w, _ = pcg(
            C_pre, b,
            M_inv=lambda r: block_thomas_apply(G_all, C_pre, r),
            tol=tol, maxiter=maxiter,
        )
        return w

    w = jax.lax.custom_linear_solve(matvec, rhs, solve_fn, symmetric=True)
    u = w + g_lift + u_s
    return u[..., 0]


def _solve_chunk_diff_3d(
    coords, sigma, free, src_i, src_fac, *, tol, maxiter, factor_passes,
    metric="cartesian",
):
    """One 3D chunk's axis potentials, differentiable wrt ``sigma``.

    Mirrors the production direct-preconditioner 3D path
    (parallel/runtime.py:_solve_chunk_3d + _pcg3: hex assembly, singularity
    subtraction, pole-tied CG with the banded-block LDL^T preconditioner),
    with the solve wrapped in ``lax.custom_linear_solve`` on the
    pole-projected operator — derivatives cost one extra solve on the same
    (gradient-stopped) factorization.
    """
    from .ops.assembly3d import (
        apply_dirichlet_3d,
        element_matrices_3d,
        fold_to_stencil_3d,
        fundamental_potential_3d,
        singularity_rhs_3d,
    )
    from .ops.block_direct3d import (
        block_thomas_apply_3d,
        block_thomas_factor_3d,
        schur_fixedpoint_factor_3d,
    )
    from .ops.cg import pcg
    from .ops.stencil3d import pole_project, stencil3d_apply

    nz, np_, nr = coords.shape[-4], coords.shape[-3], coords.shape[-2]
    K = element_matrices_3d(coords, sigma, metric=metric)
    C_raw = fold_to_stencil_3d(K, nz, np_, nr)
    C = apply_dirichlet_3d(C_raw, free)
    C_pre = jax.lax.stop_gradient(C)
    if factor_passes is None:
        G3 = block_thomas_factor_3d(C_pre, np_, nr)
    else:
        G3 = schur_fixedpoint_factor_3d(C_pre, np_, nr, passes=factor_passes)

    freeb = free[:, None]
    sigma0 = sigma[:, 0, 0, 0]  # innermost ring = mud conductivity (fixed)
    z_axis = coords[:, :, 0, 0, 2]
    src_z = jnp.take_along_axis(z_axis[:, None, :], src_i, axis=-1)
    u_s = fundamental_potential_3d(coords, sigma0, src_z, src_fac)
    rhs = singularity_rhs_3d(coords, sigma, sigma0, src_z, src_fac, metric=metric)
    g_lift = jnp.where(freeb, 0.0, -u_s)
    rhs = jnp.where(freeb, rhs - stencil3d_apply(C_raw, g_lift), 0.0)
    rhs = pole_project(rhs)

    def matvec(x):
        return pole_project(stencil3d_apply(C, pole_project(x)))

    def solve_fn(mv, b):
        def matvec_pre(p):
            return pole_project(stencil3d_apply(C_pre, pole_project(p)))

        def M_inv(r):
            r = pole_project(r)
            return pole_project(block_thomas_apply_3d(G3, C_pre, r, np_, nr))

        w, _ = pcg(
            None, b, M_inv=M_inv, tol=tol, maxiter=maxiter,
            n_grid_axes=3, matvec=matvec_pre,
        )
        return w

    w = jax.lax.custom_linear_solve(matvec, rhs, solve_fn, symmetric=True)
    # Axis readout: azimuthal mean of the tied pole ring + analytic offset.
    return jnp.mean(w[..., :, :, 0], axis=-1) + (g_lift + u_s)[..., :, 0, 0]
