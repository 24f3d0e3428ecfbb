# -*- coding: utf-8 -*-
"""Public API: the ``Model`` class, mirroring the reference package's surface.

Method-for-method parity with the reference's remo3d/remo3d.py (class Model):
``compute_synthetic_logs`` (one-shot pipeline), the decomposed lifecycle
``set_model_parameters`` / ``initialize_workers`` / ``simulate_logs`` /
``shutdown_workers`` (kept split so inversion loops can re-simulate many times per
initialized executor, Changelog.md:2-4), and ``save_results``. The MPI worker farm is
replaced by the JAX device-mesh executor; ``cpu_workers``/``gpu_workers`` are
accepted and validated for compatibility but execution always uses every visible
accelerator device.
"""

from __future__ import annotations

import dataclasses
import datetime
import sys

import numpy as np

from . import io as mio
from .meshing.grid2d import GridSpec2D
from .meshing.grid3d import THIN_ANNULUS_MIN_CELLS, GridSpec3D
from .parallel.runtime import Executor, ExecutorConfig
from .planner import plan_tasks
from .tools import parse_tools

# Allowed units conversion table (reference remo3d.py:26).
conversion_table = mio.CONVERSION_TABLE

# The reference's `mesh_generator` knob selects between two third-party meshers
# (netgen vs gmsh, remo3d.py:776-784) that produce DIFFERENT unstructured meshes.
# In the fixed-topology design there is one tuned boundary-fitted grid, so both
# names DELIBERATELY resolve to the same preset: the knob is accepted (and
# validated — 3D still requires "gmsh") purely for script compatibility, and the
# physics is mesh-generator-independent. Use `grid_spec`/`grid_spec3d` to change
# resolution instead.
_GRID_PRESETS = {
    "netgen": GridSpec2D(),
    "gmsh": GridSpec2D(),
}

# Dip angle (degrees) at or above which the default 3D grid switches to the
# refined GridSpec3D.high_dip() preset. The rotated-oracle dip ladder puts the
# default grid at 0.43% max for dips <= 45 but 1.05% at 60 — the bilinear
# facets sag off steep layer planes — while high_dip() measures 0.50% at 60
# (benchmarks/bm3_oracle.py --nz=257 --nr=65 --np=25) on 3.1x the nodes.
HIGH_DIP_THRESHOLD_DEG = 50.0

# Minimum radial cells across the thinnest kept invasion annulus before the
# 3D auto-select refines the radial grading (the reference grades unstructured
# tets around its invasion half-cylinders instead, gmsh_functions.py:625-643).
# Measured on the BM2+sinusoidal-caliper oracle (a study whose script was removed):
# the default grid leaves the 0.2 m-radius annulus (~0.09 m thick over the
# wall) at ~2.4 cells / 2.35% vs the FV-anchored 2D solver. The cell-count
# threshold THIN_ANNULUS_MIN_CELLS lives in meshing.grid3d (shared with the
# builder's anchor classification).


def _thin_annulus_refine(spec, formation, borehole):
    """Refine the radial grading when an invasion annulus is under-resolved.

    Returns (spec, notice_or_None). The thinnest annulus is measured
    conservatively against the maximum caliper radius; if it spans fewer than
    ``THIN_ANNULUS_MIN_CELLS`` cells of ``spec.h_min_radial``, the spec gets
    ``nr >= 65`` and ``fz_h_radial <= thickness/THIN_ANNULUS_MIN_CELLS`` —
    an ANCHOR-LOCAL refinement of only the under-resolved invasion
    boundaries. The first shipped rule cut the global ``h_min_radial``
    instead, which crowded the fixed radial budget at every anchor and was
    measured to regress the well-resolved 0.5 m bed ~4x while fixing the thin
    one (a study whose script was removed); the local rule leaves the rest of the
    grid untouched.
    """
    spec = spec or GridSpec3D()
    fz = np.asarray(formation[:, 2], dtype=float)
    wall_max = float(np.max(borehole[:, 1]))
    finite = np.isfinite(fz) & (fz > wall_max)
    if not np.any(finite):
        return spec, None
    t_min = float(np.min(fz[finite]) - wall_max)
    if t_min >= THIN_ANNULUS_MIN_CELLS * spec.h_min_radial:
        return spec, None
    target_h = t_min / THIN_ANNULUS_MIN_CELLS
    fz_h = target_h if spec.fz_h_radial is None else min(spec.fz_h_radial, target_h)
    refined = dataclasses.replace(
        spec,
        nr=max(spec.nr, 65),
        fz_h_radial=fz_h,
    )
    notice = (
        f"Note: thinnest invasion annulus ({t_min:.3f} m over the maximum "
        f"caliper) spans < {THIN_ANNULUS_MIN_CELLS:g} radial cells of the "
        f"default 3D grid; auto-refining to nr={refined.nr}, "
        f"fz_h_radial={refined.fz_h_radial:.4f} at the thin invasion anchors "
        "(pass grid_spec3d=GridSpec3D() to override)"
    )
    return refined, notice


def _resolve_spec3d(dip_deg, grid_spec3d, executor_overrides, formation, borehole):
    """Dip- and invasion-aware 3D grid default: an explicit ``grid_spec3d``
    (or an ``executor_overrides['spec3d']``, which replaces the config
    downstream) always wins; otherwise steep dips auto-select
    ``GridSpec3D.high_dip()`` and thin invasion annuli refine the radial
    grading. Returns (spec_or_None, [notices]); None means the ExecutorConfig
    default stands."""
    if grid_spec3d is not None:
        return grid_spec3d, []
    if executor_overrides and "spec3d" in executor_overrides:
        return None, []
    notices = []
    spec = None
    if dip_deg >= HIGH_DIP_THRESHOLD_DEG:
        spec = GridSpec3D.high_dip()
        notices.append(
            f"Note: dip {dip_deg:g} deg >= {HIGH_DIP_THRESHOLD_DEG:g} auto-selects "
            "the refined GridSpec3D.high_dip() grid (~3x solve cost; pass "
            "grid_spec3d=GridSpec3D() to keep the default grid)"
        )
    spec2, notice = _thin_annulus_refine(spec, formation, borehole)
    if notice is not None:
        spec = spec2
        notices.append(notice)
    return spec, notices


class Model:
    """DC-resistivity forward modeling of normal/lateral logging tools."""

    conversion_table = conversion_table

    def __init__(self, tools, force_single_electrode_configuration=True):
        """Initialize the modelling procedure for a set of tools.

        tools: list of tool-name strings, e.g. ``["N2.5M0.25A", "B5.7A0.4M"]``.
        force_single_electrode_configuration: rewrite two-current-electrode tools to
        the reciprocal single-electrode form for solve dedup (remo3d.py:211-214).
        """
        self.tools, self.sec = parse_tools(tools, force_single_electrode_configuration)

        self.formation_model = None
        self.borehole_model = None
        self.dip_deg = None
        self.dip_rad = None

        self.cpu_workers = None
        self.gpu_workers = None
        self._executor: Executor | None = None

        self.logs = None

    # ------------------------------------------------------------------- one-shot
    @classmethod
    def compute_synthetic_logs(
        cls,
        tools,
        measurement_depths,
        formation_model,
        borehole_model,
        force_single_electrode_configuration=True,
        formation_units=["M", "M", "M"],
        borehole_geometry_type="diameter",
        borehole_units=["M", "M"],
        dip=0,
        cpu_workers=4,
        gpu_workers=0,
        domain_radius=50,
        batch_size=5,
        mesh_generator="auto",
        preconditioner="auto",
        condense=True,
        **simulate_kwargs,
    ):
        """Complete modelling procedure (reference remo3d.py:65-174).

        Extra keyword arguments (``tol``, ``grid_spec``, ``platform``,
        ``verbose``, ...) are forwarded to :meth:`simulate_logs`.
        """
        model = cls(
            tools,
            force_single_electrode_configuration=force_single_electrode_configuration,
        )
        model.set_model_parameters(
            formation_model,
            borehole_model,
            formation_units=formation_units,
            borehole_geometry_type=borehole_geometry_type,
            borehole_units=borehole_units,
            dip=dip,
        )
        model.initialize_workers(cpu_workers=cpu_workers, gpu_workers=gpu_workers)
        model.simulate_logs(
            measurement_depths,
            domain_radius=domain_radius,
            batch_size=batch_size,
            mesh_generator=mesh_generator,
            preconditioner=preconditioner,
            condense=condense,
            **simulate_kwargs,
        )
        model.shutdown_workers()
        return model

    # ------------------------------------------------------------------ model setup
    def set_model_parameters(
        self,
        formation_model,
        borehole_model,
        formation_units=["M", "M", "M"],
        borehole_geometry_type="diameter",
        borehole_units=["M", "M"],
        dip=0,
    ):
        """Set formation/borehole models from files or arrays.

        The unit lists apply to ndarray input only — model files carry their own
        units row (reference remo3d.py:406-437, 470-499).
        """
        if isinstance(formation_model, str):
            self.formation_model = mio.load_formation_parameters(formation_model)
        elif isinstance(formation_model, np.ndarray):
            self.formation_model = mio.set_formation_parameters(
                formation_model, formation_units
            )

        if isinstance(borehole_model, str):
            self.borehole_model = mio.load_borehole_parameters(
                borehole_model, borehole_geometry_type
            )
        elif isinstance(borehole_model, np.ndarray):
            self.borehole_model = mio.set_borehole_parameters(
                borehole_model, borehole_geometry_type, borehole_units
            )

        self.dip_deg, self.dip_rad = mio.set_dip(dip)
        mio.check_model_geometry(self.formation_model, self.borehole_model)

    # Thin parity wrappers so callers of the reference's loaders keep working.
    def load_formation_parameters(self, formation_model_file):
        return mio.load_formation_parameters(formation_model_file)

    def set_formation_parameters(self, formation_parameters, formation_units=["M", "M", "M"]):
        return mio.set_formation_parameters(formation_parameters, formation_units)

    def load_borehole_parameters(self, borehole_model_file, borehole_geometry_type="diameter"):
        return mio.load_borehole_parameters(borehole_model_file, borehole_geometry_type)

    def set_borehole_parameters(
        self, borehole_parameters, borehole_geometry_type="diameter", borehole_units=["M", "M"]
    ):
        return mio.set_borehole_parameters(
            borehole_parameters, borehole_geometry_type, borehole_units
        )

    def set_dip(self, dip):
        return mio.set_dip(dip)

    def _check_model_geometry(self):
        mio.check_model_geometry(self.formation_model, self.borehole_model)

    # --------------------------------------------------------------------- runtime
    def initialize_workers(self, cpu_workers=4, gpu_workers=0):
        """Initialize the execution backend.

        Validation parity with remo3d.py:552-599; the worker counts do not spawn
        processes here — the device mesh does the parallel work — but the same
        argument errors are raised so existing scripts behave identically.
        """
        if type(cpu_workers) != int or type(gpu_workers) != int:
            raise ValueError("Worker counts must be integers")
        if cpu_workers < 1:
            raise ValueError("At least one CPU worker is required")
        if gpu_workers < 0:
            raise ValueError("The GPU worker count cannot be negative")

        self.cpu_workers = cpu_workers
        self.gpu_workers = gpu_workers
        self._executor = None  # re-created per simulate_logs configuration

    def simulate_logs(
        self,
        measurement_depths,
        domain_radius=50,
        batch_size=5,
        mesh_generator="auto",
        preconditioner="auto",
        condense=True,
        tol=None,
        maxiter=1000,
        dtype="float32",
        grid_spec: GridSpec2D | None = None,
        grid_spec3d=None,
        platform=None,
        verbose=True,
        profile_dir=None,
        checkpoint=None,
        executor_overrides: dict | None = None,
    ):
        """Simulate all logs (reference remo3d.py:723-884).

        ``preconditioner`` accepts the reference's "local"/"multigrid"
        (remo3d.py:723 kwargs parity) plus "direct" (the batched
        block-tridiagonal factorization, ops/block_direct.py) and the default
        "auto", which resolves per platform at executor init — CPU runs pick
        "direct" (measured 31x faster end-to-end on the CPU), accelerators
        pick the multigrid/ADI paths (see ExecutorConfig and resolve_auto).

        Extras beyond the reference kwargs: ``tol`` (CG relative
        tolerance; None = automatic, 3e-7 for 2D and 1e-5 for the
        singularity-subtracted 3D solve), ``dtype``, ``grid_spec`` /
        ``grid_spec3d`` (grid topology override; ``GridSpec3D.fast()`` for a
        ~2x-faster 3D preset; when omitted, dips >= 50 deg auto-select
        ``GridSpec3D.high_dip()`` — see ``_resolve_spec3d``),
        ``profile_dir`` (write a jax.profiler trace of
        the solve phase) and ``checkpoint`` (an .npz path: per-chunk results are
        persisted and an interrupted run resumes) and ``executor_overrides`` (a
        dict of :class:`~remo3d_jax.parallel.runtime.ExecutorConfig` field
        overrides, e.g. ``{"chunk_size": 96}`` — the expert tuning hatch).
        ``condense`` is accepted for
        compatibility; Q1 stencils have no interior DOFs to condense.
        ``mesh_generator`` is likewise compatibility-only: "netgen" and "gmsh"
        resolve to the SAME fixed-topology grid preset (see ``_GRID_PRESETS``) —
        use ``grid_spec``/``grid_spec3d`` to change resolution.
        """
        start_time = datetime.datetime.now()
        measurement_depths = np.asarray(measurement_depths, dtype=float)
        if tol is None:
            tol = 3e-7 if np.isclose(self.dip_deg, 0) else 1e-5

        # Domain sanity checks (remo3d.py:766-773).
        domain_radius_alert = False
        for tp in self.tools.values():
            extent = np.max(np.abs(tp.geometry))
            if extent > domain_radius:
                raise ValueError(
                    "Some electrodes lie outside the simulation domain; "
                    "increase domain_radius"
                )
            elif extent > 0.75 * domain_radius:
                domain_radius_alert = True
        if domain_radius_alert:
            print(
                "Warning: some electrodes sit within 25% of the domain boundary; "
                "results may degrade - consider a larger domain_radius"
            )

        # Mesh generator selection parity (remo3d.py:776-784).
        if mesh_generator == "auto":
            mesh_generator = "netgen" if np.isclose(self.dip_deg, 0) else "gmsh"
        if not np.isclose(self.dip_deg, 0) and mesh_generator != "gmsh":
            raise ValueError("The only mesh generator supported in 3D models is gmsh")
        active_window = 0.999 if mesh_generator == "netgen" else 0.99

        if self.dip_deg != 0:
            # Densify sparse borehole polylines (3D meshing aid, remo3d.py:791-792).
            self.borehole_model = mio.add_points_to_borehole(self.borehole_model)

        # Plan simulation depths and batches.
        simulation_depths, tasks = plan_tasks(
            self.tools, self.sec, measurement_depths, batch_size
        )
        if verbose:
            print(f"{len(tasks)} simulation tasks prepared")

        mud_resistivities = np.interp(
            simulation_depths, self.borehole_model[:, 0], self.borehole_model[:, 2]
        )

        spec = grid_spec or _GRID_PRESETS.get(mesh_generator, GridSpec2D())
        is_3d = not np.isclose(self.dip_deg, 0)
        grid_spec3d, spec_notices = (
            _resolve_spec3d(
                self.dip_deg, grid_spec3d, executor_overrides,
                self.formation_model, self.borehole_model,
            )
            if is_3d
            else (grid_spec3d, [])
        )
        if verbose:
            for notice in spec_notices:
                print(notice)
        config_kwargs = {}
        if grid_spec3d is not None:
            config_kwargs["spec3d"] = grid_spec3d
        config = ExecutorConfig(
            spec=spec,
            tol=tol,
            maxiter=maxiter,
            dtype=dtype,
            preconditioner=preconditioner,
            platform=platform,
            profile_dir=profile_dir,
            checkpoint=checkpoint,
            **config_kwargs,
        )
        if executor_overrides:
            config = dataclasses.replace(config, **executor_overrides)
        executor = Executor(config)  # compiled programs are cached process-wide
        self._executor = executor

        grids = executor.prepare_batches(
            tasks,
            self.formation_model,
            self.borehole_model[:, :2],
            mud_resistivities,
            domain_radius,
            self.dip_rad,
            active_window,
        )
        results = executor.run(
            tasks,
            grids,
            len(measurement_depths),
            len(self.tools),
            # Half-space convention: only the y>=0 half-ball is modeled in 3D
            # (worker.py:129-131).
            readout_factor=0.5 if self.dip_deg != 0 else 1.0,
            verbose=verbose,
        )

        logs = {}
        for i, name in enumerate(self.tools.keys()):
            logs[name] = np.vstack([measurement_depths, results[:, i]]).T
        self.logs = logs

        if verbose:
            print("\nProcessed in: ", datetime.datetime.now() - start_time)
            print(executor.timers.report())
        return logs

    def shutdown_workers(self):
        """Release the executor (compiled programs and device buffers)."""
        self._executor = None

    # --------------------------------------------------------------------- output
    def save_results(self, output_folder=None, **kwargs):
        """Save Results_N.txt TSVs + Results_plot.png (reference remo3d.py:902-1147)."""
        # Imported here so the solve path needs no plotting library.
        from .plotting import save_results_impl

        return save_results_impl(
            logs=self.logs,
            formation_parameters=self.formation_model,
            borehole_parameters=self.borehole_model,
            dip=self.dip_deg,
            output_folder=output_folder,
            **kwargs,
        )
