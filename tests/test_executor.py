# -*- coding: utf-8 -*-
"""Executor policy without a device: the per-platform auto picks and the
containment of a chunk that raises."""

import numpy as np
import pytest

import jax

from remo3d_jax import Model
from remo3d_jax.meshing.grid2d import GridSpec2D
from remo3d_jax.parallel import runtime
from remo3d_jax.parallel.runtime import ExecutorConfig, resolve_auto

SMALL_2D = GridSpec2D(nz=193, nr=41, n_wall_cells=6, n_blend_cells=3)

# platform -> (preconditioner, chunk_size, precond3d, direct_schedule,
#              device_meshing, stencil3d)
EXPECTED_PICKS = {
    "cpu": ("direct", 48, "direct", "scan", False, "full"),
    "gpu": ("multigrid", 96, "adi", "bcr", True, "half"),
}


@pytest.mark.parametrize("platform", sorted(EXPECTED_PICKS))
def test_auto_picks_resolve_per_platform(platform):
    """resolve_auto is pure: the GPU picks are checked without a card."""
    cfg = resolve_auto(ExecutorConfig(), platform)
    got = (
        cfg.preconditioner, cfg.chunk_size, cfg.precond3d,
        cfg.direct_schedule, cfg.device_meshing, cfg.stencil3d,
    )
    assert got == EXPECTED_PICKS[platform]
    # float64 keeps host meshing; explicit values are never overridden.
    assert resolve_auto(ExecutorConfig(dtype="float64"), platform).device_meshing is False
    explicit = ExecutorConfig(
        preconditioner="local", chunk_size=7, precond3d="lines",
        direct_schedule="scan", device_meshing=False, stencil3d="full",
    )
    assert resolve_auto(explicit, platform) == explicit
    assert resolve_auto(ExecutorConfig(direct_factor_passes=4), platform).direct_schedule == "fp"


@pytest.mark.parametrize("stage", ["dispatch", "gather"])
def test_failed_chunk_gives_nan_readouts_without_retry(stage, monkeypatch, capfd):
    """A chunk whose dispatch or result fetch raises is reported once on
    stderr and becomes NaN readouts; it is not dispatched again."""
    calls = []
    real = runtime._solve_chunk_direct

    def solve(*args, **kwargs):
        calls.append(1)
        if stage == "dispatch":
            raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: injected fault")
        return real(*args, **kwargs)

    def gather(x):
        raise jax.errors.JaxRuntimeError("INTERNAL: injected fault")

    monkeypatch.setattr(runtime, "_solve_chunk_direct", solve)
    if stage == "gather":
        monkeypatch.setattr(runtime, "gather_result", gather)

    formation = np.array([[-100.0, 100.0, np.nan, np.nan, 5.0]])
    borehole = np.array([[-100.0, 0.1, 5.0], [100.0, 0.1, 5.0]])
    m = Model(["A2.0M0.5N"])
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius")
    m.initialize_workers()
    m.simulate_logs(
        np.array([0.0, 0.1]), platform="cpu", verbose=False, grid_spec=SMALL_2D,
        executor_overrides={"preconditioner": "direct", "chunk_size": 2},
    )
    assert np.isnan(m.logs["A2.0M0.5N"][:, 1]).all()
    report = m._executor.last_report
    assert len(calls) == len(report["chunks"]) == 1
    assert report["n_failed_solves"] == 2 and report["n_nan_readouts"] == 2
    err = capfd.readouterr().err
    assert err.count("solve chunk at batch 0 failed: JaxRuntimeError") == 1, err
