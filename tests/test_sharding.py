# -*- coding: utf-8 -*-
"""Device-mesh sharding tests on the virtual 8-device CPU mesh.

The executor shards the batch axis over all devices of its platform
(jax.sharding.NamedSharding); these tests check the sharded run against the
reference single-device result and the driver-style multichip dry-run.
"""

import jax
import numpy as np
import pytest

cpu_devices = jax.devices("cpu")

pytestmark = pytest.mark.skipif(
    len(cpu_devices) < 8, reason="needs XLA_FLAGS=--xla_force_host_platform_device_count=8"
)


def test_executor_sharded_batch_axis_matches_single_device():
    from remo3d_jax import Model
    from remo3d_jax.meshing.grid2d import GridSpec2D
    from remo3d_jax.parallel.runtime import Executor, ExecutorConfig
    from remo3d_jax.planner import plan_tasks

    spec = GridSpec2D(nz=129, nr=33, n_wall_cells=4, n_blend_cells=2)
    rho = 6.0
    formation = np.array([[-100.0, 100.0, np.nan, np.nan, rho]])
    borehole = np.array([[-100.0, 0.1, rho], [100.0, 0.1, rho]])
    m = Model(["A2.0M0.5N"])
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius")
    depths = np.arange(0.0, 1.51, 0.1)  # 16 depths -> 16 batches at batch_size=1
    sim_depths, tasks = plan_tasks(m.tools, m.sec, depths, 1)
    mud = np.interp(sim_depths, m.borehole_model[:, 0], m.borehole_model[:, 2])

    def run(devices_limit):
        config = ExecutorConfig(
            spec=spec,
            platform="cpu",
            preconditioner="local",
            maxiter=20000,
            tol=1e-6,
            chunk_size=16,
        )
        ex = Executor(config)
        if devices_limit == 1:
            ex._devices = ex._devices[:1]
        grids = ex.prepare_batches(
            tasks, m.formation_model, m.borehole_model[:, :2], mud, 50.0, 0.0, 0.999
        )
        return ex.run(tasks, grids, len(depths), 1)

    res_sharded = run(8)
    res_single = run(1)
    assert np.all(np.isfinite(res_sharded))
    # Same compiled math, different partitioning: results agree to float tolerance.
    assert np.allclose(res_sharded, res_single, rtol=1e-4)
    assert np.allclose(res_sharded[:, 0], rho, rtol=0.03)


def test_executor_solve_axis_sharding_matches_single_device():
    """Scarce batches + many RHS -> the executor spends devices on the solve axis.

    2 batch meshes x 4 solves on the 8-device mesh partitions as ('batch': 2,
    'solve': 4); the result must match the single-device run exactly (same
    compiled math, different partitioning).
    """
    from remo3d_jax import Model
    from remo3d_jax.meshing.grid2d import GridSpec2D
    from remo3d_jax.parallel.runtime import Executor, ExecutorConfig
    from remo3d_jax.planner import plan_tasks

    spec = GridSpec2D(nz=129, nr=33, n_wall_cells=4, n_blend_cells=2)
    rho = 6.0
    formation = np.array([[-100.0, 100.0, np.nan, np.nan, rho]])
    borehole = np.array([[-100.0, 0.1, rho], [100.0, 0.1, rho]])
    m = Model(["A2.0M0.5N"])
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius")
    depths = np.arange(0.0, 0.71, 0.1)  # 8 depths -> 2 batches of 4 solves
    sim_depths, tasks = plan_tasks(m.tools, m.sec, depths, 4)
    assert len(tasks) == 2 and max(len(t.solves) for t in tasks) == 4
    mud = np.interp(sim_depths, m.borehole_model[:, 0], m.borehole_model[:, 2])

    def run(devices_limit):
        config = ExecutorConfig(
            spec=spec,
            platform="cpu",
            preconditioner="local",
            maxiter=20000,
            tol=1e-6,
        )
        ex = Executor(config)
        ex._devices = ex._devices[:devices_limit]
        grids = ex.prepare_batches(
            tasks, m.formation_model, m.borehole_model[:, :2], mud, 50.0, 0.0, 0.999
        )
        return ex.run(tasks, grids, len(depths), 1)

    res_sharded = run(8)
    res_single = run(1)
    assert np.all(np.isfinite(res_sharded))
    assert np.allclose(res_sharded, res_single, rtol=1e-4)
    assert np.allclose(res_sharded[:, 0], rho, rtol=0.03)


def test_dryrun_multichip_entry():
    import __graft_entry__ as ge

    with jax.default_device(cpu_devices[0]):
        fn, args = ge.entry()
        out = fn(*args)
        assert out[0].shape[0] == 1
        ge.dryrun_multichip(8)


def test_executor_sharded_direct_preconditioner_matches_single_device():
    """The block-LDL^T direct path (ops/block_direct.py) under batch-axis
    sharding: the factorization scan's carry and the G matmuls follow the
    batch sharding; results must match the single-device run."""
    from remo3d_jax import Model
    from remo3d_jax.meshing.grid2d import GridSpec2D
    from remo3d_jax.parallel.runtime import Executor, ExecutorConfig
    from remo3d_jax.planner import plan_tasks

    spec = GridSpec2D(nz=129, nr=33, n_wall_cells=4, n_blend_cells=2)
    rho = 6.0
    formation = np.array([[-100.0, 100.0, np.nan, np.nan, rho]])
    borehole = np.array([[-100.0, 0.1, rho], [100.0, 0.1, rho]])
    m = Model(["A2.0M0.5N"])
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius")
    depths = np.arange(0.0, 1.51, 0.1)
    sim_depths, tasks = plan_tasks(m.tools, m.sec, depths, 1)
    mud = np.interp(sim_depths, m.borehole_model[:, 0], m.borehole_model[:, 2])

    def run(devices_limit):
        config = ExecutorConfig(
            spec=spec,
            platform="cpu",
            preconditioner="direct",
            tol=1e-6,
            chunk_size=16,
        )
        ex = Executor(config)
        if devices_limit == 1:
            ex._devices = ex._devices[:1]
        grids = ex.prepare_batches(
            tasks, m.formation_model, m.borehole_model[:, :2], mud, 50.0, 0.0, 0.999
        )
        return ex.run(tasks, grids, len(depths), 1)

    res_sharded = run(8)
    res_single = run(1)
    assert np.all(np.isfinite(res_sharded))
    assert np.allclose(res_sharded, res_single, rtol=1e-4)
    assert np.allclose(res_sharded[:, 0], rho, rtol=0.03)


def test_executor_sharded_direct3d_matches_single_device():
    """The 3D banded-block direct path (ops/block_direct3d.py) under batch-axis
    sharding on a small uniform dipping model: the factorization scan and the
    G matmuls must follow the sharding and match the single-device run."""
    from remo3d_jax import Model
    from remo3d_jax.meshing.grid3d import GridSpec3D
    from remo3d_jax.parallel.runtime import Executor, ExecutorConfig
    from remo3d_jax.planner import plan_tasks

    spec3d = GridSpec3D(nz=33, np_=5, nr=13, n_wall_cells=4, n_blend_cells=2)
    rho = 6.0
    formation = np.array([[-100.0, 100.0, np.nan, np.nan, rho]])
    borehole = np.array([[-100.0, 0.1, rho], [100.0, 0.1, rho]])
    m = Model(["A2.0M0.5N"])
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius", dip=20)
    depths = np.arange(0.0, 0.71, 0.1)  # 8 depths -> 8 batches at batch_size=1
    sim_depths, tasks = plan_tasks(m.tools, m.sec, depths, 1)
    mud = np.interp(sim_depths, m.borehole_model[:, 0], m.borehole_model[:, 2])

    def run(devices_limit):
        config = ExecutorConfig(
            spec3d=spec3d,
            platform="cpu",
            precond3d="direct",
            tol=1e-6,
            chunk_size_3d=8,
        )
        ex = Executor(config)
        ex._devices = ex._devices[:devices_limit]
        grids = ex.prepare_batches(
            tasks, m.formation_model, m.borehole_model[:, :2], mud, 50.0,
            m.dip_rad, 0.99
        )
        return ex.run(tasks, grids, len(depths), 1, readout_factor=0.5)

    res_sharded = run(8)
    res_single = run(1)
    assert np.all(np.isfinite(res_sharded))
    assert np.allclose(res_sharded, res_single, rtol=1e-4)
    assert np.allclose(res_sharded[:, 0], rho, rtol=0.05)


def test_executor_sharded_device_meshing_matches_single_device():
    """Device meshing (profile staging + on-device grid build) under batch-axis
    sharding with the direct solver: the profile arrays shard on the batch
    axis and the built grids inherit it; results match single-device."""
    from remo3d_jax import Model
    from remo3d_jax.meshing.grid2d import GridSpec2D
    from remo3d_jax.parallel.runtime import Executor, ExecutorConfig
    from remo3d_jax.planner import plan_tasks

    spec = GridSpec2D(nz=129, nr=33, n_wall_cells=4, n_blend_cells=2)
    rho = 6.0
    formation = np.array([[-100.0, 100.0, np.nan, np.nan, rho]])
    borehole = np.array([[-100.0, 0.1, rho], [100.0, 0.1, rho]])
    m = Model(["A2.0M0.5N"])
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius")
    depths = np.arange(0.0, 1.51, 0.1)
    sim_depths, tasks = plan_tasks(m.tools, m.sec, depths, 1)
    mud = np.interp(sim_depths, m.borehole_model[:, 0], m.borehole_model[:, 2])

    def run(devices_limit):
        config = ExecutorConfig(
            spec=spec,
            platform="cpu",
            preconditioner="direct",
            device_meshing=True,
            tol=1e-6,
            chunk_size=16,
        )
        ex = Executor(config)
        if devices_limit == 1:
            ex._devices = ex._devices[:1]
        grids = ex.prepare_batches(
            tasks, m.formation_model, m.borehole_model[:, :2], mud, 50.0, 0.0, 0.999
        )
        return ex.run(tasks, grids, len(depths), 1)

    res_sharded = run(8)
    res_single = run(1)
    assert np.all(np.isfinite(res_sharded))
    assert np.allclose(res_sharded, res_single, rtol=1e-4)
    assert np.allclose(res_sharded[:, 0], rho, rtol=0.03)
