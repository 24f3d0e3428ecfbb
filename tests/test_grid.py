# -*- coding: utf-8 -*-
"""Grid builder tests: snapping, conformity, blending, sigma sampling, carve-out."""

import numpy as np
import pytest

from remo3d_jax.meshing.carve import carve_local_model
from remo3d_jax.meshing.grid2d import GridSpec2D, _snap, build_grid2d

SPEC = GridSpec2D(nz=201, nr=49, n_wall_cells=6, n_blend_cells=3)


def simple_model(mud=1.1, dip=0.0):
    formation = np.array(
        [
            [-100.0, -1.0, np.nan, np.nan, 10.0],
            [-1.0, 1.0, 0.3, 4.0, 20.0],
            [1.0, 100.0, np.nan, np.nan, 8.0],
        ]
    )
    borehole = np.array([[-100.0, 0.12, mud], [100.0, 0.12, mud]])
    return carve_local_model(formation, borehole, mud, 0.0, 50.0, dip_rad=dip)


def test_snap_places_targets_exactly():
    lines = np.linspace(-1, 1, 21)
    targets = np.array([-0.333, 0.0011, 0.777])
    out = _snap(lines, targets)
    for t in targets:
        assert np.any(np.isclose(out, t, atol=1e-12))
    assert np.all(np.diff(out) > 0)
    assert out[0] == -1 and out[-1] == 1


def test_snap_dedupes_float_noise_targets():
    lines = np.linspace(-1, 1, 21)
    out = _snap(lines, np.array([0.1, 0.1 + 9e-17]))
    assert np.all(np.diff(out) > 1e-9)


def test_grid_electrode_and_boundary_conformity():
    lm = simple_model()
    electrodes = np.array([-2.5, -2.0, 0.0, 0.4])
    grid = build_grid2d(SPEC, 50.0, lm, electrodes, np.array([0.0]))
    for e in electrodes:
        i = grid.axis_node_index(e)
        assert np.isclose(grid.z_axis[i], e)
    # Layer boundaries (-1, 1) are grid lines too.
    for b in (-1.0, 1.0):
        assert np.any(np.isclose(grid.z_axis, b))
    assert np.all(np.diff(grid.z_axis) > 0)


def test_grid_boundary_is_exact_circle():
    lm = simple_model()
    grid = build_grid2d(SPEC, 50.0, lm, np.array([0.0]), np.array([0.0]))
    z, r = grid.coords[..., 0], grid.coords[..., 1]
    border = np.zeros_like(z, bool)
    border[0] = border[-1] = True
    border[:, -1] = True
    rad = np.sqrt(z[border] ** 2 + r[border] ** 2)
    assert np.allclose(rad, 50.0, rtol=1e-9)
    # Dirichlet mask == logical border.
    assert np.array_equal(~grid.free_mask, border)


def test_grid_axis_unmoved_and_near_field_rectangular():
    lm = simple_model()
    grid = build_grid2d(SPEC, 50.0, lm, np.array([0.0]), np.array([0.0]))
    assert np.allclose(grid.coords[:, 0, 1], 0.0)  # axis at r=0
    # Inside the protected core (|z|,r < 0.35*50) z does not vary radially.
    core = np.abs(grid.coords[:, 0, 0]) < 10.0
    z_core = grid.coords[core, :, 0]
    r_core = grid.coords[core, :, 1]
    inner = r_core < 10.0
    assert np.allclose(
        np.where(inner, z_core - z_core[:, :1], 0.0), 0.0, atol=1e-9
    )


def test_sigma_sampling_regions():
    lm = simple_model()
    grid = build_grid2d(SPEC, 50.0, lm, np.array([0.0]), np.array([0.0]))
    zc = 0.25 * (
        grid.coords[:-1, :-1, 0]
        + grid.coords[1:, :-1, 0]
        + grid.coords[:-1, 1:, 0]
        + grid.coords[1:, 1:, 0]
    )
    rc = 0.25 * (
        grid.coords[:-1, :-1, 1]
        + grid.coords[1:, :-1, 1]
        + grid.coords[:-1, 1:, 1]
        + grid.coords[1:, 1:, 1]
    )
    # Borehole column is mud.
    assert np.allclose(grid.sigma_cells[:, : SPEC.n_wall_cells], 1 / 1.1)
    # A cell well inside the invasion zone of the middle layer: z ~ 0, r ~ 0.2.
    mask_fz = (np.abs(zc) < 0.8) & (rc > 0.14) & (rc < 0.28)
    assert np.allclose(grid.sigma_cells[mask_fz], 1 / 4.0)
    # Undisturbed middle layer: r > 0.3.
    mask_uz = (np.abs(zc) < 0.8) & (rc > 0.35) & (rc < 5.0)
    assert np.allclose(grid.sigma_cells[mask_uz], 1 / 20.0)
    # Outer layers.
    mask_top = (zc < -1.2) & (zc > -5.0) & (rc > 0.2)
    assert np.allclose(grid.sigma_cells[mask_top], 1 / 10.0)


def test_invasion_radius_is_a_radial_station():
    lm = simple_model()
    grid = build_grid2d(SPEC, 50.0, lm, np.array([0.0]), np.array([0.0]))
    # Some radial station equals 0.3 for all z in the core (vertical line).
    r_mid = grid.coords[100, :, 1]  # z ~ 0 line
    assert np.any(np.isclose(r_mid, 0.3, atol=1e-9))


def test_carve_promotes_far_invasion_zone():
    formation = np.array(
        [
            [-100.0, 49.4, np.nan, np.nan, 10.0],
            # Layer grazes the domain edge; its invasion boundary (corners at
            # r=3.5, z=49.4/49.9) lies outside the active window -> the in-domain
            # sliver is fully invaded.
            [49.4, 49.9, 3.5, 4.0, 20.0],
            [49.9, 100.0, np.nan, np.nan, 8.0],
        ]
    )
    borehole = np.array([[-100.0, 0.12, 1.0], [100.0, 0.12, 1.0]])
    lm = carve_local_model(formation, borehole, 1.0, 0.0, 50.0, active_geometry_window=0.99)
    # Middle layer kept but fully invaded: single resistivity = FZ value.
    i = np.argmin(np.abs(lm.tops - 49.4))
    assert np.isnan(lm.fz_radius[i])
    assert np.isclose(lm.sigma_uz[i], 1 / 4.0)


def test_carve_drops_layers_outside_window():
    formation = np.array(
        [
            [-100.0, -60.0, np.nan, np.nan, 5.0],
            [-60.0, 60.0, np.nan, np.nan, 10.0],
            [60.0, 100.0, np.nan, np.nan, 7.0],
        ]
    )
    borehole = np.array([[-100.0, 0.12, 1.0], [100.0, 0.12, 1.0]])
    lm = carve_local_model(formation, borehole, 1.0, 0.0, 50.0)
    assert lm.tops.shape[0] == 1  # only the spanning layer remains
    assert np.isclose(lm.sigma_uz[0], 1 / 10.0)


def test_native_grid_builder_matches_python():
    from remo3d_jax.meshing.native import build_grid2d_native, native_available

    if not native_available():
        pytest.skip("native toolchain unavailable")
    lm = simple_model()
    electrodes = np.array([-2.5, -2.0, 0.0, 0.4])
    sources = np.array([-0.1, 0.0, 0.1])
    g_py = build_grid2d(SPEC, 50.0, lm, electrodes, sources)
    g_c = build_grid2d_native(SPEC, 50.0, lm, electrodes, sources)
    assert np.allclose(g_py.z_axis, g_c.z_axis, atol=1e-10)
    assert np.allclose(g_py.coords, g_c.coords, atol=1e-10)
    assert np.array_equal(g_py.sigma_cells, g_c.sigma_cells)
    assert np.array_equal(g_py.free_mask, g_c.free_mask)


def test_native_grid3d_builder_matches_python():
    from remo3d_jax.meshing.grid3d import GridSpec3D, build_grid3d
    from remo3d_jax.meshing.native import build_grid3d_native, native_available

    if not native_available():
        pytest.skip("native toolchain unavailable")
    dip = np.deg2rad(30.0)
    lm = simple_model(dip=dip)
    electrodes = np.array([-2.5, -2.0, 0.0, 0.4])
    sources = np.array([-0.1, 0.0, 0.1])
    spec = GridSpec3D(nz=97, np_=9, nr=33, n_wall_cells=4, n_blend_cells=2)
    for blend in ("arithmetic", "centroid", "harmonic", "mixed"):
        sp = GridSpec3D(
            nz=spec.nz, np_=spec.np_, nr=spec.nr,
            n_wall_cells=spec.n_wall_cells, n_blend_cells=spec.n_blend_cells,
            sigma_blend=blend,
        )
        g_py = build_grid3d(sp, 50.0, lm, dip, electrodes, sources)
        g_c = build_grid3d_native(sp, 50.0, lm, dip, electrodes, sources)
        assert np.allclose(g_py.z_axis, g_c.z_axis, atol=1e-10), blend
        assert np.allclose(g_py.coords, g_c.coords, atol=1e-10), blend
        assert np.allclose(
            g_py.sigma_cells, g_c.sigma_cells, rtol=1e-9, atol=0
        ), blend
        assert np.array_equal(g_py.free_mask, g_c.free_mask), blend


def test_device_mesh_matches_host_build():
    """The on-device grid builder (meshing/device_mesh.py) must reproduce the
    host build's coordinates and conductivities from the 1D profiles (float32
    noise only) — the device-meshing staging path's correctness anchor."""
    import jax
    import jax.numpy as jnp

    from .conftest import input_path
    from remo3d_jax import Model
    from remo3d_jax.meshing.carve import carve_local_model
    from remo3d_jax.meshing.device_mesh import device_mesh_2d
    from remo3d_jax.meshing.grid2d import (
        GridSpec2D,
        build_grid2d,
        build_grid2d_light,
    )
    from remo3d_jax.planner import plan_tasks

    m = Model(["A2.0M0.5N", "B5.7A0.4M"])
    m.set_model_parameters(
        input_path("Example_01", "Formation.txt"),
        input_path("Example_01", "Borehole.txt"),
    )
    depths = np.arange(5.0, 5.4, 0.1)
    sim_depths, tasks = plan_tasks(m.tools, m.sec, depths, 5)
    mud = np.interp(sim_depths, m.borehole_model[:, 0], m.borehole_model[:, 2])
    spec = GridSpec2D(nz=193, nr=41, n_wall_cells=6, n_blend_cells=3)
    R = 50.0

    grids, lights = [], []
    for t in tasks[:2]:
        lm = carve_local_model(
            m.formation_model, m.borehole_model[:, :2],
            float(mud[t.batch_index]), t.center_depth, R,
            dip_rad=0.0, active_geometry_window=0.999,
        )
        sources = np.unique(np.concatenate([s.source_positions for s in t.solves]))
        grids.append(build_grid2d(spec, R, lm, t.electrode_positions, sources))
        lights.append(build_grid2d_light(spec, R, lm, t.electrode_positions, sources))

    Lmax = max(g.bottoms.size for g in lights)
    B = len(lights)
    f32 = np.float32
    z = np.stack([g.z_axis for g in lights]).astype(f32)
    wall = np.stack([g.wall_of_z for g in lights]).astype(f32)
    far = np.stack([g.far for g in lights]).astype(f32)
    rdet = np.array([g.r_detach for g in lights], dtype=f32)
    bot = np.full((B, Lmax), np.inf, dtype=f32)
    fzr = np.full((B, Lmax), np.nan, dtype=f32)
    sfz = np.full((B, Lmax), np.nan, dtype=f32)
    suz = np.ones((B, Lmax), dtype=f32)
    nlay = np.zeros((B,), dtype=np.int32)
    mud_s = np.array([g.mud_sigma for g in lights], dtype=f32)
    for i, g in enumerate(lights):
        L = g.bottoms.size
        bot[i, :L] = g.bottoms
        fzr[i, :L] = g.fz_radius
        sfz[i, :L] = g.sigma_fz
        suz[i, :L] = g.sigma_uz
        nlay[i] = L

    with jax.default_device(jax.devices("cpu")[0]):
        coords, sigma, free = device_mesh_2d(
            jnp.asarray(z), jnp.asarray(wall), jnp.asarray(far),
            jnp.asarray(rdet), jnp.asarray(bot), jnp.asarray(fzr),
            jnp.asarray(sfz), jnp.asarray(suz), jnp.asarray(nlay),
            jnp.asarray(mud_s), np.float32(R),
            nz=spec.nz, nr=spec.nr, n_wall_cells=spec.n_wall_cells,
            n_blend_cells=spec.n_blend_cells, blend_m0=spec.blend_m0,
        )
    for i, g in enumerate(grids):
        np.testing.assert_allclose(
            np.asarray(coords[i]), g.coords.astype(f32), rtol=0, atol=2e-5 * R
        )
        # Conductivities are piecewise constant: identical except possibly at
        # cells whose centroid sits within float noise of a layer boundary.
        mismatch = np.asarray(sigma[i]) != g.sigma_cells.astype(f32)
        assert mismatch.mean() < 1e-3, mismatch.sum()
        np.testing.assert_array_equal(np.asarray(free[i]), g.free_mask)
