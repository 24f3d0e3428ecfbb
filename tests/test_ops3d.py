# -*- coding: utf-8 -*-
"""3D numerics tests on tiny grids (CPU): assembly, pole tying, line solves,
and the production ADI line-preconditioned CG."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from remo3d_jax.meshing.carve import carve_local_model
from remo3d_jax.meshing.grid3d import GridSpec3D, build_grid3d
from remo3d_jax.ops.assembly3d import assemble_stencil_3d, element_matrices_3d
from remo3d_jax.ops.lines3d import line_solve_r3
from remo3d_jax.ops.stencil3d import pole_project, stencil3d_apply

cpu = jax.devices("cpu")[0]

SPEC = GridSpec3D(nz=33, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2)


def tiny_model(dip_rad=0.3):
    formation = np.array(
        [
            [-100.0, -1.0, np.nan, np.nan, 10.0],
            [-1.0, 1.0, np.nan, np.nan, 100.0],
            [1.0, 100.0, np.nan, np.nan, 10.0],
        ]
    )
    borehole = np.array([[-100.0, 0.1, 1.0], [100.0, 0.1, 1.0]])
    return carve_local_model(formation, borehole, 1.0, 0.0, 50.0, dip_rad=dip_rad)


def tiny_grid(dip_rad=0.3):
    lm = tiny_model(dip_rad)
    return build_grid3d(
        SPEC, 50.0, lm, dip_rad, np.array([-2.0, 0.0, 2.0]), np.array([0.0])
    )


def test_grid3d_geometry():
    g = tiny_grid()
    # Boundary nodes on the exact sphere.
    c = g.coords
    border = np.zeros(c.shape[:-1], bool)
    border[0] = border[-1] = True
    border[:, :, -1] = True
    rad = np.linalg.norm(c[border], axis=-1)
    assert np.allclose(rad, 50.0, rtol=1e-9)
    # Axis nodes (k=0) carry rho=0 and the unsheared z lines.
    assert np.allclose(c[:, :, 0, 0], 0.0) and np.allclose(c[:, :, 0, 1], 0.0)
    assert np.allclose(c[:, 0, 0, 2], g.z_axis)
    # Symmetry plane: phi=0 and phi=pi nodes have y == 0.
    assert np.allclose(c[:, 0, :, 1], 0.0, atol=1e-12)
    assert np.allclose(np.abs(c[:, -1, :, 1]), 0.0, atol=1e-9)
    # Free mask: Dirichlet only on axial ends + outer station.
    assert not g.free_mask[0].any() and not g.free_mask[-1].any()
    assert not g.free_mask[:, :, -1].any()
    assert g.free_mask[1:-1, :, :-1].all()


def test_grid3d_azimuth_is_uniform_index_phi():
    # Precondition of the cylindrical assembly metric (ops/assembly3d.py:
    # _cylindrical_axes): phi is reconstructed from the array index as a
    # uniform [0, pi] linspace. Verify off-pole atan2(y, x) agrees for the
    # grid3d convention, so index-phi == geometric-phi on production grids.
    g = tiny_grid()
    c = g.coords
    np_axis = c.shape[1]
    phi_idx = np.linspace(0.0, np.pi, np_axis)
    off_pole = np.hypot(c[..., 0], c[..., 1]) > 1e-9
    phi_geo = np.arctan2(c[..., 1], c[..., 0])
    # atan2 returns values in [0, pi] for y >= 0 (the meshed half-space).
    diff = np.abs(phi_geo - phi_idx[None, :, None])[off_pole]
    assert diff.max() < 1e-9


def test_grid3d_sigma_respects_dip():
    dip = 0.3
    g = tiny_grid(dip)
    a = np.tan(dip)
    c = g.coords
    # Cells are classified by their FULL zeta = z - tan(dip)*x extent: with the
    # sub-cell homogenization default, only cells wholly inside one layer carry
    # that layer's exact conductivity (cut cells are blended by design).
    corner_zeta = c[..., 2] - a * c[..., 0]
    corners = [
        corner_zeta[i : i + SPEC.nz - 1, j : j + SPEC.np_ - 1, k : k + SPEC.nr - 1]
        for i in (0, 1)
        for j in (0, 1)
        for k in (0, 1)
    ]
    zeta_lo = np.minimum.reduce(corners)
    zeta_hi = np.maximum.reduce(corners)
    formation_cells = np.ones(g.sigma_cells.shape, bool)
    formation_cells[:, :, : SPEC.n_wall_cells] = False
    mid = formation_cells & (zeta_lo > -0.95) & (zeta_hi < 0.95)
    outer = formation_cells & (
        ((zeta_lo > 1.05) & (zeta_hi < 20)) | ((zeta_hi < -1.05) & (zeta_lo > -20))
    )
    assert np.allclose(g.sigma_cells[mid], 1 / 100.0)
    assert np.allclose(g.sigma_cells[outer], 1 / 10.0)
    # Cut cells lie strictly between the pure-layer conductivities.
    cut = formation_cells & (zeta_lo < 1.0) & (zeta_hi > 1.0)
    assert cut.any()
    assert np.all(g.sigma_cells[cut] > 1 / 100.0 - 1e-12)
    assert np.all(g.sigma_cells[cut] < 1 / 10.0 + 1e-12)
    # Borehole column is mud.
    assert np.allclose(g.sigma_cells[:, :, : SPEC.n_wall_cells], 1.0)


def test_element_matrices_3d_rows_sum_zero():
    with jax.default_device(cpu):
        g = tiny_grid()
        K = element_matrices_3d(
            jnp.asarray(g.coords, jnp.float32), jnp.ones(tuple(s - 1 for s in g.free_mask.shape))
        )
        Ksum = sum(K[a][b] for a in range(8) for b in range(8))
        scale = float(jnp.max(jnp.abs(K[0][0])))
        assert float(jnp.max(jnp.abs(Ksum))) < 1e-5 * scale


def test_stencil3d_symmetric_via_dot():
    with jax.default_device(cpu):
        rng = np.random.default_rng(0)
        g = tiny_grid()
        C = assemble_stencil_3d(
            jnp.asarray(g.coords, jnp.float32),
            jnp.asarray(g.sigma_cells, jnp.float32),
            jnp.asarray(g.free_mask),
        )
        x = jnp.asarray(rng.standard_normal(g.free_mask.shape), jnp.float32)
        y = jnp.asarray(rng.standard_normal(g.free_mask.shape), jnp.float32)
        lhs = float(jnp.sum(y * stencil3d_apply(C, x)))
        rhs = float(jnp.sum(x * stencil3d_apply(C, y)))
        assert abs(lhs - rhs) < 2e-3 * (abs(lhs) + 1)


def test_pole_project_is_projection():
    with jax.default_device(cpu):
        rng = np.random.default_rng(1)
        u = jnp.asarray(rng.standard_normal((7, 5, 4)), jnp.float32)
        p1 = pole_project(u)
        p2 = pole_project(p1)
        assert np.allclose(np.asarray(p1), np.asarray(p2))
        # Off-pole values untouched.
        assert np.allclose(np.asarray(p1[..., 1:]), np.asarray(u[..., 1:]))


def test_line_solve_r3_matches_tridiagonal():
    with jax.default_device(cpu):
        rng = np.random.default_rng(2)
        g = tiny_grid()
        C = assemble_stencil_3d(
            jnp.asarray(g.coords, jnp.float32),
            jnp.asarray(g.sigma_cells, jnp.float32),
            jnp.asarray(g.free_mask),
        )
        b = jnp.asarray(rng.standard_normal(g.free_mask.shape), jnp.float32)
        x = np.asarray(line_solve_r3(C, b))
        Cn = np.asarray(C)
        from remo3d_jax.ops.stencil3d import entry_index

        i, j = 10, 2
        T = (
            np.diag(Cn[i, j, :, entry_index(0, 0, 0)])
            + np.diag(Cn[i, j, 1:, entry_index(0, 0, -1)], -1)
            + np.diag(Cn[i, j, :-1, entry_index(0, 0, 1)], 1)
        )
        assert np.allclose(T @ x[i, j], np.asarray(b)[i, j], atol=2e-4 * np.abs(T).max())


def test_line_pcg3_solves_and_ties_pole():
    """The PRODUCTION 3D solve path (ADI line-preconditioned CG, the same
    _solve_chunk_3d stage the executor dispatches) on a tiny grid: converges,
    ties the pole, and decays away from the source."""
    from remo3d_jax.parallel.runtime import _pcg3

    with jax.default_device(cpu):
        g = tiny_grid()
        C = assemble_stencil_3d(
            jnp.asarray(g.coords[None], jnp.float32),
            jnp.asarray(g.sigma_cells[None], jnp.float32),
            jnp.asarray(g.free_mask[None]),
        )
        i_src = g.axis_node_index(0.0)
        b = jnp.zeros((1, 1) + g.free_mask.shape, jnp.float32)
        b = b.at[0, 0, i_src, :, 0].set(1.0 / SPEC.np_)
        u_axis_offset = jnp.zeros((1, 1, SPEC.nz), jnp.float32)
        u_axis, rel, iters = _pcg3(
            C, b, u_axis_offset, tol=1e-6, maxiter=400, precond="adi"
        )
        assert float(rel[0, 0]) < 1e-5
        ua = np.asarray(u_axis)[0, 0]
        # Potential decays away from the source along the axis.
        assert ua[i_src] > ua[i_src + 5] > ua[-2] >= 0


@pytest.mark.parametrize("solve_axis", [False, True])
def test_half_plane_apply_matches_27_plane_apply(solve_axis):
    """The CG operator (ops/stencil3d.stencil3d_apply_half, 14 planes of the
    symmetric half) equals the plain 27-plane apply on an assembled operator,
    with and without the solve axis."""
    from remo3d_jax.ops.stencil3d import half_planes, stencil3d_apply_half

    with jax.default_device(cpu):
        g = tiny_grid()
        C = assemble_stencil_3d(
            jnp.asarray(g.coords[None], jnp.float32),
            jnp.asarray(g.sigma_cells[None], jnp.float32),
            jnp.asarray(g.free_mask[None]),
        )
        shape = (1, 3) + g.free_mask.shape if solve_axis else (1,) + g.free_mask.shape
        u = jnp.asarray(np.random.default_rng(5).standard_normal(shape), jnp.float32)
        y_full = np.asarray(stencil3d_apply(C, u))
        y_half = np.asarray(stencil3d_apply_half(half_planes(C), u))
    assert y_half.shape == y_full.shape
    np.testing.assert_allclose(y_half, y_full, rtol=0, atol=2e-6 * np.abs(y_full).max())


def test_pcg3_operator_choice():
    """_pcg3's "half" and "full" operators give the same solve; an unknown
    name is refused."""
    from remo3d_jax.parallel.runtime import _pcg3

    with jax.default_device(cpu):
        g = tiny_grid()
        C = assemble_stencil_3d(
            jnp.asarray(g.coords[None], jnp.float32),
            jnp.asarray(g.sigma_cells[None], jnp.float32),
            jnp.asarray(g.free_mask[None]),
        )
        b = jnp.zeros((1, 1) + g.free_mask.shape, jnp.float32)
        b = b.at[0, 0, g.axis_node_index(0.0), :, 0].set(1.0 / SPEC.np_)
        off = jnp.zeros((1, 1, SPEC.nz), jnp.float32)
        out = {
            op: _pcg3(C, b, off, tol=1e-6, maxiter=400, precond="adi", operator=op)
            for op in ("full", "half")
        }
        with pytest.raises(ValueError, match="unknown 3D operator"):
            _pcg3(C, b, off, tol=1e-6, maxiter=400, precond="adi", operator="quarter")
    ua_full, ua_half = (np.asarray(out[op][0]) for op in ("full", "half"))
    np.testing.assert_allclose(ua_half, ua_full, rtol=1e-4)
    assert abs(int(out["half"][2]) - int(out["full"][2])) <= 2


def test_cylindrical_metric_matches_2d_axisymmetric_assembly():
    """The cylindrical 3D metric (the production default, ExecutorConfig.metric3d)
    vs the independently-validated 2D axisymmetric assembly.

    On a grid that is exactly a revolution of a rectilinear meridian grid, with
    axisymmetric sigma and a phi-independent field u, testing against the
    phi-independent function v(z, r) (= the phi-sum of the nodal bases at fixed
    (z, r)) kills every u_phi term EXACTLY, and both quadratures are exact for
    the remaining separable polynomial integrand (affine meridian map: degree
    <= 3 per direction under 2-point Gauss). Hence

        sum_phi (A3 u)[z, phi, r]  ==  0.5 * (A2 u)[z, r]

    to float32 roundoff — phi spans [0, pi], half of the 2D weak form's 2*pi*r
    circle (ngsolve_functions.py:33-36 weak-form parity; the 0.5 is the same
    half-space convention as the 3D readout factor, worker.py:124-131).
    """
    from remo3d_jax.ops.assembly2d import element_matrices_2d, fold_to_stencil
    from remo3d_jax.ops.assembly3d import element_matrices_3d, fold_to_stencil_3d
    from remo3d_jax.ops.stencil import stencil_apply

    rng = np.random.default_rng(7)
    nz, np_, nr = 7, 5, 6
    z_1d = np.cumsum(np.concatenate([[0.0], rng.uniform(0.2, 0.7, nz - 1)]))
    r_1d = 0.15 + np.cumsum(np.concatenate([[0.0], rng.uniform(0.1, 0.5, nr - 1)]))
    phi = np.linspace(0.0, np.pi, np_)

    coords2d = np.zeros((nz, nr, 2), np.float32)
    coords2d[..., 0] = z_1d[:, None]
    coords2d[..., 1] = r_1d[None, :]

    coords3d = np.zeros((nz, np_, nr, 3), np.float32)
    coords3d[..., 0] = r_1d[None, None, :] * np.cos(phi)[None, :, None]
    coords3d[..., 1] = r_1d[None, None, :] * np.sin(phi)[None, :, None]
    coords3d[..., 2] = z_1d[:, None, None]

    sigma2d = rng.uniform(0.05, 2.0, (nz - 1, nr - 1)).astype(np.float32)
    sigma3d = np.broadcast_to(sigma2d[:, None, :], (nz - 1, np_ - 1, nr - 1))

    u2 = rng.standard_normal((nz, nr)).astype(np.float32)
    u3 = np.broadcast_to(u2[:, None, :], (nz, np_, nr))

    with jax.default_device(cpu):
        C2 = fold_to_stencil(
            element_matrices_2d(jnp.asarray(coords2d), jnp.asarray(sigma2d)), nz, nr
        )
        y2 = np.asarray(stencil_apply(C2, jnp.asarray(u2)))
        C3 = fold_to_stencil_3d(
            element_matrices_3d(
                jnp.asarray(coords3d), jnp.asarray(sigma3d), metric="cylindrical"
            ),
            nz, np_, nr,
        )
        y3 = np.asarray(stencil3d_apply(C3, jnp.asarray(u3)))

    scale = np.abs(y2).max()
    assert np.allclose(y3.sum(axis=1), 0.5 * y2, atol=2e-5 * scale), (
        np.abs(y3.sum(axis=1) - 0.5 * y2).max() / scale
    )
