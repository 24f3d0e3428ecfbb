# -*- coding: utf-8 -*-
"""Differentiable forward modeling (remo3d_jax/diff.py).

The reference stack (gmsh/netgen/NGSolve behind MPI) is not differentiable at
all — inversion users there pay one full log re-simulation per parameter for
finite-difference Jacobians. Here the log is a pure JAX function of the layer
resistivities; these tests pin (a) value parity with Model.simulate_logs,
(b) forward-mode / reverse-mode consistency, (c) finite-difference agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from remo3d_jax import DifferentiableLog, Model
from remo3d_jax.meshing.grid2d import GridSpec2D

from .conftest import input_path

SMALL_2D = GridSpec2D(nz=193, nr=41, n_wall_cells=6, n_blend_cells=3)
TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]
DEPTHS = np.array([2.0, 2.5, 3.0])


@pytest.fixture(scope="module")
def dlog_and_model():
    m = Model(TOOLS)
    m.set_model_parameters(
        input_path("Example_01", "Formation.txt"),
        input_path("Example_01", "Borehole.txt"),
    )
    m.initialize_workers()
    m.simulate_logs(
        DEPTHS, platform="cpu", verbose=False, grid_spec=SMALL_2D,
        executor_overrides={
            "preconditioner": "direct", "chunk_size": 8,
            "use_native_mesher": False,
        },
    )
    ref = np.stack([m.logs[t][:, 1] for t in TOOLS], axis=1)
    with jax.default_device(jax.devices("cpu")[0]):
        dlog = DifferentiableLog(m, DEPTHS, grid_spec=SMALL_2D, chunk_size=8)
    return dlog, ref


def test_forward_matches_model(dlog_and_model):
    """dlog(params0) must reproduce Model.simulate_logs on the same grid spec
    (same numpy mesher, same direct-preconditioner solve)."""
    dlog, ref = dlog_and_model
    with jax.default_device(jax.devices("cpu")[0]):
        out = np.asarray(dlog.forward(dlog.params0))
    assert np.isfinite(out).all()
    assert np.nanmax(np.abs(out / ref - 1)) < 5e-4


def test_jacobian_forward_reverse_consistency(dlog_and_model):
    """jacfwd (P tangent solves) and jacrev (adjoint solves) take entirely
    different paths through lax.custom_linear_solve — they must agree."""
    dlog, _ = dlog_and_model
    p0 = jnp.asarray(dlog.params0)
    with jax.default_device(jax.devices("cpu")[0]):
        J_fwd = np.asarray(dlog.jacobian(p0))
        # reverse mode on a scalar projection: g = d(sum w*logs)/dp = w^T J.
        rng = np.random.default_rng(3)
        w = jnp.asarray(rng.standard_normal(J_fwd.shape[:2]).astype(np.float32))

        def proj(p):
            out = dlog(p)
            return jnp.sum(jnp.where(jnp.isnan(out), 0.0, out * w))

        g_rev = np.asarray(jax.grad(proj)(p0))
    g_fwd = np.einsum("mtp,mt->p", np.nan_to_num(J_fwd), np.asarray(w))
    scale = np.abs(g_fwd).max()
    assert scale > 0
    np.testing.assert_allclose(g_rev, g_fwd, atol=2e-3 * scale, rtol=2e-3)


def test_jacobian_finite_difference(dlog_and_model):
    """Central finite differences on the two most sensitive parameters."""
    dlog, _ = dlog_and_model
    p0 = np.asarray(dlog.params0, dtype=np.float64)
    with jax.default_device(jax.devices("cpu")[0]):
        J = np.nan_to_num(np.asarray(dlog.jacobian(dlog.params0)))
        sens = np.abs(J).sum(axis=(0, 1))
        for k in np.argsort(sens)[-2:]:
            h = 0.02 * p0[k]
            pp, pm = p0.copy(), p0.copy()
            pp[k] += h
            pm[k] -= h
            fd = (
                np.nan_to_num(np.asarray(dlog.forward(pp)))
                - np.nan_to_num(np.asarray(dlog.forward(pm)))
            ) / (2 * h)
            ad = J[:, :, k]
            scale = np.abs(fd).max()
            assert scale > 0
            np.testing.assert_allclose(ad, fd, atol=0.05 * scale, rtol=0.05)


FORMATION_3D = np.array(
    [
        [-1000.0, 1.0, np.nan, np.nan, 10.0],
        [1.0, 2.2, 0.4, 5.0, 100.0],
        [2.2, 1000.0, np.nan, np.nan, 10.0],
    ]
)
BOREHOLE_3D = np.array([[-1000.0, 0.1, 1.0], [1000.0, 0.1, 1.0]])
DEPTHS_3D = np.array([1.2, 1.6, 2.0])


def _spec3d(**kw):
    from remo3d_jax.meshing.grid3d import GridSpec3D

    return GridSpec3D(nz=33, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2, **kw)


@pytest.fixture(scope="module")
def dlog3d_and_model():
    """Tiny dipping model (dip=30, one invaded bed, 4 parameters)."""
    m = Model(["A0.4M0.1N"])
    m.set_model_parameters(
        FORMATION_3D, BOREHOLE_3D, borehole_geometry_type="radius", dip=30
    )
    m.initialize_workers()
    m.simulate_logs(
        DEPTHS_3D, domain_radius=10.0, platform="cpu", verbose=False,
        grid_spec3d=_spec3d(),
        executor_overrides={"precond3d": "direct", "use_native_mesher": False},
    )
    ref = m.logs["A0.4M0.1N"][:, 1]
    with jax.default_device(jax.devices("cpu")[0]):
        dlog = DifferentiableLog(
            m, DEPTHS_3D, grid_spec3d=_spec3d(), domain_radius=10.0, chunk_size=4
        )
    return dlog, ref


def test_forward_matches_model_3d(dlog3d_and_model):
    """The 3D dipping path must reproduce Model.simulate_logs on the same
    grid spec (same hex assembly, pole-tied direct-preconditioner solve,
    0.5 half-space readout). Measured 6e-6."""
    dlog, ref = dlog3d_and_model
    with jax.default_device(jax.devices("cpu")[0]):
        out = np.asarray(dlog.forward(dlog.params0))[:, 0]
    assert np.isfinite(out).all()
    assert np.max(np.abs(out / ref - 1)) < 1e-4


def test_jacobian_finite_difference_3d(dlog3d_and_model):
    """AD through the 3D solve (incl. the arithmetic sub-cell sigma weights)
    vs central finite differences on the shoulder-UZ and FZ parameters.
    Measured <=4.4e-4."""
    dlog, _ = dlog3d_and_model
    p0 = np.asarray(dlog.params0, dtype=np.float64)
    with jax.default_device(jax.devices("cpu")[0]):
        J = np.asarray(dlog.jacobian(dlog.params0))
        for k in (0, 3):  # UZ[0] (shoulders), FZ[1] (invaded bed)
            h = 0.02 * p0[k]
            pp, pm = p0.copy(), p0.copy()
            pp[k] += h
            pm[k] -= h
            fd = (
                np.asarray(dlog.forward(pp)) - np.asarray(dlog.forward(pm))
            )[:, 0] / (2 * h)
            scale = np.abs(fd).max()
            assert scale > 0
            np.testing.assert_allclose(J[:, 0, k], fd, atol=0.01 * scale, rtol=0.01)


def test_rejects_nonlinear_sigma_blend():
    """The harmonic/mixed sub-cell blends are nonlinear in sigma — the
    differentiable path must reject them instead of silently mistracing."""
    m = Model(["A0.4M0.1N"])
    m.set_model_parameters(
        FORMATION_3D, BOREHOLE_3D, borehole_geometry_type="radius", dip=30
    )
    with pytest.raises(ValueError, match="arithmetic"):
        DifferentiableLog(
            m, DEPTHS_3D, grid_spec3d=_spec3d(sigma_blend="mixed"),
            domain_radius=10.0,
        )
