# -*- coding: utf-8 -*-
"""Block-tridiagonal direct factorization (ops/block_direct.py).

The float32-stored factorization must be an (essentially) exact inverse of the
9-point operator; the float32 storage must be an SPD
preconditioner that takes PCG to tolerance in a handful of iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np

from remo3d_jax.ops.block_direct import block_thomas_apply, block_thomas_factor
from remo3d_jax.ops.cg import pcg
from remo3d_jax.ops.stencil import stencil_apply

from ._stencils import _random_symmetric_stencil_2d


def _spd_stencil(rng, B, NZ, NR, boost=8.0):
    C = _random_symmetric_stencil_2d(rng, B, NZ, NR)
    C[..., 1, 1] += boost  # diagonal dominance -> SPD
    return jnp.asarray(C)


def test_block_thomas_is_exact_inverse_f32():
    rng = np.random.default_rng(5)
    B, S, NZ, NR = 2, 3, 12, 7
    with jax.default_device(jax.devices("cpu")[0]):
        C = _spd_stencil(rng, B, NZ, NR)
        b = jnp.asarray(rng.standard_normal((B, S, NZ, NR)).astype(np.float32))
        G = block_thomas_factor(C, store_dtype=jnp.float32)
        x = block_thomas_apply(G, C, b)
        r = np.asarray(stencil_apply(C, x) - b)
        assert np.abs(r).max() <= 2e-5 * np.abs(np.asarray(b)).max()


def test_block_thomas_rank3_rhs():
    """No solve axis (the shape the power-iteration/test callers use)."""
    rng = np.random.default_rng(6)
    B, NZ, NR = 2, 9, 6
    with jax.default_device(jax.devices("cpu")[0]):
        C = _spd_stencil(rng, B, NZ, NR)
        b = jnp.asarray(rng.standard_normal((B, NZ, NR)).astype(np.float32))
        G = block_thomas_factor(C, store_dtype=jnp.float32)
        x = block_thomas_apply(G, C, b)
        r = np.asarray(stencil_apply(C, x) - b)
        assert np.abs(r).max() <= 2e-5 * np.abs(np.asarray(b)).max()


def test_block_thomas_pcg_preconditioner():
    """Default (float32) stored symmetrized blocks: SPD, PCG converges fast.
    (bfloat16 storage diverges on production-depth chains — the recurrences
    amplify per-entry storage error; see the module docstring.)"""
    rng = np.random.default_rng(7)
    B, S, NZ, NR = 2, 2, 12, 7
    with jax.default_device(jax.devices("cpu")[0]):
        C = _spd_stencil(rng, B, NZ, NR, boost=4.0)
        b = jnp.asarray(rng.standard_normal((B, S, NZ, NR)).astype(np.float32))
        G = block_thomas_factor(C)
        M_inv = lambda r: block_thomas_apply(G, C, r)
        u, info = pcg(C, b, M_inv=M_inv, tol=1e-7, maxiter=50)
        assert int(np.asarray(info["iterations"]).max()) <= 8
        assert float(np.asarray(info["rel_residual"]).max()) <= 1e-6


def test_block_thomas_padded_batch_identity():
    """All-zero (padded) batches factor to identity and stay NaN-free."""
    rng = np.random.default_rng(8)
    B, S, NZ, NR = 2, 2, 9, 6
    with jax.default_device(jax.devices("cpu")[0]):
        C = np.array(_spd_stencil(rng, B, NZ, NR))
        C[1] = 0.0  # padded batch
        C = jnp.asarray(C)
        b = np.zeros((B, S, NZ, NR), dtype=np.float32)
        b[0] = rng.standard_normal((S, NZ, NR))
        b = jnp.asarray(b)
        G = block_thomas_factor(C, store_dtype=jnp.float32)
        x = np.asarray(block_thomas_apply(G, C, b))
        assert np.isfinite(x).all()
        assert np.abs(x[1]).max() == 0.0


def test_schur_fixedpoint_converges_to_exact_factor():
    """The batched Jacobi fixed-point (ops/block_direct.py:
    schur_fixedpoint_factor) converges monotonically to the exact block-LDL^T
    Schur inverses; at passes >= NZ it IS the exact factorization, and at
    small pass counts it is already a valid SPD preconditioner (the
    Loewner-order argument in its docstring)."""
    from remo3d_jax.ops.block_direct import schur_fixedpoint_factor

    rng = np.random.default_rng(11)
    B, S, NZ, NR = 2, 3, 14, 7
    with jax.default_device(jax.devices("cpu")[0]):
        C = _spd_stencil(rng, B, NZ, NR, boost=4.0)
        b = jnp.asarray(rng.standard_normal((B, S, NZ, NR)).astype(np.float32))
        G_exact = block_thomas_factor(C)
        # passes >= NZ reproduces the exact factorization.
        G_full = schur_fixedpoint_factor(C, passes=NZ)
        assert np.abs(np.asarray(G_full - G_exact)).max() <= 1e-5
        # few passes: apply error decays geometrically; CG converges fast.
        prev_err = np.inf
        for p in (0, 2, 4):
            G = schur_fixedpoint_factor(C, passes=p)
            x = block_thomas_apply(G, C, b)
            err = float(np.abs(np.asarray(stencil_apply(C, x) - b)).max())
            assert err < prev_err or err <= 1e-5 * np.abs(np.asarray(b)).max()
            prev_err = err
            u, info = pcg(
                C, b, M_inv=lambda r: block_thomas_apply(G, C, r),
                tol=1e-7, maxiter=50,
            )
            assert int(np.asarray(info["iterations"]).max()) <= 10
            assert float(np.asarray(info["rel_residual"]).max()) <= 1e-6


def test_bcr_exact_inverse_and_pcg():
    """Block cyclic reduction (ops/block_bcr.py) must be an (f32-) exact
    inverse of the operator at every NZ parity, and take PCG to tolerance in
    a couple of iterations — log-depth equivalent of block_thomas."""
    from remo3d_jax.ops.block_bcr import bcr_apply, bcr_factor

    rng = np.random.default_rng(13)
    B, S, NR = 2, 3, 7
    with jax.default_device(jax.devices("cpu")[0]):
        for NZ in (12, 13, 31):
            C = _spd_stencil(rng, B, NZ, NR, boost=4.0)
            b = jnp.asarray(rng.standard_normal((B, S, NZ, NR)).astype(np.float32))
            F = bcr_factor(C)
            x = bcr_apply(F, b)
            r = np.asarray(stencil_apply(C, x) - b)
            assert np.abs(r).max() <= 2e-5 * np.abs(np.asarray(b)).max(), NZ
            u, info = pcg(C, b, M_inv=lambda rr: bcr_apply(F, rr), tol=1e-7, maxiter=50)
            assert int(np.asarray(info["iterations"]).max()) <= 4, NZ
            assert float(np.asarray(info["rel_residual"]).max()) <= 1e-6, NZ
        # rank-3 RHS (no solve axis) and padded-batch safety
        Cp = np.array(_spd_stencil(rng, B, 13, NR))
        Cp[1] = 0.0
        Cp = jnp.asarray(Cp)
        Fp = bcr_factor(Cp)
        b3 = np.zeros((B, 13, NR), dtype=np.float32)
        b3[0] = rng.standard_normal((13, NR))
        x3 = np.asarray(bcr_apply(Fp, jnp.asarray(b3)))
        assert np.isfinite(x3).all()
        assert np.abs(x3[1]).max() == 0.0


def test_bcr_3d_exact_inverse_and_pcg():
    """3D cyclic reduction (ops/block_bcr3d.py): banded level-0 elimination +
    dense recursion must be an exact inverse at both NZ parities."""
    from remo3d_jax.ops.block_bcr3d import bcr_apply_3d, bcr_factor_3d
    from remo3d_jax.ops.stencil3d import entry_index, stencil3d_apply

    from ._stencils import _random_symmetric_stencil

    rng = np.random.default_rng(14)
    B, S, NP, NR = 2, 2, 3, 4
    with jax.default_device(jax.devices("cpu")[0]):
        for NZ in (6, 7):
            C = np.array(_random_symmetric_stencil(rng, B, NZ, NP, NR))
            C[..., entry_index(0, 0, 0)] += 8.0
            C = jnp.asarray(C)
            b = jnp.asarray(
                rng.standard_normal((B, S, NZ, NP, NR)).astype(np.float32)
            )
            F = bcr_factor_3d(C, NP, NR, z_block=4)
            x = bcr_apply_3d(F, b, NP, NR)
            r = np.asarray(stencil3d_apply(C, x) - b)
            assert np.abs(r).max() <= 3e-5 * np.abs(np.asarray(b)).max(), NZ
            u, info = pcg(
                None, b, M_inv=lambda rr: bcr_apply_3d(F, rr, NP, NR),
                tol=1e-7, maxiter=50, n_grid_axes=3,
                matvec=lambda p: stencil3d_apply(C, p),
            )
            assert int(np.asarray(info["iterations"]).max()) <= 4, NZ
            assert float(np.asarray(info["rel_residual"]).max()) <= 1e-6, NZ


def test_schur_fixedpoint_3d_preconditioner():
    """3D analog (ops/block_direct3d.py:schur_fixedpoint_factor_3d), with a
    z_block that does NOT divide NZ (pad path) — few passes must already take
    PCG to tolerance in a handful of iterations."""
    from remo3d_jax.ops.block_direct3d import (
        block_thomas_apply_3d,
        schur_fixedpoint_factor_3d,
    )
    from remo3d_jax.ops.stencil3d import entry_index, stencil3d_apply

    from ._stencils import _random_symmetric_stencil

    rng = np.random.default_rng(12)
    B, S, NZ, NP, NR = 1, 2, 7, 3, 4
    with jax.default_device(jax.devices("cpu")[0]):
        C = np.array(_random_symmetric_stencil(rng, B, NZ, NP, NR))
        C[..., entry_index(0, 0, 0)] += 8.0
        C = jnp.asarray(C)
        b = jnp.asarray(rng.standard_normal((B, S, NZ, NP, NR)).astype(np.float32))
        G = schur_fixedpoint_factor_3d(C, NP, NR, passes=3, z_block=4)
        M_inv = lambda r: block_thomas_apply_3d(G, C, r, NP, NR)
        u, info = pcg(
            None, b, M_inv=M_inv, tol=1e-7, maxiter=50, n_grid_axes=3,
            matvec=lambda p: stencil3d_apply(C, p),
        )
        assert int(np.asarray(info["iterations"]).max()) <= 8
        assert float(np.asarray(info["rel_residual"]).max()) <= 1e-6


def test_block_thomas_3d_is_exact_inverse_f32():
    from remo3d_jax.ops.block_direct3d import (
        block_thomas_apply_3d,
        block_thomas_factor_3d,
    )
    from remo3d_jax.ops.stencil3d import entry_index, stencil3d_apply

    from ._stencils import _random_symmetric_stencil

    rng = np.random.default_rng(9)
    B, S, NZ, NP, NR = 2, 2, 6, 3, 4
    with jax.default_device(jax.devices("cpu")[0]):
        C = np.array(_random_symmetric_stencil(rng, B, NZ, NP, NR))
        C[..., entry_index(0, 0, 0)] += 15.0  # diagonal dominance -> SPD
        C = jnp.asarray(C)
        b = jnp.asarray(rng.standard_normal((B, S, NZ, NP, NR)).astype(np.float32))
        G = block_thomas_factor_3d(C, NP, NR, store_dtype=jnp.float32)
        x = block_thomas_apply_3d(G, C, b, NP, NR)
        r = np.asarray(stencil3d_apply(C, x) - b)
        assert np.abs(r).max() <= 3e-5 * np.abs(np.asarray(b)).max()


def test_block_thomas_3d_pcg_preconditioner():
    from remo3d_jax.ops.block_direct3d import (
        block_thomas_apply_3d,
        block_thomas_factor_3d,
    )
    from remo3d_jax.ops.stencil3d import entry_index, stencil3d_apply

    from ._stencils import _random_symmetric_stencil

    rng = np.random.default_rng(10)
    B, S, NZ, NP, NR = 1, 2, 6, 3, 4
    with jax.default_device(jax.devices("cpu")[0]):
        C = np.array(_random_symmetric_stencil(rng, B, NZ, NP, NR))
        C[..., entry_index(0, 0, 0)] += 8.0
        C = jnp.asarray(C)
        b = jnp.asarray(rng.standard_normal((B, S, NZ, NP, NR)).astype(np.float32))
        G = block_thomas_factor_3d(C, NP, NR)
        M_inv = lambda r: block_thomas_apply_3d(G, C, r, NP, NR)
        u, info = pcg(
            None, b, M_inv=M_inv, tol=1e-7, maxiter=50, n_grid_axes=3,
            matvec=lambda p: stencil3d_apply(C, p),
        )
        assert int(np.asarray(info["iterations"]).max()) <= 8
        assert float(np.asarray(info["rel_residual"]).max()) <= 1e-6
