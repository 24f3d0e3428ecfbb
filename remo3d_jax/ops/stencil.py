# -*- coding: utf-8 -*-
"""9-point stencil linear operator on (NZ, NR) node arrays.

The SpMV of the structured FEM system is nine shifted multiply-adds on dense arrays —
fully fusible by XLA, no gather/scatter. Supports an extra solve axis S that shares
the stencil (one matrix, many right-hand sides per batch mesh — the reference solves
one RHS at a time per mesh, worker.py:104-110; we batch them).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def stencil_apply(C: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """y = A u.

    C: (..., NZ, NR, 3, 3); u: (..., [S,] NZ, NR). When u has one more leading axis
    than C (the solve axis), the stencil broadcasts across it. The ops carry the
    named scope ``stencil2d_apply_{NZ}x{NR}``, so a profiler trace attributes
    their device time per grid level.
    """
    nz, nr = C.shape[-4], C.shape[-3]
    extra = u.ndim - (C.ndim - 2)  # 0 or 1 (solve axis)
    if extra not in (0, 1):
        raise ValueError(f"rank mismatch: C {C.shape}, u {u.shape}")
    with jax.named_scope(f"stencil2d_apply_{nz}x{nr}"):
        Cb = C if extra == 0 else jnp.expand_dims(C, axis=-5)  # (..., 1, NZ, NR, 3, 3)
        u_pad = jnp.pad(u, [(0, 0)] * (u.ndim - 2) + [(1, 1), (1, 1)])
        y = jnp.zeros_like(u)
        for di in range(3):
            for dj in range(3):
                y = y + Cb[..., di, dj] * u_pad[..., di : di + nz, dj : dj + nr]
    return y


def stencil_diag(C: jnp.ndarray) -> jnp.ndarray:
    """Operator diagonal (Jacobi preconditioner source)."""
    return C[..., 1, 1]
