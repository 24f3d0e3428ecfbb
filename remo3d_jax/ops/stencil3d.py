# -*- coding: utf-8 -*-
"""27-point stencil operator on (NZ, NP, NR) node grids + the pole projector.

3D counterpart of :mod:`.stencil` for the sheared-cylindrical half-ball grids:
axes are (axial z-line i, azimuth j, radial station k). The stencil is stored with a
FLATTENED entry axis ``C[..., NZ, NP, NR, 27]`` (entry e = ((dz+1)*3+(dp+1))*3+dr+1),
which keeps the operator arrays at rank 5 instead of 7.

The CG operator reads the symmetric half of the stencil (:func:`half_planes`,
:func:`stencil3d_apply_half`): the centre plus the 13 forward offsets, stored
plane-major, since an FEM operator satisfies C[n, d] == C[n + d, -d].
:func:`stencil3d_apply` is the plain 27-plane apply it is checked against.

The radial station k=0 is the borehole axis, where all azimuth copies of a node
coincide physically; the orthogonal projector :func:`pole_project` ties them
(average over the azimuth), turning the full-grid operator into the exact reduced
FEM system on the tied subspace.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_OFFSETS = [(dz, dp, dr) for dz in (-1, 0, 1) for dp in (-1, 0, 1) for dr in (-1, 0, 1)]


def entry_index(dz: int, dp: int, dr: int) -> int:
    """Flattened stencil entry for neighbor offset (dz, dp, dr) in {-1,0,1}^3."""
    return ((dz + 1) * 3 + (dp + 1)) * 3 + (dr + 1)


DIAG = entry_index(0, 0, 0)


def stencil3d_apply(C: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """y = A u.  C: (..., NZ, NP, NR, 27); u: (..., [S,] NZ, NP, NR).

    The ops carry the named scope ``stencil3d_apply`` for profiler traces.
    """
    nz, np_, nr = C.shape[-4], C.shape[-3], C.shape[-2]
    extra = u.ndim - (C.ndim - 1)
    if extra not in (0, 1):
        raise ValueError(f"rank mismatch: C {C.shape}, u {u.shape}")
    with jax.named_scope("stencil3d_apply"):
        Cb = C if extra == 0 else jnp.expand_dims(C, axis=-5)
        u_pad = jnp.pad(u, [(0, 0)] * (u.ndim - 3) + [(1, 1), (1, 1), (1, 1)])
        y = jnp.zeros_like(u)
        for dz, dp, dr in _OFFSETS:
            e = entry_index(dz, dp, dr)
            y = y + Cb[..., e] * u_pad[
                ..., 1 + dz : 1 + dz + nz, 1 + dp : 1 + dp + np_, 1 + dr : 1 + dr + nr
            ]
    return y


# Offsets d > 0 in lexicographic order; with the centre they index the
# symmetric half of the stencil (C[n, d] == C[n + d, -d] for an FEM operator).
_FORWARD = [d for d in _OFFSETS if d > (0, 0, 0)]


def _shifted(a_pad, d, shape):
    """a[n + d] from ``a`` zero-padded by one on each grid axis."""
    (dz, dp, dr), (nz, np_, nr) = d, shape
    return a_pad[..., 1 + dz : 1 + dz + nz, 1 + dp : 1 + dp + np_, 1 + dr : 1 + dr + nr]


def half_planes(C: jnp.ndarray) -> jnp.ndarray:
    """The centre and the 13 forward-offset planes of a symmetric stencil,
    plane-major: (..., NZ, NP, NR, 27) -> (..., 14, NZ, NP, NR)."""
    idx = [DIAG] + [entry_index(*d) for d in _FORWARD]
    return jnp.moveaxis(C[..., idx], -1, -4)


def stencil3d_apply_half(Ch: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """y = A u for a symmetric stencil from its half planes (:func:`half_planes`).

    y[n] = C_0[n] u[n] + sum_{d > 0} (C_d[n] u[n + d] + C_d[n - d] u[n - d]):
    14 coefficient planes are read instead of 27.
    """
    shape = Ch.shape[-3:]
    Cb = Ch if u.ndim == Ch.ndim - 1 else jnp.expand_dims(Ch, axis=-5)
    pad = [(0, 0)] * (u.ndim - 3) + [(1, 1)] * 3
    with jax.named_scope("stencil3d_apply"):
        u_pad = jnp.pad(u, pad)
        y = Cb[..., 0, :, :, :] * u
        for k, (dz, dp, dr) in enumerate(_FORWARD, start=1):
            c = Cb[..., k, :, :, :]
            y = y + c * _shifted(u_pad, (dz, dp, dr), shape)
            y = y + _shifted(jnp.pad(c * u, pad), (-dz, -dp, -dr), shape)
    return y


def stencil3d_diag(C: jnp.ndarray) -> jnp.ndarray:
    return C[..., DIAG]


def pole_project(u: jnp.ndarray) -> jnp.ndarray:
    """Average the coincident axis DOFs over the azimuth (radial station 0)."""
    pole_mean = jnp.mean(u[..., :, :, 0], axis=-1, keepdims=True)
    return u.at[..., :, :, 0].set(jnp.broadcast_to(pole_mean, u[..., :, :, 0].shape))
