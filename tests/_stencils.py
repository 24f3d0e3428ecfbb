# -*- coding: utf-8 -*-
"""Random symmetric FEM-like stencils shared by the solver tests."""

import numpy as np

from remo3d_jax.ops.stencil3d import entry_index


def _random_symmetric_stencil_2d(rng, B, NZ, NR):
    """Random 9-point stencil with FEM symmetry C[n, d] == C[n+d, -d] and zero
    coupling across the grid boundary."""
    C = np.zeros((B, NZ, NR, 3, 3), dtype=np.float32)
    C[..., 1, 1] = 10.0 + rng.random((B, NZ, NR))
    for dz, dr in [(0, 1), (1, -1), (1, 0), (1, 1)]:
        h = rng.standard_normal((B, NZ, NR)).astype(np.float32)
        sl = [slice(None)] * 3
        for ax, d, n in ((1, dz, NZ), (2, dr, NR)):
            if d > 0:
                sl[ax] = slice(0, n - d)
            elif d < 0:
                sl[ax] = slice(-d, n)
        mask = np.zeros((B, NZ, NR), dtype=bool)
        mask[tuple(sl)] = True
        h *= mask
        C[..., 1 + dz, 1 + dr] = h
        hm = np.zeros_like(h)
        src = [slice(None)] * 3
        dst = [slice(None)] * 3
        for ax, d, n in ((1, dz, NZ), (2, dr, NR)):
            if d > 0:
                src[ax], dst[ax] = slice(0, n - d), slice(d, n)
            elif d < 0:
                src[ax], dst[ax] = slice(-d, n), slice(0, n + d)
        hm[tuple(dst)] = h[tuple(src)]
        C[..., 1 - dz, 1 - dr] = hm
    return C


def _random_symmetric_stencil(rng, B, NZ, NP, NR):
    """Random 27-point stencil with FEM symmetry C[n, d] == C[n+d, -d] and
    zero coupling across the grid boundary."""
    C = np.zeros((B, NZ, NP, NR, 27), dtype=np.float32)
    C[..., entry_index(0, 0, 0)] = 10.0 + rng.random((B, NZ, NP, NR))
    offs = [
        (dz, dp, dr)
        for dz in (-1, 0, 1)
        for dp in (-1, 0, 1)
        for dr in (-1, 0, 1)
        if (dz, dp, dr) > (0, 0, 0)
    ]
    for dz, dp, dr in offs:
        h = rng.standard_normal((B, NZ, NP, NR)).astype(np.float32)
        # Zero the entries whose +d neighbor would fall outside the grid.
        sl = [slice(None)] * 4
        for ax, d, n in ((1, dz, NZ), (2, dp, NP), (3, dr, NR)):
            if d > 0:
                sl[ax] = slice(0, n - d)
            elif d < 0:
                sl[ax] = slice(-d, n)
        mask = np.zeros((B, NZ, NP, NR), dtype=bool)
        mask[tuple(sl)] = True
        h *= mask
        C[..., entry_index(dz, dp, dr)] = h
        # Mirror: the coupling seen from the neighbor node.
        hm = np.zeros_like(h)
        src = [slice(None)] * 4
        dst = [slice(None)] * 4
        for ax, d, n in ((1, dz, NZ), (2, dp, NP), (3, dr, NR)):
            if d > 0:
                src[ax], dst[ax] = slice(0, n - d), slice(d, n)
            elif d < 0:
                src[ax], dst[ax] = slice(-d, n), slice(0, n + d)
        hm[tuple(dst)] = h[tuple(src)]
        C[..., entry_index(-dz, -dp, -dr)] = hm
    return C

