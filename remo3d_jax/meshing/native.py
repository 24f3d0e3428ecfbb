# -*- coding: utf-8 -*-
"""ctypes bindings for the native C++ grid builder (native/grid2d.cpp).

The shared library is compiled on demand with the system toolchain (no pybind11 in
the image; plain C ABI + ctypes). Falls back silently to the numpy builder when the
toolchain or library is unavailable — the Python implementation is the reference
specification and the two are cross-checked in tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .carve import LocalModel
from .grid2d import Grid2D, GridSpec2D
from .grid3d import Grid3D, GridSpec3D

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SRCS = [
    os.path.join(_NATIVE_DIR, "grid2d.cpp"),
    os.path.join(_NATIVE_DIR, "grid3d.cpp"),
]
_HDR = os.path.join(_NATIVE_DIR, "grid_common.h")
_LIB = os.path.join(_NATIVE_DIR, "build", "libremo3d_grid.so")

_SIGMA_BLEND_CODES = {"centroid": 0, "arithmetic": 1, "harmonic": 2, "mixed": 3}

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            src_mtime = max(os.path.getmtime(p) for p in _SRCS + [_HDR])
            if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < src_mtime:
                os.makedirs(os.path.dirname(_LIB), exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *_SRCS, "-o", _LIB],
                    check=True,
                    capture_output=True,
                )
            lib = ctypes.CDLL(_LIB)
            lib.build_grid2d_native.restype = ctypes.c_int
            lib.build_grid3d_native.restype = ctypes.c_int
            _lib = lib
        except Exception:
            _lib_failed = True
            _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def build_grid2d_native(
    spec: GridSpec2D,
    domain_radius: float,
    local_model: LocalModel,
    electrode_positions: np.ndarray,
    source_positions: np.ndarray,
) -> Grid2D:
    """Native counterpart of :func:`remo3d_jax.meshing.grid2d.build_grid2d`."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native grid builder unavailable")

    electrodes = np.ascontiguousarray(np.asarray(electrode_positions, dtype=float))
    sources = np.ascontiguousarray(np.asarray(source_positions, dtype=float))
    boundaries = np.ascontiguousarray(local_model.boundaries)
    bottoms = np.ascontiguousarray(local_model.bottoms)
    fz_radius = np.ascontiguousarray(local_model.fz_radius)
    sigma_fz = np.ascontiguousarray(np.nan_to_num(local_model.sigma_fz, nan=0.0))
    sigma_uz = np.ascontiguousarray(local_model.sigma_uz)
    bh = local_model.borehole
    bh_z = np.ascontiguousarray(bh[:, 0])
    bh_r = np.ascontiguousarray(bh[:, 1])

    coords = np.empty((spec.nz, spec.nr, 2), dtype=float)
    sigma = np.empty((spec.nz - 1, spec.nr - 1), dtype=float)
    z_axis = np.empty((spec.nz,), dtype=float)

    # fz_radius: keep NaN markers (C checks isnan); rebuild with NaNs intact.
    fz_nan = np.ascontiguousarray(local_model.fz_radius)

    ret = lib.build_grid2d_native(
        ctypes.c_double(domain_radius),
        ctypes.c_int(spec.nz),
        ctypes.c_int(spec.nr),
        ctypes.c_int(spec.n_wall_cells),
        ctypes.c_int(spec.n_blend_cells),
        ctypes.c_double(spec.h_min_source),
        ctypes.c_double(spec.slope_source),
        ctypes.c_double(spec.h_min_electrode),
        ctypes.c_double(spec.slope_electrode),
        ctypes.c_double(spec.h_min_boundary),
        ctypes.c_double(spec.slope_boundary),
        ctypes.c_double(spec.h_max_axial_frac),
        ctypes.c_double(spec.h_min_radial),
        ctypes.c_double(spec.slope_radial),
        ctypes.c_double(spec.h_max_radial_frac),
        ctypes.c_double(spec.blend_m0),
        _dptr(electrodes),
        ctypes.c_int(electrodes.size),
        _dptr(sources),
        ctypes.c_int(sources.size),
        _dptr(boundaries),
        ctypes.c_int(boundaries.size),
        _dptr(bottoms),
        ctypes.c_int(bottoms.size),
        _dptr(fz_nan),
        _dptr(sigma_fz),
        _dptr(sigma_uz),
        _dptr(bh_z),
        _dptr(bh_r),
        ctypes.c_int(bh_z.size),
        ctypes.c_double(local_model.mud_sigma),
        _dptr(coords),
        _dptr(sigma),
        _dptr(z_axis),
    )
    if ret != 0:
        raise RuntimeError(f"native grid builder failed with code {ret}")

    free_mask = np.ones((spec.nz, spec.nr), dtype=bool)
    free_mask[0, :] = False
    free_mask[-1, :] = False
    free_mask[:, -1] = False

    return Grid2D(
        spec=spec,
        z_axis=z_axis,
        coords=coords,
        sigma_cells=sigma,
        free_mask=free_mask,
    )


def build_grid3d_native(
    spec: GridSpec3D,
    domain_radius: float,
    local_model: LocalModel,
    dip_rad: float,
    electrode_positions: np.ndarray,
    source_positions: np.ndarray,
) -> Grid3D:
    """Native counterpart of :func:`remo3d_jax.meshing.grid3d.build_grid3d`."""
    if spec.fz_h_radial is not None:
        # The C ABI predates the anchor-local thin-annulus refinement; the
        # Python builder handles it (meshing is ~0.2% of chunk wall time, so
        # the native speedup is immaterial for these runs).
        from .grid3d import build_grid3d

        return build_grid3d(
            spec, domain_radius, local_model, dip_rad,
            electrode_positions, source_positions,
        )
    lib = _load()
    if lib is None:
        raise RuntimeError("native grid builder unavailable")

    electrodes = np.ascontiguousarray(np.asarray(electrode_positions, dtype=float))
    sources = np.ascontiguousarray(np.asarray(source_positions, dtype=float))
    boundaries = np.ascontiguousarray(local_model.boundaries)
    bottoms = np.ascontiguousarray(local_model.bottoms)
    fz_nan = np.ascontiguousarray(local_model.fz_radius)
    sigma_fz = np.ascontiguousarray(np.nan_to_num(local_model.sigma_fz, nan=0.0))
    sigma_uz = np.ascontiguousarray(local_model.sigma_uz)
    bh = local_model.borehole
    bh_z = np.ascontiguousarray(bh[:, 0])
    bh_r = np.ascontiguousarray(bh[:, 1])

    coords = np.empty((spec.nz, spec.np_, spec.nr, 3), dtype=float)
    sigma = np.empty((spec.nz - 1, spec.np_ - 1, spec.nr - 1), dtype=float)
    z_axis = np.empty((spec.nz,), dtype=float)

    ret = lib.build_grid3d_native(
        ctypes.c_double(domain_radius),
        ctypes.c_int(spec.nz),
        ctypes.c_int(spec.np_),
        ctypes.c_int(spec.nr),
        ctypes.c_int(spec.n_wall_cells),
        ctypes.c_int(spec.n_blend_cells),
        ctypes.c_double(spec.h_min_source),
        ctypes.c_double(spec.slope_source),
        ctypes.c_double(spec.h_min_electrode),
        ctypes.c_double(spec.slope_electrode),
        ctypes.c_double(spec.h_min_boundary),
        ctypes.c_double(spec.slope_boundary),
        ctypes.c_double(spec.h_max_axial_frac),
        ctypes.c_double(spec.h_min_radial),
        ctypes.c_double(spec.slope_radial),
        ctypes.c_double(spec.h_max_radial_frac),
        ctypes.c_double(spec.blend_m0),
        ctypes.c_double(spec.shear_cap_frac),
        ctypes.c_double(float(np.tan(dip_rad))),
        ctypes.c_int(_SIGMA_BLEND_CODES[spec.sigma_blend]),
        _dptr(electrodes),
        ctypes.c_int(electrodes.size),
        _dptr(sources),
        ctypes.c_int(sources.size),
        _dptr(boundaries),
        ctypes.c_int(boundaries.size),
        _dptr(bottoms),
        ctypes.c_int(bottoms.size),
        _dptr(fz_nan),
        _dptr(sigma_fz),
        _dptr(sigma_uz),
        _dptr(bh_z),
        _dptr(bh_r),
        ctypes.c_int(bh_z.size),
        ctypes.c_double(local_model.mud_sigma),
        _dptr(coords),
        _dptr(sigma),
        _dptr(z_axis),
    )
    if ret != 0:
        raise RuntimeError(f"native grid builder failed with code {ret}")

    free_mask = np.ones((spec.nz, spec.np_, spec.nr), dtype=bool)
    free_mask[0] = False
    free_mask[-1] = False
    free_mask[:, :, -1] = False

    return Grid3D(
        spec=spec,
        z_axis=z_axis,
        coords=coords,
        sigma_cells=sigma,
        free_mask=free_mask,
    )
