# -*- coding: utf-8 -*-
"""Structured boundary-fitted grid builders (host-side, vectorized numpy).

Replacement for the reference's gmsh/netgen unstructured meshing
(gmsh_functions.py, netgen_functions.py): fixed-topology tensor-product grids whose
node positions conform to electrodes, layer boundaries, borehole wall and invasion
radii, blended onto the exact circular/spherical truncation boundary.
"""

from .grid2d import Grid2D, GridSpec2D, build_grid2d  # noqa: F401
from .carve import carve_local_model  # noqa: F401
