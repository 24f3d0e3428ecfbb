# -*- coding: utf-8 -*-
"""Device-side numerics: stencil FEM assembly, SpMV, batched preconditioned CG.

Replacement for NGSolve/ngscuda (ngsolve_functions.py, ngsolve_functions_gpu.py):
everything is dense structured-array arithmetic that XLA fuses into device loops;
no sparse formats, no gather/scatter.
"""

from .assembly2d import assemble_stencil_2d  # noqa: F401
from .stencil import stencil_apply, stencil_diag  # noqa: F401
from .cg import pcg  # noqa: F401
