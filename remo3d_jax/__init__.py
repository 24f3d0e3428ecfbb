# -*- coding: utf-8 -*-
"""remo3d_jax — forward modeling of normal and lateral resistivity logs in JAX.

A from-scratch JAX/XLA re-implementation of the capability surface of ReMo3D
(synthetic DC resistivity borehole logs for 2D axisymmetric and 3D dipping-layer
models): structured boundary-fitted grids, stencil FEM, batched preconditioned CG
sharded over the device mesh. See DESIGN.md.

Public API parity: ``Model`` mirrors the reference package's single exported class
(remo3d/__init__.py:15).
"""

__version__ = "0.2.0"

import os as _os

import jax as _jax

# Persistent XLA compilation cache: the solve programs are large (multigrid
# V-cycles inside CG loops) and caching them across processes turns later runs
# into pure-execute runs. JAX reads JAX_COMPILATION_CACHE_DIR itself; when it
# is set, nothing is set here. Otherwise the cache lives at a fixed path in the
# checkout (the path is part of the cache key, so it must not move). Pure-CPU
# runs (tests, the multichip dryrun) skip the cache: CPU AOT cache entries
# replay with mismatched machine-feature metadata (xla cpu_aot_loader warns
# about possible SIGILL).
_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
if (
    "JAX_COMPILATION_CACHE_DIR" not in _os.environ
    and _os.environ.get("JAX_PLATFORMS", "").strip().lower() != "cpu"
):
    _jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)

from .diff import DifferentiableLog  # noqa: F401,E402
from .model import Model  # noqa: F401,E402

__all__ = ["Model", "DifferentiableLog"]
