# -*- coding: utf-8 -*-
"""Multi-host (multi-process) execution support.

The reference scales across nodes with MPI dynamic process management
(remo3d.py:592, mpiexec in the examples). The JAX equivalent is the
single-controller-per-process model: every process runs the same program, calls
:func:`initialize_distributed` once, and the executor's device mesh then spans
ALL processes' GPUs (NVLink within a host, the network across hosts); the batch axis is
data-parallel so the only cross-host traffic is the initial shard staging and
the result gather.

Single-process runs are unaffected — every helper degrades to a no-op.
"""

from __future__ import annotations

import os
import warnings

import jax
import numpy as np

# Tracks whether THIS module already attempted jax.distributed.initialize();
# querying jax.process_count() would itself initialize the XLA backend and make
# a later initialize() call impossible, so the guard must not touch the backend.
_init_attempted = False


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize `jax.distributed` for multi-host runs (idempotent).

    Must be called BEFORE any other JAX API (anything that touches the XLA
    backend — even ``jax.process_count()`` — locks out distributed init).
    With no arguments, relies on what JAX can detect from the cluster
    environment (a scheduler such as Slurm, or ``JAX_COORDINATOR_ADDRESS`` and
    friends). A plain multi-process GPU run has neither: pass
    ``coordinator_address="host:port"`` (any free port on process 0's host),
    ``num_processes`` and ``process_id`` explicitly. Returns True when a
    multi-process service is up, False for a plain single-host run.

    Failure policy: explicit arguments mean the caller *expects* a cluster, so
    errors re-raise; the no-argument auto-detect form degrades to single-host
    with a warning only when cluster environment variables are present.
    """
    global _init_attempted
    if jax.distributed.is_initialized():
        return True
    if _init_attempted:
        return False
    _init_attempted = True
    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
    )
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    except Exception as e:
        if explicit:
            raise
        cluster_hints = [
            k
            for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES")
            if os.environ.get(k)
        ]
        if cluster_hints:
            warnings.warn(
                f"jax.distributed.initialize() failed ({type(e).__name__}: {e}) "
                f"despite cluster env vars {cluster_hints}; running single-host",
                RuntimeWarning,
                stacklevel=2,
            )
        return False


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def stage_sharded(arrays: list[np.ndarray], shardings: list) -> list[jax.Array]:
    """Place host arrays onto (possibly multi-host) shardings.

    Single-process: plain ``device_put``. Multi-process: every process holds the
    FULL logical array (the executor stages identical chunk data on all hosts —
    batches are cheap host-side), and each process contributes its local shard
    via ``jax.make_array_from_callback``.
    """
    if not is_multiprocess():
        return [jax.device_put(a, s) for a, s in zip(arrays, shardings)]
    out = []
    for a, s in zip(arrays, shardings):
        out.append(
            jax.make_array_from_callback(a.shape, s, lambda idx, a=a: a[idx])
        )
    return out


def gather_result(x: jax.Array) -> np.ndarray:
    """Fetch a (possibly multi-host sharded) result to every host."""
    if not is_multiprocess():
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
