# -*- coding: utf-8 -*-
"""Subprocess payload for the two-process jax.distributed smoke test.

Run as: python _distributed_worker.py <coordinator_port> <num_processes> <process_id>

Must call initialize_distributed BEFORE any other JAX API — that ordering is
exactly what round 2 got wrong (the process_count() guard initialized the XLA
backend first, so multi-host init always failed and silently degraded).
"""

import sys

coordinator_port, num_processes, process_id = sys.argv[1:4]

from remo3d_jax.parallel.distributed import (  # noqa: E402
    gather_result,
    initialize_distributed,
    is_multiprocess,
    stage_sharded,
)

ok = initialize_distributed(
    coordinator_address=f"localhost:{coordinator_port}",
    num_processes=int(num_processes),
    process_id=int(process_id),
)
assert ok, "initialize_distributed returned False under explicit arguments"
assert is_multiprocess(), "process_count() == 1 after distributed init"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

assert jax.process_count() == int(num_processes), jax.process_count()

# Global mesh over ALL processes' devices; stage a host array through the
# multi-process branch (make_array_from_callback) and bring the computed
# result back to every host (process_allgather) — the two branches no
# single-process test can reach.
devices = np.array(jax.devices())
mesh = jax.sharding.Mesh(devices.reshape(len(devices), 1), ("batch", "solve"))
sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("batch"))

host = np.arange(32, dtype=np.float32).reshape(8, 4)
(staged,) = stage_sharded([host], [sharding])
assert staged.sharding.is_equivalent_to(sharding, ndim=2)

doubled = jax.jit(lambda x: 2.0 * x)(staged)
back = gather_result(doubled)
np.testing.assert_allclose(back, 2.0 * host)
print(f"DISTRIBUTED_OK process={process_id} devices={len(devices)}", flush=True)
