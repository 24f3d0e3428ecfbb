# -*- coding: utf-8 -*-
"""Benchmark: the 3D dipping-log rate + 2D throughput, on the attached GPU.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...extras},
with the device as JAX reports it and the card's name and power limit. Exits
non-zero when JAX finds no GPU.

Primary metric: a 100-measurement-point 3D dipping log of moderate complexity
(Benchmark model 3 stack, inputs/BM3, dip=30, one lateral tool). The reference
takes 15-30 min for this workload on an AMD Ryzen 2600 (its README.md:26) =>
midpoint ~0.074 points/s.

Secondary fields: 2D Example_01-class throughput (inputs/Example_01), reported
BOTH as tool-readout points/s (6 tools share each solve via SEC dedup) and as
solves/s — the apples-to-apples number vs the reference's ~5 single-tool
points/s midpoint.

Usage: python bench.py   (BENCH_DEPTHS=N sets the 2D depth count, default 101)
"""

import json
import os
import sys
import time

import numpy as np

try:  # installed package (pip install -e .) or repo-root fallback
    import remo3d_jax  # noqa: F401
except ImportError:  # pragma: no cover
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REFERENCE_3D_POINTS_PER_S = 0.074  # 100 pts / 22.5 min midpoint (reference README.md:26)
REFERENCE_2D_POINTS_PER_S = 5.0  # 100 pts / 15-30 s midpoint (reference README.md:26)
TOOLS_2D = ["B5.7A0.4M", "B4.48A1.62M", "M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A", "M4.0A0.5B"]


def device_info():
    """Platform, kind and count as JAX reports them, plus the card's name and
    power limit. Exits when JAX's default device is not a GPU."""
    import subprocess

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX default platform is {devices[0].platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": smi.stdout.strip() or smi.stderr.strip(),
    }


def bench_3d():
    from inputs.generate import path
    from remo3d_jax import Model

    depths = np.round(5.0 + 0.25 * np.arange(100), 4)  # 100 measurement points
    model = Model(["A2.0M0.5N"])
    model.set_model_parameters(
        path("BM3", "Formation.txt"), path("BM3", "Borehole.txt"), dip=30
    )
    model.initialize_workers(cpu_workers=4)
    # Warm-up: compile the chunk programs.
    model.simulate_logs(depths, domain_radius=150, verbose=False)
    t0 = time.perf_counter()
    model.simulate_logs(depths, domain_radius=150, verbose=False)
    elapsed = time.perf_counter() - t0
    vals = model.logs["A2.0M0.5N"][:, 1]
    phases = {k: round(v, 3) for k, v in model._executor.timers.seconds.items()}
    model.shutdown_workers()
    return elapsed, len(depths), int(np.isnan(vals).sum()), phases


def bench_2d():
    from inputs.generate import path
    from remo3d_jax import Model

    n_depths = int(os.environ.get("BENCH_DEPTHS", "101"))
    depths = np.round(0.1 * np.arange(251), 4)[:n_depths]

    model = Model(TOOLS_2D)
    model.set_model_parameters(
        path("Example_01", "Formation.txt"), path("Example_01", "Borehole.txt")
    )
    model.initialize_workers(cpu_workers=4)
    # Warm-up at full size: chunk shapes depend on the task count, so a smaller
    # warm-up would leave the timed run paying the compile.
    model.simulate_logs(depths, verbose=False)
    t0 = time.perf_counter()
    model.simulate_logs(depths, verbose=False)
    elapsed = time.perf_counter() - t0
    n_solves = sum(c["solves"] for c in model._executor.last_report["chunks"])
    n_nan = int(sum(np.isnan(v[:, 1]).sum() for v in model.logs.values()))
    phases = {k: round(v, 3) for k, v in model._executor.timers.seconds.items()}
    model.shutdown_workers()
    return elapsed, len(depths) * len(TOOLS_2D), n_solves, n_nan, phases


def main():
    device = device_info()
    el3, n3, nan3, phases3 = bench_3d()
    el2, n2_readouts, n2_solves, nan2, phases2 = bench_2d()
    pts3 = n3 / el3
    print(
        json.dumps(
            {
                "metric": "3D dipping-log points/sec (BM3 dip=30, 100 pts, 1 tool)",
                "value": round(pts3, 3),
                "unit": "points/s",
                "vs_baseline": round(pts3 / REFERENCE_3D_POINTS_PER_S, 1),
                "elapsed_3d_s": round(el3, 2),
                "n_nan_3d": nan3,
                "phases_3d_s": phases3,
                "pts2d_per_s": round(n2_readouts / el2, 1),
                "solves2d_per_s": round(n2_solves / el2, 1),
                "vs_baseline_2d_readouts": round(n2_readouts / el2 / REFERENCE_2D_POINTS_PER_S, 2),
                "elapsed_2d_s": round(el2, 2),
                "n_nan_2d": nan2,
                "phases_2d_s": phases2,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
