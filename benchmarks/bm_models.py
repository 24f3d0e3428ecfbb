# -*- coding: utf-8 -*-
"""Benchmark models 1-3 from the reference (Examples/Benchmark models/).

BM1: thick homogeneous beds, 10/100 ohmm contrast, no invasion — apparent
resistivity deep inside each thick bed must approach the bed resistivity.
BM2: invasion zones of radius 0.2/0.35/0.5 m.
BM3: one 100-ohmm bed at dips 0/15/30/45/60 degrees (exercises the 3D path).

The reference ships no logs for these models; this script runs them as smoke +
physics checks (asymptotic values, continuity across dips) and reports timing.

Usage: python benchmarks/bm_models.py [1|2|3] [--cpu]
"""

import os
import sys
import time

import numpy as np

try:  # installed package (pip install -e .) or repo-root fallback
    import remo3d_jax  # noqa: F401
except ImportError:  # pragma: no cover
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BM = "/root/reference/Examples/Benchmark models"
TOOLS = ["B5.7A0.4M", "A2.0M0.5N"]


def run_bm1():
    from remo3d_jax import Model

    depths = np.arange(2.0, 58.01, 0.25)
    m = Model(TOOLS)
    m.set_model_parameters(
        os.path.join(BM, "Benchmark model 1", "Formation_BM1.txt"),
        os.path.join(BM, "Benchmark model 1", "Borehole_BM1.txt"),
    )
    m.initialize_workers()
    t0 = time.time()
    m.simulate_logs(depths, verbose=False)
    el = time.time() - t0
    print(f"BM1: {len(depths)} depths x {len(TOOLS)} tools in {el:.1f}s")
    # Asymptotic checks: mid-bed values in the thick beds.
    for t in TOOLS:
        log = m.logs[t]
        mid10 = log[np.abs(log[:, 0] - 26.0) < 1.0, 1]  # inside 20.5-30.5 (10 ohmm)
        mid100 = log[np.abs(log[:, 0] - 48.0) < 1.0, 1]  # inside 44.5-52.5 (100 ohmm)
        print(
            f"  {t:>10}: mid-bed(10 ohmm) {np.nanmean(mid10):.2f}  "
            f"mid-bed(100 ohmm) {np.nanmean(mid100):.2f}  nan={np.isnan(log[:,1]).sum()}"
        )


def run_bm2():
    from remo3d_jax import Model

    depths = np.arange(1.0, 19.01, 0.25)
    m = Model(TOOLS)
    m.set_model_parameters(
        os.path.join(BM, "Benchmark model 2", "Formation_BM2.txt"),
        os.path.join(BM, "Benchmark model 2", "Borehole_BM2.txt"),
    )
    m.initialize_workers()
    t0 = time.time()
    m.simulate_logs(depths, verbose=False)
    el = time.time() - t0
    print(f"BM2: {len(depths)} depths x {len(TOOLS)} tools in {el:.1f}s")
    for t in TOOLS:
        log = m.logs[t]
        print(
            f"  {t:>10}: range {np.nanmin(log[:,1]):.2f}..{np.nanmax(log[:,1]):.2f}"
            f"  nan={np.isnan(log[:,1]).sum()}"
        )


def run_bm3(platform=None):
    from remo3d_jax import Model

    depths = np.arange(5.0, 20.01, 0.25)
    results = {}
    for dip in (0, 15, 30, 45, 60):
        m = Model(["A2.0M0.5N"])
        m.set_model_parameters(
            os.path.join(BM, "Benchmark model 3", f"Formation_BM3_{dip:02d}.txt"),
            os.path.join(BM, "Benchmark model 3", "Borehole_BM3.txt"),
            dip=dip,
        )
        m.initialize_workers()
        t0 = time.time()
        m.simulate_logs(depths, platform=platform, verbose=False)
        el = time.time() - t0
        log = m.logs["A2.0M0.5N"]
        results[dip] = log[:, 1]
        print(
            f"BM3 dip={dip:2d}: {len(depths)} pts in {el:.1f}s  "
            f"range {np.nanmin(log[:,1]):.2f}..{np.nanmax(log[:,1]):.2f}"
            f"  nan={np.isnan(log[:,1]).sum()}",
            flush=True,
        )
    # Continuity: small dips should stay close to the axisymmetric result.
    if 0 in results and 15 in results:
        d = np.nanmean(
            np.abs(results[15] - results[0]) / np.maximum(results[0], 1e-9)
        )
        print(f"BM3: mean |dip15 - dip0| = {d*100:.2f}% (expected small)")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "1"
    platform = "cpu" if "--cpu" in sys.argv else None
    {"1": run_bm1, "2": run_bm2, "3": lambda: run_bm3(platform)}[which]()
