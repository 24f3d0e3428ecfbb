# -*- coding: utf-8 -*-
"""Example_01 / Example_02 golden-output parity.

The reference ships the outputs of both example scripts
(Examples/Example_0N/Output/Results_*/Results_1.txt). Example_01 runs the default
configuration; Example_02 the advanced one (domain_radius=25, batch_size=10,
netgen generator selection).

Usage: python benchmarks/example_parity.py [1|2] [n_depths]
"""

import glob
import os
import sys
import time

import numpy as np

try:  # installed package (pip install -e .) or repo-root fallback
    import remo3d_jax  # noqa: F401
except ImportError:  # pragma: no cover
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOOLS = ["B5.7A0.4M", "B4.48A1.62M", "M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A", "M4.0A0.5B"]


def main(example=1, n_depths=251):
    from remo3d_jax import Model

    base = f"/root/reference/Examples/Example_{example:02d}"
    golden_file = glob.glob(os.path.join(base, "Output", "Results_*", "Results_1.txt"))[0]
    golden = np.loadtxt(golden_file, skiprows=2)
    depths = np.arange(0, 25.1, 0.1)[:n_depths]

    kwargs = {}
    if example == 2:
        kwargs = dict(domain_radius=25, batch_size=10, mesh_generator="netgen")

    model = Model(TOOLS)
    model.set_model_parameters(
        os.path.join(base, "Input", "Formation.txt"),
        os.path.join(base, "Input", "Borehole.txt"),
    )
    model.initialize_workers()
    t0 = time.time()
    model.simulate_logs(depths, verbose=False, **kwargs)
    el = time.time() - t0

    print(f"Example_{example:02d}: {len(depths)} depths x 6 tools in {el:.1f}s")
    worst = 0.0
    for j, t in enumerate(TOOLS):
        ours = model.logs[t][:, 1]
        ref = golden[: len(depths), 1 + j]
        rel = (ours - ref) / ref
        worst = max(worst, np.nanmax(np.abs(rel)))
        print(
            f"  {t:>12}: mean {np.nanmean(rel)*100:+.3f}%  max {np.nanmax(np.abs(rel))*100:.3f}%"
            f"  nan={int(np.isnan(ours).sum())}"
        )
    print(f"  WORST: {worst*100:.3f}%")
    return worst


if __name__ == "__main__":
    ex = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    nd = int(sys.argv[2]) if len(sys.argv) > 2 else 251
    main(ex, nd)
