# -*- coding: utf-8 -*-
"""Generate the model input files that the examples, tests, bench and chip
smoke read.

Writes tab-separated files in the reference's format: a names row, a units row,
then data rows (remo3d_jax/io.py).

* ``Example_01/Formation.txt`` and ``Example_01/Borehole.txt``: an
  Example_01-class 2D model (seven layers over 0-25 m with invasion zones).
* ``BM3/Formation.txt`` and ``BM3/Borehole.txt``: the Benchmark model 3 layer
  stack for dipping runs, with the needle borehole of
  ``benchmarks/bm3_oracle.py`` so that the rotated layered-medium oracle applies.

Example_01-class model. Known values: 7 layers over 0-25 m; undisturbed-zone
resistivities 5/18/6/12/8/20/7 ohmm; invasion-zone resistivities 3/4/4 ohmm in
layers 1/3/5 (0-based); invasion radius 0.3 m in layer 1; caliper 236.0941 mm
at the top station; mud 1.1 ohmm. Assumed values:

* layer boundaries at 3.5, 9.0, 11.0, 14.0, 19.0 and 22.0 m (read off the
  shape of an earlier Example_01 log, not taken from the original file);
* invasion radii 0.25 m in layer 3 and 0.4 m in layer 5;
* borehole stations every 0.1 m from 0 to 25 m;
* caliper 236.0941 mm everywhere except one smooth washout in layer 2 (the
  6 ohmm bed), a raised cosine 9.2-10.8 m deep that peaks at 260 mm;
* mud resistivity constant at 1.1 ohmm.

BM3 model (benchmarks/bm3_oracle.py): 10 | 100 | 10 ohmm with the bed between
10.77 and 14.23 m measured along the borehole axis, outer layers closed at
-1000 and 1000 m, no invasion; a 4 mm borehole diameter (0.002 m radius) and
10 ohmm mud, matched to the shoulders. Assumed: the formation file holds the
axis-crossing depths for any dip, so one file serves every dip angle.

Run ``python inputs/generate.py`` to rewrite the files; the output is
deterministic and the committed files must equal it (tests/test_io.py).
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

EX01_TOPS = np.array([0.0, 3.5, 9.0, 11.0, 14.0, 19.0, 22.0])
EX01_BOTTOM = 25.0
EX01_UZ = np.array([5.0, 18.0, 6.0, 12.0, 8.0, 20.0, 7.0])
EX01_FZ = {1: (0.3, 3.0), 3: (0.25, 4.0), 5: (0.4, 4.0)}  # layer: (radius m, ohmm)
EX01_CALIPER_MM = 236.0941
EX01_WASHOUT = (9.2, 10.8, 260.0)  # top m, bottom m, peak caliper mm
EX01_MUD = 1.1

BM3_BOUNDARIES = np.array([10.77, 14.23])
BM3_RHOS = np.array([10.0, 100.0, 10.0])
BM3_BH_RADIUS = 0.002
BM3_MUD = 10.0

FORMATION_HEADER = ("TOP\tBOTTOM\tFZ_RADIUS\tFZ_VALUE\tUZ_VALUE", "M\tM\tM\tOHMM\tOHMM")
BOREHOLE_HEADER = ("DEPT\tCALM\tRM", "M\tMM\tOHMM")


def example01_formation() -> np.ndarray:
    bottoms = np.append(EX01_TOPS[1:], EX01_BOTTOM)
    fz_r = np.full(EX01_TOPS.size, np.nan)
    fz_v = np.full(EX01_TOPS.size, np.nan)
    for layer, (radius, rho) in EX01_FZ.items():
        fz_r[layer], fz_v[layer] = radius, rho
    return np.column_stack([EX01_TOPS, bottoms, fz_r, fz_v, EX01_UZ])


def example01_borehole() -> np.ndarray:
    depth = np.round(np.arange(0.0, EX01_BOTTOM + 0.05, 0.1), 4)
    top, bottom, peak = EX01_WASHOUT
    phase = np.clip((depth - top) / (bottom - top), 0.0, 1.0)
    bump = 0.5 * (1.0 - np.cos(2.0 * np.pi * phase))
    caliper = EX01_CALIPER_MM + (peak - EX01_CALIPER_MM) * bump
    return np.column_stack([depth, caliper, np.full(depth.size, EX01_MUD)])


def bm3_formation() -> np.ndarray:
    tops = np.concatenate([[-1000.0], BM3_BOUNDARIES])
    bottoms = np.concatenate([BM3_BOUNDARIES, [1000.0]])
    nan = np.full(tops.size, np.nan)
    return np.column_stack([tops, bottoms, nan, nan, BM3_RHOS])


def bm3_borehole() -> np.ndarray:
    diameter_mm = 2.0 * BM3_BH_RADIUS * 1000.0
    return np.array([[-1000.0, diameter_mm, BM3_MUD], [1000.0, diameter_mm, BM3_MUD]])


def _format(header, rows) -> str:
    lines = list(header)
    for row in rows:
        lines.append("\t".join("nan" if np.isnan(v) else f"{v:.4f}" for v in row))
    return "\n".join(lines) + "\n"


def render() -> dict[str, str]:
    """Relative path -> file text, for every generated input."""
    return {
        os.path.join("Example_01", "Formation.txt"): _format(
            FORMATION_HEADER, example01_formation()
        ),
        os.path.join("Example_01", "Borehole.txt"): _format(
            BOREHOLE_HEADER, example01_borehole()
        ),
        os.path.join("BM3", "Formation.txt"): _format(FORMATION_HEADER, bm3_formation()),
        os.path.join("BM3", "Borehole.txt"): _format(BOREHOLE_HEADER, bm3_borehole()),
    }


def path(*parts: str) -> str:
    """Absolute path of a generated input, e.g. ``path("BM3", "Formation.txt")``."""
    return os.path.join(HERE, *parts)


def main(out_dir: str = HERE) -> None:
    for rel, text in render().items():
        target = os.path.join(out_dir, rel)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(target, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
