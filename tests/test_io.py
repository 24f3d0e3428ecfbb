# -*- coding: utf-8 -*-
"""Model I/O tests against the generated Example_01-class input files."""

import numpy as np
import pytest

from remo3d_jax import io as mio
from .conftest import input_path


def test_load_example01_formation():
    fm = mio.load_formation_parameters(
        input_path("Example_01", "Formation.txt")
    )
    assert fm.shape == (7, 5)
    assert np.isclose(fm[0, 0], 0.0) and np.isclose(fm[-1, 1], 25.0)
    # Layer 2 has an invasion zone of radius 0.3 m, rho 3 / 18 ohmm.
    assert np.isclose(fm[1, 2], 0.3)
    assert np.isclose(fm[1, 3], 3.0) and np.isclose(fm[1, 4], 18.0)
    # Contiguity: bottoms == next tops.
    assert np.allclose(fm[1:, 0], fm[:-1, 1])


def test_load_example01_borehole_diameter_to_radius_and_mm():
    bh = mio.load_borehole_parameters(
        input_path("Example_01", "Borehole.txt")
    )
    assert bh.shape[1] == 3
    # CALM column is in MM and is a diameter: 236.0941 mm -> radius 0.11804705 m.
    assert np.isclose(bh[0, 1], 236.0941 / 1000 / 2)
    assert np.isclose(bh[0, 2], 1.1)


def test_unit_conversion_and_validation():
    fm = np.array([[0.0, 1.0, np.nan, np.nan, 10.0], [1.0, 2.0, 0.2, 5.0, 20.0]])
    out = mio.set_formation_parameters(fm.copy(), ["M", "M", "M"])
    assert np.allclose(out[:, :2], fm[:, :2])

    out_ft = mio.set_formation_parameters(fm.copy(), ["FT", "FT", "M"])
    assert np.isclose(out_ft[1, 1], 2 * 0.3048)

    with pytest.raises(ValueError):
        mio.set_formation_parameters(fm.copy(), ["KM", "M", "M"])

    bad_geom = np.array([[0.0, 1.0, np.nan, np.nan, 10.0], [1.5, 2.0, np.nan, np.nan, 10.0]])
    with pytest.raises(ValueError):
        mio.set_formation_parameters(bad_geom)

    bad_res = np.array([[0.0, 1.0, np.nan, np.nan, -10.0]])
    with pytest.raises(ValueError):
        mio.set_formation_parameters(bad_res)


def test_borehole_validation():
    with pytest.raises(ValueError):
        mio.set_borehole_parameters(np.array([[0.0, 0.2, 1.0]]))
    bad_depths = np.array([[0.0, 0.2, 1.0], [0.0, 0.2, 1.0]])
    with pytest.raises(ValueError):
        mio.set_borehole_parameters(bad_depths)
    with pytest.raises(ValueError):
        mio.set_borehole_parameters(
            np.array([[0.0, 0.2, 1.0], [1.0, 0.2, 1.0]]), borehole_geometry_type="width"
        )
    ok = mio.set_borehole_parameters(
        np.array([[0.0, 0.2, 1.0], [1.0, 0.2, 1.0]]), borehole_geometry_type="radius"
    )
    assert np.isclose(ok[0, 1], 0.2)


def test_dip_validation():
    assert mio.set_dip(0) == (0, 0.0)
    deg, rad = mio.set_dip(30)
    assert np.isclose(rad, np.pi / 6)
    for bad in (-1, 90, 120):
        with pytest.raises(ValueError):
            mio.set_dip(bad)


def test_check_model_geometry():
    fm = np.array([[0.0, 2.0, 0.3, 5.0, 20.0]])
    bh_ok = np.array([[0.0, 0.1, 1.0], [2.0, 0.1, 1.0]])
    mio.check_model_geometry(fm, bh_ok)  # no raise
    bh_bad = np.array([[0.0, 0.35, 1.0], [2.0, 0.1, 1.0]])
    with pytest.raises(ValueError):
        mio.check_model_geometry(fm, bh_bad)


def test_add_points_to_borehole():
    bh = np.array([[0.0, 0.1, 1.0], [1.0, 0.2, 2.0]])
    dense = mio.add_points_to_borehole(bh)
    assert dense.shape[0] > 2
    assert np.all(np.diff(dense[:, 0]) <= 0.15 + 1e-12)
    # Endpoint values preserved; interior linearly interpolated.
    assert np.isclose(dense[0, 1], 0.1) and np.isclose(dense[-1, 1], 0.2)
    mid = dense[np.argmin(np.abs(dense[:, 0] - 0.5))]
    assert np.isclose(mid[1], 0.15, atol=0.01)


def test_generated_inputs_match_generator(tmp_path):
    """The committed input files are exactly what inputs/generate.py writes."""
    import importlib.util
    import os

    from .conftest import REPO_ROOT

    spec = importlib.util.spec_from_file_location(
        "generate", os.path.join(REPO_ROOT, "inputs", "generate.py")
    )
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    gen.main(str(tmp_path))
    for rel in gen.render():
        with open(tmp_path / rel) as fresh, open(input_path(rel)) as committed:
            assert fresh.read() == committed.read(), rel
    bm3 = mio.load_formation_parameters(input_path("BM3", "Formation.txt"))
    assert np.allclose(bm3[1, :2], [10.77, 14.23]) and np.allclose(bm3[:, 4], [10, 100, 10])
    bh = mio.load_borehole_parameters(input_path("BM3", "Borehole.txt"))
    assert np.allclose(bh[:, 1], 0.002) and np.allclose(bh[:, 2], 10.0)
