# -*- coding: utf-8 -*-
"""Task planner tests: SEC dedup, batching, offsets, readout mapping."""

import numpy as np

from remo3d_jax.planner import plan_tasks
from remo3d_jax.tools import parse_tools


def test_sec_dedup_merges_shared_depths():
    # Two tools whose current electrodes land on the same simulation depths.
    tools, sec = parse_tools(["A2.0M0.5N", "N0.5M2.0A"])
    assert sec
    depths = np.arange(0.0, 1.01, 0.1)
    sim_depths, tasks = plan_tasks(tools, sec, depths, batch_size=5)
    n_solves = sum(len(t.solves) for t in tasks)
    all_sim = np.unique(
        np.hstack(
            [np.round(depths + tools[n].depth_shift, 4) for n in tools]
        )
    )
    assert n_solves == all_sim.size
    # Every solve in SEC mode has exactly one unit source.
    for t in tasks:
        for s in t.solves:
            assert s.source_positions.shape[0] == 1
            assert np.allclose(s.source_terms, [1.0])


def test_batch_offsets_and_centers():
    tools, sec = parse_tools(["A2.0M0.5N"])
    depths = np.arange(0.0, 2.01, 0.1)  # 21 depths
    sim_depths, tasks = plan_tasks(tools, sec, depths, batch_size=5)
    assert len(tasks) == int(np.ceil(21 / 5))
    # Batch center equals the nanmean of its simulation depths.
    t0 = tasks[0]
    sims = np.round(depths[:5] + tools["A2.0M0.5N"].depth_shift, 4)
    assert np.isclose(t0.center_depth, np.round(np.mean(sims), 4))
    for s, d in zip(t0.solves, sims):
        # Source sits at the solve's offset from the batch center.
        assert np.isclose(s.source_positions[0], np.round(d - t0.center_depth, 4))


def test_readout_positions_track_tool_geometry():
    tools, sec = parse_tools(["A2.0M0.5N"])
    tp = tools["A2.0M0.5N"]
    depths = np.array([10.0])
    sim_depths, tasks = plan_tasks(tools, sec, depths, batch_size=1)
    assert len(tasks) == 1 and len(tasks[0].solves) == 1
    ro = tasks[0].solves[0].readouts[0]
    assert ro.measurement_index == 0 and ro.tool_index == 0
    meas = np.sort(ro.measuring_positions)
    expected = np.sort(tp.geometry[tp.source_terms == 0])  # offset is 0 (single depth)
    assert np.allclose(meas, expected)
    assert np.isclose(ro.geometric_factor, tp.geometric_factor)


def test_non_sec_one_solve_per_tool_per_depth():
    tools, sec = parse_tools(["B5.7A0.4M", "A2.0M0.5N"], force_single_electrode_configuration=False)
    assert not sec
    depths = np.arange(0.0, 0.51, 0.1)  # 6 depths
    sim_depths, tasks = plan_tasks(tools, sec, depths, batch_size=5)
    n_solves = sum(len(t.solves) for t in tasks)
    assert n_solves == 2 * 6
    # Two-current tool injects +1/-1.
    two_src = [s for t in tasks for s in t.solves if s.source_positions.shape[0] == 2]
    assert len(two_src) == 6
    for s in two_src:
        assert np.isclose(np.sum(s.source_terms), 0.0)


def test_electrode_union_covers_all_solve_electrodes():
    tools, sec = parse_tools(
        ["B5.7A0.4M", "B4.48A1.62M", "M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A", "M4.0A0.5B"]
    )
    depths = np.arange(0.0, 1.01, 0.1)
    _, tasks = plan_tasks(tools, sec, depths, batch_size=5)
    for t in tasks:
        for s in t.solves:
            for p in s.source_positions:
                assert np.any(np.isclose(t.electrode_positions, p))
            for ro in s.readouts:
                for p in ro.measuring_positions:
                    assert np.any(np.isclose(t.electrode_positions, p))


def test_nan_padding_partial_last_batch():
    tools, sec = parse_tools(["A2.0M0.5N"])
    depths = np.arange(0.0, 0.61, 0.1)  # 7 depths, batch 5 -> batches of 5 and 2
    _, tasks = plan_tasks(tools, sec, depths, batch_size=5)
    assert len(tasks) == 2
    assert len(tasks[0].solves) == 5
    assert len(tasks[1].solves) == 2
