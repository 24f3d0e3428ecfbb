# -*- coding: utf-8 -*-
"""Trace reduction (remo3d_jax/utils/trace.py) on synthetic events and on a
small trace recorded on the CPU."""

import jax
import jax.numpy as jnp
import pytest

from remo3d_jax.utils.trace import KernelEvent, busy_ns, kernel_events, summarize


def _ev(start, dur, name="k", labels=""):
    return KernelEvent(name=name, start_ns=start, duration_ns=dur, module="m",
                       labels=f"{name} {labels}")


def test_busy_union_and_summary():
    events = [
        _ev(0, 10, "a", "jit(f)/stencil3d_apply/mul"),
        _ev(5, 10, "b"),  # overlaps a: union 0..15
        _ev(30, 5, "a", "jit(f)/stencil3d_apply/add"),
    ]
    assert busy_ns(events) == 20
    s = summarize(events, scopes=["stencil3d_apply"])
    assert s["span_s"] == pytest.approx(35e-9)
    assert s["busy_s"] == pytest.approx(20e-9)
    assert s["idle_share"] == pytest.approx(15 / 35)
    assert s["scopes"]["stencil3d_apply"] == {"seconds": pytest.approx(15e-9), "events": 2}
    assert s["top_kernels"][0]["name"] == "a" and s["top_kernels"][0]["count"] == 2


def test_recorded_cpu_trace(tmp_path):
    """The reader finds the XLA ops of a jitted program in a real trace."""
    cpu = jax.devices("cpu")[0]
    x = jax.device_put(jnp.ones((256, 256)), cpu)

    @jax.jit
    def f(x):
        return jnp.cumsum(jnp.sin(x) * 2.0 + x[::-1], axis=0)

    f(x).block_until_ready()
    jax.profiler.start_trace(str(tmp_path))
    for _ in range(3):
        f(x).block_until_ready()
    jax.profiler.stop_trace()
    events = kernel_events(str(tmp_path), plane_prefix="/host:CPU")
    mine = [e for e in events if e.module == "jit_f"]
    assert len(mine) >= 3
    s = summarize(mine)
    assert 0 < s["busy_s"] <= s["span_s"]
    assert s["top_kernels"][0]["module"] == "jit_f"
