# -*- coding: utf-8 -*-
"""Reduce a ``jax.profiler`` trace to device metrics.

A trace directory written by ``jax.profiler.start_trace`` (for example through
``Model.simulate_logs(profile_dir=...)``) holds
``plugins/profile/<run>/<host>.xplane.pb``. :func:`kernel_events` reads the
newest one with JAX's own reader and keeps the events that ran an XLA op on a
device; :func:`summarize` turns them into busy time, idle share, time per
named scope and the heaviest kernels.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from collections import defaultdict


@dataclasses.dataclass(frozen=True)
class KernelEvent:
    name: str
    start_ns: float
    duration_ns: float
    module: str  # the XLA module (jitted program) that launched it
    labels: str  # event name and every string stat, searched for scope names


def newest_xplane(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def kernel_events(trace_dir: str, plane_prefix: str = "/device:GPU") -> list[KernelEvent]:
    """Events of the planes named ``plane_prefix*`` that ran an XLA op.

    An event counts when it carries an ``hlo_op`` or ``hlo_module`` stat, or
    sits on a stream line of a device plane (kernels and copies).
    """
    from jax.profiler import ProfileData

    data = ProfileData.from_file(newest_xplane(trace_dir))
    out = []
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            on_stream = line.name.startswith("Stream")
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                if not (on_stream or "hlo_op" in stats or "hlo_module" in stats):
                    continue
                texts = [ev.name] + [str(v) for v in stats.values() if isinstance(v, str)]
                out.append(
                    KernelEvent(
                        name=ev.name,
                        start_ns=float(ev.start_ns),
                        duration_ns=float(ev.duration_ns),
                        module=str(stats.get("hlo_module", "")),
                        labels=" ".join(texts),
                    )
                )
    return out


def busy_ns(events: list[KernelEvent]) -> float:
    """Length of the union of the events' intervals."""
    total = 0.0
    end = -float("inf")
    for ev in sorted(events, key=lambda e: e.start_ns):
        a, b = ev.start_ns, ev.start_ns + ev.duration_ns
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def summarize(events: list[KernelEvent], scopes=(), top: int = 12) -> dict:
    """Busy time, span and idle share of the device, plus time per scope and
    per kernel. A scope's time sums the events whose labels contain it."""
    if not events:
        return {"n_events": 0, "busy_s": 0.0, "span_s": 0.0, "idle_share": None,
                "scopes": {s: {"seconds": 0.0, "events": 0} for s in scopes},
                "top_kernels": []}
    span = max(e.start_ns + e.duration_ns for e in events) - min(e.start_ns for e in events)
    busy = busy_ns(events)
    per_scope = {}
    for scope in scopes:
        hit = [e for e in events if scope in e.labels]
        per_scope[scope] = {
            "seconds": sum(e.duration_ns for e in hit) * 1e-9,
            "events": len(hit),
        }
    per_kernel = defaultdict(lambda: [0.0, 0])
    for e in events:
        acc = per_kernel[(e.module, e.name)]
        acc[0] += e.duration_ns
        acc[1] += 1
    heavy = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "n_events": len(events),
        "busy_s": busy * 1e-9,
        "span_s": span * 1e-9,
        "idle_share": 1.0 - busy / span if span > 0 else 0.0,
        "scopes": per_scope,
        "top_kernels": [
            {"module": m, "name": n, "seconds": t * 1e-9, "count": c}
            for (m, n), (t, c) in heavy
        ],
    }
