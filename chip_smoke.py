#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the resistivity-log solver on NVIDIA GPUs, at production width.

Drives ``Model`` the way a user does and checks every result against the
repository's own references. Phases:

* device: ``jax.devices()``, the device kind, and the card's name and power
  limit from ``nvidia-smi``. Fails unless JAX's default platform is "gpu".
* 2d: an Example_01-class log (inputs/Example_01): six tools at 251 depths,
  0-25 m at 0.1 m, default GridSpec2D (761x161) and default solver picks.
  Cold run, then a warm run; prints readouts/s, CG iterations per chunk,
  failed solves and peak device memory. Requires 0 NaN and 0 failed solves,
  and agreement to 1e-3 relative with platform="cpu" at 4 depths x 6 tools on
  the same grid (the CPU path shares the discretization, not the solver).
* 3d: the Benchmark model 3 stack at dip 30 deg (inputs/BM3, needle borehole,
  domain radius 150 m): tool A2.0M0.5N at 100 depths, 5.0-29.75 m at 0.25 m,
  default GridSpec3D (193x17x49). Requires 0 NaN and a maximum deviation of
  1.0% from the rotated layered-medium oracle (benchmarks/bm3_oracle.py).
* applies (one card only): a profiler trace of a third, traced run of each
  log, reduced to device busy time and the time of the named scopes
  ``stencil2d_apply_*`` / ``stencil3d_apply``; and each stencil apply timed
  alone at the run's chunk shape, with its bytes moved (coefficient planes
  plus u in and y out) over that time against the HBM peak.
* kernel (one card only): the half-plane 3D apply that the CG uses on the
  GPU (ExecutorConfig.stencil3d="half") against the plain 27-plane apply:
  agreement to 2e-5 relative at the chunk shape, both timed alone in turns,
  then the warm 3D log with each operator in turns.

With ``--four-cards`` only the 2d and 3d phases run, with their CPU and oracle
comparisons, sharded over four cards; the script asserts four devices.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failure raises, so the script exits non-zero and prints no such line.

Usage: python chip_smoke.py [--four-cards] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# HBM bandwidth by device kind (NVIDIA H100 SXM data sheet: 3.35 TB/s).
HBM_PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

TOOLS_2D = ["B5.7A0.4M", "B4.48A1.62M", "M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A", "M4.0A0.5B"]
DEPTHS_2D = np.round(0.1 * np.arange(251), 4)
# One depth inside each of layers 0, 1, 3 and 5 (the invaded beds among them).
CHECK_DEPTHS_2D = np.array([2.0, 6.0, 12.5, 20.5])
TOOL_3D = "A2.0M0.5N"
DIP_3D = 30.0
DEPTHS_3D = np.round(5.0 + 0.25 * np.arange(100), 4)
RTOL_CPU_2D = 1e-3  # GPU summation order on top of the 2.2e-4 f32-vs-f64 gap
RTOL_ORACLE_3D = 1e-2


def log(msg: str = "") -> None:
    print(msg, flush=True)


def device_phase(want: int) -> dict:
    import jax

    devices = jax.devices()
    log(f"jax {jax.__version__} devices: {devices}")
    d0 = devices[0]
    if d0.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX default platform is {d0.platform!r})")
    if len(devices) != want:
        raise SystemExit(f"chip_smoke: need {want} GPU(s), JAX sees {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip() or smi.stderr.strip()
    log(f"device_kind: {d0.device_kind}")
    log(f"nvidia-smi name, power.limit: {card}")
    log(f"default matmul precision: {jax.config.jax_default_matmul_precision}")
    return {"platform": d0.platform, "kind": d0.device_kind, "count": len(devices), "card": card}


def peak_bytes() -> int:
    import jax

    stats = [d.memory_stats() or {} for d in jax.devices()]
    return max(int(s.get("peak_bytes_in_use", 0)) for s in stats)


def new_model(tools, formation, borehole, dip=0.0):
    from remo3d_jax import Model

    m = Model(tools)
    m.set_model_parameters(formation, borehole, dip=dip)
    m.initialize_workers()
    return m


def timed_run(model, depths, **kw) -> float:
    t0 = time.perf_counter()
    model.simulate_logs(depths, verbose=False, **kw)
    return time.perf_counter() - t0


def logs_array(model, tools) -> np.ndarray:
    return np.stack([model.logs[t][:, 1] for t in tools], axis=1)


def run_report(model) -> dict:
    ex = model._executor
    rep = ex.last_report
    return {
        "chunk": rep["chunk"],
        "n_solve_slots": rep["n_solve_slots"],
        "mesh": rep["mesh"],
        "iterations_per_chunk": [c["iterations"] for c in rep["chunks"]],
        "n_failed_solves": rep["n_failed_solves"],
        "n_nan_readouts": rep["n_nan_readouts"],
        "phases_s": dict(ex.timers.seconds),
        "preconditioner": ex.config.preconditioner,
        "precond3d": ex.config.precond3d,
        "device_meshing": bool(ex.config.device_meshing),
    }


def log_phase(tag, n_readouts, cold, warm, rep) -> None:
    log(f"[{tag}] cold {cold:.3f} s, warm {warm:.3f} s, "
        f"{n_readouts / warm:.2f} readouts/s warm")
    log(f"[{tag}] chunk {rep['chunk']} x {rep['n_solve_slots']} solves, mesh {rep['mesh']}, "
        f"CG iterations per chunk {rep['iterations_per_chunk']}, "
        f"failed solves {rep['n_failed_solves']}, NaN readouts {rep['n_nan_readouts']}")
    log(f"[{tag}] phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in rep["phases_s"].items()))
    log(f"[{tag}] peak_bytes_in_use {peak_bytes()}")


def phase_2d() -> tuple[dict, object]:
    from inputs.generate import path

    files = (path("Example_01", "Formation.txt"), path("Example_01", "Borehole.txt"))
    m = new_model(TOOLS_2D, *files)
    cold = timed_run(m, DEPTHS_2D)
    warm = timed_run(m, DEPTHS_2D)
    rep = run_report(m)
    vals = logs_array(m, TOOLS_2D)
    log_phase("2d", vals.size, cold, warm, rep)
    assert vals.shape == (DEPTHS_2D.size, len(TOOLS_2D)), vals.shape
    assert rep["n_failed_solves"] == 0, rep
    assert np.isfinite(vals).all(), f"{np.isnan(vals).sum()} NaN readouts"

    # Plain reference: the same grid and discretization on the CPU, whose
    # default solver is the direct factorization. Both sides run the same
    # 4 depths, so their batches and meshes are identical.
    chk = new_model(TOOLS_2D, *files)
    chk.simulate_logs(CHECK_DEPTHS_2D, verbose=False)
    gpu = logs_array(chk, TOOLS_2D)
    ref = new_model(TOOLS_2D, *files)
    t0 = time.perf_counter()
    ref.simulate_logs(CHECK_DEPTHS_2D, verbose=False, platform="cpu")
    cpu_s = time.perf_counter() - t0
    cpu = logs_array(ref, TOOLS_2D)
    rel = float(np.max(np.abs(gpu / cpu - 1.0)))
    log(f"[2d] vs platform=cpu at {CHECK_DEPTHS_2D.tolist()} m x 6 tools: "
        f"max rel {rel:.3e} (limit {RTOL_CPU_2D:g}; CPU run {cpu_s:.1f} s)")
    assert np.isfinite(gpu).all() and np.isfinite(cpu).all()
    assert rel <= RTOL_CPU_2D, rel
    out = {"cold_s": cold, "warm_s": warm, "readouts_per_s": vals.size / warm,
           "max_rel_vs_cpu": rel, "peak_bytes_in_use": peak_bytes(), **rep}
    return out, m


def phase_3d() -> tuple[dict, object]:
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from bm3_oracle import DOMAIN_RADIUS, oracle_log

    from inputs.generate import path

    m = new_model([TOOL_3D], path("BM3", "Formation.txt"), path("BM3", "Borehole.txt"),
                  dip=DIP_3D)
    cold = timed_run(m, DEPTHS_3D, domain_radius=DOMAIN_RADIUS)
    warm = timed_run(m, DEPTHS_3D, domain_radius=DOMAIN_RADIUS)
    rep = run_report(m)
    vals = m.logs[TOOL_3D][:, 1]
    log_phase("3d", vals.size, cold, warm, rep)
    n_nan = int(np.isnan(vals).sum())
    assert n_nan == 0, f"{n_nan} NaN readouts"
    ana = oracle_log(TOOL_3D, DEPTHS_3D, DIP_3D)
    rel = np.abs(vals / ana - 1.0)
    log(f"[3d] vs rotated layered-medium oracle: max {rel.max() * 100:.3f}% "
        f"mean {rel.mean() * 100:.3f}% (limit {RTOL_ORACLE_3D * 100:g}%)")
    assert rel.max() <= RTOL_ORACLE_3D, rel.max()
    out = {"cold_s": cold, "warm_s": warm, "points_per_s": vals.size / warm,
           "max_rel_vs_oracle": float(rel.max()), "peak_bytes_in_use": peak_bytes(), **rep}
    return out, m


def time_apply(apply, C, u, reps: int = 10) -> float:
    """Seconds per apply: ``reps`` chained applies in one compiled program."""
    import jax

    @jax.jit
    def chain(C, u):
        for _ in range(reps):
            u = apply(C, u) * 1e-3  # keeps values finite; fuses into the apply
        return u

    chain(C, u).block_until_ready()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        chain(C, u).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best / reps


def traced_summary(model, depths, scopes, **kw) -> dict:
    from jax.profiler import ProfileData

    from remo3d_jax.utils.trace import kernel_events, newest_xplane, summarize

    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        model.simulate_logs(depths, verbose=False, profile_dir=trace_dir, **kw)
        summary = summarize(kernel_events(trace_dir), scopes=scopes)
        if not summary["n_events"]:
            planes = ProfileData.from_file(newest_xplane(trace_dir)).planes
            log("no device kernel events in the trace; planes and lines: " + "; ".join(
                f"{p.name}: {[ln.name for ln in p.lines][:6]}" for p in planes))
        return summary
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)


def log_trace(tag, summary) -> None:
    idle = summary["idle_share"]
    log(f"[{tag} trace] {summary['n_events']} device events, busy {summary['busy_s']:.3f} s "
        f"over {summary['span_s']:.3f} s"
        + (f" (idle {idle * 100:.1f}%)" if idle is not None else "")
        + f", scopes {summary['scopes']}")


def apply_report(tag, level_counts, busy_s, peak) -> dict:
    """level_counts: [(shape label, applies per run, seconds per apply, bytes per apply)]."""
    total = sum(n * t for _, n, t, _ in level_counts)
    rows = []
    for label, n, t, nbytes in level_counts:
        bw = nbytes / t
        rows.append({"grid": label, "applies": n, "seconds_per_apply": t,
                     "bytes_per_apply": nbytes, "bytes_per_s": bw,
                     "hbm_share": bw / peak if peak else None})
        share = f"{bw / peak * 100:.1f}% of HBM peak" if peak else "no HBM peak for this device"
        log(f"[{tag}] apply {label}: {n} applies x {t * 1e6:.1f} us, "
            f"{nbytes / 1e6:.1f} MB each, {bw / 1e9:.0f} GB/s ({share})")
    share = total / busy_s if busy_s else None
    log(f"[{tag}] stencil applies ~{total:.3f} s of {busy_s:.3f} s device busy"
        + (f" ({share * 100:.1f}%)" if share is not None else ""))
    return {"levels": rows, "apply_seconds": total, "share_of_busy": share}


# Coefficient planes each 3D operator reads per apply (ExecutorConfig.stencil3d).
STENCIL3D_PLANES = {"full": 27, "half": 14}


def symmetric_stencil3d(key, B, shape):
    """Random 27-point stencil with FEM symmetry C[n, d] == C[n + d, -d] and no
    coupling across the grid boundary, built on the device."""
    import jax
    import jax.numpy as jnp

    from remo3d_jax.ops.stencil3d import _FORWARD, DIAG, entry_index

    nz, np_, nr = shape
    zi = jnp.arange(nz)[:, None, None]
    pi = jnp.arange(np_)[None, :, None]
    ri = jnp.arange(nr)[None, None, :]
    keys = jax.random.split(key, len(_FORWARD) + 1)
    C = jnp.zeros((B,) + shape + (27,), jnp.float32)
    C = C.at[..., DIAG].set(30.0 + jax.random.uniform(keys[0], (B,) + shape))
    for k, (dz, dp, dr) in enumerate(_FORWARD, start=1):
        inside = ((zi + dz >= 0) & (zi + dz < nz) & (pi + dp >= 0) & (pi + dp < np_)
                  & (ri + dr >= 0) & (ri + dr < nr))
        h = jnp.where(inside, jax.random.normal(keys[k], (B,) + shape), 0.0)
        C = C.at[..., entry_index(dz, dp, dr)].set(h)
        # The neighbour's view: C[n, -d] = h[n - d].
        back = jnp.roll(h, (dz, dp, dr), axis=(1, 2, 3))
        C = C.at[..., entry_index(-dz, -dp, -dr)].set(jnp.where(
            (zi - dz >= 0) & (zi - dz < nz) & (pi - dp >= 0) & (pi - dp < np_)
            & (ri - dr >= 0) & (ri - dr < nr), back, 0.0))
    return C


def kernel_phase(m3d, B, S, shape) -> dict:
    """The half-plane 3D apply against the plain 27-plane apply at the run's
    chunk shape: agreement to 2e-5 relative, both timed alone in turns, then
    the warm 3D log run with each in turns."""
    import jax
    import jax.numpy as jnp

    from remo3d_jax.ops.stencil3d import half_planes, stencil3d_apply, stencil3d_apply_half

    key = jax.random.PRNGKey(1)
    C = symmetric_stencil3d(key, B, shape)
    u = jax.random.normal(key, (B, S) + shape)
    Ch = jax.jit(half_planes)(C)
    y_full = jax.jit(stencil3d_apply)(C, u)
    y_half = jax.jit(stencil3d_apply_half)(Ch, u)
    rel = float(jnp.max(jnp.abs(y_half - y_full)) / jnp.max(jnp.abs(y_full)))
    log(f"[kernel] half-plane vs 27-plane 3D apply at B={B}, S={S}, {shape}: max rel {rel:.2e}")
    assert rel <= 2e-5, rel
    times = {"full": [], "half": []}
    for name in ("full", "half", "half", "full"):
        if name == "full":
            times[name].append(time_apply(stencil3d_apply, C, u))
        else:
            times[name].append(time_apply(stencil3d_apply_half, Ch, u))
    log("[kernel] seconds per apply, in turns: "
        + ", ".join(f"{k} {[round(t * 1e6, 1) for t in v]} us" for k, v in times.items()))
    del C, u, Ch, y_full, y_half

    from bm3_oracle import DOMAIN_RADIUS

    def run(name):
        return timed_run(m3d, DEPTHS_3D, domain_radius=DOMAIN_RADIUS,
                         executor_overrides={"stencil3d": name})

    run("full")  # compile
    logs = {"full": [], "half": []}
    for name in ("full", "half", "half", "full"):
        logs[name].append(run(name))
    log("[kernel] warm 3D log seconds, in turns: "
        + ", ".join(f"{k} {[round(t, 3) for t in v]}" for k, v in logs.items()))
    return {"apply_s": times, "log_s": logs}


def applies_phase(kind, m2d, m3d) -> dict:
    import jax
    import jax.numpy as jnp

    from remo3d_jax.ops.multigrid import MGConfig
    from remo3d_jax.ops.stencil import stencil_apply

    peak = HBM_PEAK_BYTES_PER_S.get(kind)
    key = jax.random.PRNGKey(0)
    out = {}

    # 2D multigrid: applies per V-cycle level (pre + post Chebyshev steps and
    # the residual; the coarsest level runs coarse_degree steps), plus the CG
    # matvec on the finest level. Setup applies (power iteration, Galerkin
    # probes) are left out.
    trace2 = traced_summary(m2d, DEPTHS_2D, scopes=["stencil2d_apply"])
    ex = m2d._executor
    cfg, rep = ex.config, ex.last_report
    B, S = rep["chunk"], rep["n_solve_slots"]
    its = [c["iterations"] for c in rep["chunks"]]
    nz, nr = cfg.spec.nz, cfg.spec.nr
    mg = MGConfig()
    rows = []
    for lvl in range(4):
        nzl, nrl = (nz - 1) // 2**lvl + 1, (nr - 1) // 2**lvl + 1
        per_cycle = mg.coarse_degree if lvl == 3 else 2 * cfg.mg_degree + 1
        n = sum((it + 1) * per_cycle + (it if lvl == 0 else 0) for it in its)
        C = jax.random.normal(key, (B, nzl, nrl, 3, 3), jnp.float32)
        u = jax.random.normal(key, (B, S, nzl, nrl), jnp.float32)
        t = time_apply(stencil_apply, C, u)
        rows.append((f"{nzl}x{nrl}", n, t, 4 * (9 * B * nzl * nrl + 2 * B * S * nzl * nrl)))
        del C, u
    log_trace("2d", trace2)
    out["2d"] = {"trace": trace2, **apply_report("2d", rows, trace2["busy_s"], peak)}

    # 3D ADI: per CG iteration one matvec plus four inside the preconditioner
    # sweep, four more in the first preconditioner call, one in the load build.
    from bm3_oracle import DOMAIN_RADIUS

    trace3 = traced_summary(m3d, DEPTHS_3D, scopes=["stencil3d_apply"],
                            domain_radius=DOMAIN_RADIUS)
    ex = m3d._executor
    cfg, rep = ex.config, ex.last_report
    B, S = rep["chunk"], rep["n_solve_slots"]
    its = [c["iterations"] for c in rep["chunks"]]
    shape = (cfg.spec3d.nz, cfg.spec3d.np_, cfg.spec3d.nr)
    kernel = kernel_phase(m3d, B, S, shape)
    times = kernel["apply_s"]
    n = sum(5 * it + 5 for it in its)
    log_trace("3d", trace3)
    label = "x".join(map(str, shape))
    N = int(np.prod(shape))
    rows = [(f"{label} {cfg.stencil3d}", n, min(times[cfg.stencil3d]),
             4 * (STENCIL3D_PLANES[cfg.stencil3d] * B * N + 2 * B * S * N))]
    out["3d"] = {"trace": trace3, "kernel": kernel,
                 **apply_report("3d", rows, trace3["busy_s"], peak)}
    for tag in ("2d", "3d"):
        log(f"[{tag} trace] heaviest kernels:")
        for k in out[tag]["trace"]["top_kernels"]:
            log(f"    {k['seconds']:8.4f} s {k['count']:6d}x  {k['module']}  {k['name']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the 2d and 3d phases sharded over four cards")
    ap.add_argument("--out", help="directory for a JSON record of every phase")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    device = device_phase(n_cards)  # before importing the package: no GPU, no run
    sys.path.insert(0, ROOT)
    from remo3d_jax.meshing.native import native_available

    log("host grid builder: " + ("native C++ (native/)" if native_available()
                                 else "numpy (native build unavailable)"))
    record = {"device": device}
    record["2d"], m2d = phase_2d()
    record["3d"], m3d = phase_3d()
    if not args.four_cards:
        record["applies"] = applies_phase(device["kind"], m2d, m3d)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1, default=str)
    log(device["card"])
    result = {k: device[k] for k in ("platform", "kind", "count")}
    print(json.dumps({"ok": True, "device": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
