"""Memory roofline of the hot kernels, measured on the card in one process.

Every kernel of the solvers is memory-bound, so its roofline share is the
bytes the algorithm must move over the time it takes, against two rates:
a plain copy timed in the same process, and the card's published peak
(``PEAKS``, keyed by ``device_kind``; a device missing from the table is
an error).  Measured:

* one explicit RHS stage (``ops.rhs.eval_rhs``) for 1..4 blended states,
  the shapes RK4 and RKM stages take; its floor reads the blended fields
  and writes dPhi and dT: (2 * states + 2) words per cell;
* one plain CG iteration of the implicit heat system
  (``solvers.cg.cg_solve``); its floor is ``CG_ITER_WORDS_PER_CELL``;
* a device trace of a few RK4 and RKM steps, reduced to per-kernel device
  time and the device's busy share (``kernel_table``).

    python -m bachelors_tpu.bench.roofline [--sizes 2048 8192] [--out F]

prints one JSON object (and writes it to ``--out``).  It needs a GPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import time
from typing import Dict, List

import jax
import jax.numpy as jnp
from jax import lax

# Published peak rates, keyed by jax's device_kind (NVIDIA's data sheets,
# SXM parts, at the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12,
                                  source="NVIDIA H100 SXM5 data sheet"),
}

# The least traffic of one CG iteration, in words per cell: its two global
# reductions split it into two passes at best -- pass 1 forms
# p = r + beta p and <p, A p> (reads r, p; writes p), pass 2 updates x and
# r from a recomputed A p and forms <r, r> (reads x, r, p; writes x, r).
CG_ITER_WORDS_PER_CELL = 8

# per-call loop lengths: long enough that device time dominates dispatch
COPY_REPS = 20
CG_DEEP, CG_SHALLOW = 24, 4


def peak(device) -> dict:
    kind = device.device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peak for device_kind {kind!r}; add it "
                       "to bench.roofline.PEAKS with its source")
    return PEAKS[kind]


def timed(fn, *args, reps: int = 5) -> float:
    """Median seconds of ``fn(*args)`` (after one warm call), each timing
    ending in block_until_ready."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _fields(n: int, count: int, dtype, seed: int = 0):
    key = jax.random.PRNGKey(seed)
    return [jax.random.uniform(k, (n, n), dtype)
            for k in jax.random.split(key, count)]


def copy_rate(n: int, dtype=jnp.float32) -> float:
    """Bytes/s of an elementwise read-modify-write pass over an (n, n)
    array: the plain copy every kernel here is measured against."""
    (x,) = _fields(n, 1, dtype)
    run = jax.jit(lambda v: lax.fori_loop(
        0, COPY_REPS, lambda _i, v: v * 0.5 + 0.25, v))
    t = timed(run, x) / COPY_REPS
    return 2 * n * n * x.dtype.itemsize / t


def stage_time(n: int, n_states: int, S: float = 0.25,
               dtype: str = "float32") -> Dict:
    """One RHS stage at the blend of ``n_states`` states, ladder geometry."""
    from ..core.params import SimParams
    from ..ops.rhs import eval_rhs
    from ..parallel.topology import Topology

    p = SimParams(nx=n, ny=n, L0=4.0 * n / 512, S=S, dtype=dtype)
    fields = _fields(n, 2 * n_states, jnp.dtype(dtype))
    weights = [1.0] + [1e-6 * (i + 1) for i in range(n_states - 1)]
    fn = jax.jit(lambda *fs: eval_rhs(
        [(fs[2 * i], fs[2 * i + 1]) for i in range(n_states)], weights, p,
        Topology()))
    t = timed(fn, *fields)
    words = 2 * n_states + 2
    return dict(states=n_states, seconds=t,
                floor_bytes=words * n * n * jnp.dtype(dtype).itemsize)


def cg_iter_time(n: int, dtype: str = "float32") -> Dict:
    """One plain CG iteration of the implicit heat system, ladder dx."""
    from ..core.params import SimParams
    from ..ops.stencil import CrossMatrix, cross_matvec
    from ..parallel.topology import Topology
    from ..solvers.cg import cg_solve

    p = SimParams(nx=n, ny=n, L0=4.0 * n / 512, dtype=dtype)
    A = CrossMatrix.implicit_heat(p)
    (b,) = _fields(n, 1, jnp.dtype(dtype))

    def solver(iters):
        # tolerance 0 never converges: exactly `iters` iterations
        return jax.jit(lambda b: cg_solve(
            lambda v: cross_matvec(A, v, Topology()), b, tolerance=0.0,
            max_iters=iters)[0])

    t = (timed(solver(CG_DEEP), b) - timed(solver(CG_SHALLOW), b)) / (
        CG_DEEP - CG_SHALLOW)
    return dict(seconds=t, floor_bytes=CG_ITER_WORDS_PER_CELL * n * n
                * jnp.dtype(dtype).itemsize)


def kernel_table(xplane_path: str, top: int = 12) -> Dict:
    """Reduce a jax.profiler trace to per-kernel device time.

    Reads the device planes (``/device:...``): kernel events are summed by
    name over every line, and the device's busy time is the union of the
    kernel intervals over the window from the first kernel's start to the
    last one's end.  Returns {"window_ns", "busy_ns", "idle_share",
    "kernels": [{"name", "count", "total_ns"}, ...] (longest first)}."""
    from jax.profiler import ProfileData

    out = reduce_planes(ProfileData.from_file(xplane_path).planes, top)
    if out is None:
        raise ValueError(f"{xplane_path}: no device kernel events")
    return out


def reduce_planes(planes, top: int = 12):
    """``kernel_table`` on already-read planes (objects with ``.name`` and
    ``.lines``; lines with ``.name`` and ``.events``; events with ``.name``,
    ``.start_ns`` and ``.duration_ns``).  None when no device event."""
    totals: Dict[str, List[float]] = {}
    intervals = []
    for plane in planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            # per-op summary lines repeat the kernels' time; count the
            # streams only
            if line.name in ("XLA Ops", "XLA Modules", "Steps",
                             "TensorFlow Ops", "Framework Ops"):
                continue
            for ev in line.events:
                if ev.duration_ns <= 0:
                    continue
                c = totals.setdefault(ev.name, [0, 0.0])
                c[0] += 1
                c[1] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        return None
    intervals.sort()
    busy, cur_s, cur_e = 0.0, intervals[0][0], intervals[0][1]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _s, e in intervals) - intervals[0][0]
    kernels = sorted(({"name": k, "count": v[0], "total_ns": v[1]}
                      for k, v in totals.items()),
                     key=lambda r: -r["total_ns"])
    return dict(window_ns=window, busy_ns=busy,
                idle_share=1 - busy / window if window else 0.0,
                kernels=kernels[:top])


def trace_steps(solver: str, n: int, steps: int, logdir: str) -> Dict:
    """Trace ``steps`` steps of ``solver`` (ladder geometry, S=0.25, f32)
    run in one dispatch, and reduce the trace."""
    import bachelors_tpu as bt
    from ..solvers.run import advance_n
    from ..utils.profiling import device_trace

    p = bt.SimParams(nx=n, ny=n, L0=4.0 * n / 512, S=0.25, dt=5e-6,
                     min_dt=1e-9, Phi_tolerance=1e-5, T_tolerance=1e-5,
                     solver=bt.SolverType(solver), dtype="float32")
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(p.L0 / 2, p.L0 / 2), circle_radius=p.L0 / 20,
        circle_fade=1.0))
    st = bt.make_state(F, U, p)
    step = bt.make_stepper(p)
    adv = jax.jit(lambda s, k: advance_n(step, s, k))
    jax.block_until_ready(adv(st, steps))
    os.makedirs(logdir, exist_ok=True)
    with device_trace(logdir):
        jax.block_until_ready(adv(st, steps))
    path = max(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                      "*.xplane.pb")), key=os.path.getmtime)
    out = kernel_table(path)
    out.update(solver=solver, grid=n, steps=steps)
    return out


def measure(sizes=(2048, 8192), trace_dir: str = "") -> Dict:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"roofline: needs a GPU, JAX found {dev.platform!r}")
    pk = peak(dev)
    out = dict(device=dict(platform=dev.platform, kind=dev.device_kind,
                           count=len(jax.devices())),
               peak_hbm_bytes_per_s=pk["hbm_bytes_per_s"],
               peak_source=pk["source"], sizes={})
    for n in sizes:
        copy = copy_rate(n)
        row = dict(copy_bytes_per_s=copy, stages=[], cg=None, traces=[])
        for k in (1, 2, 3, 4):
            st = stage_time(n, k)
            rate = st["floor_bytes"] / st["seconds"]
            st.update(bytes_per_s=rate, copy_share=rate / copy,
                      peak_share=rate / pk["hbm_bytes_per_s"])
            row["stages"].append(st)
        cg = cg_iter_time(n)
        rate = cg["floor_bytes"] / cg["seconds"]
        cg.update(bytes_per_s=rate, copy_share=rate / copy,
                  peak_share=rate / pk["hbm_bytes_per_s"])
        row["cg"] = cg
        if trace_dir:
            for solver in ("explicit-rk4", "explicit-rk4-adaptive"):
                row["traces"].append(trace_steps(
                    solver, n, 8, os.path.join(trace_dir, f"{solver}_{n}")))
        out["sizes"][str(n)] = row
    return out


def main(argv=None) -> int:
    from ..app.driver import _default_compile_cache

    ap = argparse.ArgumentParser(prog="python -m bachelors_tpu.bench.roofline")
    ap.add_argument("--sizes", type=int, nargs="+", default=[2048, 8192])
    ap.add_argument("--out", default="")
    ap.add_argument("--trace-dir", default="",
                    help="also trace RK4 and RKM steps into this directory")
    args = ap.parse_args(argv)
    _default_compile_cache()
    res = measure(args.sizes, args.trace_dir)
    text = json.dumps(res, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    for n, row in res["sizes"].items():
        print(f"{n}^2 copy {row['copy_bytes_per_s'] / 1e9:.1f} GB/s")
        for st in row["stages"]:
            print(f"  rhs stage, {st['states']} state(s): "
                  f"{st['seconds'] * 1e3:.4f} ms, "
                  f"{st['bytes_per_s'] / 1e9:.1f} GB/s floor-bytes rate = "
                  f"{st['copy_share']:.3f} of copy, "
                  f"{st['peak_share']:.3f} of peak")
        cg = row["cg"]
        print(f"  cg iteration: {cg['seconds'] * 1e3:.4f} ms, "
              f"{cg['bytes_per_s'] / 1e9:.1f} GB/s = "
              f"{cg['copy_share']:.3f} of copy, {cg['peak_share']:.3f} of peak")
        for tr in row["traces"]:
            print(f"  trace {tr['solver']} x{tr['steps']}: idle share "
                  f"{tr['idle_share']:.3f}; top kernels:")
            for k in tr["kernels"][:6]:
                print(f"    {k['total_ns'] / 1e6:9.3f} ms  x{k['count']:<5d} "
                      f"{k['name'][:90]}")
    print(json.dumps({"device": res["device"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
