"""Reduction micro-benchmark (the ``run_benchmarks`` hook).

The analog of the reference's reduction benchmark sweep
(`simulation.cu:1300-1358`): f32 max-reduce bandwidth over a size sweep,
racing two implementations the way the reference races CPU vs thrust vs
its custom tree:
  * plain ``jnp.max`` (XLA reduction emitter),
  * the production fused {sum,L1,L2,min,max} stats pass (XLA,
    `ops/reductions.field_stats`),
reported in GB/s (the reference's custom tree peaks at 68 GB/s on consumer
hardware, `plot.py:731-733`).

``python -m bachelors_tpu.bench.microbench [fig.png]`` runs the sweep and
regenerates the bandwidth figure from live results
(`postprocess.plots.plot_reduction_bandwidth`).

Timing: per-dispatch overhead dwarfs the small kernels, so each
measurement chains many reductions inside one device-side fori_loop and
subtracts a short-loop run.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.reductions import field_stats
from ..parallel.topology import Topology
from ..utils.logging import get_logger

log = get_logger("bench")


def _sync(x):
    jax.block_until_ready(x)


def _loop_time(fn, x, iters: int) -> float:
    """Seconds per fn(x) via chained device-side loop, dispatch-corrected.

    The input is perturbed by one in-place scalar poke per iteration (free:
    the while-loop carry aliases in place) so XLA cannot hoist the
    loop-invariant reduction out of the loop.
    """

    def body(_i, carry):
        x, acc = carry
        acc = acc + fn(x)
        x = x.at[0].set(x[0] + acc * 1e-38)
        return (x, acc)

    run = jax.jit(lambda a, k: lax.fori_loop(
        0, k, body, (a, jnp.zeros((), a.dtype)))[1])
    _sync(run(x, 4))  # compile

    def best_of(k, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            _sync(run(x, k))
            best = min(best, time.perf_counter() - t0)
        return best

    # two loop lengths; the difference cancels dispatch/sync overhead, and
    # min-of-3 suppresses host jitter
    t1 = best_of(iters)
    t2 = best_of(2 * iters)
    return max((t2 - t1) / iters, 1e-12)


def run_reduction_benchmark(n_max: int = 2 * 4096 * 4096) -> list:
    sizes = []
    n = 256 * 256
    while n <= n_max:
        sizes.append(n)
        n *= 4
    if not sizes:
        sizes = [n_max]

    topo = Topology()
    results = []
    key = jax.random.PRNGKey(0)
    for n in sizes:
        x = jax.random.uniform(key, (n,), jnp.float32)
        # target ~8 GB of traffic per timed loop so device time dominates
        # the host's timing jitter
        iters = max(64, min(40000, (8 << 30) // (n * 4)))

        t_max = _loop_time(lambda a: jnp.max(a), x, iters)
        t_stats = _loop_time(lambda a: field_stats(a, topo).L2, x, iters)

        bytes_ = n * 4
        r = dict(n=n,
                 max_gbps=bytes_ / t_max / 1e9,
                 fused_stats_gbps=bytes_ / t_stats / 1e9)
        results.append(r)
        log.info(f"reduce n={n}: max {r['max_gbps']:.1f} GB/s, "
                 f"fused stats {r['fused_stats_gbps']:.1f} GB/s")
    return results


def run_ensemble_benchmark(mesh_size: int = 256, batches=(1, 4, 16, 64),
                           steps: int = 200) -> list:
    """Data-parallel throughput: B independent simulations advanced as one
    vmapped program (the ensemble axis, `[tpu] ensemble`).

    The reference's only counterpart is running config files sequentially
    (`main.cpp:244`); here the whole ensemble rides one device, so small
    grids that underutilize the device recover member throughput.
    Reports member-steps/s for the adaptive RKM solver (the default-config
    solver) at each batch size.
    """
    import numpy as np

    import bachelors_tpu as bt
    from ..solvers.base import make_stepper
    from ..solvers.run import advance_n

    p = bt.SimParams(nx=mesh_size, ny=mesh_size, L0=4.0 * mesh_size / 512,
                     solver=bt.SolverType.EXPLICIT_RK4_ADAPTIVE,
                     dt=5e-6, S=0.0, dtype="float32", min_dt=1e-9)
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(p.L0 / 2, p.L0 / 2), circle_radius=p.L0 / 80))
    base = bt.make_state(F, U, p)
    step = jax.vmap(make_stepper(p))

    results = []
    small = max(2, steps // 8)
    for B in batches:
        st = jax.tree.map(lambda a: jnp.stack([a] * B), base)
        adv = jax.jit(lambda s, n: advance_n(step, s, n))
        _sync(adv(st, small).F)

        def run(k):
            t0 = time.perf_counter()
            _sync(adv(st, k).F)
            return time.perf_counter() - t0

        run(small)
        t = (run(steps) - run(small)) / (steps - small)
        if t <= 1e-7:
            # below the host's timing noise floor; don't report a bogus
            # throughput
            log.warn(f"ensemble B={B} {mesh_size}^2: below measurement "
                     "noise floor, increase `steps`")
            results.append(dict(batch=B, mesh=mesh_size,
                                member_steps_per_s=None, step_ms=None))
            continue
        r = dict(batch=B, mesh=mesh_size,
                 member_steps_per_s=B / t,
                 step_ms=t * 1e3)
        results.append(r)
        log.info(f"ensemble B={B} {mesh_size}^2 RKM: {t * 1e3:.4f} ms/step "
                 f"({B / t:.0f} member-steps/s)")
    return results


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    results = run_reduction_benchmark()
    if argv:
        from ..postprocess.plots import plot_reduction_bandwidth

        plot_reduction_bandwidth(results, save=argv[0])
        log.info(f"bandwidth figure written to {argv[0]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
