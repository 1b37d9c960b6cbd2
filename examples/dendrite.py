"""Dendrite growth showcase: grow an anisotropic crystal and render it.

Usage:
    python examples/dendrite.py [--size 512] [--steps 20000] [--out dendrite.png]

Produces the classic 6-fold dendrite figure (temperature field + phase
interface overlay), the same experiment the reference's interactive viewer
shows, end-to-end.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import bachelors_tpu as bt
from bachelors_tpu.solvers.run import advance_n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--out", default="dendrite.png")
    ap.add_argument("--anisotropy", type=float, default=0.3)
    args = ap.parse_args()

    n = args.size
    p = bt.SimParams(
        nx=n, ny=n, L0=4.0, dt=5e-6,
        solver=bt.SolverType.EXPLICIT_RK4,
        S=args.anisotropy, m0=6.0,
        # slight undercooling drives growth
        Tm=1.0,
    )
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.05, circle_fade=1.0,
        inside_phi=1.0, outside_phi=0.0, inside_T=0.0, outside_T=0.0))
    state = bt.make_state(F, U, p)

    step = bt.make_stepper(p)
    adv = jax.jit(lambda s, k: advance_n(step, s, k))

    t0 = time.perf_counter()
    chunk = 2000
    done = 0
    while done < args.steps:
        k = min(chunk, args.steps - done)
        state = adv(state, k)
        done += k
        print(f"  {done}/{args.steps} steps, t={float(state.t):.4g}", flush=True)
    jax.block_until_ready(state.F)
    dt_wall = time.perf_counter() - t0
    print(f"{args.steps} steps of {n}^2 in {dt_wall:.1f}s "
          f"({dt_wall / args.steps * 1e3:.3f} ms/step)")

    import matplotlib

    matplotlib.use("Agg")
    from bachelors_tpu.postprocess.plots import plot_temperature_interface

    plot_temperature_interface(np.asarray(state.U), np.asarray(state.F),
                               p.L0, save=args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
