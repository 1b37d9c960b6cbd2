"""Inverse design by differentiating through the simulation.

Optimizes the initial undercooling field so that after a fixed rollout the
solid phase fraction hits a target -- gradient descent straight through the
coupled PDE integrator (the steppers are pure jittable functions, so
``jax.grad`` of the rollout is exact).  Nothing comparable is expressible
in the reference CUDA architecture.

Usage: python examples/inverse_design.py [--target 0.12] [--iters 30]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import bachelors_tpu as bt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", type=float, default=0.04)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.02)
    args = ap.parse_args()

    p = bt.SimParams(nx=96, ny=96, L0=4.0, dt=5e-6, S=0.25, m0=6.0,
                     solver=bt.SolverType.EXPLICIT_EULER,
                     dtype="float32")
    F0, U_init = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.4, circle_fade=6.0))
    step = bt.make_stepper(p)

    def phase_fraction_after_rollout(U0):
        st = bt.make_state(F0, U0, p)

        # lax.scan keeps the rollout rolled (fast compile) and supports
        # reverse-mode (fori_loop does not)
        def body(s, _):
            s2, _stats = step(s)
            return s2, None

        st, _ = jax.lax.scan(body, st, None, length=args.steps)
        return jnp.mean(st.F)

    @jax.jit
    def loss_and_grad(U0):
        def loss(u):
            return (phase_fraction_after_rollout(u) - args.target) ** 2

        return jax.value_and_grad(loss)(U0)

    U0 = jnp.asarray(U_init)
    frac0 = float(phase_fraction_after_rollout(U0))
    print(f"initial phase fraction after rollout: {frac0:.5f} "
          f"(target {args.target})")

    for it in range(args.iters):
        l, g = loss_and_grad(U0)
        # normalized gradient step: lr is in temperature units
        U0 = U0 - args.lr * g / jnp.maximum(jnp.abs(g).max(), 1e-30)
        if it % 5 == 0 or it == args.iters - 1:
            print(f"  iter {it:3d}: loss {float(l):.3e}")

    frac = float(phase_fraction_after_rollout(U0))
    print(f"optimized phase fraction: {frac:.5f} "
          f"(|error| {abs(frac - args.target):.2e})")
    print(f"initial-field change: max |dU| = "
          f"{float(jnp.abs(U0 - U_init).max()):.4f}")


if __name__ == "__main__":
    main()
