"""Matrix-free conjugate gradient as an on-device ``lax.while_loop``.

Semantics mirror the reference GPU CG (`simulation.cu:596-690`):
  * scaled tolerance: stop when <r,r> < tol^2 * N       (`simulation.cu:608`)
  * epsilon-guarded divisions                            (`simulation.cu:657,671`)
  * optional warm start                                  (`simulation.cu:628-638`)
  * reported ``iters`` is the loop index at the break (converged) or
    max_iters (diverged); ``converged = iters != max_iters``
                                                         (`simulation.cu:680-684`)

The key structural difference: the reference reads each dot product back to
the host to decide convergence (`simulation.cu:656,664` -> host scalar every
iteration).  Here the whole loop -- matvec, dots, axpys, convergence test --
stays on device inside one jitted while_loop; on a mesh the dots are psum
collectives (``topo.dot``), so a sharded CG iteration is one halo exchange
plus two all-reduces with no host round-trips.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..parallel.topology import Topology


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CGResult:
    error: Any
    iters: Any
    converged: Any


def cg_solve(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    tolerance: float = 1.0e-5,
    max_iters: int = 10,
    epsilon: float = 1.0e-10,
    topo: Topology = Topology(),
    diag: Optional[jnp.ndarray] = None,
):
    """Solve A x = b.  Returns (x, CGResult).

    ``diag``, when given, enables Jacobi (diagonal) preconditioning with
    M = diag(diag): search directions use z = r / diag and the alpha/beta
    ratios use <r, z>, while the stopping test stays on <r, r> (the
    reference's convergence semantics, `simulation.cu:608,656`).  Useful
    when the operator diagonal varies per cell (the anisotropic phase
    system, `ops/stencil.AnisotropyMatrix`); a constant diag reproduces
    plain CG exactly.
    """
    if diag is not None:
        return _pcg_solve(matvec, b, x0, diag=diag, tolerance=tolerance,
                          max_iters=max_iters, epsilon=epsilon, topo=topo)
    dtype = b.dtype
    N = topo.count(b).astype(dtype)
    scaled_tol2 = jnp.asarray(tolerance, dtype) ** 2 * N
    eps = jnp.asarray(epsilon, dtype)

    if x0 is not None:
        x = x0
        r = b - matvec(x0)
        p = r
        rr = topo.dot(r, r)
    else:
        x = jnp.zeros_like(b)
        r = b
        p = b
        rr = topo.dot(b, b)

    def cond(carry):
        x, r, p, rr, it, stop = carry
        return jnp.logical_and(jnp.logical_not(stop), it < max_iters)

    def body(carry):
        x, r, p, rr, it, stop = carry
        Ap = matvec(p)
        pAp = topo.dot(p, Ap)
        alpha = rr / jnp.maximum(pAp, eps)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = topo.dot(r, r)
        done = rr_new < scaled_tol2
        beta = rr_new / jnp.maximum(rr, eps)
        p_next = jnp.where(done, p, r + beta * p)
        it_next = jnp.where(done, it, it + 1)
        return (x, r, p_next, rr_new, it_next, done)

    init = (x, r, p, rr, jnp.zeros((), jnp.int32), jnp.zeros((), bool))
    x, r, p, rr, it, stop = lax.while_loop(cond, body, init)

    res = CGResult(
        error=jnp.sqrt(rr / N),
        iters=it,
        converged=it != max_iters,
    )
    return x, res


def _pcg_solve(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    diag: jnp.ndarray,
    tolerance: float = 1.0e-5,
    max_iters: int = 10,
    epsilon: float = 1.0e-10,
    topo: Topology = Topology(),
):
    """Jacobi-preconditioned CG (see ``cg_solve``'s ``diag`` argument)."""
    dtype = b.dtype
    N = topo.count(b).astype(dtype)
    scaled_tol2 = jnp.asarray(tolerance, dtype) ** 2 * N
    eps = jnp.asarray(epsilon, dtype)
    inv_d = 1.0 / diag

    if x0 is not None:
        x = x0
        r = b - matvec(x0)
    else:
        x = jnp.zeros_like(b)
        r = b
    z = r * inv_d
    p = z
    rr = topo.dot(r, r)
    rz = topo.dot(r, z)

    def cond(carry):
        x, r, p, rr, rz, it, stop = carry
        return jnp.logical_and(jnp.logical_not(stop), it < max_iters)

    def body(carry):
        x, r, p, rr, rz, it, stop = carry
        Ap = matvec(p)
        pAp = topo.dot(p, Ap)
        alpha = rz / jnp.maximum(pAp, eps)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = topo.dot(r, r)
        done = rr_new < scaled_tol2
        z = r * inv_d
        rz_new = topo.dot(r, z)
        beta = rz_new / jnp.maximum(rz, eps)
        p_next = jnp.where(done, p, z + beta * p)
        it_next = jnp.where(done, it, it + 1)
        return (x, r, p_next, rr_new, rz_new, it_next, done)

    init = (x, r, p, rr, rz, jnp.zeros((), jnp.int32), jnp.zeros((), bool))
    x, r, p, rr, rz, it, stop = lax.while_loop(cond, body, init)
    return x, CGResult(error=jnp.sqrt(rr / N), iters=it,
                       converged=it != max_iters)


def cg_solve_diff(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    tolerance: float = 1.0e-5,
    max_iters: int = 10,
    epsilon: float = 1.0e-10,
    topo: Topology = Topology(),
):
    """Reverse-mode-differentiable CG via ``lax.custom_linear_solve``.

    The operators here are symmetric, so the adjoint system A^T lam = g is
    solved with the SAME CG (implicit-function-theorem gradients -- no
    differentiation through the iteration itself), and gradients w.r.t.
    parameters closed over by ``matvec`` (e.g. the anisotropy map s) flow
    automatically.  Iteration-count diagnostics are not available on this
    path (custom_linear_solve returns only x); ``CGResult.error`` is
    recomputed from the true residual and ``iters`` is reported as -1.
    Used when ``SimParams.differentiable`` is set; the default path is
    ``cg_solve`` (exact reference diagnostics).
    """
    from jax import lax

    def solve(mv, rhs):
        x, _res = cg_solve(mv, rhs, x0=x0, tolerance=tolerance,
                           max_iters=max_iters, epsilon=epsilon, topo=topo)
        return x

    def transpose_solve(mv, rhs):
        # the adjoint RHS is gradient-like: the field warm start would be a
        # poor (potentially harmful under an iteration cap) initial guess
        x, _res = cg_solve(mv, rhs, x0=None, tolerance=tolerance,
                           max_iters=max_iters, epsilon=epsilon, topo=topo)
        return x

    x = lax.custom_linear_solve(matvec, b, solve=solve,
                                transpose_solve=transpose_solve,
                                symmetric=True)
    r = b - matvec(x)
    N = topo.count(b).astype(b.dtype)
    res = CGResult(error=jnp.sqrt(topo.dot(r, r) / N),
                   iters=jnp.asarray(-1, jnp.int32),
                   converged=jnp.asarray(True))
    return x, res
