"""Built-in self tests (the ``[program] run_tests`` hook, `main.cpp:261-262`).

The full oracle suite lives in tests/ (pytest); this runs a fast in-process
subset mirroring the reference's ship-in-binary tests (`simulation.cu:1368`).
"""
from __future__ import annotations

import numpy as np

from ..core.params import BoundaryType, SimParams
from ..ops.rhs import eval_rhs
from ..ops.reductions import field_stats
from ..ops.stencil import CrossMatrix, cross_matvec
from ..parallel.topology import Topology
from ..solvers.cg import cg_solve
from ..utils.logging import get_logger

log = get_logger("selftest")


def run_selftests() -> bool:
    topo = Topology()
    rng = np.random.default_rng(0)
    ok = True

    # stencil RHS finite + antisymmetry of laplacian under constant shift
    p = SimParams(nx=32, ny=16)
    F = rng.random((16, 32)).astype(np.float32)
    U = rng.random((16, 32)).astype(np.float32)
    dF, dU = eval_rhs([(F, U)], [1.0], p, topo)
    ok &= bool(np.isfinite(np.asarray(dF)).all() and np.isfinite(np.asarray(dU)).all())

    # reductions vs numpy
    s = field_stats(F, topo)
    ok &= np.isclose(float(s.sum), F.sum(), rtol=1e-5)
    ok &= np.isclose(float(s.max), F.max())
    ok &= np.isclose(float(s.min), F.min())

    # CG on the implicit heat system
    pp = SimParams(nx=16, ny=16, dt=1e-4, T_boundary=BoundaryType.NEUMANN)
    A = CrossMatrix.implicit_heat(pp)
    xs = rng.random((16, 16)).astype(np.float32)
    b = cross_matvec(A, xs, topo)
    x, res = cg_solve(lambda v: cross_matvec(A, v, topo), b,
                      tolerance=1e-6, max_iters=200, topo=topo)
    ok &= bool(np.allclose(np.asarray(x), xs, atol=1e-3))

    (log.okay if ok else log.error)(f"selftests {'PASSED' if ok else 'FAILED'}")
    return ok
