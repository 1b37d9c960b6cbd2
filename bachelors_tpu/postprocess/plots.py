"""Publication/diagnostic plots over run artifacts.

The analog of the reference's plotting suite (`plot.py:241-953`): per-map
heatmaps, side-by-side comparisons with difference panels, the
temperature + interface publication figure, step-residual convergence
plots, and benchmark bandwidth/runtime/scaling figures -- driven by
*measured* data (the reference hardcodes its tables, `plot.py:725-953`).

All functions return the matplotlib Figure; pass ``save=`` to write a file.
Import is lazy so headless/pipeline use never pays for matplotlib.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .colormap import science_colormap
from .interface import extract_interface, smooth_polyline
from .loaders import StatsTable


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, save: Optional[str]):
    if save:
        fig.savefig(save, bbox_inches="tight", dpi=150)
    return fig


def plot_map(field: np.ndarray, title: str = "", vmin: float = 0.0,
             vmax: float = 1.0, L0: float = 1.0, save: Optional[str] = None):
    """Single-field heatmap (`plot.py:241`)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(field, origin="lower", cmap=science_colormap(),
                   vmin=vmin, vmax=vmax, extent=(0, L0, 0, L0))
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    return _finish(fig, save)


def plot_comparison(a: np.ndarray, b: np.ndarray, names=("a", "b"),
                    L0: float = 1.0, save: Optional[str] = None):
    """Side-by-side + signed difference panel (`plot.py:257-300`)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(15, 4.4))
    for ax, f, n in zip(axes[:2], (a, b), names):
        im = ax.imshow(f, origin="lower", cmap=science_colormap(),
                       vmin=0, vmax=1, extent=(0, L0, 0, L0))
        ax.set_title(n)
        fig.colorbar(im, ax=ax)
    d = np.asarray(a) - np.asarray(b)
    lim = max(float(np.abs(d).max()), 1e-300)
    im = axes[2].imshow(d, origin="lower", cmap="RdBu_r", vmin=-lim, vmax=lim,
                        extent=(0, L0, 0, L0))
    axes[2].set_title(f"{names[0]} - {names[1]}")
    fig.colorbar(im, ax=axes[2])
    return _finish(fig, save)


def plot_temperature_interface(U: np.ndarray, Phi: np.ndarray, L0: float,
                               smooth: bool = True, save: Optional[str] = None):
    """Publication figure: temperature background + phi=0.5 front overlay +
    inset colorbar (`plot.py:436-494`)."""
    plt = _plt()
    ny, nx = np.asarray(U).shape
    dx, dy = L0 / nx, L0 / ny
    fig, ax = plt.subplots(figsize=(6.4, 6))
    im = ax.imshow(U, origin="lower", cmap=science_colormap(),
                   vmin=float(np.nanmin(U)), vmax=float(np.nanmax(U)),
                   extent=(0, L0, 0, L0))
    for line in extract_interface(Phi, 0.5, dx, dy):
        if smooth and len(line) >= 8:
            line = smooth_polyline(line)
        ax.plot(line[:, 0], line[:, 1], "k-", lw=1.2)
    cax = ax.inset_axes([0.04, 0.04, 0.3, 0.03])
    fig.colorbar(im, cax=cax, orientation="horizontal")
    ax.set_xlim(0, L0)
    ax.set_ylim(0, L0)
    return _finish(fig, save)


def plot_interface_overlay(fields: Dict[str, np.ndarray], L0: float,
                           save: Optional[str] = None):
    """Front outlines of several schemes on one axis (`plot.py:554-616`)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    for name, phi in fields.items():
        ny, nx = np.asarray(phi).shape
        first = True
        for line in extract_interface(phi, 0.5, L0 / nx, L0 / ny):
            ax.plot(line[:, 0], line[:, 1], lw=1.0,
                    label=name if first else None)
            first = False
    ax.legend()
    ax.set_aspect("equal")
    return _finish(fig, save)


def plot_step_residuals(stats: StatsTable, save: Optional[str] = None):
    """Corrector-loop residual convergence (`plot.py:695-723`)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    t = stats["time"]
    for s in range(stats.step_res_count):
        key = f"step_res_Lmax[{s}]"
        if key in stats.columns:
            ax.semilogy(t, stats[key], label=f"iteration {s}")
    ax.set_xlabel("simulation time")
    ax.set_ylabel("step residual (Lmax)")
    ax.legend()
    return _finish(fig, save)


def plot_delta_norms(stats: StatsTable, save: Optional[str] = None):
    """Per-step field delta norms over time."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for key in ("Phi_delta_L2", "T_delta_L2", "Phi_delta_Lmax", "T_delta_Lmax"):
        if key in stats.columns and len(stats[key]):
            ax.semilogy(stats["time"], np.abs(stats[key]) + 1e-300, label=key)
    ax.set_xlabel("simulation time")
    ax.legend()
    return _finish(fig, save)


def plot_reduction_bandwidth(results: Sequence[dict], save: Optional[str] = None):
    """GB/s vs N for the reduction microbenchmark (`plot.py:725-773`),
    from measured `bench.microbench` output."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ns = [r["n"] for r in results]
    for key in ("max_gbps", "fused_stats_gbps"):
        if key in results[0]:
            ax.plot(ns, [r[key] for r in results], "o-", label=key)
    ax.set_xscale("log")
    ax.set_xlabel("N (elements)")
    ax.set_ylabel("GB/s")
    ax.legend()
    return _finish(fig, save)


def plot_runtime_scaling(runtimes: Dict[str, Dict[int, float]],
                         reference: Optional[Dict[str, Dict[int, float]]] = None,
                         save: Optional[str] = None):
    """Total runtime vs grid size per solver, optionally against reference
    hardware numbers (`plot.py:777-898`).

    runtimes: {solver: {grid_n: seconds}}.
    """
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7.5, 5))
    for solver, table in runtimes.items():
        ns = sorted(table)
        ax.plot(ns, [table[n] for n in ns], "o-", label=solver)
    for solver, table in (reference or {}).items():
        ns = sorted(table)
        ax.plot(ns, [table[n] for n in ns], "s--", alpha=0.6,
                label=f"ref {solver}")
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.set_xlabel("grid side N")
    ax.set_ylabel("total runtime (s)")
    ax.legend(fontsize=8)
    return _finish(fig, save)
