"""Multi-process launcher: the analog of the reference's PBS qsub
generation (`benchmark_configs/generator.py:203-226`).

The reference submits single-GPU jobs to a PBS cluster; here the
deployment story has two shapes:

* **Clusters** (SLURM, k8s, OpenMPI): start the SAME driver command on
  every host and set ``[tpu] multihost = true`` (or
  ``--set tpu.multihost=true``); `jax.distributed.initialize()` autodetects
  the cluster (jax._src.clusters) and the existing mesh / shard_map
  machinery spans all hosts.

* **Local multi-process** (development, CI, single host): this module.
  ``python -m bachelors_tpu.launch -n 2 [--platform cpu --cpu-devices 2]
  config.ini [--set ...]`` spawns n driver processes wired into one
  jax.distributed cluster via the BTPU_* environment contract below; the
  primary process writes all artifacts.  Off the CPU platform each process
  is given its own GPU through ``CUDA_VISIBLE_DEVICES`` (process i takes
  the i-th visible card), since a JAX process preallocates most of the
  memory of every card it sees.

Environment contract (read by ``app.driver.main`` before any backend use):
  BTPU_COORD / BTPU_NPROCS / BTPU_PID   explicit jax.distributed wiring
  BTPU_PLATFORM                         force a jax platform
  BTPU_CPU_DEVICES                      virtual CPU device count per process
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import List, Optional


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def card_assignment(nprocs: int, visible: Optional[str]) -> List[str]:
    """The ``CUDA_VISIBLE_DEVICES`` value of each of ``nprocs`` processes:
    one card each, taken in order from ``visible`` (the launcher's own
    ``CUDA_VISIBLE_DEVICES``) or from cards 0..nprocs-1 when it is unset."""
    ids = ([c.strip() for c in visible.split(",") if c.strip()]
           if visible else [str(i) for i in range(nprocs)])
    if len(ids) < nprocs:
        raise ValueError(f"{nprocs} processes need {nprocs} cards, "
                         f"CUDA_VISIBLE_DEVICES lists {len(ids)}")
    return ids[:nprocs]


def launch(nprocs: int, argv: List[str], platform: Optional[str] = None,
           cpu_devices: int = 0, coordinator: Optional[str] = None) -> int:
    """Spawn ``nprocs`` driver processes; returns the worst exit code."""
    coord = coordinator or f"127.0.0.1:{find_free_port()}"
    # make the package importable from any cwd (it may not be pip-installed)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cards = card_assignment(nprocs, os.environ.get("CUDA_VISIBLE_DEVICES"))
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ,
                   BTPU_COORD=coord,
                   BTPU_NPROCS=str(nprocs),
                   BTPU_PID=str(pid),
                   PYTHONPATH=pkg_root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        if platform != "cpu":
            env["CUDA_VISIBLE_DEVICES"] = cards[pid]
        if platform:
            env["BTPU_PLATFORM"] = platform
        if cpu_devices:
            env["BTPU_CPU_DEVICES"] = str(cpu_devices)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "bachelors_tpu"] + argv, env=env))
    rcs = [p.wait() for p in procs]
    return max(rcs)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bachelors_tpu.launch",
        description="spawn N coordinated driver processes (local multi-host)")
    ap.add_argument("-n", "--nprocs", type=int, default=2)
    ap.add_argument("--platform", default=None,
                    help="force jax platform in workers (e.g. cpu)")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="virtual CPU devices per process")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="driver arguments (configs, --set overrides)")
    args = ap.parse_args(argv)
    return launch(args.nprocs, args.rest, platform=args.platform,
                  cpu_devices=args.cpu_devices)


if __name__ == "__main__":
    raise SystemExit(main())
