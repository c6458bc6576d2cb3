"""Multi-process scale-out (SURVEY.md §2.3).

A multi-process run is the same sharded programs as a single process —
the mesh just spans processes.  Layout policy: the **channel** axis may
cross processes (embarrassingly parallel, only input distribution), and
the **time** axis stays within one process's devices, so the one halo
``ppermute`` per program never leaves the process.  Within one host the
cards are joined all to all, so the mesh follows the algorithm alone.

This module only wires process initialization and mesh construction; the
compute path (parallel.channel / parallel.time_shard) is unchanged.
Single-process multi-device environments (including the CPU
``--xla_force_host_platform_device_count`` mesh) work identically with
``init_distributed=False``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def setup(coordinator_address: Optional[str] = None,
          num_processes: Optional[int] = None,
          process_id: Optional[int] = None,
          init_distributed: bool = True) -> None:
    """Initialize jax.distributed for a multi-process mesh.

    No-op when ``init_distributed`` is False or JAX is already initialized.
    """
    import jax
    if not init_distributed:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(time_per_host: Optional[int] = None,
              ch_axis: str = "ch", time_axis: str = "time",
              cross_process_time: bool = False):
    """Global 2D (channel x time) mesh with time confined to each process.

    ``time_per_host`` defaults to the local device count, which keeps every
    halo exchange inside one process; the channel axis then spans
    processes.

    ``cross_process_time`` deliberately TRANSPOSES the layout so every
    time row spans the processes (each halo ppermute crosses the process
    boundary).  This is the configuration the default policy exists to
    avoid; it is exposed so its correctness can be validated and its cost
    measured (scripts/multihost_scaling.py time-axis cross config), not
    for production use.
    """
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    if time_per_host is None:
        time_per_host = jax.local_device_count()
    assert len(devs) % time_per_host == 0, (len(devs), time_per_host)
    grid = devs.reshape(len(devs) // time_per_host, time_per_host)
    if cross_process_time:
        # rows of the default grid are per-process; the transpose makes
        # each TIME row take one device from every process group
        grid = grid.T
    return Mesh(grid, (ch_axis, time_axis))
