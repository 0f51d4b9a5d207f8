"""Multi-host (pod-slice) scaffolding for the tile-sharded renderer.

Several processes, each owning some devices (one process per card of a
multi-GPU host, or several hosts).  The workload's parallelism story (SURVEY.md §2.6)
is data-parallel over image tiles with replicated scene/BVH; gradients
psum over the mesh.  Multi-host changes NOTHING about the math — the RNG
is keyed by absolute pixel coordinates, so `Mesh(hosts x chips)` renders
are identical to the single-process `Mesh(n)` render — it only changes how
the mesh is built and who holds which rows:

* every process calls :func:`initialize` first (`jax.distributed`),
* :func:`make_multihost_mesh` builds the mesh over the GLOBAL device list
  (optionally as a (hosts, chips) grid whose flattened order keeps each
  host's rows contiguous — the only cross-host traffic is the tiny
  parameter-gradient psum),
* the sharded entry points in `bpt_tpu.parallel.sharding` work unchanged;
  each process computes and holds its local row shards.

Verified by tests/test_multihost.py: two CPU processes x 4 virtual devices
reproduce the single-process 8-device render bit-for-bit.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """`jax.distributed.initialize` wrapper (idempotent).

    Nothing in a single multi-GPU host's environment describes a cluster, so
    pass the arguments explicitly: ``coordinator_address`` as
    ``localhost:<free port>``, ``num_processes`` and this process's
    ``process_id`` (one process can also drive every card of the host with
    no initialize at all).  Must run before any computation.
    """
    if getattr(initialize, "_done", False):
        return
    # NB: must not touch jax.devices()/process_count() here — any backend
    # query initializes XLA and makes distributed.initialize() illegal.
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    initialize._done = True


def make_multihost_mesh(axis: str = "tiles", hierarchical: bool = False):
    """Device mesh over the global (all-hosts) device list.

    ``hierarchical=False`` (default): a flat 1-D ('tiles',) mesh in
    process-major order — device i of process p owns contiguous image rows,
    so a host's shards are contiguous and intra-host boundaries dominate.

    ``hierarchical=True``: a ('hosts', 'chips') 2-D mesh for schemes that
    want an explicit DCN axis (e.g. psum_scatter over chips then psum over
    hosts).  The renderer's DP-only plan does not need it.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    if not hierarchical:
        return Mesh(np.asarray(devs), (axis,))
    n_hosts = jax.process_count()
    per_host = len(devs) // n_hosts
    grid = np.asarray(devs).reshape(n_hosts, per_host)
    return Mesh(grid, ("hosts", "chips"))


def host_row_range(height: int, mesh: Mesh, axis: str = "tiles") -> tuple[int, int]:
    """[row0, row1) of the image owned by THIS process under row sharding —
    host-count-aware tiling for input pipelines / per-host IO."""
    n = mesh.shape[axis]
    if height % n:
        raise ValueError(
            f"height={height} must divide evenly over the {n}-way '{axis}' "
            "axis (same requirement as the sharded renderer); a remainder "
            "would leave rows no host owns"
        )
    tile_rows = height // n
    locals_ = [
        i for i, d in enumerate(mesh.devices.reshape(-1))
        if d.process_index == jax.process_index()
    ]
    return min(locals_) * tile_rows, (max(locals_) + 1) * tile_rows
