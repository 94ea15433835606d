"""Multi-process (multi-host) execution: the DCN axis of the scaling story.

One JAX process per host, per card, or per test subprocess, all joined into
a single GSPMD program by `jax.distributed` (one controller per process):

  * every process calls `initialize()` (coordinator TCP rendezvous), after
    which `jax.devices()` is the GLOBAL device list across processes;
  * the existing mesh/sharding layer (`parallel.mesh`, `parallel.sharding`)
    is reused unchanged over the global mesh — XLA inserts the same
    collectives from the same PartitionSpecs whether they cross cards of
    one host or hosts;
  * host state (scene build is deterministic, so every process holds the
    full arrays) is distributed with `host_array` — each process feeds only
    the shards it addresses; results come back with `allgather` for
    host-side consumers (image sinks, stats).

The reference is single-device single-process (SURVEY §5 "Distributed
communication backend: none"); this module is the rebuild's counterpart to
an ML framework's torchrun/NCCL bootstrap, built on JAX's coordination
service instead (tested two-process on a CPU mesh in
tests/test_multihost.py — real workers, real TCP rendezvous, real
cross-process collectives).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np

from .mesh import make_mesh


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join this process into the global JAX runtime.

    With no arguments, reads the launcher contract of
    tools/launch_multihost.py (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID, and SPACETIME_LOCAL_DEVICES — a comma list of the local
    card indices this process may open), falling back to single-process
    (no-op) when they are absent.  Several processes on one GPU host must
    each open only their own card: a JAX process reserves most of a card's
    memory when it first uses it, so a second process on the same card
    fails.  Must run BEFORE any other JAX call in the process.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return  # single-process: nothing to join
    if num_processes is None:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if local_device_ids is None and os.environ.get("SPACETIME_LOCAL_DEVICES"):
        local_device_ids = [
            int(i) for i in os.environ["SPACETIME_LOCAL_DEVICES"].split(",")
        ]
    # CPU meshes need a cross-process collectives transport; gloo is the
    # one compiled into jax's CPU client (GPU meshes use NCCL)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def global_mesh(axis: str = "d"):
    """1D mesh over ALL global devices (every process must call this with
    the same arguments — it is a collective-free but SPMD-consistent
    constructor)."""
    return make_mesh(axis=axis)


def host_array(value, sharding) -> jax.Array:
    """Build a global sharded array from a host value every process holds.

    Scene construction is deterministic, so each process builds the same
    full-size host arrays; this places each process's ADDRESSABLE shards
    onto its local devices and stitches them into one global jax.Array.
    (`jax.device_put(value, sharding)` requires all devices addressable —
    fine single-process, impossible multi-process; this is the standard
    `make_array_from_callback` pattern.)
    """
    value = np.asarray(value)
    return jax.make_array_from_callback(
        value.shape, sharding, lambda idx: value[idx]
    )


def host_state(particles, buf, mesh, axis: str = "d"):
    """Multi-process counterpart of sharding.shard_state: place host-built
    Particles + WorldlineBuffer pytrees onto the global mesh."""
    from . import sharding as sh

    p_shard = sh.particle_sharding(
        mesh, axis, with_rest_len=particles.rest_len is not None
    )
    b_shard = sh.worldline_sharding(mesh, axis)
    p = jax.tree.map(host_array, particles, p_shard)
    b = jax.tree.map(host_array, buf, b_shard)
    return p, b


def allgather(x: jax.Array) -> np.ndarray:
    """Fetch a (possibly cross-process-sharded) global array to EVERY
    process's host memory — one cross-DCN all-gather, then local device
    reads.  Used by host-side consumers: image sinks, stats, checkpoints."""
    from jax.experimental import multihost_utils

    if not is_multiprocess():
        return np.asarray(x)
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def sync(name: str = "barrier") -> None:
    """Cross-process barrier (e.g. before teardown, between bench phases)."""
    if is_multiprocess():
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)
