"""Device mesh construction (SURVEY.md §2 distributed-communication table).

The reference's control plane is Node `cluster` fork + IPC messages; its data
plane is SysV shared memory (C4/C6c). Both collapse into the single-controller
JAX runtime: a 1-D mesh over however many chips are visible, shardings for the
data plane, XLA collectives (psum over NVLink) for the reductions the reference
did via in-place shm writes + epoch barriers.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "shard"


def make_mesh(n_shards: int | None = None, axis: str = AXIS) -> Mesh:
    """1-D mesh over the first n_shards visible devices (None = all).

    The workload's scaling dimensions are users/items/nnz (SURVEY.md §5 —
    there is no pipeline/expert/sequence dimension in an MF engine), so a 1-D
    mesh is the faithful topology; rank never needs sharding at k<=256.
    """
    devs = jax.devices()
    n = n_shards or len(devs)
    if n > len(devs):
        raise ValueError(f"asked for {n} shards, only {len(devs)} devices")
    return Mesh(np.asarray(devs[:n]), (axis,))


def shard_leading(mesh: Mesh, axis: str = AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Join a multi-host job (the reference's hypothetical TCP multi-machine
    mode, SURVEY.md C4 [K-low]; here it is first-class: the network between hosts,
    NVLink within each host).

    Call once per host process before any mesh/device use; afterwards
    jax.devices() spans all hosts and make_mesh() lays the 1-D shard axis
    across them, so every training path (shard.py / dual.py) runs unchanged
    — XLA routes the psum/all_gather segments over NVLink within a host and
    the network across hosts. With no arguments, coordinates through the
    cluster environment (SLURM / env vars), which is the common production
    path; a bare host needs coordinator, process count and id. Returns this host's process index.
    """
    kw = {}
    if coordinator is not None:
        kw["coordinator_address"] = coordinator
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)
    return jax.process_index()
