"""Multi-host execution setup for runs that span several processes.

The reference is single-process (SURVEY.md §2.3); this is the new-design
multi-host path: single-program multi-process JAX, with the same sharded
stages as parallel/spmd.py — the mesh simply spans all processes' devices
and XLA inserts the collectives (SURVEY.md §5.8).

Division of labor across processes:
  * every host runs the same program; the frame stream is read on host 0
    and broadcast (or each host reads its own shard of a multi-camera rig);
  * the loop-closure descriptor database shards across ALL devices
    (capacity scales linearly with devices);
  * pose-graph factors shard across devices; the dense reduced solve is
    replicated (it is tiny);
  * host-side control (status machine, splitting) is deterministic given
    the same stats readback, so hosts stay in lockstep without extra
    coordination.

tests/test_multihost.py runs the chunked orchestrator across two local
processes on virtual CPU devices.
"""
from __future__ import annotations

import jax

from .spmd import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the JAX distributed runtime for a multi-process run.

    With no arguments JAX looks for a cluster it can detect on its own
    (e.g. SLURM); elsewhere pass the coordinator address, the process
    count and this process's id.  Call once per process before any jax
    API touches the backend.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "d"):
    """1-D mesh over every device of every process."""
    return make_mesh(jax.devices(), axis)


def is_coordinator() -> bool:
    return jax.process_index() == 0
