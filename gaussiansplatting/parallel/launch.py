"""Multi-host launching (SURVEY.md §2.3: jax.distributed + per-host data).

The reference is single-process with no communication backend.  Across
several hosts every host runs the same program; ``initialize()`` wires the JAX
distributed runtime, and the tile-sharded step (parallel/sharded.py) then runs
over the global mesh with XLA collectives (NCCL on GPUs).

Environment contract:
  COORDINATOR_ADDRESS  host:port of process 0 (or --coordinator flag)
  NUM_PROCESSES        total host count
  PROCESS_ID           this host's index
Nothing is discovered automatically: without them the run is one process.
"""

from __future__ import annotations

import os

import jax


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Initialize jax.distributed (no-op when single-process) and return a
    topology summary for logging."""
    # explicit zeros are meaningful (process_id=0 is the coordinator), so
    # only fall back to the environment when the argument is actually None
    if coordinator is None:
        coordinator = os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _int_env("NUM_PROCESSES")
    if process_id is None:
        process_id = _int_env("PROCESS_ID")

    if coordinator is not None or num_processes not in (None, 1):
        kwargs = {}
        if coordinator is not None:
            kwargs["coordinator_address"] = coordinator
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
        jax.distributed.initialize(**kwargs)

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def is_primary() -> bool:
    """True on the host that should write checkpoints/metrics/exports."""
    return jax.process_index() == 0
