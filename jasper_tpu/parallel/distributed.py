"""Multi-host deployment: jax.distributed init + host work partitioning.

The reference never leaves one node (its "cluster" is xargs -P on one box,
reference src/jasper.sh:212). A multi-host deployment runs one process per
host; this module is the thin layer that (a) initializes the JAX
distributed runtime so jax.devices() spans the hosts, and (b) deals hosts
their share of polish batches, with outputs joined on the shared filesystem
by process 0 (the analog of the reference's per-batch files + cat/awk join,
sh:218-232). Each host scans on its own local devices.

Env contract (standard JAX names, or flags on run_pipeline):
  JASPER_TPU_COORDINATOR   host:port of process 0 (enables multi-host)
  JASPER_TPU_NUM_PROCESSES total process count
  JASPER_TPU_PROCESS_ID    this process's id
"""

from __future__ import annotations

import os


def maybe_init_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> tuple[int, int]:
    """Initialize jax.distributed when configured; returns
    (process_index, process_count). No-op single-process otherwise."""
    import jax

    coordinator = coordinator or os.environ.get("JASPER_TPU_COORDINATOR")
    if coordinator:
        num_processes = num_processes or int(
            os.environ.get("JASPER_TPU_NUM_PROCESSES", "1")
        )
        process_id = process_id if process_id is not None else int(
            os.environ.get("JASPER_TPU_PROCESS_ID", "0")
        )
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def my_shard(items: list, process_index: int, process_count: int) -> list:
    """Deal a host its round-robin share of work items (batch files)."""
    return list(items[process_index::process_count])


def barrier(name: str = "jasper_tpu") -> None:
    """Cross-host sync point (no-op single-process)."""
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)
