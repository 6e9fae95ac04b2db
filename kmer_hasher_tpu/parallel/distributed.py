"""Multi-host initialisation.

The reference is strictly single-process (pthreads over shared memory,
SURVEY.md §2.3). Multi-host here is standard JAX SPMD: every host runs the
same program, ``jax.distributed.initialize`` wires the hosts into one
runtime, and the key-space mesh spans all devices of all hosts. Each host
reads a distinct slice
of the input files (true data parallelism, unlike the reference's
every-thread-reads-everything pool).
"""
from __future__ import annotations

from typing import Optional

import jax


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Initialise the multi-host runtime (no-op on a single process).

    With no arguments, JAX must detect the cluster from its environment;
    where nothing describes one, pass all three arguments (the
    coordinator is ``host:port`` of process 0). Returns a summary dict
    for logging.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def host_read_slice(n_records: int) -> slice:
    """The record range this host should read: contiguous split of the
    input across processes (replaces the reference's redundant per-thread
    full-file reads, src/kmer_reader.h:32-34)."""
    p = jax.process_index()
    n = jax.process_count()
    per = -(-n_records // n)
    return slice(p * per, min((p + 1) * per, n_records))
