"""Device mesh helpers.

Single-axis mesh ("shard") — the k-mer engine's parallelism is key-space
sharding (the reference's ``prefix % thread_n`` owner-computes filter,
src/kmer_reader.c:28-39, lifted to devices) combined with data-parallel
input streaming; both ride one axis. On one host of NVLink-joined cards
every card reaches every other at one rate, so the flat mesh is the
default; the two-level mesh is for device groups joined by a slower link.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def make_hierarchical_mesh(n_slices: int,
                           chips_per_slice: Optional[int] = None,
                           axes=("dcn", "ici")) -> Mesh:
    """Two-level mesh: the leading axis spans device groups ("slices")
    joined by the slower link (e.g. hosts on a network), the trailing
    axis the devices within a group. ``ShardedCountStore`` routes key
    batches hierarchically over such a mesh (group-bucketed all_to_all
    across groups, then per-owner all_to_all within a group) so traffic
    on the slow link moves in n_slices large blocks instead of n_devices
    fine-grained ones.

    A plain reshape of jax.devices() puts each row of the mesh inside one
    group when the devices are ordered group-major (as multi-host
    runtimes order them: process by process)."""
    devices = jax.devices()
    if chips_per_slice is None:
        if len(devices) % n_slices:
            raise ValueError(
                f"{len(devices)} devices do not split into {n_slices} slices"
            )
        chips_per_slice = len(devices) // n_slices
    need = n_slices * chips_per_slice
    if need > len(devices):
        raise ValueError(f"requested {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_slices, chips_per_slice)
    return Mesh(arr, tuple(axes))
