"""Index / count-store persistence.

The reference has no on-disk state at all — indexes die with the R session
(finalizers, src/kmer_hash.c:56-92) and "resume" means keeping an external
pointer alive and adding more files into it (src/kmer_hash.c:561-574). For a
sharded, long-running service that is not enough, so save/restore is a
first-class addition here (SURVEY.md §5 checkpoint/resume).

Format: a single ``.npz`` with a JSON-encoded meta blob — no framework
dependency, readable anywhere. Sharded stores save per-shard arrays and
restore onto any mesh of the same size.
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np

from ..index.count_store import CountStore
from ..index.position_index import KmerIndex

_MAGIC = "kmer_hasher_tpu"
_VERSION = 1


def save_count_store(store, path, progress=None) -> None:
    """Persist a CountStore or a ShardedCountStore (kind recorded in the
    meta blob; ``load_count_store`` restores either). ``progress`` is an
    optional JSON-serialisable resume cursor (e.g. source file + reads
    consumed) stored in the meta blob — read it back with
    ``load_progress``.

    Multi-process note: the fold/allgather inside is collective (every
    process must call), but only process 0 writes the file. A caller
    that immediately RELOADS on every process must barrier first
    (``multihost_utils.sync_global_devices``) — normal resume flows load
    in a fresh run and need no barrier."""
    if hasattr(store, "mesh"):  # ShardedCountStore (import-cycle-free)
        return _save_sharded_count_store(store, path, progress)
    store.flush()
    meta = {
        "magic": _MAGIC, "version": _VERSION, "kind": "count_store",
        "k": store.k, "counts_n": store.counts_n,
        "prefix_bits": store.prefix_bits, "suffix_bits": store.suffix_bits,
        "mode": store.mode, "n_unique": store.n_unique,
        "max_size_bytes": store.max_size_bytes,
        "budget_semantics": store.budget_semantics,
        "admit_frozen": store._admit_frozen,
        "progress": progress,
    }
    n = store.n_unique
    extra = {}
    if store._admitted is not None:
        extra["admitted"] = store._admitted
    np.savez_compressed(
        path, meta=json.dumps(meta),
        u_hi=np.asarray(store.u_hi)[:n], u_lo=np.asarray(store.u_lo)[:n],
        cnt=np.asarray(store.cnt)[:n], total_added=store.total_added,
        **extra,
    )


def _save_sharded_count_store(store, path, progress=None) -> None:
    from ..parallel.sharded import _host_read

    n = store.n_unique  # folds all pending runs first
    D = store.n_shards
    u_hi = _host_read(store.u_hi)
    u_lo = _host_read(store.u_lo)
    cnt = _host_read(store.cnt)
    meta = {
        "magic": _MAGIC, "version": _VERSION, "kind": "sharded_count_store",
        "k": store.k, "counts_n": store.counts_n, "n_shards": D,
        "capacity": store.capacity, "n_unique": [int(v) for v in n],
        "progress": progress,
    }
    import jax

    if jax.process_index() != 0:
        return  # the fold + allgather above ran on every process (they are
        # collectives); only one process may write the shared file
    np.savez_compressed(
        path, meta=json.dumps(meta),
        u_hi=np.concatenate([u_hi[d, : n[d]] for d in range(D)]),
        u_lo=np.concatenate([u_lo[d, : n[d]] for d in range(D)]),
        cnt=np.concatenate([cnt[d, : n[d]] for d in range(D)]),
        total_added=store.total_added,
    )


def _load_sharded_count_store(z, meta, mesh):
    """Restore shard tables. With ``mesh`` (same size as at save) the
    result is a ShardedCountStore; without, the disjoint shard tables are
    fed as LSM runs into a single-chip CountStore."""
    import jax.numpy as jnp

    D = int(meta["n_shards"])
    n = np.asarray(meta["n_unique"], np.int64)
    offs = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    counts_n = int(meta["counts_n"])
    if mesh is None:
        store = CountStore(int(meta["k"]), counts_n=counts_n)
        for d in range(D):
            nd = int(n[d])
            if not nd:
                continue
            cap = 1 << max(6, (nd - 1).bit_length())
            hi = np.full(cap, 0xFFFFFFFF, np.uint32)  # dead-row key
            lo = np.full(cap, 0xFFFFFFFF, np.uint32)
            cnt = np.zeros((cap, counts_n), np.uint32)
            hi[:nd] = z["u_hi"][offs[d]: offs[d + 1]]
            lo[:nd] = z["u_lo"][offs[d]: offs[d + 1]]
            cnt[:nd] = z["cnt"][offs[d]: offs[d + 1]]
            # n_obs bounds the run's live rows (the store trims runs to
            # it), so it must cover all nd restored keys: the run's own
            # observation totals do; total_added is restored below
            store.add_run(jnp.asarray(hi), jnp.asarray(lo),
                          jnp.asarray(cnt),
                          cnt[:nd].sum(axis=0, dtype=np.int64))
        store.total_added = z["total_added"].copy()
        return store.flush()
    from ..parallel.sharded import ShardedCountStore

    if mesh.size != D:
        raise ValueError(
            f"store was saved with {D} shards; mesh has {mesh.size}"
        )
    store = ShardedCountStore(int(meta["k"]), mesh, counts_n=counts_n,
                              capacity=int(meta["capacity"]))
    cap = 1 << max(6, int(max(n.max(), 1) - 1).bit_length())
    u_hi = np.zeros((D, cap), np.uint32)
    u_lo = np.zeros((D, cap), np.uint32)
    cnt = np.zeros((D, cap, counts_n), np.uint32)
    for d in range(D):
        u_hi[d, : n[d]] = z["u_hi"][offs[d]: offs[d + 1]]
        u_lo[d, : n[d]] = z["u_lo"][offs[d]: offs[d + 1]]
        cnt[d, : n[d]] = z["cnt"][offs[d]: offs[d + 1]]
    store.u_hi = store._global_put(u_hi)
    store.u_lo = store._global_put(u_lo)
    store.cnt = store._global_put(cnt)
    store.n_unique = n
    store.total_added = z["total_added"].copy()
    return store


def load_progress(path):
    """Resume cursor stored by ``save_count_store(..., progress=)`` —
    ``{"path": ..., "reads_done": N, "done": bool}`` for counting
    checkpoints, or None for stores saved without one."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
    return meta.get("progress")


def load_count_store(path, mesh=None):
    """Load a saved store. Plain stores ignore ``mesh``; sharded stores
    restore onto ``mesh`` (same shard count) or, with ``mesh=None``, fold
    into a single-chip CountStore."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("kind") == "sharded_count_store":
            return _load_sharded_count_store(z, meta, mesh)
        if meta.get("magic") != _MAGIC or meta.get("kind") != "count_store":
            raise ValueError(f"{path} is not a kmer_hasher_tpu count store")
        store = CountStore(
            meta["k"], counts_n=meta["counts_n"],
            prefix_bits=meta["prefix_bits"], suffix_bits=meta["suffix_bits"],
            mode=meta["mode"], max_size_bytes=meta["max_size_bytes"],
            budget_semantics=meta.get("budget_semantics", "error"),
        )
        if "admitted" in z:
            store._admitted = z["admitted"].astype(np.uint64)
            store._admit_frozen = bool(meta.get("admit_frozen", False))
        n = int(meta["n_unique"])
        cap = max(64, 1 << max(6, (n - 1).bit_length())) if n else 64
        u_hi = np.zeros(cap, np.uint32)
        u_lo = np.zeros(cap, np.uint32)
        cnt = np.zeros((cap, meta["counts_n"]), np.uint32)
        u_hi[:n] = z["u_hi"]
        u_lo[:n] = z["u_lo"]
        cnt[:n] = z["cnt"]
        store.u_hi = jnp.asarray(u_hi)
        store.u_lo = jnp.asarray(u_lo)
        store.cnt = jnp.asarray(cnt)
        store.n_unique = n
        store.total_added = z["total_added"].copy()
    return store


def save_index(index: KmerIndex, path) -> None:
    n = index.n_valid
    meta = {
        "magic": _MAGIC, "version": _VERSION, "kind": "kmer_index",
        "k": index.k, "seq_len": index.seq_len, "n_valid": n,
    }
    np.savez_compressed(
        path, meta=json.dumps(meta),
        s_hi=np.asarray(index.s_hi)[:n], s_lo=np.asarray(index.s_lo)[:n],
        s_pos=np.asarray(index.s_pos)[:n],
    )


def load_index(path) -> KmerIndex:
    """Restore a position index without re-encoding the sequence."""
    from ..index.position_index import _group_stats
    from ..ops import sort as srt

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("magic") != _MAGIC or meta.get("kind") != "kmer_index":
            raise ValueError(f"{path} is not a kmer_hasher_tpu index")
        n = int(meta["n_valid"])
        cap = 1 << max(6, (n - 1).bit_length()) if n > 1 else 64
        idx = KmerIndex.__new__(KmerIndex)
        idx.k = int(meta["k"])
        idx.seq_len = int(meta["seq_len"])
        idx.n_valid = n
        s_hi = np.zeros(cap, np.uint32)
        s_lo = np.zeros(cap, np.uint32)
        s_pos = np.zeros(cap, np.int32)
        s_hi[:n] = z["s_hi"]
        s_lo[:n] = z["s_lo"]
        s_pos[:n] = z["s_pos"]
        idx.s_hi = jnp.asarray(s_hi)
        idx.s_lo = jnp.asarray(s_lo)
        idx.s_pos = jnp.asarray(s_pos)
        live = jnp.arange(cap, dtype=jnp.int32) < n
        idx.starts = srt.segment_starts(idx.s_hi, idx.s_lo, live)
        idx.seg_ids = srt.segment_ids(idx.starts)
        (idx._counts_dense, idx.i_col, idx.rank, idx.m,
         idx.cum_m) = _group_stats(idx.s_pos, jnp.asarray(n, jnp.int32),
                                   idx.starts, idx.seg_ids)
        idx._n_unique = None
        idx._u = None
    return idx
