"""Multi-chip sharded index and count store.

Parallelism map (SURVEY.md §2.2 -> devices):

* The reference's reader-pool "owner-computes" filter — every pthread scans
  the whole input and keeps k-mers with ``prefix % thread_n == thread_i``
  (src/kmer_reader.c:28-39) — becomes key-space sharding across chips with
  the k-mers *routed* to their owner via ``all_to_all`` instead of
  redundantly re-read: each device encodes only its slice of the input.
* Splitting one long sequence across chips is context parallelism with a
  (k-1)-base halo from the right neighbour (``ppermute``), replacing the
  rolling register's sequential dependency at shard boundaries.
* The owner is a *salted multiplicative hash* of the k-mer, not its raw
  leading bits — repeat-dominated prefixes would skew raw-prefix shards
  (SURVEY.md §7 hard parts).
* Routing uses fixed per-destination capacity (MoE-style): senders bucket
  k-mers by owner, pad to capacity, and a single tiled ``all_to_all`` moves
  every bucket; an overflow flag is psum-reduced so the host can retry with
  a bigger capacity factor instead of silently dropping.
* Queries replicate, search the local shard, and merge with ``psum`` (hit
  counts) — the all-gather analogue of the reference's shared-memory reads.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import encode as enc
from ..ops import expand as exp
from ..ops import sort as srt

I32 = jnp.int32
I64 = jnp.int64
U32 = jnp.uint32
U64 = jnp.uint64


def owner_hash(hi: jax.Array, lo: jax.Array, n_shards: int,
               salt: int = 0x9E3779B1) -> jax.Array:
    """Salted multiplicative hash -> shard owner in [0, n_shards)."""
    h = hi * U32(salt) + lo * U32(0x85EBCA77)
    h ^= h >> 15
    h *= U32(0xCC9E2D51)
    h ^= h >> 13
    return (h % U32(n_shards)).astype(I32)


def _global_put(mesh: Mesh, full_np, spec=None):
    """Host value (identical on every process) -> global array sharded
    ``spec`` (default: first-axis over all mesh axes) over the mesh.
    Plain device array on a single process."""
    if jax.process_count() == 1:
        return jnp.asarray(full_np)
    from jax.sharding import NamedSharding

    full_np = np.asarray(full_np)
    if spec is None:
        spec = P(tuple(mesh.axis_names))
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        full_np.shape, sharding, lambda idx: full_np[idx]
    )


def _replicated(mesh: Mesh, x):
    """Host value (identical on every process) -> fully-replicated global
    array (the multi-process-safe form of a P() shard_map input)."""
    return _global_put(mesh, x, spec=P())


class _LRU(dict):
    """Bounded program cache: inserts past ``maxsize`` evict the least
    recently *used* entry. Keys hold Mesh objects and values compiled
    executables — unbounded growth (capacity-doubling retries, many
    store/index instances per process) would keep every mesh and program
    alive for the process lifetime (ADVICE r3)."""

    def __init__(self, maxsize: int = 128):
        super().__init__()
        self.maxsize = maxsize

    def get_or_build(self, key, build):
        fn = self.get(key)
        if fn is not None:
            # re-insert = move to the fresh end (dicts are ordered)
            del self[key]
            self[key] = fn
            return fn
        fn = self[key] = build()
        while len(self) > self.maxsize:
            del self[next(iter(self))]
        return fn


_PROGRAMS = _LRU(maxsize=128)


def _shared_program(key, build):
    """Module-level cache of jitted shard_map programs keyed by (mesh,
    static shapes): capacity-overflow retries and repeat builds at an
    already-seen capacity reuse the compiled program instead of paying a
    fresh trace + compile."""
    return _PROGRAMS.get_or_build(key, build)


def _bucket_for_send(hi, lo, pos, valid, n_shards: int, capacity: int, k: int,
                     owner=None):
    """Lay out (key, pos) tuples into per-owner send buckets [D, C].

    Returns (send_hi, send_lo, send_pos, send_valid, overflow) for one
    device. Entries beyond an owner's capacity raise the overflow flag.
    ``owner`` overrides the default salted-hash placement (e.g. key-range
    splitters for ordered emission).
    """
    L = hi.shape[0]
    if owner is None:
        owner = owner_hash(hi, lo, n_shards)
    owner = jnp.where(valid, owner, n_shards)
    o_sort, idx = jax.lax.sort(
        (owner.astype(U32), jnp.arange(L, dtype=I32)), num_keys=1,
        is_stable=True,
    )
    o_sort = o_sort.astype(I32)
    counts = jnp.zeros(n_shards + 1, I32).at[owner].add(1, mode="drop")
    group_start = jnp.concatenate(
        [jnp.zeros(1, I32), jnp.cumsum(counts)[:-1].astype(I32)]
    )
    rank = jnp.arange(L, dtype=I32) - group_start[o_sort]
    overflow = (counts[:n_shards] > capacity).any()
    ok = (o_sort < n_shards) & (rank < capacity)
    tgt = jnp.where(ok, o_sort * capacity + rank, n_shards * capacity)

    def scatter(arr, fill):
        out = jnp.full(n_shards * capacity + 1, fill, arr.dtype)
        return out.at[tgt].set(arr[idx], mode="drop")[:-1]

    s_hi = scatter(hi, 0).reshape(n_shards, capacity)
    s_lo = scatter(lo, 0).reshape(n_shards, capacity)
    s_pos = scatter(pos, 0).reshape(n_shards, capacity)
    s_val = jnp.zeros(n_shards * capacity + 1, bool).at[tgt].set(
        ok, mode="drop"
    )[:-1].reshape(n_shards, capacity)
    return s_hi, s_lo, s_pos, s_val, overflow


def _route_and_build_shard(hi, lo, pos, valid, n_shards: int, capacity: int,
                           k: int, axis: str):
    """Inside shard_map: route k-mers to owners and build the local sorted
    shard. Returns (s_hi, s_lo, s_pos, n_valid, overflow)."""
    b_hi, b_lo, b_pos, b_val, ovf = _bucket_for_send(
        hi, lo, pos, valid, n_shards, capacity, k
    )
    r_hi = jax.lax.all_to_all(b_hi, axis, 0, 0, tiled=False)
    r_lo = jax.lax.all_to_all(b_lo, axis, 0, 0, tiled=False)
    r_pos = jax.lax.all_to_all(b_pos, axis, 0, 0, tiled=False)
    r_val = jax.lax.all_to_all(b_val, axis, 0, 0, tiled=False)
    f_hi = r_hi.reshape(-1)
    f_lo = r_lo.reshape(-1)
    f_pos = r_pos.reshape(-1)
    f_val = r_val.reshape(-1)
    s_hi, s_lo, s_pos = srt.sort_windows(f_hi, f_lo, f_pos.astype(I32),
                                         f_val, k)
    n_valid = f_val.sum().astype(I32)
    overflow = jax.lax.psum(ovf.astype(I32), axis)
    return s_hi, s_lo, s_pos, n_valid, overflow


class ShardedKmerIndex:
    """Position index sharded by k-mer hash across a device mesh.

    Build: context-parallel encode (halo exchange) -> all_to_all routing ->
    per-device sorted shards. Queries are replicated and psum-merged.
    """

    def __init__(self, seq, k: int, mesh: Mesh,
                 capacity_factor: float = 2.0,
                 drop_trailing_exact_k: bool = True):
        if isinstance(seq, str):
            seq = np.frombuffer(seq.encode(), np.uint8)
        elif isinstance(seq, (bytes, bytearray)):
            seq = np.frombuffer(bytes(seq), np.uint8)
        seq = np.asarray(seq, np.uint8)
        if not 1 <= k <= 32:
            raise ValueError("k must be in 1..32")
        if seq.shape[0] <= k:
            raise ValueError("the length of the sequence must be at least k")
        self.k = int(k)
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        D = mesh.size
        self.n_shards = D
        L = int(seq.shape[0])
        self.seq_len = L
        # the reference drops the final window when its region starts fresh
        # (src/kmer_pos.c:81-84); precompute the single affected position
        quirk = -1
        if drop_trailing_exact_k:
            a = L - k
            if a == 0 or (seq[a - 1] | 0x20) == ord("n"):
                quirk = a + 1  # 1-based
        self._quirk_pos = quirk
        # pad to a multiple of D (and a power-of-two chunk) with N
        Lc = -(-L // D)
        Lc = 1 << max(4, (Lc - 1).bit_length())
        Lp = Lc * D
        if Lp != L:
            seq = np.concatenate([seq, np.full(Lp - L, ord("N"), np.uint8)])
        self.chunk = Lc
        cap = int(capacity_factor * Lc / D)
        self.capacity = 1 << max(3, (cap - 1).bit_length())
        # multi-process (jax.distributed) meshes: every process holds the
        # same full sequence; globalize it once (sharded over the mesh)
        # and pass the scalars replicated — the readbacks then allgather
        seq_g = _global_put(self.mesh, seq)
        meta = _replicated(self.mesh, np.asarray([L, quirk], np.int32))
        for attempt in range(3):
            out = self._build(seq_g, meta)
            s_hi, s_lo, s_pos, n_valid, overflow = out
            # overflow is psum-replicated: any local shard holds the value
            if int(np.asarray(overflow.addressable_data(0)).ravel()[0]) == 0:
                break
            self.capacity *= 2  # skewed shards: retry with more headroom
        else:
            raise RuntimeError("all_to_all capacity overflow after retries")
        self.s_hi, self.s_lo, self.s_pos = s_hi, s_lo, s_pos
        self.n_valid = _host_read(n_valid)  # [D]
        self._nv_g = _global_put(self.mesh, self.n_valid.astype(np.int32))
        self.total_kmers = int(self.n_valid.sum())

    def _repl(self, x):
        """Replicated shard_map input (multi-process-safe P() arg)."""
        return _replicated(self.mesh, x)

    def _np_view(self, x):
        """Host view for shard-indexed table extraction: allgathered numpy
        on a multi-process mesh, the device array itself otherwise (so the
        single-process path never materialises the index on host)."""
        return _host_read(x) if jax.process_count() > 1 else x

    def _build(self, seq_g, meta):
        k, D, Lc, C = self.k, self.n_shards, self.chunk, self.capacity
        axis, mesh = self.axis, self.mesh
        halo = max(1, k - 1)

        def build():
            def fn(seq_local, meta):
                true_len, quirk_pos = meta[0], meta[1]
                seq_local = seq_local.reshape(-1)  # [Lc]
                me = jax.lax.axis_index(axis)
                # halo: first (k-1) bases of the RIGHT neighbour
                nxt = jax.lax.ppermute(
                    seq_local[:halo], axis,
                    [(i, (i - 1) % D) for i in range(D)],
                )
                ext = jnp.concatenate([seq_local, nxt])  # [Lc + halo]
                start = me.astype(I32) * Lc
                hi, lo, valid = enc.encode_stream(
                    ext, k, jnp.minimum(true_len - start, Lc + halo),
                    canonical=False, drop_trailing_exact_k=False,
                )
                idx = jnp.arange(Lc + halo, dtype=I32)
                gpos = start + idx + 1  # 1-based global window start
                valid &= idx < Lc  # windows starting in this chunk only
                valid &= gpos != quirk_pos
                # windows crossing into the wrapped halo of the last device
                # are already invalid via true_len masking
                s_hi, s_lo, s_pos, n_valid, ovf = _route_and_build_shard(
                    hi, lo, gpos, valid, D, C, k, axis
                )
                return (
                    s_hi[None], s_lo[None], s_pos[None], n_valid[None],
                    ovf[None],
                )

            return jax.jit(
                jax.shard_map(
                    fn, mesh=mesh, in_specs=(P(axis), P()),
                    out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
                )
            )

        shard_fn = _shared_program(("kidx_build", mesh, k, Lc, C), build)
        return shard_fn(seq_g, meta)

    # -- kmer.pos table family (src/kmer_hash.c:1054-1147), sharded --------
    def _range_partitioned(self, capacity_factor: float = 2.0,
                           splitters=None):
        """Re-shard (key, pos) by key *range* (quantile splitters sampled
        from the hash shards) so that shard-major emission is globally
        key-sorted — the multi-chip form of the canonical table order.
        Cached; returns (r_hi, r_lo, r_pos [D, C], n_valid [D]).

        ``splitters=(spl_hi, spl_lo)`` overrides the sampled splitters so
        a SECOND index can be partitioned into the same key intervals
        (cross-index pairs, kmer_pairs_sharded); such calls bypass the
        cache."""
        if splitters is None and getattr(self, "_rp", None) is not None:
            return self._rp
        D, k, axis, mesh = self.n_shards, self.k, self.axis, self.mesh
        cap_shard = int(self.s_hi.shape[1])
        if splitters is not None:
            spl_hi, spl_lo = splitters
        else:
            # sample S quantile keys per shard ON DEVICE and fetch only the
            # [D, S] sample matrix (O(D*S) bytes instead of an O(index)
            # readback); the D-1 global splitters come from the pooled
            # samples on host
            S = 64

            def build_sample():
                def samp_fn(s_hi, s_lo, nv):
                    flat_hi = s_hi.reshape(-1)
                    flat_lo = s_lo.reshape(-1)
                    n = jnp.maximum(nv[0], 1)
                    idx = (jnp.arange(S, dtype=I64) * n) // S
                    return flat_hi[idx][None], flat_lo[idx][None]

                return jax.jit(
                    jax.shard_map(
                        samp_fn, mesh=mesh,
                        in_specs=(P(axis), P(axis), P(axis)),
                        out_specs=(P(axis), P(axis)),
                    )
                )

            samp = _shared_program(("kidx_sample", mesh, cap_shard, S),
                                   build_sample)
            samp_hi, samp_lo = samp(self.s_hi, self.s_lo, self._nv_g)
            samp_hi = _host_read(samp_hi)
            samp_lo = _host_read(samp_lo)
            keys = ((samp_hi.astype(np.uint64) << 32)
                    | samp_lo.astype(np.uint64))
            keys = np.sort(keys.reshape(-1))
            spl = keys[[(i + 1) * len(keys) // D for i in range(D - 1)]]
            spl_hi = self._repl((spl >> 32).astype(np.uint32))
            spl_lo = self._repl(spl.astype(np.uint32))
        C = 1 << max(4, int(capacity_factor * cap_shard / D - 1)
                     .bit_length())

        for _attempt in range(4):
            def build_rp(C=C):
                def fn(s_hi, s_lo, s_pos, nv, spl_hi, spl_lo):
                    s_hi, s_lo = s_hi.reshape(-1), s_lo.reshape(-1)
                    s_pos = s_pos.reshape(-1)
                    live = jnp.arange(s_hi.shape[0], dtype=I32) < nv[0]
                    # owner = rank of key among splitters (right side)
                    owner = srt.searchsorted2(spl_hi, spl_lo, D - 1,
                                              s_hi, s_lo, "right")
                    b = _bucket_for_send(s_hi, s_lo, s_pos, live, D, C, k,
                                         owner=owner)
                    b_hi, b_lo, b_pos, b_val, ovf = b
                    r_hi = jax.lax.all_to_all(b_hi, axis, 0, 0).reshape(-1)
                    r_lo = jax.lax.all_to_all(b_lo, axis, 0, 0).reshape(-1)
                    r_pos = jax.lax.all_to_all(b_pos, axis, 0, 0).reshape(-1)
                    r_val = jax.lax.all_to_all(b_val, axis, 0, 0).reshape(-1)
                    o_hi, o_lo, o_pos = srt.sort_windows(
                        r_hi, r_lo, r_pos.astype(I32), r_val, k
                    )
                    nv_out = r_val.sum().astype(I32)
                    ovf_t = jax.lax.psum(ovf.astype(I32), axis)
                    return (o_hi[None], o_lo[None], o_pos[None],
                            nv_out[None], ovf_t[None])

                return jax.jit(
                    jax.shard_map(
                        fn, mesh=mesh,
                        in_specs=(P(axis), P(axis), P(axis), P(axis),
                                  P(), P()),
                        out_specs=(P(axis),) * 5,
                    )
                )

            shard_fn = _shared_program(("kidx_rp", mesh, k, cap_shard, C),
                                       build_rp)
            r_hi, r_lo, r_pos, nv, ovf = shard_fn(
                self.s_hi, self.s_lo, self.s_pos, self._nv_g,
                jnp.asarray(spl_hi), jnp.asarray(spl_lo)
            )
            if int(np.asarray(ovf.addressable_data(0)).ravel()[0]) == 0:
                break
            C *= 2
        else:
            raise RuntimeError("range-partition capacity overflow")
        if splitters is not None:
            return (r_hi, r_lo, r_pos, _host_read(nv))
        self._rp_spl = (spl_hi, spl_lo)
        # NOTE: this cache holds a full second (key, pos) copy of the
        # index in device memory (plus _rp_stats) for as long as tables
        # are in use — it halves the maximum index size once tables() has
        # been touched. drop_range_partition() releases it.
        self._rp = (r_hi, r_lo, r_pos, _host_read(nv))
        return self._rp

    def drop_range_partition(self) -> None:
        """Release the cached range-partitioned copy of the index (and its
        group stats): tables()/iter_pair_chunks keep a full second
        (key, pos) copy in HBM — call this when done extracting tables to
        return to single-copy memory use. The next table call rebuilds it
        (one cached-program re-shard)."""
        self._rp = None
        self._rp_spl = None
        self._rp_stats = None

    def _rp_group_stats(self):
        """Per-range-shard segment stats + global kmer-rank bases (cached)."""
        if getattr(self, "_rp_stats", None) is not None:
            return self._rp_stats
        from ..index.position_index import _group_stats

        r_hi, r_lo, r_pos, nv = self._range_partitioned()
        axis, mesh = self.axis, self.mesh

        def build():
            def fn(hi, lo, pos, n):
                hi, lo, pos = hi.reshape(-1), lo.reshape(-1), pos.reshape(-1)
                live = jnp.arange(hi.shape[0], dtype=I32) < n[0]
                starts = srt.segment_starts(hi, lo, live)
                seg = srt.segment_ids(starts)
                counts, i_col, rank, m, cum_m = _group_stats(pos, n[0],
                                                             starts, seg)
                n_unique = starts.sum().astype(I32)
                return (counts[None], i_col[None], m[None], cum_m[None],
                        n_unique[None], starts[None], seg[None])

            return jax.jit(
                jax.shard_map(
                    fn, mesh=mesh, in_specs=(P(axis),) * 4,
                    out_specs=(P(axis),) * 7,
                )
            )

        shard_fn = _shared_program(
            ("kidx_rp_stats", mesh, int(r_hi.shape[1])), build)
        counts, i_col, m, cum_m, n_unique, starts, seg = shard_fn(
            r_hi, r_lo, r_pos, _global_put(mesh, nv.astype(np.int32))
        )
        n_unique = _host_read(n_unique)
        base = np.concatenate([[0], np.cumsum(n_unique)[:-1]])
        self._rp_stats = (counts, i_col, m, cum_m, n_unique, base, starts,
                          seg)
        return self._rp_stats

    @property
    def n_kmers(self) -> int:
        return int(self._rp_group_stats()[4].sum())

    def kmer_strings(self):
        """Decoded distinct k-mers in global canonical order."""
        from ..index.position_index import _NUC, _decode_kmers, _unique_compact

        r_hi, r_lo, _r_pos, _nv = self._range_partitioned()
        _c, _i, _m, _cm, n_unique, _base, starts, seg = self._rp_group_stats()
        r_hi, r_lo = self._np_view(r_hi), self._np_view(r_lo)
        starts, seg = self._np_view(starts), self._np_view(seg)
        out = []
        for d in range(self.n_shards):
            u_hi, u_lo, _n = _unique_compact(r_hi[d], r_lo[d], starts[d],
                                             seg[d])
            mat = np.asarray(_decode_kmers(u_hi, u_lo, self.k))
            mat = mat[: int(n_unique[d])]
            out.extend(bytes(row).decode("ascii") for row in _NUC[mat])
        return out

    def counts(self) -> np.ndarray:
        counts, _i, _m, _cm, n_unique, _base, _s, _g = self._rp_group_stats()
        counts = _host_read(counts)
        return np.concatenate(
            [counts[d, : int(n_unique[d])] for d in range(self.n_shards)]
        )

    def pos_table(self) -> np.ndarray:
        """[total, 2] (i, pos) rows, i = global 1-based kmer rank in
        canonical order — equals the single-chip table exactly."""
        r_hi, r_lo, r_pos, nv = self._range_partitioned()
        _c, i_col, _m, _cm, _nu, base, _s, _g = self._rp_group_stats()
        i_col = _host_read(i_col)
        r_pos_np = _host_read(r_pos)
        rows = []
        for d in range(self.n_shards):
            n = int(nv[d])
            rows.append(np.stack(
                [i_col[d, :n] + int(base[d]), r_pos_np[d, :n]], axis=1
            ))
        return np.concatenate(rows, axis=0).astype(np.int32)

    def iter_pair_chunks(self, capacity: int = 1 << 20):
        """Stream the (i, x, y) pair table shard by shard in canonical
        order with bounded memory (the multi-chip form of
        KmerIndex.iter_pair_chunks)."""
        from ..index.position_index import _pair_chunk

        r_hi, r_lo, r_pos, nv = self._range_partitioned()
        _c, i_col, m, cum_m, _nu, base, _s, _g = self._rp_group_stats()
        r_pos = self._np_view(r_pos)
        i_col, m, cum_m = (self._np_view(i_col), self._np_view(m),
                           self._np_view(cum_m))
        for d in range(self.n_shards):
            n = int(nv[d])
            if n == 0:
                continue
            total = int(np.asarray(cum_m[d, n - 1]))
            cap = srt.clamp_chunk_capacity(capacity, total)
            start = 0
            if exp.use_plan(total, int(r_pos.shape[-1]), cap):
                plan = exp.ExpansionPlan(
                    m[d], (i_col[d] + int(base[d]), r_pos[d]), cap
                )
                total_d = jnp.asarray(total, I64)
                while start < total:
                    rows, ok = exp.pair_chunk_planned(
                        r_pos[d], plan.cum, plan.run_start, plan.w,
                        plan.cols[0], plan.cols[1], total_d,
                        jnp.asarray(start, I64), cap,
                    )
                    n_ok = int(np.asarray(ok).sum())
                    yield np.asarray(rows)[:n_ok]
                    start += cap
                continue
            while start < total:
                rows, ok = _pair_chunk(
                    r_pos[d], i_col[d] + int(base[d]), m[d], cum_m[d],
                    jnp.asarray(n, I32), jnp.asarray(start, I64), cap,
                )
                n_ok = int(np.asarray(ok).sum())
                yield np.asarray(rows)[:n_ok]
                start += cap

    @property
    def total_pairs(self) -> int:
        _c, _i, m, cum_m, _nu, _base, _s, _g = self._rp_group_stats()
        _r_hi, _r_lo, _r_pos, nv = self._range_partitioned()
        cum_m = _host_read(cum_m)
        return int(sum(cum_m[d, int(nv[d]) - 1] for d in
                       range(self.n_shards) if int(nv[d])))

    def tables(self, opt_flag: int, max_pairs=None):
        """The ``kmer.pos`` entry (opt_flag bits 1=kmer 2=pos 4=pair.pos
        8=count, src/kmer_hash.c:17), emitted from the sharded index."""
        out = {"kmer": None, "pos": None, "pair.pos": None, "count": None}
        if opt_flag & 1:
            out["kmer"] = self.kmer_strings()
        if opt_flag & 2:
            out["pos"] = self.pos_table()
        if opt_flag & 4:
            total = self.total_pairs
            if max_pairs is not None and total > max_pairs:
                raise MemoryError(
                    f"pair table has {total} rows > max_pairs={max_pairs}; "
                    "use iter_pair_chunks() to stream"
                )
            chunks = list(self.iter_pair_chunks())
            out["pair.pos"] = (np.concatenate(chunks, axis=0) if chunks
                               else np.zeros((0, 3), np.int32))
        if opt_flag & 8:
            out["count"] = self.counts()
        return out

    # -- queries ------------------------------------------------------------
    def lookup_counts(self, q_hi, q_lo) -> np.ndarray:
        """Occurrence count per query k-mer, psum-merged across shards."""
        axis = self.axis
        n_valid = self._nv_g
        q_hi, q_lo = jnp.ravel(q_hi), jnp.ravel(q_lo)

        def build():
            def fn(s_hi, s_lo, nv, qh, ql):
                s_hi, s_lo = s_hi.reshape(-1), s_lo.reshape(-1)
                lb, ub = srt.lookup_bounds(s_hi, s_lo, nv[0], qh, ql)
                return jax.lax.psum(ub - lb, axis)

            return jax.jit(
                jax.shard_map(
                    fn, mesh=self.mesh,
                    in_specs=(P(axis), P(axis), P(axis), P(), P()),
                    out_specs=P(),
                )
            )

        shard_fn = _shared_program(
            ("kidx_lookup_counts", self.mesh, int(self.s_hi.shape[1]),
             int(q_hi.shape[0])), build)
        return np.asarray(
            shard_fn(self.s_hi, self.s_lo, n_valid,
                     self._repl(q_hi), self._repl(q_lo))
        )

    def _hit_totals(self, qh, ql, qv) -> np.ndarray:
        """Count-only pre-pass: per-shard total hits for a replicated
        query, so drain loops can clamp their chunk capacity before
        compiling the (capacity-sized) expansion program."""
        axis = self.axis
        n_valid = self._nv_g

        def build():
            def fn(s_hi, s_lo, nv, qh, ql, qv):
                s_hi, s_lo = s_hi.reshape(-1), s_lo.reshape(-1)
                lb, ub = srt.lookup_bounds(s_hi, s_lo, nv[0], qh, ql)
                cnt = jnp.where(qv, ub - lb, 0)
                return cnt.astype(I64).sum()[None]

            return jax.jit(
                jax.shard_map(
                    fn, mesh=self.mesh,
                    in_specs=(P(axis), P(axis), P(axis), P(), P(), P()),
                    out_specs=P(axis),
                )
            )

        shard_fn = _shared_program(
            ("kidx_hit_totals", self.mesh, int(self.s_hi.shape[1]),
             int(jnp.ravel(qh).shape[0])), build)
        return _host_read(shard_fn(
            self.s_hi, self.s_lo, n_valid, self._repl(qh), self._repl(ql),
            self._repl(qv))).astype(np.int64)

    def seq_kmer_pos(self, query, k: int,
                     max_hits_per_shard: int = 1 << 20) -> np.ndarray:
        """Sharded ``seq.kmer.pos``: full (i, j) matrix (reference row
        order); see ``iter_seq_kmer_pos`` for the streaming form."""
        blocks = list(self.iter_seq_kmer_pos(query, k, max_hits_per_shard))
        if not blocks:
            return np.zeros((0, 2), np.int32)
        return np.concatenate(blocks, axis=0)

    def iter_seq_kmer_pos(self, query, k: int,
                          max_hits_per_shard: int = 1 << 20):
        """Stream sharded ``seq.kmer.pos`` rows as sorted (i, j) blocks.

        Replicates the encoded query; every shard emits rows for the
        k-mers it owns, drained in fixed-size chunks (the build path's
        detect-and-retry discipline; round-1 silently truncated here).
        Each shard's stream is already (i, j)-sorted and — because the
        index is key-sharded — no window appears on two shards, so an
        incremental frontier-bounded merge yields globally sorted blocks
        (the single-chip/reference row order) without ever holding or
        lexsorting the full hit matrix on the host (ROADMAP §5).
        """
        if isinstance(query, str):
            query = np.frombuffer(query.encode(), np.uint8)
        elif isinstance(query, (bytes, bytearray)):
            query = np.frombuffer(bytes(query), np.uint8)
        query = np.asarray(query, np.uint8)
        if query.shape[-1] <= k or k > 31:
            raise ValueError(
                "the sequence should be longer than k and k should not be"
                " longer than 31"
            )
        from ..ops import encode as enc

        tl = query.shape[0]
        Lp = 1 << max(6, (tl - 1).bit_length())
        if Lp != tl:
            query = np.concatenate(
                [query, np.full(Lp - tl, ord("N"), np.uint8)]
            )
        q_hi, q_lo, q_valid = enc.encode_stream(
            jnp.asarray(query), k, tl, drop_trailing_exact_k=True
        )
        axis = self.axis
        n_valid = self._nv_g
        totals = self._hit_totals(q_hi, q_lo, q_valid)
        q_hi, q_lo = self._repl(q_hi), self._repl(q_lo)
        q_valid = self._repl(q_valid)
        C = srt.clamp_chunk_capacity(max_hits_per_shard,
                                     int(totals.max(initial=0)))
        if exp.use_plan(int(totals.max(initial=0)), int(q_hi.shape[0]), C):

            def build_plan():
                def plan_fn(s_hi, s_lo, nv, qh, ql, qv):
                    s_hi, s_lo = s_hi.reshape(-1), s_lo.reshape(-1)
                    lb, ub = srt.lookup_bounds(s_hi, s_lo, nv[0], qh, ql)
                    cnt = jnp.where(qv, ub - lb, 0).astype(I32)
                    cum, rs, w, cols, total = exp._build_plan(cnt, (lb,),
                                                              C, 1)
                    return (cum[None], rs[None], w[None], cols[0][None],
                            total[None])

                return jax.jit(jax.shard_map(
                    plan_fn, mesh=self.mesh,
                    in_specs=(P(axis), P(axis), P(axis), P(), P(), P()),
                    out_specs=(P(axis),) * 5,
                ))

            plan_sf = _shared_program(
                ("kidx_skp_plan", self.mesh, int(self.s_hi.shape[1]),
                 int(q_hi.shape[0]), C), build_plan)
            p_cum, p_rs, p_w, p_lb, p_tot = plan_sf(
                self.s_hi, self.s_lo, n_valid, q_hi, q_lo, q_valid)

            def build_chunk():
                def fn(s_pos, cum, rs, w, lbp, tot, start):
                    s_pos = s_pos.reshape(-1)
                    cum, rs = cum.reshape(-1), rs.reshape(-1)
                    w, lbp = w.reshape(-1), lbp.reshape(-1)
                    src, t, g = exp.chunk_src(cum, rs, start[0], C)
                    i_col = (w[src] + k).astype(I32)
                    j_col = s_pos[jnp.clip(lbp[src] + t, 0,
                                           s_pos.shape[0] - 1)]
                    ok = g < tot[0]
                    rows = jnp.stack([jnp.where(ok, i_col, 0),
                                      jnp.where(ok, j_col, 0)], axis=1)
                    return rows[None], ok.sum(dtype=I32)[None], tot[0][None]

                return jax.jit(jax.shard_map(
                    fn, mesh=self.mesh, in_specs=(P(axis),) * 7,
                    out_specs=(P(axis),) * 3,
                ))

            shard_fn = _shared_program(
                ("kidx_skp_chunkp", self.mesh, int(self.s_pos.shape[1]),
                 int(q_hi.shape[0]), C, k), build_chunk)

            def call(starts_v):
                starts = _global_put(
                    self.mesh, np.asarray(starts_v, np.int64)[:, None])
                return shard_fn(self.s_pos, p_cum, p_rs, p_w, p_lb, p_tot,
                                starts)

            yield from self._merge_sorted_streams(call, C, totals)
            return

        def build_fb():
            def fn(s_hi, s_lo, s_pos, nv, qh, ql, qv, start):
                s_hi, s_lo = s_hi.reshape(-1), s_lo.reshape(-1)
                s_pos = s_pos.reshape(-1)
                lb, ub = srt.lookup_bounds(s_hi, s_lo, nv[0], qh, ql)
                cnt = jnp.where(qv, ub - lb, 0)
                cum = jnp.cumsum(cnt.astype(I64))
                g = start[0] + jnp.arange(C, dtype=I64)
                w = srt.expand_rank_i64(cum, g, qh.shape[0])
                t = (g - (cum - cnt.astype(I64))[w]).astype(I32)
                i_col = (w + k).astype(I32)
                j_col = s_pos[jnp.clip(lb[w] + t, 0, s_pos.shape[0] - 1)]
                ok = g < cum[-1]
                rows = jnp.stack([jnp.where(ok, i_col, 0),
                                  jnp.where(ok, j_col, 0)], axis=1)
                return rows[None], ok.sum(dtype=I32)[None], cum[-1][None]

            return jax.jit(
                jax.shard_map(
                    fn, mesh=self.mesh,
                    in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P(),
                              P(), P()),
                    out_specs=(P(axis), P(axis), P(axis)),
                )
            )

        shard_fn = _shared_program(
            ("kidx_skp_chunk", self.mesh, int(self.s_hi.shape[1]),
             int(q_hi.shape[0]), C, k), build_fb)

        def call(starts_v):
            starts = _global_put(
                self.mesh, np.asarray(starts_v, np.int64)[:, None])
            return shard_fn(self.s_hi, self.s_lo, self.s_pos, n_valid,
                            q_hi, q_lo, q_valid, starts)

        yield from self._merge_sorted_streams(call, C, totals)

    @staticmethod
    def _row_keys(rows):
        return ((rows[:, 0].astype(np.int64) << 32)
                | rows[:, 1].astype(np.int64))

    def _merge_sorted_streams(self, call, C: int, totals):
        """Drain per-shard chunk streams (each internally (i, j)-sorted,
        pairwise disjoint in i) and yield globally sorted row blocks as
        soon as they are safe: a buffered row is emittable once every
        still-active shard has drained past it (its future rows are
        strictly greater than its last drained row).

        Host memory is BOUNDED under skew (VERDICT r3 weak-6): each shard
        advances its own drain cursor and STALLS (its start pinned at its
        total, so the chunk program emits nothing for it) while its host
        buffer holds >= 2*C rows — so one hit-heavy low-key shard can no
        longer force the others to accumulate their whole streams; peak
        buffered rows <= D*(2+1)*C instead of O(total hits). Progress is
        guaranteed: the frontier shard's buffered rows all sit at-or-below
        its own last drained key, so each emission empties it and it
        becomes willing again. ``call`` takes a per-shard [D] int64 start
        vector; ``totals`` is the per-shard true row count."""
        D = self.n_shards
        totals = np.asarray(totals, np.int64)
        bufs = [np.zeros((0, 2), np.int32) for _ in range(D)]
        cursors = np.zeros(D, np.int64)
        last_key = np.full(D, -1, np.int64)  # last drained key per shard
        self._merge_peak_rows = 0
        while True:
            unfinished = cursors < totals
            willing = unfinished & np.array(
                [b.shape[0] < 2 * C for b in bufs])
            if willing.any():
                starts = np.where(willing, cursors, totals)
                rows, n, _tot = call(starts)
                rows, n = _host_read(rows), _host_read(n)
                for d in range(D):
                    if willing[d] and n[d]:
                        chunk = rows[d, : n[d]]
                        bufs[d] = (np.concatenate([bufs[d], chunk])
                                   if bufs[d].size else chunk.copy())
                        last_key[d] = int(
                            self._row_keys(chunk[-1:])[0])
                cursors = np.where(willing, cursors + C, cursors)
                unfinished = cursors < totals
            self._merge_peak_rows = max(
                self._merge_peak_rows, sum(b.shape[0] for b in bufs))
            done = not unfinished.any()
            frontier = (None if done
                        else int(last_key[unfinished].min()))
            out = []
            for d in range(D):
                if not bufs[d].size:
                    continue
                if done:
                    out.append(bufs[d])
                    bufs[d] = np.zeros((0, 2), np.int32)
                    continue
                keys = self._row_keys(bufs[d])
                cut = int(np.searchsorted(keys, frontier, side="right"))
                if cut:
                    out.append(bufs[d][:cut])
                    bufs[d] = bufs[d][cut:]
            if out:
                block = np.concatenate(out, axis=0)
                block = block[np.argsort(self._row_keys(block),
                                         kind="stable")]
                yield block.astype(np.int32)
            if done:
                return

    def _drain_chunks(self, call, C: int):
        """Run a chunked per-shard emitter until every shard's true total is
        drained (no silent truncation)."""
        D = self.n_shards
        chunks = []
        start = 0
        while True:
            rows, n, total = call(np.full(D, start, np.int64))
            rows, n = _host_read(rows), _host_read(n)
            for d in range(D):
                if n[d]:
                    chunks.append(rows[d, : n[d]])
            start += C
            if start >= int(_host_read(total).max()):
                return chunks

    def positions_of(self, q_hi, q_lo, max_hits_per_shard: int = 1 << 16
                     ) -> np.ndarray:
        """All 1-based positions of the queried k-mers, gathered from every
        shard (ascending, merged on host); chunk-drained, never truncated."""
        axis = self.axis
        n_valid = self._nv_g
        q_hi, q_lo = jnp.ravel(q_hi), jnp.ravel(q_lo)
        totals = self._hit_totals(q_hi, q_lo,
                                  jnp.ones(q_hi.shape[0], bool))
        q_hi, q_lo = self._repl(q_hi), self._repl(q_lo)
        C = srt.clamp_chunk_capacity(max_hits_per_shard,
                                     int(totals.max(initial=0)))
        if exp.use_plan(int(totals.max(initial=0)), int(q_hi.shape[0]), C):

            def build_plan():
                def plan_fn(s_hi, s_lo, nv, qh, ql):
                    s_hi, s_lo = s_hi.reshape(-1), s_lo.reshape(-1)
                    lb, ub = srt.lookup_bounds(s_hi, s_lo, nv[0], qh, ql)
                    cnt = (ub - lb).astype(I32)
                    cum, rs, _w, cols, total = exp._build_plan(cnt, (lb,),
                                                               C, 1)
                    return cum[None], rs[None], cols[0][None], total[None]

                return jax.jit(jax.shard_map(
                    plan_fn, mesh=self.mesh,
                    in_specs=(P(axis), P(axis), P(axis), P(), P()),
                    out_specs=(P(axis),) * 4,
                ))

            plan_sf = _shared_program(
                ("kidx_pos_plan", self.mesh, int(self.s_hi.shape[1]),
                 int(q_hi.shape[0]), C), build_plan)
            p_cum, p_rs, p_lb, p_tot = plan_sf(self.s_hi, self.s_lo,
                                               n_valid, q_hi, q_lo)

            def build_chunk():
                def fn(s_pos, cum, rs, lbp, tot, start):
                    s_pos = s_pos.reshape(-1)
                    cum, rs = cum.reshape(-1), rs.reshape(-1)
                    lbp = lbp.reshape(-1)
                    src, t, g = exp.chunk_src(cum, rs, start[0], C)
                    p = s_pos[jnp.clip(lbp[src] + t, 0, s_pos.shape[0] - 1)]
                    ok = g < tot[0]
                    return (jnp.where(ok, p, -1)[:, None][None],
                            ok.sum(dtype=I32)[None], tot[0][None])

                return jax.jit(jax.shard_map(
                    fn, mesh=self.mesh, in_specs=(P(axis),) * 6,
                    out_specs=(P(axis),) * 3,
                ))

            shard_fn = _shared_program(
                ("kidx_pos_chunkp", self.mesh, int(self.s_pos.shape[1]),
                 int(q_hi.shape[0]), C), build_chunk)

            def call(starts_v):
                starts = _global_put(
                    self.mesh, np.asarray(starts_v, np.int64)[:, None])
                return shard_fn(self.s_pos, p_cum, p_rs, p_lb, p_tot,
                                starts)
        else:

            def build_fb():
                def fn(s_hi, s_lo, s_pos, nv, qh, ql, start):
                    s_hi, s_lo = s_hi.reshape(-1), s_lo.reshape(-1)
                    s_pos = s_pos.reshape(-1)
                    lb, ub = srt.lookup_bounds(s_hi, s_lo, nv[0], qh, ql)
                    cnt = ub - lb
                    cum = jnp.cumsum(cnt.astype(I64))
                    g = start[0] + jnp.arange(C, dtype=I64)
                    w = srt.expand_rank_i64(cum, g, qh.shape[0])
                    t = (g - (cum - cnt.astype(I64))[w]).astype(I32)
                    p = s_pos[jnp.clip(lb[w] + t, 0, s_pos.shape[0] - 1)]
                    ok = g < cum[-1]
                    return (jnp.where(ok, p, -1)[:, None][None],
                            ok.sum(dtype=I32)[None], cum[-1][None])

                return jax.jit(
                    jax.shard_map(
                        fn, mesh=self.mesh,
                        in_specs=(P(axis), P(axis), P(axis), P(axis), P(),
                                  P(), P()),
                        out_specs=(P(axis), P(axis), P(axis)),
                    )
                )

            shard_fn = _shared_program(
                ("kidx_pos_chunk", self.mesh, int(self.s_hi.shape[1]),
                 int(q_hi.shape[0]), C), build_fb)

            def call(starts_v):
                starts = _global_put(
                    self.mesh, np.asarray(starts_v, np.int64)[:, None])
                return shard_fn(self.s_hi, self.s_lo, self.s_pos, n_valid,
                                q_hi, q_lo, starts)

        chunks = self._drain_chunks(call, C)
        out = (np.concatenate(chunks, axis=0)[:, 0] if chunks
               else np.zeros(0, np.int32))
        return np.sort(out)


#: peak host-buffered rows of the last iter_kmer_pairs_sharded_chunks
#: drain (bounded-memory test hook)
_PAIRS_STREAM_STATS = {"peak_rows": 0}


def iter_kmer_pairs_sharded_chunks(a: "ShardedKmerIndex",
                                   b: "ShardedKmerIndex",
                                   capacity: int = 1 << 20):
    """Stream ``kmer.pairs`` across two *sharded* indexes in exact
    single-chip row order (the multi-chip form of
    index.query.iter_kmer_pairs_chunks; intended semantics of the
    reference's broken hash-vs-hash entry, src/kmer_hash.c:1190-1238).

    Both indexes are re-sharded by key RANGE using ``a``'s splitters, so
    every shard owns the same key interval in both; each shard emits its
    (a_pos, b_pos) cross-products in a-sorted order through fixed-size
    drained chunks, and shard-major emission reproduces the single-chip
    row order exactly — no host-side sort. Host buffering is BOUNDED:
    shards ahead of the emission head stall (start pinned at their total)
    once they hold 2 chunks, so the repeat-rich blow-up table
    (README.md:80-89) streams through ~3*D*capacity rows of host memory
    instead of materialising."""
    if a.mesh is not b.mesh and a.mesh != b.mesh:
        raise ValueError("both indexes must live on the same mesh")
    if a.k != b.k:
        raise ValueError("k mismatch between indexes")
    axis, D = a.axis, a.n_shards
    a_hi, a_lo, a_pos, a_nv = a._range_partitioned()
    spl = a._rp_spl
    b_hi, b_lo, b_pos, b_nv = b._range_partitioned(splitters=spl)
    a_nv_d = _global_put(a.mesh, a_nv.astype(np.int32))
    b_nv_d = _global_put(a.mesh, b_nv.astype(np.int32))

    def build_total():
        def fn_total(ah, al, an, bh, bl, bn):
            ah, al = ah.reshape(-1), al.reshape(-1)
            bh, bl = bh.reshape(-1), bl.reshape(-1)
            lb, ub = srt.lookup_bounds(bh, bl, bn[0], ah, al)
            live_a = jnp.arange(ah.shape[0], dtype=I32) < an[0]
            return jnp.where(live_a, ub - lb, 0).astype(I64).sum()[None]

        return jax.jit(jax.shard_map(
            fn_total, mesh=a.mesh, in_specs=(P(axis),) * 6,
            out_specs=P(axis),
        ))

    total_sf = _shared_program(
        ("xpairs_total", a.mesh, int(a_hi.shape[-1]), int(b_hi.shape[-1])),
        build_total)
    totals = _host_read(
        total_sf(a_hi, a_lo, a_nv_d, b_hi, b_lo, b_nv_d)).astype(np.int64)
    C = srt.clamp_chunk_capacity(capacity, int(totals.max(initial=0)))

    if exp.use_plan(int(totals.max(initial=0)), int(a_hi.shape[-1]), C):

        def build_plan():
            def plan_fn(ah, al, ap, an, bh, bl, bn):
                ah, al, ap = ah.reshape(-1), al.reshape(-1), ap.reshape(-1)
                bh, bl = bh.reshape(-1), bl.reshape(-1)
                lb, ub = srt.lookup_bounds(bh, bl, bn[0], ah, al)
                live_a = jnp.arange(ah.shape[0], dtype=I32) < an[0]
                c = jnp.where(live_a, ub - lb, 0).astype(I32)
                cum, rs, _w, cols, total = exp._build_plan(c, (lb, ap), C, 2)
                return (cum[None], rs[None], cols[0][None], cols[1][None],
                        total[None])

            return jax.jit(jax.shard_map(
                plan_fn, mesh=a.mesh, in_specs=(P(axis),) * 7,
                out_specs=(P(axis),) * 5,
            ))

        plan_sf = _shared_program(
            ("xpairs_plan", a.mesh, int(a_hi.shape[-1]),
             int(b_hi.shape[-1]), C), build_plan)
        p_cum, p_rs, p_lb, p_x, p_tot = plan_sf(
            a_hi, a_lo, a_pos, a_nv_d, b_hi, b_lo, b_nv_d)

        def build_chunk():
            def fn(bp, cum, rs, lbp, xp, tot, start):
                bp = bp.reshape(-1)
                cum, rs = cum.reshape(-1), rs.reshape(-1)
                lbp, xp = lbp.reshape(-1), xp.reshape(-1)
                src, t, g = exp.chunk_src(cum, rs, start[0], C)
                j = bp[jnp.clip(lbp[src] + t, 0, bp.shape[0] - 1)]
                ok = g < tot[0]
                rows = jnp.stack([jnp.where(ok, xp[src], 0),
                                  jnp.where(ok, j, 0)], axis=1)
                return rows[None], ok.sum(dtype=I32)[None], tot[0][None]

            return jax.jit(jax.shard_map(
                fn, mesh=a.mesh, in_specs=(P(axis),) * 7,
                out_specs=(P(axis),) * 3,
            ))

        shard_fn_p = _shared_program(
            ("xpairs_chunkp", a.mesh, int(b_pos.shape[-1]),
             int(a_hi.shape[-1]), C), build_chunk)

        def call(starts_v):
            starts = _global_put(a.mesh,
                                 np.asarray(starts_v, np.int64)[:, None])
            return shard_fn_p(b_pos, p_cum, p_rs, p_lb, p_x, p_tot, starts)
    else:

        def build_fb():
            def fn(ah, al, ap, an, bh, bl, bp, bn, start):
                ah, al, ap = ah.reshape(-1), al.reshape(-1), ap.reshape(-1)
                bh, bl, bp = bh.reshape(-1), bl.reshape(-1), bp.reshape(-1)
                lb, ub = srt.lookup_bounds(bh, bl, bn[0], ah, al)
                live_a = jnp.arange(ah.shape[0], dtype=I32) < an[0]
                c = jnp.where(live_a, ub - lb, 0).astype(I32)
                cum = jnp.cumsum(c.astype(I64))
                g = start[0] + jnp.arange(C, dtype=I64)
                w = srt.expand_rank_i64(cum, g, ah.shape[0])
                t = (g - (cum - c.astype(I64))[w]).astype(I32)
                j = bp[jnp.clip(lb[w] + t, 0, bp.shape[0] - 1)]
                ok = g < cum[-1]
                rows = jnp.stack([jnp.where(ok, ap[w], 0),
                                  jnp.where(ok, j, 0)], axis=1)
                return rows[None], ok.sum(dtype=I32)[None], cum[-1][None]

            return jax.jit(
                jax.shard_map(
                    fn, mesh=a.mesh,
                    in_specs=(P(axis),) * 4 + (P(axis),) * 4 + (P(axis),),
                    out_specs=(P(axis), P(axis), P(axis)),
                )
            )

        shard_fn = _shared_program(
            ("xpairs_chunk", a.mesh, int(a_hi.shape[-1]),
             int(b_hi.shape[-1]), C), build_fb)

        def call(starts_v):
            starts = _global_put(a.mesh,
                                 np.asarray(starts_v, np.int64)[:, None])
            return shard_fn(a_hi, a_lo, a_pos, a_nv_d,
                            b_hi, b_lo, b_pos, b_nv_d, starts)

    bufs = [[] for _ in range(D)]  # per-shard FIFO of drained blocks
    buffered = np.zeros(D, np.int64)  # rows held per shard
    cursors = np.zeros(D, np.int64)
    emit_d = 0  # shard-major emission head
    _PAIRS_STREAM_STATS["peak_rows"] = 0
    if not totals.any():  # same contract as the single-chip iterator
        yield np.zeros((0, 2), np.int32)
        return
    while emit_d < D:
        unfinished = cursors < totals
        # the emission-head shard always drains (its buffer empties each
        # round below); shards ahead stall at 2 chunks of buffered rows
        willing = unfinished & (buffered < 2 * C)
        if willing.any():
            starts = np.where(willing, cursors, totals)
            rows, n, _tot = call(starts)
            rows, n = _host_read(rows), _host_read(n)
            for d in range(D):
                if willing[d] and n[d]:
                    bufs[d].append(rows[d, : n[d]].astype(np.int32))
                    buffered[d] += int(n[d])
            cursors = np.where(willing, cursors + C, cursors)
        _PAIRS_STREAM_STATS["peak_rows"] = max(
            _PAIRS_STREAM_STATS["peak_rows"], int(buffered.sum()))
        # emit everything buffered at the head (its stream arrives in
        # order); advance the head past fully-drained, fully-emitted shards
        while emit_d < D:
            while bufs[emit_d]:
                blk = bufs[emit_d].pop(0)
                buffered[emit_d] -= blk.shape[0]
                yield blk
            if cursors[emit_d] >= totals[emit_d]:
                emit_d += 1
            else:
                break


def kmer_pairs_sharded(a: "ShardedKmerIndex", b: "ShardedKmerIndex",
                       capacity: int = 1 << 20,
                       max_pairs: "int | None" = None) -> np.ndarray:
    """Eager ``kmer.pairs`` across two sharded indexes: thin collector
    over :func:`iter_kmer_pairs_sharded_chunks`. ``max_pairs`` aborts
    the collection as soon as the table exceeds it (stream past the
    blow-up with the iterator instead)."""
    blocks, total = [], 0
    for blk in iter_kmer_pairs_sharded_chunks(a, b, capacity):
        total += blk.shape[0]
        if max_pairs is not None and total > max_pairs:
            raise MemoryError(
                f"kmer.pairs has > max_pairs={max_pairs} rows; stream "
                "them with iter_kmer_pairs_sharded_chunks instead")
        blocks.append(blk)
    if not blocks:
        return np.zeros((0, 2), np.int32)
    return np.concatenate(blocks, axis=0).astype(np.int32)


def _host_read(x) -> np.ndarray:
    """Read a (possibly multi-process) global array back to every host."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def _route_spec_flat(spec, b_hi, b_lo, b_val):
    """Traced inside shard_map: rows -> owner devices. Flat: one
    all_to_all over the single axis. Hierarchical ("dcn","ici", see
    parallel.mesh.make_hierarchical_mesh): group-bucketed all_to_all
    across groups first (n_dcn coarse blocks), then per-owner all_to_all
    within a group — same total volume, the slow link moves it in
    group-sized transfers (global shard id = group * n_ici + intra,
    matching the mesh's row-major device order)."""
    axes, mesh_shape, D, k, C, _keyonly = spec
    zero = jnp.zeros_like(b_hi, I32)
    if len(axes) == 1:
        s_hi, s_lo, _sp, s_val, ovf = _bucket_for_send(
            b_hi, b_lo, zero, b_val, D, C, k
        )
        r_hi = jax.lax.all_to_all(s_hi, axes[0], 0, 0).reshape(-1)
        r_lo = jax.lax.all_to_all(s_lo, axes[0], 0, 0).reshape(-1)
        r_val = jax.lax.all_to_all(s_val, axes[0], 0, 0).reshape(-1)
        return r_hi, r_lo, r_val, ovf
    n_dcn, n_ici = mesh_shape
    own = owner_hash(b_hi, b_lo, D)
    s1 = _bucket_for_send(b_hi, b_lo, zero, b_val, n_dcn,
                          C * n_ici, k, owner=own // n_ici)
    h1 = jax.lax.all_to_all(s1[0], axes[0], 0, 0).reshape(-1)
    l1 = jax.lax.all_to_all(s1[1], axes[0], 0, 0).reshape(-1)
    v1 = jax.lax.all_to_all(s1[3], axes[0], 0, 0).reshape(-1)
    own2 = owner_hash(h1, l1, D) % n_ici
    s2 = _bucket_for_send(h1, l1, jnp.zeros_like(h1, I32), v1,
                          n_ici, C * n_dcn, k, owner=own2)
    r_hi = jax.lax.all_to_all(s2[0], axes[1], 0, 0).reshape(-1)
    r_lo = jax.lax.all_to_all(s2[1], axes[1], 0, 0).reshape(-1)
    r_val = jax.lax.all_to_all(s2[3], axes[1], 0, 0).reshape(-1)
    return r_hi, r_lo, r_val, s1[4] | s2[4]


def _route_build_spec(spec, b_hi, b_lo, b_val, onehot):
    """Traced inside shard_map: route flat observations to their owner
    shards and build this shard's sorted run; one replicated stats
    vector rides the (already required) overflow readback:
    [per-source observations..., per-shard live rows (D), overflow].
    The live entries let _append_run slice every shard's run to the
    pow-2 bucket of the fullest live prefix (dead routing slots +
    dead-quality windows dominate the run otherwise) at zero extra
    readbacks. ``spec`` is a store's _route_spec() snapshot — closures
    capture it instead of the store itself."""
    from ..index import count_store as cs

    axes, mesh_shape, D, k, _C, keyonly = spec
    r_hi, r_lo, r_val, ovf = _route_spec_flat(spec, b_hi, b_lo, b_val)
    if keyonly:
        rh, rl, n_obs = cs._build_run_keys(r_hi, r_lo, r_val, k)
        rc = None
    else:
        rh, rl, rc, n_obs = cs._build_run_direct(r_hi, r_lo, r_val,
                                                 onehot, k)
    # per-shard live counts ride a one-hot psum; the consumer takes the
    # max host-side. Flat shard id works for
    # both the 1-axis and the hierarchical ("dcn","ici") mesh.
    sid = jax.lax.axis_index(axes[0])
    for i, ax in enumerate(axes[1:]):
        sid = sid * mesh_shape[i + 1] + jax.lax.axis_index(ax)
    lives = (jnp.zeros(D, jnp.int64)
             .at[sid].set(n_obs.astype(jnp.int64)))
    stats = jax.lax.psum(
        jnp.concatenate([
            (onehot.astype(jnp.int64) * n_obs),
            lives,
            ovf.astype(jnp.int64)[None],
        ]), axes,
    )
    if rc is None:
        return rh[None], rl[None], stats
    return rh[None], rl[None], rc[None], stats


class ShardedCountStore:
    """Canonical k-mer counting sharded by key hash: data-parallel read
    batches, all_to_all routing, per-device sorted count shards — the true
    data-parallel upgrade of the reference's redundant-read pool
    (SURVEY.md §2.2).

    Works on a single-process mesh and on a multi-process
    (``jax.distributed``) mesh: each process feeds its *local* rows of a
    batch (its own read slice, see ``distributed.host_read_slice``) and
    host readbacks allgather across processes.
    """

    def __init__(self, k: int, mesh: Mesh, counts_n: int = 1,
                 capacity: int = 1 << 7,
                 spill_bytes: "Optional[int]" = None,
                 spill_dir: "Optional[str]" = None):
        # ``capacity`` is only a floor: every batch entry autosizes the
        # per-destination routing capacity from the GLOBAL batch volume
        # (_autosize_capacity) and overflow retries double it, so a small
        # default keeps tiny batches from building (and compiling merge
        # networks over) runs far larger than the data they carry.
        self.k = int(k)
        self.mesh = mesh
        # one mesh axis = flat key sharding; two axes ("dcn", "ici") = a
        # two-level mesh (make_hierarchical_mesh): add_batch then routes
        # group-first so traffic on the slow link moves in n_slices
        # coarse blocks, and every other collective runs over both axes
        self.axes = tuple(mesh.axis_names)
        if len(self.axes) > 2:
            raise ValueError("mesh must have 1 or 2 axes")
        self.axis = self.axes[0]
        self.n_shards = mesh.size
        self.counts_n = int(counts_n)
        self.capacity = capacity
        D = self.n_shards
        cap0 = 64
        self.u_hi = self._global_put(np.zeros((D, cap0), np.uint32))
        self.u_lo = self._global_put(np.zeros((D, cap0), np.uint32))
        self.cnt = self._global_put(np.zeros((D, cap0, counts_n), np.uint32))
        self._n_unique = np.zeros(D, np.int64)
        self.total_added = np.zeros(counts_n, np.int64)
        # per-shard LSM runs: list of (hi [D,C], lo [D,C], cnt [D,C,n]);
        # tier-merged with a vmapped _merge_runs, folded at reads
        self._runs = []
        # host/disk spill like the single-chip store (count_store.py):
        # past spill_bytes of device-resident run bytes the largest run
        # sets move off-device (allgathered host np, or an .npz under
        # spill_dir) and rejoin one at a time at fold time
        self.spill_bytes = spill_bytes
        self.spill_dir = spill_dir
        self._spilled = []  # ('mem', (hi, lo, cnt) np [D,...]) | ('file', p)
        self._spill_seq = 0

    @property
    def n_unique(self) -> np.ndarray:
        self._fold()
        return self._n_unique

    @property
    def keyonly_runs(self) -> bool:
        """Per-shard tier runs may omit the count column (key-only unit
        runs) — same conditions as CountStore.keyonly_runs."""
        from ..index import count_store as cs

        return cs._KEYONLY_MERGE and cs._BITONIC_MERGE and self.k < 32

    def peek_n_unique(self) -> int:
        """Exact global distinct count WITHOUT the fold's consolidation +
        compaction sort (the CountStore.peek_n_unique analogue): merge the
        per-shard tier runs into one staged run set and scan each shard.
        A folded base table (checkpoints fold) joins as one more sorted
        run set over COPIES, so progress reads stay fold-free after
        checkpoints. Falls back to a full fold when spills exist or the
        sorted-run invariant is off."""
        from ..index import count_store as cs

        if not cs._BITONIC_MERGE or self._spilled:
            self._fold()
            return int(self._n_unique.sum())
        if not self._runs:
            return int(self._n_unique.sum())

        def pad_pow2(run):
            hi, lo, cnt = run[0], run[1], run[2]
            c = int(hi.shape[1])
            cap = 1 << max(6, (c - 1).bit_length())
            if cap == c:
                return run
            padw = cap - c
            hi = jnp.concatenate(
                [hi, jnp.full((hi.shape[0], padw), np.uint32(0xFFFFFFFF),
                              hi.dtype)], axis=1)
            lo = jnp.concatenate(
                [lo, jnp.full((lo.shape[0], padw), np.uint32(0xFFFFFFFF),
                              lo.dtype)], axis=1)
            if cnt is not None:
                cnt = jnp.pad(cnt, ((0, 0), (0, padw), (0, 0)))
            return (hi, lo, cnt) + run[3:]

        base_run = None
        if self._n_unique.max() > 0:
            # base-table COPY in run form (same cached program _fold uses)
            base_run = self._base_run()
        if base_run is None and len({r[3] for r in self._runs}) == 1:
            # uniform kind: merges preserve it, the staged run is kept
            while len(self._runs) > 1:
                self._runs.sort(key=lambda r: int(r[0].shape[1]),
                                reverse=True)
                b = self._runs.pop()
                a = self._runs.pop()
                self._runs.append(pad_pow2(self._vmerge_runs(a, b)))
            hi, lo, cnt = self._runs[0][:3]
        elif self.k < 32:
            # base and/or mixed kinds: distinct counting only needs keys
            # (k < 32), so merge key lanes of COPIES and keep the tier
            # state (and the folded base) untouched
            runs = [(r[0], r[1], None) for r in self._runs]
            if base_run is not None:
                runs.append((base_run[0], base_run[1], None))
            while len(runs) > 1:
                runs.sort(key=lambda r: int(r[0].shape[1]), reverse=True)
                b = runs.pop()
                a = runs.pop()
                oh, ol = self._vmerge_keys(a, b)
                runs.append(pad_pow2((oh, ol, None)))
            hi, lo, cnt = runs[0][0], runs[0][1], None
        else:
            # k == 32 with a base: the all-G key shares the sentinel, so
            # count lanes ride; merge cnt-carrying COPIES
            runs = [self._vmaterialize(r)[:3] for r in self._runs]
            if base_run is not None:
                runs.append(base_run)
            while len(runs) > 1:
                runs.sort(key=lambda r: int(r[0].shape[1]), reverse=True)
                b = runs.pop()
                a = runs.pop()
                runs.append(pad_pow2(self._vmerge_runs(a, b))[:3])
            hi, lo, cnt = runs[0][:3]
        keyonly = cnt is None

        def build():
            axes, mesh = self.axes, self.mesh  # no self in the closure

            def fn(*args):
                h = args[0].reshape(-1)
                l_ = args[1].reshape(-1)
                c = (args[2].reshape(args[2].shape[1], -1)
                     if not keyonly else None)
                n = cs._distinct_count_sorted(h, l_, c)
                return jax.lax.psum(n.astype(jnp.int64), axes)

            n_in = 2 if keyonly else 3
            return jax.jit(
                jax.shard_map(
                    fn, mesh=mesh, in_specs=(P(axes),) * n_in,
                    out_specs=P(),
                )
            )

        fn = self._program(("peek", int(hi.shape[1]), keyonly), build)
        out = fn(hi, lo) if keyonly else fn(hi, lo, cnt)
        return int(np.asarray(out.addressable_data(0)))

    @n_unique.setter
    def n_unique(self, v) -> None:  # checkpoint restore
        self._n_unique = np.asarray(v, np.int64)

    def _global_put(self, full_np):
        """Host value (identical on every process) -> global array sharded
        P(axes) over the mesh. Plain device array on a single process."""
        return _global_put(self.mesh, full_np, spec=P(self.axes))

    def _globalize(self, arr):
        """Turn per-process local batch rows into one global [D, n] array
        sharded over the mesh (no-op equivalent on a single process)."""
        if jax.process_count() == 1:
            return arr
        from jax.sharding import NamedSharding

        sharding = NamedSharding(self.mesh, P(self.axes))
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(arr)
        )

    def _route_spec(self) -> tuple:
        """Immutable snapshot of everything the routed-build trace reads:
        (axes, mesh axis sizes, D, k, capacity, keyonly). The batch-entry
        closures capture THIS instead of ``self`` so the module-wide
        program cache never pins a store (and its HBM arrays), and a
        later ``capacity`` growth can't leak into a retrace of an
        already-keyed program."""
        return (self.axes, tuple(self.mesh.devices.shape), self.n_shards,
                self.k, self.capacity, self.keyonly_runs)

    def _route_build(self, b_hi, b_lo, b_val, onehot):
        return _route_build_spec(self._route_spec(), b_hi, b_lo, b_val,
                                 onehot)

    def _autosize_capacity(self, flat_per_device: int) -> None:
        """Size the per-destination routing capacity for the observation
        volume actually flowing: expected keys per destination are
        flat/D (uniform salted hash), kept with 2x headroom. Derived from
        GLOBAL batch shape, so every process lands on the same static.
        Only ever grows (overflow retries below may have grown it)."""
        need = 2 * flat_per_device // max(1, self.n_shards)
        cap = 1 << max(7, int(max(1, need) - 1).bit_length())
        if cap > self.capacity:
            self.capacity = cap

    def _append_run(self, r_hi, r_lo, r_cnt, stats,
                    source: int = 0) -> bool:
        """Common tail of the batch entries: overflow check, stats fold,
        LSM tiering. Key-only runs (r_cnt None) carry their source as a
        host-side tag. Returns False on routing overflow (callers retry
        the batch at doubled capacity; stats/runs untouched — the psum-
        replicated flag means every process sees the same outcome and
        retries in lockstep, so nothing is ever silently dropped)."""
        # stats is psum-replicated: every process reads its local copy
        stats = np.asarray(stats.addressable_data(0))
        if int(stats[-1]) > 0:
            return False
        D = self.n_shards
        self.total_added += stats[:-(D + 1)].astype(np.int64)
        from ..index import count_store as cs

        cap = int(r_hi.shape[1])
        if cs._TRIM_RUNS and cs._BITONIC_MERGE:
            # live-prefix trim (see count_store._flush_deferred): slice
            # every shard's run to the pow-2 bucket of the fullest live
            # prefix — the per-shard live counts rode the stats readback
            # that already had to happen for the overflow flag
            new = cs._next_pow2(max(int(stats[-(D + 1):-1].max()), 1 << 6))
            if new < cap:
                r_hi, r_lo = r_hi[:, :new], r_lo[:, :new]
                if r_cnt is not None:
                    r_cnt = r_cnt[:, :new]
        self._runs.append((r_hi, r_lo, r_cnt,
                           source if r_cnt is None else None))
        self._compact_tiers()
        return True

    _MAX_CAPACITY = 1 << 27

    def _grow_capacity(self) -> None:
        if self.capacity >= self._MAX_CAPACITY:
            raise RuntimeError(
                "routing capacity overflow after retries; keys are "
                "pathologically skewed across owner shards")
        self.capacity *= 2

    def _program(self, key, build):
        """Cache of jitted shard_map programs, shared MODULE-wIDE: the
        traced structure depends only on (mesh, k, counts_n, keyonly)
        plus each site's local statics (capacity, shapes, source, tag),
        all of which join the key — so a fresh store instance on the same
        mesh reuses every compiled program instead of re-tracing (the
        sharded_hybrid bench re-traced 16 batch programs per store on a
        ~50x-throttled host). Builders must bind every ``self`` attribute
        to a local BEFORE the traced fn (see _route_spec): a retained
        closure over ``self`` would pin the store and its HBM arrays in
        the module cache for the process lifetime."""
        full = (self.mesh, self.k, self.counts_n,
                self.keyonly_runs) + tuple(key)
        return _PROGRAMS.get_or_build(full, build)

    def add_batch(self, hi, lo, valid, source: int = 0):
        """hi/lo/valid: [D, n] observations (each device's slice of the
        read batch, already canonical). On a multi-process mesh pass the
        *local* [D_local, n] rows for this process's devices.

        Routes keys to their owner shards and appends a per-shard sorted
        *run* (LSM tiering, like the single-chip store) — the base table
        is only touched when a read folds. The only per-batch host sync is
        the routing-overflow flag (kept so overflow is detected, never
        dropped)."""
        axes = self.axes
        onehot = jnp.zeros(self.counts_n, U32).at[source].set(1)
        hi = self._globalize(hi)
        lo = self._globalize(lo)
        valid = self._globalize(valid)

        keyonly = self.keyonly_runs

        # hi is the GLOBAL [D, n] batch after _globalize: n per device
        self._autosize_capacity(int(hi.shape[-1]))
        while True:
            spec = self._route_spec()
            mesh = self.mesh

            def build():
                def fn(b_hi, b_lo, b_val):
                    return _route_build_spec(spec, b_hi.reshape(-1),
                                             b_lo.reshape(-1),
                                             b_val.reshape(-1), onehot)

                out_specs = ((P(axes), P(axes), P()) if keyonly
                             else (P(axes), P(axes), P(axes), P()))
                return jax.jit(
                    jax.shard_map(
                        fn, mesh=mesh,
                        in_specs=(P(axes), P(axes), P(axes)),
                        out_specs=out_specs,
                    )
                )

            shard_fn = self._program(
                ("add_batch", source, keyonly, self.capacity), build)
            out = shard_fn(hi, lo, valid)
            if keyonly:
                if self._append_run(out[0], out[1], None, out[2],
                                    source=source):
                    return
            elif self._append_run(out[0], out[1], out[2], out[3]):
                return
            self._grow_capacity()  # skewed shards: retry with headroom

    def add_reads(self, seq, qual, lengths, has_qual, min_ll_f: float,
                  precision: str = "fast", source: int = 0,
                  with_q: bool = True, with_noq: bool = False,
                  min_q_char: int | None = None,
                  n_win: int | None = None):
        """Fused sharded counterpart of counting._fused_rp_batch: the
        whole read batch — quality-likelihood FSM (+ no-quality encoder
        rows) -> canonical -> all_to_all routing -> per-shard sorted run —
        as ONE shard_map program, so a batch costs one dispatch instead of
        several eager FSM/canonical rounds plus the routing program.

        ``seq`` is a [B, L] byte plane or the packed (codes, nmask) upload
        tuple (io.native.iter_fastx_packed); rows are this process's local
        slice with B divisible by its local device count. ``with_q`` /
        ``with_noq`` must be computed from the FULL batch (identical on
        every process — they select program structure, which has to match
        across the collective)."""
        from ..ops import encode as enc
        from ..ops import scan_iter as si

        # ``n_win`` (static, identical on every process — derived from the
        # FULL batch) trims the window axis like counting._fused_rp_batch:
        # dead window columns inflate the routed runs' pow-2 capacities

        axes, k = self.axes, self.k
        onehot = jnp.zeros(self.counts_n, U32).at[source].set(1)
        seq = (tuple(self._globalize(p) for p in seq)
               if isinstance(seq, tuple) else self._globalize(seq))
        packed_q = isinstance(qual, tuple)
        if packed_q:
            # 4-bit dictionary form (io.native.iter_fastx_packed): route
            # the nibble plane like the rows and give every shard its own
            # [1, 16] dict row (safe even if per-process dicts differed)
            qnib, qdict = qual
            n_loc = self.n_shards // jax.process_count()
            qdict_np = np.asarray(qdict, np.uint8)  # [16] dict or [1] q6
            qdict_t = np.ascontiguousarray(np.broadcast_to(
                qdict_np, (n_loc, qdict_np.shape[0])))
            qual = (self._globalize(qnib), self._globalize(qdict_t))
        else:
            qual = self._globalize(qual)
        lengths = self._globalize(lengths)
        has_qual = self._globalize(has_qual)
        # 0 = raw byte plane; else the packed-tuple arity
        # (2 = codes+nmask, 1 = codes only for N-free batches)
        packed = len(seq) if isinstance(seq, tuple) else 0

        def build():
            min_ll = jnp.asarray(float(min_ll_f))
            # immutable snapshots: the cached program must pin neither
            # the store nor a mutable capacity (see _route_spec)
            spec = self._route_spec()
            mesh = self.mesh

            def fn(seq, qual, lens, hq):
                if packed:
                    seq = enc.unpack_seq(*seq)
                if packed_q:
                    qual = enc.unpack_qual(qual[0], qual[1][0])
                chi = clo = emit = None
                if with_q:
                    q_lens = jnp.where(hq, lens, 0)
                    if precision == "hybrid":
                        # fast f32 FSM with borderline flags — bitwise
                        # -equal to precision="exact" (unflagged reads are
                        # proven identical by the ll_scan(return_flags)
                        # bound; flagged ones are recomputed exactly).
                        # The exact f64 re-scan follows the single-chip
                        # compaction discipline (counting._compact_flagged
                        # / _sweep_backlog): flagged rows gather into a
                        # fixed 256-row sub-batch per shard, so a shard
                        # with a handful of borderline reads pays f64 for
                        # 256 rows, not its whole block; only shards where
                        # MORE than 256 rows flag re-run the whole block.
                        # The lax.cond predicates are per-shard and the
                        # branches hold no collectives, so unflagged
                        # shards skip the emulated-f64 work entirely.
                        fast = si.ll_scan(seq, qual, q_lens, k, min_ll,
                                          precision="fast",
                                          return_flags=True,
                                          min_q_char=min_q_char)
                        flags = fast[5]
                        R = min(256, int(flags.shape[0]))

                        def _compact(_):
                            order = jnp.argsort(~flags)  # flagged first
                            rows = order[:R]
                            sub_flag = flags[rows]
                            sub_lens = jnp.where(sub_flag, q_lens[rows], 0)
                            ex = si.ll_scan(seq[rows], qual[rows],
                                            sub_lens, k, min_ll,
                                            precision="exact")
                            f = sub_flag[:, None]
                            return tuple(
                                fast[i].at[rows].set(
                                    jnp.where(f, ex[i], fast[i][rows]))
                                for i in range(5)
                            )

                        def _whole(_):
                            ex = si.ll_scan(seq, qual, q_lens, k, min_ll,
                                            precision="exact")
                            f = flags[:, None]
                            return tuple(
                                jnp.where(f, ex[i], fast[i])
                                for i in range(5)
                            )

                        n_flag = flags.sum()
                        out = jax.lax.cond(
                            n_flag == 0, lambda _: fast[:5],
                            lambda _: jax.lax.cond(n_flag <= R, _compact,
                                                   _whole, None),
                            None)
                    else:
                        out = si.ll_scan(seq, qual, q_lens, k, min_ll,
                                         precision=precision)
                    chi, clo = enc.canonical_windows(out[1], out[2],
                                                     out[3], out[4])
                    emit = out[0]
                    if n_win is not None:
                        # FSM windows are END-aligned: live ends sit in
                        # [k-1, true_max_len)
                        nw = max(1, min(n_win, emit.shape[1] - k + 1))
                        emit = emit[:, k - 1:k - 1 + nw]
                        chi = chi[:, k - 1:k - 1 + nw]
                        clo = clo[:, k - 1:k - 1 + nw]
                if with_noq:
                    hi2, lo2, v2 = enc.encode_stream(
                        seq, k, jnp.where(~hq, lens, 0), canonical=True,
                        drop_trailing_exact_k=False,
                    )
                    v2 = v2 & (lens > k)[:, None]
                    if n_win is not None:
                        # encoder windows are START-aligned
                        nw = max(1, min(n_win, v2.shape[1] - k + 1))
                        hi2, lo2, v2 = (hi2[:, :nw], lo2[:, :nw],
                                        v2[:, :nw])
                    if chi is None:
                        chi, clo, emit = hi2, lo2, v2
                    else:
                        chi = jnp.where(hq[:, None], chi, hi2)
                        clo = jnp.where(hq[:, None], clo, lo2)
                        emit = emit | v2
                return _route_build_spec(spec, chi.reshape(-1),
                                         clo.reshape(-1),
                                         emit.reshape(-1), onehot)

            seq_spec = ((P(axes),) * packed if packed else P(axes))
            qual_spec = ((P(axes), P(axes)) if packed_q else P(axes))
            out_specs = ((P(axes), P(axes), P()) if keyonly
                         else (P(axes), P(axes), P(axes), P()))
            return jax.jit(
                jax.shard_map(
                    fn, mesh=mesh,
                    in_specs=(seq_spec, qual_spec, P(axes), P(axes)),
                    out_specs=out_specs,
                )
            )

        keyonly = self.keyonly_runs
        # observation volume per device: rows/D x window-axis width
        # (lengths is the GLOBAL [B] vector after _globalize)
        if n_win is not None:
            nw_eff = n_win
        elif packed:
            nw_eff = int(seq[0].shape[-1]) * 4
        else:
            nw_eff = int(seq.shape[-1])
        self._autosize_capacity(
            int(lengths.shape[0]) // self.n_shards * nw_eff)
        while True:
            shard_fn = self._program(
                ("add_reads", source, float(min_ll_f), precision, with_q,
                 with_noq, packed, packed_q, keyonly, min_q_char, n_win,
                 self.capacity),
                build,
            )
            out = shard_fn(seq, qual, lengths, has_qual)
            if keyonly:
                if self._append_run(out[0], out[1], None, out[2],
                                    source=source):
                    return
            elif self._append_run(out[0], out[1], out[2], out[3]):
                return
            self._grow_capacity()  # skewed shards: retry with headroom

    def _vmaterialize(self, run):
        """Materialise the count column of a key-only per-shard run set:
        (hi [D,C], lo [D,C], None, tag) -> cnt [D, C, counts_n] (one-hot
        of the run's source tag). Count-carrying runs pass through
        unchanged — deriving liveness from key != all-ones would mark a
        REAL all-G k=32 kmer dead (the single-chip _materialize has the
        same passthrough)."""
        from ..index import count_store as cs

        if run[2] is not None:
            return run
        tag = run[3] if len(run) > 3 else 0
        counts_n = self.counts_n

        def build():
            axes, mesh = self.axes, self.mesh  # no self in the closure

            def fn(hi, lo):
                if counts_n == 1:
                    c = cs._unit_run_cnt(hi.reshape(-1), lo.reshape(-1))
                else:
                    c = cs._unit_run_cnt_onehot(
                        hi.reshape(-1), lo.reshape(-1), counts_n, tag)
                return c[None]

            return jax.jit(
                jax.shard_map(
                    fn, mesh=mesh, in_specs=(P(axes),) * 2,
                    out_specs=P(axes),
                )
            )

        fn = self._program(("vmaterialize", int(run[0].shape[1]), tag),
                           build)
        return (run[0], run[1], fn(run[0], run[1]), None)

    def _vmerge_keys(self, a, b):
        """Bitonic key-lane merge of two per-shard run sets -> (hi, lo)
        of shape [D, Ca+Cb]; count lanes (if any) are ignored."""
        from ..index import count_store as cs

        def build_keys():
            axes, mesh, k = self.axes, self.mesh, self.k

            def fn(a_hi, a_lo, b_hi, b_lo):
                oh, ol = cs._merge_runs_keyonly(
                    a_hi.reshape(-1), a_lo.reshape(-1),
                    b_hi.reshape(-1), b_lo.reshape(-1), k=k,
                )
                return oh[None], ol[None]

            return jax.jit(
                jax.shard_map(
                    fn, mesh=mesh, in_specs=(P(axes),) * 4,
                    out_specs=(P(axes),) * 2,
                )
            )

        fn = self._program(
            ("vmerge_keys", int(a[0].shape[1]), int(b[0].shape[1])),
            build_keys)
        return fn(a[0], a[1], b[0], b[1])

    def _vmerge_runs(self, a, b):
        """Tier-merge two per-shard run sets: [D, Ca] + [D, Cb] -> [D,
        Ca+Cb], rows independent (shard_map over the mesh so each device
        merges only its own rows). Two key-only run sets of the same
        source merge key-only (no count lanes move); any other pair
        materialises first."""
        from ..index import count_store as cs

        tag_a = a[3] if len(a) > 3 else None
        tag_b = b[3] if len(b) > 3 else None
        if tag_a is not None and tag_a == tag_b:
            oh, ol = self._vmerge_keys(a, b)
            return (oh, ol, None, tag_a)
        if a[2] is None:
            a = self._vmaterialize(a)
        if b[2] is None:
            b = self._vmaterialize(b)

        def build():
            axes, mesh, k = self.axes, self.mesh, self.k

            def fn(a_hi, a_lo, a_cnt, b_hi, b_lo, b_cnt):
                out = cs._merge_runs(
                    a_hi.reshape(-1), a_lo.reshape(-1),
                    a_cnt.reshape(a_cnt.shape[1], -1),
                    b_hi.reshape(-1), b_lo.reshape(-1),
                    b_cnt.reshape(b_cnt.shape[1], -1),
                    k=k,
                )
                return out[0][None], out[1][None], out[2][None]

            return jax.jit(
                jax.shard_map(
                    fn, mesh=mesh, in_specs=(P(axes),) * 6,
                    out_specs=(P(axes),) * 3,
                )
            )

        # one cached wrapper per (Ca, Cb) capacity pair: _compact_tiers
        # runs ~once per batch, and a fresh jit wrapper per call would
        # re-trace the merge program on the hot path
        shard_fn = self._program(
            ("vmerge", int(a[0].shape[1]), int(b[0].shape[1])), build)
        return shard_fn(a[0], a[1], a[2], b[0], b[1], b[2]) + (None,)

    def _compact_tiers(self):
        from ..index.count_store import lsm_compact

        self._runs = lsm_compact(
            self._runs,
            lambda r: (int(r[0].shape[1]),
                       "cnt" if r[3] is None else r[3]),
            self._vmerge_runs)
        self._spill_if_needed()

    # -- host/disk spill (mirrors count_store.CountStore) -------------------
    def _device_run_bytes(self) -> int:
        return sum(
            int(r[0].shape[1]) * self.n_shards
            * (8 + (4 * self.counts_n if r[2] is not None else 0))
            for r in self._runs
        )

    def _spill_one(self) -> None:
        """Allgather the largest per-shard run set to host (every process
        holds the full [D, C] copy, so rejoining is a plain _global_put)."""
        self._runs.sort(key=lambda r: int(r[0].shape[1]))
        run = self._runs.pop()
        if run[2] is None:
            run = self._vmaterialize(run)
        hi, lo, cnt = run[0], run[1], run[2]
        a = (_host_read(hi), _host_read(lo), _host_read(cnt))
        if self.spill_dir is not None:
            os.makedirs(self.spill_dir, exist_ok=True)
            path = os.path.join(  # per-process file: each rejoins its own
                self.spill_dir,
                f"kmh_sspill_{id(self):x}_p{jax.process_index()}"
                f"_{self._spill_seq}.npz",
            )
            np.savez(path, hi=a[0], lo=a[1], cnt=a[2])
            self._spilled.append(("file", path))
        else:
            self._spilled.append(("mem", a))
        self._spill_seq += 1

    def _spill_if_needed(self) -> None:
        if self.spill_bytes is None:
            return
        # spilling the last run is allowed (same as the single-chip store)
        while self._runs and self._device_run_bytes() > self.spill_bytes:
            self._spill_one()

    def _load_spilled(self, entry):
        tag, payload = entry
        if tag == "file":
            with np.load(payload) as z:
                a = (z["hi"], z["lo"], z["cnt"])
            os.remove(payload)
        else:
            a = payload
        return tuple(self._global_put(x) for x in a)

    def _base_run(self):
        """The folded base table as one more (sorted, consolidated) run
        set — used by _fold and the fold-free peek. The shard_map program
        caches per base capacity (re-jitting per fold was a fresh trace
        on every fold on this throttled host)."""
        from ..index import count_store as cs

        def build():
            axes, mesh = self.axes, self.mesh  # no self in the closure

            def to_run(u_hi, u_lo, cnt, ns):
                r = cs._run_from_merge(
                    u_hi.reshape(-1), u_lo.reshape(-1),
                    cnt.reshape(cnt.shape[1], -1), ns[0],
                )
                return r[0][None], r[1][None], r[2][None]

            return jax.jit(
                jax.shard_map(
                    to_run, mesh=mesh, in_specs=(P(axes),) * 4,
                    out_specs=(P(axes),) * 3,
                )
            )

        run_fn = self._program(("base_to_run", int(self.u_hi.shape[1])),
                               build)
        ns = self._global_put(self._n_unique.astype(np.int32)
                              .reshape(-1, 1))
        return run_fn(self.u_hi, self.u_lo, self.cnt, ns)

    def _fold(self):
        """Fold runs into the compact per-shard base table (syncs once)."""
        if not self._runs and not self._spilled:
            return
        from ..index import count_store as cs

        if self._n_unique.max() > 0:
            self._runs.append(self._base_run() + (None,))
        self._runs.sort(key=lambda r: int(r[0].shape[1]), reverse=True)
        if not self._runs:  # only spilled runs: seed from the first one
            self._runs.append(
                self._load_spilled(self._spilled.pop()) + (None,))
        acc = self._runs.pop()
        while self._runs:
            acc = self._vmerge_runs(acc, self._runs.pop())
        while self._spilled:  # rejoin spilled runs one at a time
            acc = self._vmerge_runs(acc, self._load_spilled(
                self._spilled.pop()))
        if acc[2] is None:
            # all-key-only single-source fold: scatter-free consolidation
            tag = acc[3] if len(acc) > 3 else 0
            counts_n = self.counts_n

            def build_fin_keys():
                axes, mesh, k = self.axes, self.mesh, self.k

                def fin_keys(hi, lo):
                    u_hi, u_lo, u_cnt, n_u = cs._finalize_run_keys(
                        hi.reshape(-1), lo.reshape(-1), k=k,
                        counts_n=counts_n, source=tag,
                    )
                    return u_hi[None], u_lo[None], u_cnt[None], n_u[None]

                return jax.jit(
                    jax.shard_map(
                        fin_keys, mesh=mesh,
                        in_specs=(P(axes),) * 2,
                        out_specs=(P(axes),) * 4,
                    )
                )

            fin_fn = self._program(
                ("fold_fin_keys", int(acc[0].shape[1]), tag),
                build_fin_keys)
            u_hi, u_lo, cnt, n_u = fin_fn(acc[0], acc[1])
        else:
            def build_fin():
                axes, mesh, k = self.axes, self.mesh, self.k

                def fin(hi, lo, cnt):
                    u_hi, u_lo, u_cnt, n_u = cs._finalize_run(
                        hi.reshape(-1), lo.reshape(-1),
                        cnt.reshape(cnt.shape[1], -1), k=k,
                    )
                    return u_hi[None], u_lo[None], u_cnt[None], n_u[None]

                return jax.jit(
                    jax.shard_map(
                        fin, mesh=mesh, in_specs=(P(axes),) * 3,
                        out_specs=(P(axes),) * 4,
                    )
                )

            fin_fn = self._program(
                ("fold_fin", int(acc[0].shape[1])), build_fin)
            u_hi, u_lo, cnt, n_u = fin_fn(acc[0], acc[1], acc[2])
        self._n_unique = _host_read(n_u).astype(np.int64)
        need = 1 << max(6, int(max(self._n_unique.max(), 1) - 1)
                        .bit_length())
        if need < u_hi.shape[1]:
            u_hi, u_lo, cnt = (u_hi[:, :need], u_lo[:, :need],
                               cnt[:, :need])
        self.u_hi, self.u_lo, self.cnt = u_hi, u_lo, cnt

    def spectrum(self, max_count: int) -> np.ndarray:
        """Global count histogram: per-shard bincount + psum."""
        axes = self.axes
        nv = self._global_put(self.n_unique.astype(np.int32))

        from ..index import count_store as cs

        sort_based = cs._use_sort_spectrum()  # read OUTSIDE the trace

        def build():
            mesh = self.mesh  # no self in the retained closure

            def fn(cnt, ns):
                cnt0 = cnt.reshape(cnt.shape[1], -1)[:, 0]
                live = jnp.arange(cnt0.shape[0], dtype=I32) < ns[0]
                if sort_based:
                    # sort-based histogram (the single-chip _spectrum
                    # twin): a u32 sort + bin boundary searches
                    c = jnp.minimum(cnt0.astype(U32), np.uint32(max_count))
                    c = jnp.where(live, c, np.uint32(max_count + 1))
                    c_sorted = jax.lax.sort(c, dimension=-1,
                                            is_stable=False)
                    bins = jnp.arange(max_count + 3, dtype=U32)
                    idx = jnp.searchsorted(c_sorted, bins, side="left")
                    spec = (idx[1:] - idx[:-1]).astype(jnp.float64)
                else:
                    c = jnp.minimum(cnt0.astype(I64), max_count)
                    c = jnp.where(live, c, max_count + 1)
                    spec = jnp.zeros(max_count + 2,
                                     jnp.float64).at[c].add(1.0)
                return jax.lax.psum(spec[: max_count + 1], axes)

            return jax.jit(
                jax.shard_map(fn, mesh=mesh,
                              in_specs=(P(axes), P(axes)), out_specs=P())
            )

        shard_fn = self._program(
            ("spectrum", int(self.cnt.shape[1]), max_count, sort_based),
            build)
        return np.asarray(shard_fn(self.cnt, nv))

    def spectrum_n(self, max_count: int, comb, comb_inner,
                   source_min) -> np.ndarray:
        """Combinatorial multi-source spectrum, psum-merged across shards
        (kmer.spec.sh.n semantics, src/suffix_hash.c:335-425)."""
        from ..index.count_store import _spectrum_nc

        comb = np.asarray(comb, np.int32)
        comb_inner = np.asarray(comb_inner, np.int32)
        source_min = np.asarray(source_min, np.int64)
        axes = self.axes
        comb_n = int(len(comb))
        nv = self._global_put(self.n_unique.astype(np.int32))

        def build():
            mesh = self.mesh  # no self in the retained closure

            def fn(cnt, ns):
                cnt2 = cnt.reshape(cnt.shape[1], -1)
                live = jnp.arange(cnt2.shape[0], dtype=I32) < ns[0]
                out = _spectrum_nc(cnt2, live, max_count,
                                   jnp.asarray(comb),
                                   jnp.asarray(comb_inner),
                                   jnp.asarray(source_min), comb_n)
                return jax.lax.psum(out, axes)

            return jax.jit(
                jax.shard_map(fn, mesh=mesh,
                              in_specs=(P(axes), P(axes)), out_specs=P())
            )

        # comb/comb_inner/source_min are baked into the trace as
        # constants, so they must key the cache
        shard_fn = self._program(
            ("spectrum_n", int(self.cnt.shape[1]), max_count,
             comb.tobytes(), comb_inner.tobytes(), source_min.tobytes()),
            build)
        return np.asarray(shard_fn(self.cnt, nv))

    def lookup(self, q_hi, q_lo) -> np.ndarray:
        """Count rows for queries, merged across shards (each key lives on
        exactly one shard, so psum of per-shard lookups is exact)."""
        axes = self.axes
        nv = self._global_put(self.n_unique.astype(np.int32))

        def build():
            mesh = self.mesh  # no self in the retained closure

            def fn(u_hi, u_lo, cnt, ns, qh, ql):
                u_hi, u_lo = u_hi.reshape(-1), u_lo.reshape(-1)
                cnt2 = cnt.reshape(u_hi.shape[0], -1)
                lb, ub = srt.lookup_bounds(u_hi, u_lo, ns[0], qh, ql)
                lbc = jnp.clip(lb, 0, u_hi.shape[0] - 1)
                found = ub > lb
                rows = jnp.where(found[:, None], cnt2[lbc], 0).astype(I32)
                return jax.lax.psum(rows, axes)

            return jax.jit(
                jax.shard_map(
                    fn, mesh=mesh,
                    in_specs=(P(axes), P(axes), P(axes), P(axes), P(),
                              P()),
                    out_specs=P(),
                )
            )

        q_hi, q_lo = jnp.ravel(q_hi), jnp.ravel(q_lo)
        shard_fn = self._program(
            ("lookup", int(self.u_hi.shape[1]), int(q_hi.shape[0])), build)
        return np.asarray(
            shard_fn(self.u_hi, self.u_lo, self.cnt, nv, q_hi, q_lo)
        )
