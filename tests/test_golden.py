"""Golden-checksum regression tests: cheap whole-pipeline fingerprints on
the seeded test data (kmer_hasher_tpu.synth). If semantics drift anywhere
(encode, sort, grouping, emission order), these change."""
import hashlib

import numpy as np

from kmer_hasher_tpu.api import (
    count_kmers_fq_sh_rp,
    kmer_spectrum,
    make_kmer_hash,
    seq_kmer_pos,
)


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def test_golden_index_tables(test_fa):
    idx = make_kmer_hash(test_fa, 8)
    t = idx.tables(1 | 2 | 8)
    d = _digest(t["pos"], t["count"],
                np.frombuffer("".join(t["kmer"]).encode(), np.uint8))
    assert d == "cb5998d863c4ac40", d


def test_golden_query(test_fa):
    idx = make_kmer_hash(test_fa, 16)
    m = seq_kmer_pos(idx, test_fa[20000:21000], 16)
    assert _digest(m) == "339eeef78c318bcb", _digest(m)


def test_golden_counting(ref):
    st = count_kmers_fq_sh_rp(f"{ref}/test.fastq.gz", k=21,
                              min_q=20, max_reads=500)
    spec = kmer_spectrum(st, 30)
    d = _digest(np.asarray(st.u_hi)[: st.n_unique],
                np.asarray(st.u_lo)[: st.n_unique],
                np.asarray(st.cnt)[: st.n_unique], spec)
    assert d == "3c4e11d1a7762d6f", d
