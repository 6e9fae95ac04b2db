"""Save/restore round-trips for index and count store."""
import numpy as np

from kmer_hasher_tpu.api import (
    count_kmers_fq_sh_rp,
    kmer_spectrum,
    make_kmer_hash,
    seq_kmer_depth,
    seq_kmer_pos,
)
from kmer_hasher_tpu.utils import checkpoint as ckpt



def test_index_roundtrip(tmp_path, test_fa):
    seq = test_fa[:4000]
    idx = make_kmer_hash(seq, 10)
    p = tmp_path / "idx.npz"
    ckpt.save_index(idx, p)
    idx2 = ckpt.load_index(p)
    assert idx2.k == idx.k and idx2.n_valid == idx.n_valid
    t1, t2 = idx.tables(15), idx2.tables(15)
    assert t1["kmer"] == t2["kmer"]
    np.testing.assert_array_equal(t1["pos"], t2["pos"])
    np.testing.assert_array_equal(t1["pair.pos"], t2["pair.pos"])
    np.testing.assert_array_equal(t1["count"], t2["count"])
    # queries still work post-restore
    np.testing.assert_array_equal(
        seq_kmer_pos(idx, seq[100:300], 10), seq_kmer_pos(idx2, seq[100:300], 10)
    )


def test_count_store_roundtrip(ref, tmp_path):
    st = count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=7, min_q=0,
                              source_n=2, source=0)
    p = tmp_path / "store.npz"
    ckpt.save_count_store(st, p)
    st2 = ckpt.load_count_store(p)
    assert st2.counts_dict() == st.counts_dict()
    np.testing.assert_array_equal(kmer_spectrum(st2, 100),
                                  kmer_spectrum(st, 100))
    # resume: keep counting into the restored store
    st2 = count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=7, min_q=0,
                               source_n=2, source=1, store=st2)
    d = st2.counts_dict()
    assert any(v[1] > 0 for v in d.values())
    # depth works after restore
    dep = seq_kmer_depth(st2, "ACTGG" * 10, 7)
    assert dep.shape == (2, 50)


def test_bad_file_rejected(tmp_path):
    import json

    import pytest

    p = tmp_path / "junk.npz"
    np.savez(p, meta=json.dumps({"magic": "nope"}))
    with pytest.raises(ValueError):
        ckpt.load_count_store(p)
    with pytest.raises(ValueError):
        ckpt.load_index(p)
