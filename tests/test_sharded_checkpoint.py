"""ShardedCountStore save/restore: onto a mesh and folded to single-chip."""
import jax
import numpy as np
import pytest

from kmer_hasher_tpu import counting
from kmer_hasher_tpu.parallel import make_mesh
from kmer_hasher_tpu.utils import checkpoint as ckpt



@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


def test_sharded_store_roundtrip(ref, tmp_path, mesh):
    st = counting.count_kmers_fq_sh_rp(f"{ref}/test_10.fastq", k=9,
                                       min_q=20, mesh=mesh)
    single = counting.count_kmers_fq_sh_rp(f"{ref}/test_10.fastq", k=9,
                                           min_q=20)
    assert int(st.n_unique.sum()) == single.n_unique
    np.testing.assert_array_equal(st.total_added,
                                  np.asarray(single.total_added))
    p = tmp_path / "sharded.npz"
    ckpt.save_count_store(st, p)

    # restore onto the same-size mesh: spectra and per-shard sizes agree
    st2 = ckpt.load_count_store(p, mesh=mesh)
    np.testing.assert_array_equal(st2.n_unique, st.n_unique)
    np.testing.assert_array_equal(st2.spectrum(50), st.spectrum(50))
    np.testing.assert_array_equal(st2.total_added, st.total_added)

    # restore without a mesh: folds into a plain CountStore equal to the
    # single-chip count of the same reads
    st3 = ckpt.load_count_store(p)
    assert st3.counts_dict() == single.counts_dict()
    np.testing.assert_array_equal(st3.spectrum(50), single.spectrum(50))
    np.testing.assert_array_equal(np.asarray(st3.total_added),
                                  np.asarray(single.total_added))


def test_cli_count_mesh(ref, tmp_path, capsys):
    import json

    from kmer_hasher_tpu.__main__ import main

    out = str(tmp_path / "st.npz")
    main(["count", f"{ref}/repeat_40.fq", "-k", "7", "--min-q", "0",
          "--mesh", "8", "-o", out])
    info = json.loads(capsys.readouterr().out)
    single = counting.count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=7,
                                           min_q=0)
    assert info["distinct"] == single.n_unique
    assert info["total_added"] == np.asarray(single.total_added).tolist()
    # the saved sharded store folds back losslessly
    st = ckpt.load_count_store(out)
    assert st.counts_dict() == single.counts_dict()
