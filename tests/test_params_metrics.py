"""Typed param shims and progress metrics."""
import pytest

from kmer_hasher_tpu.api import count_kmers_fq_sh_rp
from kmer_hasher_tpu.params import CountParams, FqParams, RpParams
from kmer_hasher_tpu.utils.metrics import ProgressMeter, most_common_kmer


def test_rp_params_from_r_vector():
    # test.R:380 uses c(5, 2, 0, tn, -1, 100, 4, 0)
    p = RpParams.from_r_vector([5, 2, 0, 2, -1, 100, 4, 0])
    assert p == RpParams(k=5, prefix_bits=2, min_q=0, n_shards=2,
                         max_reads=None, max_mem_gb=100, source_n=4,
                         source=0)
    with pytest.raises(ValueError):
        RpParams.from_r_vector([5, 2, 0])


def test_fq_and_count_params():
    p = FqParams.from_r_vector([21, 1000000, 16, 100, 20, -1])
    assert p.k == 21 and p.max_reads is None and p.min_q == 20
    c = CountParams.from_r_vector([4, 0, 2])
    assert c == CountParams(k=4, source=0, source_n=2)


def test_progress_meter():
    recs = []
    m = ProgressMeter(name="reads", report_every=10, sink=recs.append)
    for _ in range(5):
        m.update(4, kmers=123)
    assert len(recs) == 1  # window crossed at total=12; next at >=22
    assert recs[0]["total"] == 12 and recs[0]["kmers"] == 123
    assert recs[0]["rate"] > 0
    m.update(10)
    assert len(recs) == 2 and recs[1]["total"] == 30


def test_most_common_kmer(ref, repeat_40_fq):
    st = count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=5, min_q=0)
    info = most_common_kmer(st)
    # the dominant canonical 5-mer of the ACTGG repeat family
    assert info["count"] == max(v[0] for v in st.counts_dict().values())
    assert len(info["kmer"]) == 5
