from kmer_hasher_tpu.io import pad_records


def test_read_fasta(test_fa):
    assert len(test_fa) == 59940
    assert set(test_fa) <= set("ACGT")


def test_read_fastq(test_10_fastq):
    assert len(test_10_fastq) == 10
    for _n, s, q in test_10_fastq:
        assert q is not None and len(q) == len(s)


def test_read_fastq_gz(test_fastq_gz):
    assert len(test_fastq_gz) == 2500
    for _n, s, q in test_fastq_gz[:10]:
        assert q is not None and len(q) == len(s)


def test_repeat40(repeat_40_fq):
    assert len(repeat_40_fq) == 10
    for _n, s, _q in repeat_40_fq:
        assert len(s) == 250


def test_padding(repeat_40_fq):
    pr = pad_records(repeat_40_fq)
    assert pr.seq.shape[0] == 10
    assert pr.seq.shape[1] % 8 == 0
    assert (pr.lengths == 250).all()
    assert pr.has_qual.all()
    # padded tail is 'N' with qual 0 so it can never form valid windows
    assert (pr.seq[:, 250:] == ord("N")).all()
    assert (pr.qual[:, 250:] == 0).all()


def test_iter_fastx_streams_in_batches(ref):
    from kmer_hasher_tpu.io import iter_fastx, read_fastx

    path = f"{ref}/test.fastq.gz"
    batches = list(iter_fastx(path, batch_size=700))
    assert [len(b) for b in batches] == [700, 700, 700, 400]
    flat = [r for b in batches for r in b]
    assert flat == read_fastx(path)
    # max_records honoured mid-stream
    some = [r for b in iter_fastx(path, batch_size=64, max_records=100)
            for r in b]
    assert some == read_fastx(path, 100)
    # fasta streaming too
    fa = list(iter_fastx(f"{ref}/test.fa", batch_size=10))
    assert len(fa) == 1 and fa[0][0][0] == "SUPER_1"


def test_multiline_fastq_py_parser(tmp_path):
    # kseq supports multi-line FASTQ (src/kseq.h:195-218); the py fallback
    # must not desynchronize on it (round-1 advisor finding)
    from kmer_hasher_tpu.io.fastx import read_fastx_py
    from kmer_hasher_tpu.io import native

    p = tmp_path / "ml.fq"
    p.write_text(
        "@r1 comment\nACGT\nACGT\n+\nIIII\nIIII\n"
        "@r2\nTTTT\n+r2\nJJJJ\n"
    )
    recs = read_fastx_py(str(p))
    assert recs == [("r1", b"ACGTACGT", b"IIIIIIII"), ("r2", b"TTTT", b"JJJJ")]
    if native.available():
        assert native.read_fastx(str(p)) == recs


def test_corrupt_gzip_raises(tmp_path):
    from kmer_hasher_tpu.io import native

    if not native.available():
        import pytest
        pytest.skip("native parser unavailable")
    import gzip as _gz

    p = tmp_path / "bad.fq.gz"
    data = _gz.compress(b"@r1\n" + b"A" * 1000 + b"\n+\n" + b"I" * 1000 + b"\n")
    p.write_bytes(data[: len(data) // 2])  # truncated/corrupt stream
    import pytest
    with pytest.raises((IOError, ValueError)):
        native.read_fastx(str(p))
