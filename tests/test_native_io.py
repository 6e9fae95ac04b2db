"""Native C++ fastx parser vs the pure-Python reader."""
import pathlib

import pytest

from kmer_hasher_tpu.io import fastx, native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native parser not built"
)


@pytest.mark.parametrize(
    "name", ["test.fa", "test_10.fastq", "test.fastq.gz", "repeat_40.fq"]
)
def test_native_matches_python(ref, name):
    assert native.read_fastx(str(ref / name)) == fastx.read_fastx_py(
        str(ref / name)
    )


def test_native_max_records(ref):
    a = native.read_fastx(str(ref / "test.fastq.gz"), 7)
    assert len(a) == 7


def test_native_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.read_fastx(str(tmp_path / "missing.fa"))
    bad = tmp_path / "bad.txt"
    bad.write_text("not a fastx\n")
    with pytest.raises(ValueError):
        native.read_fastx(str(bad))
    empty = tmp_path / "empty.fa"
    empty.write_text("")
    assert native.read_fastx(str(empty)) == []


def test_native_multiline_fasta(tmp_path):
    p = tmp_path / "ml.fa"
    p.write_text(">a desc here\nACGT\nACGT\n>b\nGGGG\n")
    recs = native.read_fastx(str(p))
    assert recs == [("a", b"ACGTACGT", None), ("b", b"GGGG", None)]
    assert recs == fastx.read_fastx_py(str(p))


def test_streaming_raw_batches_match_whole_file(ref):
    from kmer_hasher_tpu.io import native

    if not native.available():
        import pytest
        pytest.skip("native parser unavailable")
    import numpy as np

    path = f"{ref}/test.fastq.gz"
    whole = native.read_fastx_raw(path)
    batches = list(native.iter_fastx_raw(path, batch_records=700))
    assert [len(b[3]) for b in batches] == [700, 700, 700, 400]
    seq_cat = np.concatenate([b[0] for b in batches])
    np.testing.assert_array_equal(seq_cat, whole[0])
    qual_cat = np.concatenate([b[1] for b in batches])
    np.testing.assert_array_equal(qual_cat, whole[1])
    qp_cat = np.concatenate([b[3] for b in batches])
    np.testing.assert_array_equal(qp_cat, whole[3])
    # per-batch offsets rebase to 0 and chain to the global ones
    lens_stream = np.concatenate([np.diff(b[2]) for b in batches])
    np.testing.assert_array_equal(lens_stream, np.diff(whole[2]))
    # max_records honoured mid-batch
    lim = list(native.iter_fastx_raw(path, batch_records=64,
                                     max_records=100))
    assert sum(len(b[3]) for b in lim) == 100
    # FASTA streaming across batch boundaries
    fa = list(native.iter_fastx_raw(f"{ref}/test.fa", 10))
    assert len(fa) == 1 and len(fa[0][3]) == 1


def test_iter_fastx_padded_matches_numpy_padder(ref, tmp_path):
    """The C++ fill (fastx_fill_padded) must be byte-identical to the NumPy
    scatter padder across files, batch sizes, limits and skips."""
    import numpy as np

    from kmer_hasher_tpu.counting import _pad_from_raw

    def old_iter(path, br, mx=None, skip=0):
        limit = None if mx is None else skip + mx
        to_skip = skip
        for raw in native.iter_fastx_raw(path, br, limit):
            seq_all, qual_all, offsets, qpres = raw
            n = len(qpres)
            if to_skip >= n:
                to_skip -= n
                continue
            start, to_skip = to_skip, 0
            yield _pad_from_raw(seq_all, qual_all, offsets, qpres,
                                start, n, br)

    # a multi-line FASTQ + mixed-length records exercises the padding edges
    ml = tmp_path / "ml.fq"
    ml.write_text("@r1\nACGTAC\nGT\n+\nIIIIII\nII\n@r2\nAC\n+\nII\n"
                  "@r3\nACGTACGTACGTACGTACGTACGTACGTACGTA\n+\n"
                  "IIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII\n")
    cases = [(str(ref / "test.fastq.gz"), 512, None, 0),
             (str(ref / "test.fastq.gz"), 128, 300, 0),
             (str(ref / "test.fastq.gz"), 512, None, 700),
             (str(ref / "test.fastq.gz"), 256, 1000, 100),
             (str(ref / "test.fa"), 512, None, 0),
             (str(ref / "repeat_40.fq"), 8, 9, 3),
             (str(ml), 2, None, 0), (str(ml), 8, None, 1)]
    for path, br, mx, skip in cases:
        a = list(old_iter(path, br, mx, skip))
        b = list(native.iter_fastx_padded(path, br, mx, skip))
        assert len(a) == len(b), (path, br, mx, skip)
        for (s1, q1, l1, h1), (s2, q2, l2, h2) in zip(a, b):
            assert s1.shape == s2.shape
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_array_equal(q1, q2)
            np.testing.assert_array_equal(l1, l2)
            np.testing.assert_array_equal(h1, h2)


def test_packed_fill_matches_numpy_packer(ref, tmp_path):
    """fastx_fill_packed's (codes, nmask) must equal the NumPy packer
    applied to the padded byte plane, including partial tail bytes."""
    import numpy as np

    from kmer_hasher_tpu.counting import _pack_np

    odd = tmp_path / "odd.fq"  # lengths 5/2/33: partial code/nmask bytes
    odd.write_text("@r1\nACGTN\n+\nIIIII\n@r2\nnA\n+\nII\n"
                   "@r3\nACGTACGTACGTACGTACGTACGTACGTACGTA\n+\n"
                   "IIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII\n")
    for path in [str(ref / "test.fastq.gz"), str(ref / "test.fa"), str(odd)]:
        pairs = list(zip(native.iter_fastx_padded(path, 512),
                         native.iter_fastx_packed(path, 512)))
        assert pairs
        for (s1, q1, l1, h1), (s2, q2, l2, h2) in pairs:
            c_np, n_np = _pack_np(s1)
            np.testing.assert_array_equal(c_np, s2[0])
            if len(s2) == 2:
                np.testing.assert_array_equal(n_np, s2[1])
            else:  # nmask omitted: the batch must be N-free within reads
                in_read = (np.arange(s1.shape[1])[None, :] < l1[:, None])
                assert not ((s1 == ord("N")) & in_read).any()
            if isinstance(q2, tuple):  # 4-bit dictionary form
                from kmer_hasher_tpu.ops import encode as enc

                q2 = np.asarray(enc.unpack_qual(*q2))
            np.testing.assert_array_equal(q1, q2)
            np.testing.assert_array_equal(l1, l2)
            np.testing.assert_array_equal(h1, h2)


def test_packed_qual_dictionary_branches(tmp_path):
    """The packed iterator must dictionary-pack the qual plane when a
    batch has <= 16 distinct quality bytes (byte-exact reconstruction)
    and fall back to the raw byte plane above 16."""
    import numpy as np

    from kmer_hasher_tpu.ops import encode as enc

    few = tmp_path / "few.fq"  # 4 distinct qual values (binned Illumina)
    few.write_text("@r1\nACGTACGT\n+\n#,:FF:,#\n@r2\nGGGTTT\n+\nFFF##:\n")
    (s1, q1, l1, h1), = native.iter_fastx_padded(str(few), 64)
    (s2, q2, l2, h2), = native.iter_fastx_packed(str(few), 64)
    assert isinstance(q2, tuple)
    qnib, qdict = q2
    assert qnib.shape[-1] == q1.shape[-1] // 2 and qdict.shape == (16,)
    assert qdict[0] == 0  # pad nibble must decode to 0
    np.testing.assert_array_equal(np.asarray(enc.unpack_qual(qnib, qdict)),
                                  q1)

    many = tmp_path / "many.fq"  # 20 distinct, range < 63 -> 6-bit pack
    quals = "".join(chr(33 + i) for i in range(20))
    many.write_text(f"@r1\n{'A' * 20}\n+\n{quals}\n")
    (_, q1m, _, _), = native.iter_fastx_padded(str(many), 64)
    (_, q2m, _, _), = native.iter_fastx_packed(str(many), 64)
    assert isinstance(q2m, tuple)
    q6, qbase = q2m
    assert qbase.shape == (1,) and int(qbase[0]) == 33
    assert q6.shape[-1] == q1m.shape[-1] * 3 // 4
    np.testing.assert_array_equal(np.asarray(enc.unpack_qual(q6, qbase)),
                                  q1m)

    wide = tmp_path / "wide.fq"  # > 63 range -> raw plane fallback
    wide.write_text(f"@r1\n{'A' * 3}\n+\n!e~\n@r2\n{'C' * 17}\n+\n"
                    + "".join(chr(40 + i) for i in range(17)) + "\n")
    (_, q1w, _, _), = native.iter_fastx_padded(str(wide), 64)
    (_, q2w, _, _), = native.iter_fastx_packed(str(wide), 64)
    assert not isinstance(q2w, tuple)
    np.testing.assert_array_equal(q1w, q2w)


def test_qdict_env_gate(tmp_path, monkeypatch):
    """KMH_QDICT=0 must force the raw qual plane (A/B revert switch)
    with identical bytes."""
    import numpy as np

    few = tmp_path / "few.fq"
    few.write_text("@r1\nACGTACGT\n+\n#,:FF:,#\n")
    (_, qd, _, _), = native.iter_fastx_packed(str(few), 64)
    assert isinstance(qd, tuple)
    monkeypatch.setenv("KMH_QDICT", "0")
    (_, qr, _, _), = native.iter_fastx_packed(str(few), 64)
    assert not isinstance(qr, tuple)
    from kmer_hasher_tpu.ops import encode as enc

    np.testing.assert_array_equal(np.asarray(enc.unpack_qual(*qd)), qr)


def test_unpack_seq_roundtrip_semantics():
    """unpack_seq(pack(x)) must reproduce (base_codes, n_flags) for
    arbitrary bytes — the only sequence reads the device path performs."""
    import numpy as np

    from kmer_hasher_tpu.counting import _pack_np
    from kmer_hasher_tpu.ops import encode as enc

    rng = np.random.default_rng(0)
    raw = rng.integers(33, 127, (16, 64), np.uint8)
    raw[0, :8] = np.frombuffer(b"ACGTNacg", np.uint8)
    rec = np.asarray(enc.unpack_seq(*_pack_np(raw)))
    np.testing.assert_array_equal(np.asarray(enc.base_codes(rec)),
                                  np.asarray(enc.base_codes(raw)))
    np.testing.assert_array_equal(np.asarray(enc.n_flags(rec)),
                                  np.asarray(enc.n_flags(raw)))


def test_nmask_omitted_for_n_free_batches(tmp_path):
    """N-free batches drop the nmask plane (1-tuple seq); batches with Ns
    keep it, and both reconstruct correctly."""
    import numpy as np

    from kmer_hasher_tpu.ops import encode as enc

    clean = tmp_path / "clean.fq"
    clean.write_text("@r1\nACGTACGT\n+\nIIIIIIII\n")
    (s, _q, l_, _h), = native.iter_fastx_packed(str(clean), 64)
    assert isinstance(s, tuple) and len(s) == 1
    plane = np.asarray(enc.unpack_seq(*s))
    assert plane[0, :8].tobytes() == b"ACGTACGT"

    withn = tmp_path / "withn.fq"
    withn.write_text("@r1\nACGNACGT\n+\nIIIIIIII\n")
    (s2, _q, _l, _h), = native.iter_fastx_packed(str(withn), 64)
    assert isinstance(s2, tuple) and len(s2) == 2
    plane2 = np.asarray(enc.unpack_seq(*s2))
    assert plane2[0, :8].tobytes() == b"ACGNACGT"


# -- byte-range readers (multi-host input slicing) ---------------------------

def _range_records_native(path, start, end, batch=7):
    """Drain the native range reader via the padded batch iterator and
    return (seq_bytes, qual_or_None) per record."""
    out = []
    for seq, qual, lengths, has_qual in native.iter_fastx_padded(
            str(path), batch, byte_range=(start, end)):
        for r in range(len(lengths)):
            if lengths[r] > 0:
                s = bytes(seq[r, : lengths[r]])
                q = bytes(qual[r, : lengths[r]]) if has_qual[r] else None
                out.append((s, q))
    return out


@pytest.mark.parametrize("name", ["test_10.fastq", "repeat_40.fq",
                                  "test.fa"])
@pytest.mark.parametrize("n_ranges", [2, 3, 5])
def test_range_partition_exact(ref, name, n_ranges, tmp_path):
    """The union over contiguous byte ranges reproduces the whole file's
    records exactly, in order, with no duplicates — for both the native
    and the pure-Python range readers, at several split counts."""
    import os

    path = str(ref / name)
    want = [(s, q) for (_n, s, q) in fastx.read_fastx_py(path)]
    size = os.path.getsize(path)
    bounds = [size * i // n_ranges for i in range(n_ranges + 1)]
    got_native, got_py = [], []
    for i in range(n_ranges):
        got_native += _range_records_native(path, bounds[i], bounds[i + 1])
        for recs in fastx.iter_fastx_range(path, bounds[i], bounds[i + 1]):
            got_py += [(s, q) for (_n, s, q) in recs]
    assert got_native == want
    assert got_py == want


def test_range_split_at_quality_at_sign(tmp_path):
    """FASTQ boundary re-sync must not mistake a quality line starting
    with '@' (Q31) for a record header: force splits at every byte of a
    file whose quality strings all begin with '@'."""
    import os

    p = tmp_path / "tricky.fastq"
    with open(p, "w") as f:
        for i in range(8):
            ln = 20 + i
            seq = ("ACGT" * 5 + "A" * 8)[:ln]
            f.write(f"@read{i}\n{seq}\n+\n{'@' * ln}\n")
    want = [(s, q) for (_n, s, q) in fastx.read_fastx_py(str(p))]
    size = os.path.getsize(p)
    for cut in range(0, size + 1, 3):  # every 3rd split point
        a = _range_records_native(p, 0, cut)
        b = _range_records_native(p, cut, size)
        assert a + b == want, f"split at {cut}"
        ap = [(s, q) for recs in fastx.iter_fastx_range(str(p), 0, cut)
              for (_n, s, q) in recs]
        bp = [(s, q) for recs in fastx.iter_fastx_range(str(p), cut, size)
              for (_n, s, q) in recs]
        assert ap + bp == want, f"py split at {cut}"


def test_range_empty_slice(tmp_path):
    """A byte range containing no record start yields nothing."""
    p = tmp_path / "two.fastq"
    p.write_text("@a\nACGTACGTACGT\n+\nIIIIIIIIIIII\n"
                 "@b\nTTTTACGTACGT\n+\nIIIIIIIIIIII\n")
    import os

    size = os.path.getsize(p)
    # a tiny window in the middle of record a's quality line
    assert _range_records_native(p, 20, 24) == []
    assert list(fastx.iter_fastx_range(str(p), 20, 24)) == []
    # full file via one range == plain parse
    whole = _range_records_native(p, 0, size)
    assert len(whole) == 2


def test_range_empty_file_and_junk_leader(tmp_path):
    """Range mode must mirror the non-range parser's edge behavior: an
    empty file yields an empty stream (NOT FileNotFoundError), a junk
    leader raises the parse error on the host that owns byte 0, and a
    missing file still raises FileNotFoundError."""
    empty = tmp_path / "empty.fastq"
    empty.write_bytes(b"")
    assert _range_records_native(empty, 0, 0) == []
    junk = tmp_path / "junk.txt"
    junk.write_text("definitely not fastx\nmore\n")
    import os

    size = os.path.getsize(junk)
    with pytest.raises(ValueError, match="unrecognised"):
        _range_records_native(junk, 0, size)
    # a host whose range starts past 0 goes empty instead of erroring
    assert _range_records_native(junk, size // 2, size) == []
    with pytest.raises(FileNotFoundError):
        list(native.iter_fastx_padded(str(tmp_path / "nope.fq"), 4,
                                      byte_range=(0, 10)))


def test_is_fourline_fastq(tmp_path):
    four = tmp_path / "four.fastq"
    four.write_text("@a\nACGT\n+\nIIII\n@b\nTTTT\n+\nJJJJ\n")
    multi = tmp_path / "multi.fastq"
    multi.write_text("@a\nACGT\nACGT\n+\nIIII\nIIII\n@b\nTT\n+\nJJ\n")
    fasta = tmp_path / "x.fa"
    fasta.write_text(">a\nACGT\nACGT\n")
    assert fastx.is_fourline_fastq(str(four))
    assert not fastx.is_fourline_fastq(str(multi))
    assert fastx.is_fourline_fastq(str(fasta))  # FASTA is range-safe


def test_py_range_parser_multiline_grammar(tmp_path):
    """The Python range parser uses the FULL kseq grammar (multi-line
    seq/qual) — over the whole-file range it must match read_fastx_py."""
    p = tmp_path / "multi.fastq"
    p.write_text("@a x\nACGT\nACGTA\n+\nIIII\nIIIII\n"
                 "@b\nTTTTT\n+anything\nJJJJJ\n")
    import os

    size = os.path.getsize(p)
    info = {}
    got = [r for recs in fastx.iter_fastx_range(str(p), 0, size,
                                                range_info=info)
           for r in recs]
    assert got == fastx.read_fastx_py(str(p))
    assert info["start"] == 0 and info["end"] == size


def test_range_info_tiling(ref, tmp_path):
    """Resolved per-range boundaries tile the file exactly on 4-line
    input (native + python), giving the counting continuity check its
    invariant."""
    import os

    path = str(ref / "repeat_40.fq")
    size = os.path.getsize(path)
    bounds = [size * i // 3 for i in range(4)]
    last_end = 0
    for i in range(3):
        info_n: dict = {}
        for _ in native.iter_fastx_padded(path, 4,
                                          byte_range=(bounds[i],
                                                      bounds[i + 1]),
                                          range_info=info_n):
            pass
        info_p: dict = {}
        for _ in fastx.iter_fastx_range(path, bounds[i], bounds[i + 1],
                                        range_info=info_p):
            pass
        assert info_n["start"] == info_p["start"] == last_end
        assert info_n["end"] == info_p["end"]
        last_end = info_n["end"]
    assert last_end == size
