"""CLI smoke tests through the real argv surface."""
import json

import numpy as np
import pytest

from kmer_hasher_tpu.__main__ import main



def test_cli_index_tables_query(ref, tmp_path, capsys, test_fa):
    idx_path = str(tmp_path / "idx.npz")
    main(["index", f"{ref}/test.fa", "-k", "10", "-o", idx_path])
    info = json.loads(capsys.readouterr().out)
    assert info["distinct"] > 0 and info["positions"] == 59931

    main(["tables", idx_path, "--opt-flag", "11", "-o",
          str(tmp_path / "t")])
    kmers = (tmp_path / "t.kmer.txt").read_text().splitlines()
    counts = np.load(tmp_path / "t.count.npy")
    pos = np.load(tmp_path / "t.pos.npy")
    assert len(kmers) == len(counts) == info["distinct"]
    assert pos.shape == (info["positions"], 2)

    # query a slice, not the whole chromosome: the full 60 kb self-query
    # emits 33.5M hit rows, which the throttled CI host spends ~30 s
    # materialising (the library streams it fine — examples/large_pairs.py
    # covers the big-table regime on real hardware)
    qpath = tmp_path / "q.fa"
    qpath.write_text(">q\n" + test_fa[1000:3000] + "\n")
    main(["query", idx_path, str(qpath), "-k", "10", "-o",
          str(tmp_path / "q.npy")])
    q = json.loads(capsys.readouterr().out)
    assert q["hits"] >= 1991  # self-slice: at least the diagonal


def test_cli_partition_files(ref, tmp_path, capsys):
    out = str(tmp_path / "plist.npz")
    main(["count", f"{ref}/repeat_40.fq", f"{ref}/test_10.fastq", "-k", "5",
          "--min-q", "0", "--partition-files", "-o", out])
    info = json.loads(capsys.readouterr().out)

    # equals the incremental two-call run under one source
    inc = str(tmp_path / "inc.npz")
    main(["count", f"{ref}/repeat_40.fq", "-k", "5", "--min-q", "0",
          "--source", "0", "-o", inc])
    capsys.readouterr()
    main(["count", f"{ref}/test_10.fastq", "-k", "5", "--min-q", "0",
          "--source", "0", "--resume", inc, "-o", inc])
    info2 = json.loads(capsys.readouterr().out)
    assert info["distinct"] == info2["distinct"]
    assert info["total_added"] == info2["total_added"]

    with pytest.raises(SystemExit, match="partition-files excludes"):
        main(["count", f"{ref}/repeat_40.fq", "-k", "5",
              "--partition-files", "--max-reads", "5", "-o", out])
    with pytest.raises(SystemExit, match="ONE source"):
        main(["count", f"{ref}/repeat_40.fq", "-k", "5", "--source-n", "2",
              "--partition-files", "-o", out])


def test_cli_count_spectrum_depth(ref, tmp_path, capsys):
    store_path = str(tmp_path / "store.npz")
    main(["count", f"{ref}/repeat_40.fq", "-k", "5", "--min-q", "0",
          "-o", store_path])
    info = json.loads(capsys.readouterr().out)
    assert info["distinct"] == 5
    assert len(info["most_common"]["kmer"]) == 5

    main(["spectrum", store_path, "--max-count", "6000"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) >= 2  # a few occupied bins
    total = sum(int(l.split("\t")[1]) for l in lines)
    assert total == 5

    main(["depth", store_path, f"{ref}/test.fa", "-k", "5", "-o",
          str(tmp_path / "d.npy")])
    capsys.readouterr()
    d = np.load(tmp_path / "d.npy")
    assert d.shape == (1, 59940)

    # resume accumulation through the CLI
    main(["count", f"{ref}/repeat_40.fq", "-k", "5", "--min-q", "0",
          "--resume", store_path, "-o", store_path])
    info2 = json.loads(capsys.readouterr().out)
    assert info2["total_added"][0] == 2 * info["total_added"][0]


def test_cli_bad_args(tmp_path):
    with pytest.raises(SystemExit):
        main(["index", "-k", "5"])  # missing positional/out
