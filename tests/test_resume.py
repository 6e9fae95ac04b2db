"""Mid-file resume: skip_reads, periodic checkpointing with a progress
cursor, and the CLI --resume/--checkpoint-every flow."""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from kmer_hasher_tpu.counting import count_kmers_fq_sh_rp
from kmer_hasher_tpu.utils import checkpoint as ckpt



@pytest.fixture
def fq(ref):
    return f"{ref}/test.fastq.gz"


def test_skip_reads_counts_only_the_tail(fq):
    whole = count_kmers_fq_sh_rp(fq, 21, min_q=20, max_reads=120)
    head = count_kmers_fq_sh_rp(fq, 21, min_q=20, max_reads=80)
    tail = count_kmers_fq_sh_rp(fq, 21, min_q=20, skip_reads=80,
                                max_reads=40)
    # head + tail partition the first 120 reads
    assert (int(head.total_added[0]) + int(tail.total_added[0])
            == int(whole.total_added[0]))
    resumed = count_kmers_fq_sh_rp(fq, 21, min_q=20, skip_reads=80,
                                   max_reads=40, store=head)
    np.testing.assert_array_equal(resumed.spectrum(30), whole.spectrum(30))
    assert resumed.n_unique == whole.n_unique


def test_periodic_checkpoint_and_resume(fq, tmp_path):
    out = str(tmp_path / "ck.npz")
    # a run that checkpoints every ~50 reads; the final write marks done
    count_kmers_fq_sh_rp(fq, 21, min_q=20, max_reads=130,
                         checkpoint_every=50, checkpoint_path=out)
    prog = ckpt.load_progress(out)
    # done=False: the leg hit max_reads, the file itself has records left
    assert prog == {"path": fq, "reads_done": 130, "done": False}
    # simulate a crash after the first periodic checkpoint: count only 60
    # reads (one checkpoint at >=50), then resume from the cursor
    out2 = str(tmp_path / "ck2.npz")
    count_kmers_fq_sh_rp(fq, 21, min_q=20, max_reads=60,
                         checkpoint_every=50, checkpoint_path=out2)
    prog2 = ckpt.load_progress(out2)
    assert not prog2["done"] and prog2["reads_done"] == 60
    store = ckpt.load_count_store(out2)
    resumed = count_kmers_fq_sh_rp(fq, 21, min_q=20,
                                   skip_reads=prog2["reads_done"],
                                   max_reads=130 - prog2["reads_done"],
                                   store=store)
    whole = count_kmers_fq_sh_rp(fq, 21, min_q=20, max_reads=130)
    np.testing.assert_array_equal(resumed.spectrum(30), whole.spectrum(30))
    assert resumed.n_unique == whole.n_unique
    assert np.array_equal(resumed.total_added, whole.total_added)


def test_checkpoint_requires_path(fq):
    with pytest.raises(ValueError, match="checkpoint_path"):
        count_kmers_fq_sh_rp(fq, 21, min_q=20, max_reads=60,
                             checkpoint_every=10)


def test_cli_resume_cursor_mismatch_refuses(fq, ref, tmp_path):
    """A resume cursor that matches none of the given inputs must abort
    instead of skipping every file as 'already counted' and re-saving the
    store unchanged."""
    from kmer_hasher_tpu.__main__ import main

    out = str(tmp_path / "s.npz")
    count_kmers_fq_sh_rp(fq, 21, min_q=20, max_reads=20,
                         checkpoint_every=10, checkpoint_path=out)
    with pytest.raises(SystemExit, match="matches none"):
        main(["count", f"{ref}/repeat_40.fq", "-k", "21",
              "--resume", out, "-o", str(tmp_path / "o.npz")])


def test_cli_resume_matches_same_file_spelled_differently(ref, fq, tmp_path):
    """The cursor stores the path string of the original run; resuming with
    a different lexical spelling of the same file must still match."""
    from kmer_hasher_tpu.__main__ import main

    out = str(tmp_path / "s.npz")
    count_kmers_fq_sh_rp(fq, 21, min_q=20, max_reads=20,
                         checkpoint_every=10, checkpoint_path=out)
    alias = f"{ref}/../{ref.name}/test.fastq.gz"
    main(["count", alias, "-k", "21", "--min-q", "20", "--max-reads", "10",
          "--resume", out, "-o", str(tmp_path / "o.npz")])
    whole = count_kmers_fq_sh_rp(fq, 21, min_q=20, max_reads=30)
    got = ckpt.load_count_store(str(tmp_path / "o.npz"))
    assert got.n_unique == whole.n_unique


@pytest.mark.slow
def test_cli_checkpoint_resume_flow(fq, tmp_path):
    out = str(tmp_path / "store.npz")
    # force the CPU backend in the subprocess (the env var alone does not
    # override an installed accelerator plugin — as in tests/conftest.py)
    env_args = [sys.executable, "-c",
                "import jax; jax.config.update('jax_platforms', 'cpu'); "
                "from kmer_hasher_tpu.__main__ import main; main()",
                "count", fq, "-k", "21", "--min-q", "20", "-o", out]
    # first leg: 70 reads with periodic checkpoints
    r1 = subprocess.run(
        env_args + ["--max-reads", "70", "--checkpoint-every", "30"],
        capture_output=True, text=True, cwd=str(pathlib.Path(__file__).parent.parent), timeout=600,
    )
    assert r1.returncode == 0, r1.stderr
    assert ckpt.load_progress(out)["reads_done"] == 70
    # second leg resumes mid-file and runs 30 more reads
    r2 = subprocess.run(
        env_args + ["--max-reads", "30", "--resume", out],
        capture_output=True, text=True, cwd=str(pathlib.Path(__file__).parent.parent), timeout=600,
    )
    assert r2.returncode == 0, r2.stderr
    assert "resuming after 70 reads" in r2.stderr
    got = json.loads(r2.stdout.strip().splitlines()[-1])
    whole = count_kmers_fq_sh_rp(fq, 21, min_q=20, max_reads=100)
    assert got["distinct"] == whole.n_unique
    assert got["total_added"] == whole.total_added.tolist()
