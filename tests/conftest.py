"""Test configuration: force an 8-device virtual CPU mesh.

Sharding tests run over ``--xla_force_host_platform_device_count=8`` CPU
devices. Must be set before JAX initialises its backends. Only a run that
names the GPU itself (``JAX_PLATFORMS=cuda,cpu pytest -m gpu tests/``, on
the card) keeps it: the ``gpu``-marked tests then compile for the card.
"""
import os

if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Persistent compilation cache is configured by the package itself
# (kmer_hasher_tpu/__init__.py). The env var alone does not override an
# installed accelerator plugin — force the CPU platform through the
# config API.
import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pathlib

import pytest


@pytest.fixture(scope="session")
def ref(tmp_path_factory) -> pathlib.Path:
    """Directory of the seeded test data files (kmer_hasher_tpu.synth
    .write_test_data): test.fa, test_10.fastq, test.fastq.gz,
    repeat_40.fq."""
    from kmer_hasher_tpu.synth import write_test_data

    d = tmp_path_factory.mktemp("reference")
    write_test_data(str(d))
    return d


@pytest.fixture(scope="session")
def test_fa(ref) -> str:
    """The 59,940 bp single-record SUPER_1 sequence (test.fa)."""
    from kmer_hasher_tpu.io import read_fastx

    recs = read_fastx(str(ref / "test.fa"))
    assert len(recs) == 1 and recs[0][0] == "SUPER_1"
    return recs[0][1].decode()


@pytest.fixture(scope="session")
def test_10_fastq(ref):
    from kmer_hasher_tpu.io import read_fastx

    return read_fastx(str(ref / "test_10.fastq"))


@pytest.fixture(scope="session")
def repeat_40_fq(ref):
    from kmer_hasher_tpu.io import read_fastx

    return read_fastx(str(ref / "repeat_40.fq"))


@pytest.fixture(scope="session")
def test_fastq_gz(ref):
    from kmer_hasher_tpu.io import read_fastx

    return read_fastx(str(ref / "test.fastq.gz"))
